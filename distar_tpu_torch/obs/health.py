"""Health rules engine + watchdog: turn TSDB windows into alerts.

Counterpart of ``distar_tpu.obs.health``. The failure mode of a long league
run is rarely a clean crash; it is a silent stall (actor starvation, NaN
loss, queue saturation) that burns hours of chip time before a human
notices. A ``HealthRule`` is a declarative check over the
``TimeSeriesStore`` (metric reference, window, aggregate, predicate); the
``HealthEvaluator`` runs the rulebook on a timer and drives a debounced
ok -> warning -> firing state machine per rule, emitting exactly one
structured alert event per transition (into the flight recorder and the
bounded alert history the ``/alerts`` route serves).

Debounce: a breach moves ok -> warning at once; only ``for_count``
consecutive breached evaluations escalate to firing; recovery to ok needs
``clear_count`` consecutive clean evaluations. One injected NaN loss
therefore produces exactly one firing alert, not one per evaluation tick.

``default_rulebook`` is the JAX package's rule for rule, including the
learner's perf and training-dynamics rules over ``distar_perf_mfu``
(``obs/perf.py``) and ``distar_train_*`` (``obs/dynamics.py``).

``FleetHealth`` bundles the subsystem (store, sampler, ingest, trace store,
evaluator, flight recorder) behind one process-global handle that the HTTP
surfaces (coordinator, serve frontend, replay admin) answer from.
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence

from .flightrecorder import FlightRecorder, get_flight_recorder
from .registry import MetricsRegistry, get_registry
from .shipper import TelemetryIngest
from .timeseries import RegistrySampler, TimeSeriesStore

OK, WARNING, FIRING = "ok", "warning", "firing"
_STATE_LEVEL = {OK: 0, WARNING: 1, FIRING: 2}

AGGS = ("last", "mean", "min", "max", "rate")
OPS = (">", ">=", "<", "<=", "nonfinite", "stalled", "trending_up")


@dataclass
class HealthRule:
    """One declarative check over the TSDB.

    ``metric`` names a flattened snapshot key (exact) or a labelled family
    (every ``metric{...}`` series); a rule breaches when ANY matching series
    breaches. ``op='nonfinite'`` fires on NaN/Inf values; ``op='stalled'``
    fires when a series with >=2 in-window points stopped moving (rate==0) —
    the counter-watchdog primitive (no data at all is NOT a breach: a role
    that never started is absence, not a stall; staleness is tracked
    per-source instead). ``op='trending_up'`` is the gauge-drift primitive:
    it breaches when the window's slope exceeds ``threshold`` (units/s) AND
    the last value sits at or above the window mean — a persistent rise,
    not one noisy endpoint; the ``for_count`` debounce then demands the
    trend survive consecutive evaluations before firing."""

    name: str
    metric: str
    agg: str = "last"
    op: str = ">"
    threshold: float = 0.0
    window_s: float = 60.0
    for_count: int = 2
    clear_count: int = 2
    severity: str = "critical"
    source: Optional[str] = None
    summary: str = ""

    def __post_init__(self):
        assert self.agg in AGGS, f"agg {self.agg!r} not in {AGGS}"
        assert self.op in OPS, f"op {self.op!r} not in {OPS}"
        assert self.for_count >= 1 and self.clear_count >= 1

    def breached(self, q: dict) -> Optional[float]:
        """Evaluate one series window; returns the offending value on breach,
        None when healthy (or unanswerable: rate on a 1-point window)."""
        if self.op == "nonfinite":
            v = q[self.agg]
            if v is None:
                return None
            return v if not math.isfinite(v) else None
        if self.op == "stalled":
            rate = q["rate"]
            if rate is None:  # <2 points: not enough history to call a stall
                return None
            return rate if rate == 0.0 else None
        if self.op == "trending_up":
            rate, last, mean = q["rate"], q["last"], q["mean"]
            if rate is None or last is None or not math.isfinite(last):
                return None
            rising = rate > self.threshold and (mean is None or last >= mean)
            return rate if rising else None
        v = q["rate"] if self.agg == "rate" else q[self.agg]
        if v is None or not math.isfinite(v):
            return None
        hit = {
            ">": v > self.threshold,
            ">=": v >= self.threshold,
            "<": v < self.threshold,
            "<=": v <= self.threshold,
        }[self.op]
        return v if hit else None


@dataclass
class _RuleState:
    state: str = OK
    breach_streak: int = 0
    clear_streak: int = 0
    since_ts: float = field(default_factory=time.time)
    last_value: Optional[float] = None
    last_series: Optional[str] = None
    fired_count: int = 0
    no_data: bool = True


class HealthEvaluator:
    """Evaluates a rulebook against the store on a timer; owns the per-rule
    state machines and the bounded alert history."""

    def __init__(self, store: TimeSeriesStore, rules: Sequence[HealthRule],
                 recorder: Optional[FlightRecorder] = None,
                 registry: Optional[MetricsRegistry] = None,
                 interval_s: float = 1.0, history: int = 256):
        names = [r.name for r in rules]
        assert len(names) == len(set(names)), "duplicate rule names"
        self.store = store
        self.rules: List[HealthRule] = list(rules)
        self.interval_s = interval_s
        self.recorder = recorder
        self._registry = registry
        self._lock = threading.Lock()
        self._states: Dict[str, _RuleState] = {r.name: _RuleState() for r in self.rules}
        self._history: deque = deque(maxlen=history)
        self._callbacks: List = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def add_transition_callback(self, fn) -> None:
        """Subscribe to alert transitions: ``fn(event_dict)`` is invoked for
        every ok/warning/firing edge, after the evaluation pass, outside the
        evaluator lock (callbacks may query ``alerts()``). This is the
        remediation hook the resilience layer's ``AlertRemediator`` attaches
        to. Exceptions are swallowed: a broken remediator must not kill the
        watchdog."""
        with self._lock:
            self._callbacks.append(fn)

    # -------------------------------------------------------------- evaluate
    def _emit(self, rule: HealthRule, st: _RuleState, transition: str,
              now: float) -> dict:
        event = {
            "ts": now,
            "type": "alert",
            "rule": rule.name,
            "state": transition,
            "severity": rule.severity,
            "value": st.last_value,
            "series": st.last_series,
            "summary": rule.summary or rule.name,
        }
        # exemplar: when the rule's metric matches a latency family that
        # records trace exemplars, the alert names a retrievable offending
        # trace_id (GET /trace/<id>, opsctl trace --id) — the event rides
        # into the flight recorder, so crash bundles carry it too
        from .tracestore import get_exemplar_store

        exemplar = get_exemplar_store().lookup(rule.metric)
        if exemplar is not None:
            event["exemplar_trace_id"] = exemplar["trace_id"]
        self._history.append(event)
        recorder = self.recorder or get_flight_recorder()
        recorder.record("alert", **{k: v for k, v in event.items() if k != "type"})
        return event

    def evaluate_once(self, now: Optional[float] = None) -> List[dict]:
        """One pass over the rulebook; returns the transition events emitted."""
        now = time.time() if now is None else now
        reg = self._registry or get_registry()
        events: List[dict] = []
        with self._lock:
            for rule in self.rules:
                st = self._states[rule.name]
                names = self.store.matching_names(rule.metric, source=rule.source)
                st.no_data = not names
                worst: Optional[float] = None
                worst_series: Optional[str] = None
                for name in names:
                    if rule.source is not None:
                        sources = [rule.source]
                    else:
                        # EVERY source holding the series, not just the
                        # freshest: "a rule breaches when ANY matching
                        # series breaches" — with one series name shipped
                        # by N fleet members (N gateways' p99), querying
                        # only the last shipper masked a breaching member
                        # behind a healthy one that shipped a beat later
                        sources = list(self.store.points(
                            name, window_s=rule.window_s)) or [None]
                    for src in sources:
                        q = self.store.query(name, window_s=rule.window_s,
                                             source=src)
                        if q is None:
                            continue
                        v = rule.breached(q)
                        if v is not None and (worst is None or not math.isfinite(v)
                                              or (math.isfinite(worst) and v > worst)):
                            worst, worst_series = v, f"{q['source']}:{name}"
                if worst is not None:
                    st.last_value, st.last_series = worst, worst_series
                    st.breach_streak += 1
                    st.clear_streak = 0
                    if st.state == OK:
                        st.state, st.since_ts = WARNING, now
                        events.append(self._emit(rule, st, WARNING, now))
                    if st.state == WARNING and st.breach_streak >= rule.for_count:
                        st.state, st.since_ts = FIRING, now
                        st.fired_count += 1
                        reg.counter(
                            "distar_health_alerts_total", "rule firings",
                            rule=rule.name,
                        ).inc()
                        events.append(self._emit(rule, st, FIRING, now))
                else:
                    st.breach_streak = 0
                    st.clear_streak += 1
                    if st.state != OK and st.clear_streak >= rule.clear_count:
                        st.state, st.since_ts = OK, now
                        events.append(self._emit(rule, st, OK, now))
                reg.gauge(
                    "distar_health_rule_state",
                    "0 ok / 1 warning / 2 firing", rule=rule.name,
                ).set(_STATE_LEVEL[st.state])
            reg.counter(
                "distar_health_evaluations_total", "rulebook evaluation passes"
            ).inc()
            callbacks = list(self._callbacks)
        for event in events:  # dispatched OUTSIDE the lock (see add_…)
            for cb in callbacks:
                try:
                    cb(event)
                except Exception:
                    pass
        return events

    # --------------------------------------------------------------- surface
    def alerts(self) -> dict:
        """The ``GET /alerts`` payload: per-rule state + recent transitions."""
        with self._lock:
            rules = {
                r.name: {
                    "state": st.state,
                    "severity": r.severity,
                    "since_ts": st.since_ts,
                    "value": st.last_value,
                    "series": st.last_series,
                    "fired_count": st.fired_count,
                    "no_data": st.no_data,
                    "summary": r.summary or r.name,
                }
                for r in self.rules
                for st in (self._states[r.name],)
            }
            history = list(self._history)
        return {
            "ts": time.time(),
            "firing": sorted(n for n, r in rules.items() if r["state"] == FIRING),
            "warning": sorted(n for n, r in rules.items() if r["state"] == WARNING),
            "rules": rules,
            "history": history,
        }

    def overall_state(self) -> str:
        with self._lock:
            level = max(
                (_STATE_LEVEL[st.state] for st in self._states.values()), default=0
            )
        return {v: k for k, v in _STATE_LEVEL.items()}[level]

    # --------------------------------------------------------------- control
    def start(self) -> "HealthEvaluator":
        if self._thread is not None:
            return self
        self._stop.clear()

        def run():
            while not self._stop.wait(self.interval_s):
                try:
                    self.evaluate_once()
                except Exception:
                    pass  # the watchdog must never kill the watched

        self._thread = threading.Thread(target=run, daemon=True, name="obs-health")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


# ------------------------------------------------------------ default rules
def default_rulebook(roles: Iterable[str] = ("learner", "actor", "coordinator",
                                             "trace", "serve", "replay",
                                             "distill", "arena"),
                     slo_e2e_s: float = 30.0,
                     queue_saturation: float = 384.0,
                     shed_rate_per_s: float = 5.0,
                     stall_window_s: float = 60.0,
                     slo_serve_latency_s: float = 5.0) -> List[HealthRule]:
    """The stock fleet rulebook, filtered by which roles this process hosts
    (or, on the coordinator, observes via shipped telemetry — pass all)."""
    roles = set(roles)
    book: List[HealthRule] = []
    if "learner" in roles:
        book.append(HealthRule(
            name="learner_loss_nonfinite",
            metric="distar_learner_loss", agg="last", op="nonfinite",
            window_s=stall_window_s, for_count=2,
            summary="training loss went NaN/Inf",
        ))
        book.append(HealthRule(
            name="learner_step_stall",
            metric="distar_learner_iterations_total", op="stalled",
            window_s=stall_window_s, for_count=3,
            summary="learner stopped completing optimisation steps",
        ))
        book.append(HealthRule(
            name="learner_mfu_collapse",
            # labelled family: one series per learner token, published by
            # the perf monitor (obs/perf.py); the gauge reads 0 until the
            # flop count lands, as the JAX package's does
            metric="distar_perf_mfu", agg="last", op="<", threshold=0.02,
            window_s=stall_window_s, for_count=3, severity="warning",
            summary="measured MFU collapsed below 2% of the chip's peak — "
                    "the step is input/host-bound or a kernel regressed "
                    "(capture a trace: opsctl profile)",
        ))
        book.append(HealthRule(
            name="learner_grad_nonfinite",
            # fed by the dynamics tree (obs/dynamics.py): the per-module
            # census totals localize the origin
            metric="distar_train_nonfinite_grads{module=total}",
            agg="last", op=">", threshold=0.0,
            window_s=stall_window_s, for_count=1,
            summary="non-finite gradient elements detected — the dynamics "
                    "census names the first bad module and the alert's "
                    "exemplar points at the black-box bundle "
                    "(opsctl dynamics; tools/stepreplay.py --bundle <id>)",
        ))
        book.append(HealthRule(
            name="learner_grad_explosion",
            # ratio gauge published by DynamicsMonitor: ||g|| / EMA(||g||)
            metric="distar_train_grad_norm_explosion", agg="last", op=">",
            threshold=10.0, window_s=stall_window_s, for_count=2,
            severity="warning",
            summary="gradient norm exploded past 10x its EMA — check "
                    "distar_train_grad_norm{module=...} for the culprit "
                    "module and distar_train_grad_clip_fraction for "
                    "whether the clip is saturating",
        ))
        book.append(HealthRule(
            name="learner_entropy_collapse",
            # per-head family; masked-out heads publish nothing (the
            # monitor skips exact-0.0 values), so no-data is not a breach
            metric="distar_train_entropy{head=action_type}", agg="last",
            op="<", threshold=1e-4, window_s=stall_window_s, for_count=3,
            severity="warning",
            summary="action_type policy entropy collapsed toward zero — "
                    "the policy went deterministic (premature convergence "
                    "or a broken entropy bonus); inspect "
                    "distar_train_entropy per head",
        ))
    if "distill" in roles:
        book.append(HealthRule(
            name="distill_divergence_runaway",
            # gauge drift, not level: a healthy student's KL falls toward a
            # floor; a KL RISING over the window means the student has
            # fallen behind a fast-moving teacher (stale student rollouts
            # serve increasingly off-policy actions) — warn while the
            # canary-compare gate still protects promotion
            metric="distar_distill_kl", op="trending_up", threshold=0.0,
            window_s=stall_window_s, for_count=3, severity="warning",
            summary="student-vs-teacher KL divergence is trending up over "
                    "the window — the student has fallen behind a "
                    "fast-moving teacher (check distill learner throughput "
                    "and the teacher's publish cadence)",
        ))
    if "actor" in roles:
        book.append(HealthRule(
            name="actor_env_starvation",
            metric="distar_env_steps_total", op="stalled",
            window_s=stall_window_s, for_count=3,
            summary="actors stopped stepping environments",
        ))
    if "coordinator" in roles:
        book.append(HealthRule(
            name="coordinator_queue_saturation",
            metric="distar_coordinator_queue_depth", agg="last", op=">=",
            threshold=queue_saturation, window_s=stall_window_s, for_count=3,
            severity="warning",
            summary="broker backlog near the per-token cap — consumers behind",
        ))
    if "trace" in roles:
        book.append(HealthRule(
            name="trace_e2e_slo",
            metric="distar_trace_e2e_seconds{span=trajectory}_p99",
            agg="last", op=">", threshold=slo_e2e_s,
            window_s=stall_window_s, for_count=3, severity="warning",
            summary="actor->learner e2e p99 breached the staleness SLO",
        ))
    if "serve" in roles:
        book.append(HealthRule(
            name="serve_shed_rate",
            metric="distar_serve_shed_total", agg="rate", op=">",
            threshold=shed_rate_per_s, window_s=30.0, for_count=3,
            severity="warning",
            summary="gateway shedding load faster than the tolerated rate",
        ))
        book.append(HealthRule(
            name="serve_latency_slo",
            metric="distar_serve_request_latency_seconds_p99",
            agg="last", op=">", threshold=slo_serve_latency_s,
            window_s=30.0, for_count=2, severity="warning",
            summary="gateway p99 request latency breached the serving SLO "
                    "(the alert carries an exemplar trace_id — retrieve the "
                    "waterfall: opsctl trace --id <id>)",
        ))
    if "replay" in roles:
        book.append(HealthRule(
            name="replay_table_saturation",
            metric="distar_replay_table_occupancy", agg="last", op=">=",
            threshold=0.95, window_s=stall_window_s, for_count=3,
            severity="warning",
            summary="replay table near max_size — eviction is eating "
                    "unsampled trajectories",
        ))
        book.append(HealthRule(
            name="replay_sample_stall",
            metric="distar_replay_samples_total", op="stalled",
            window_s=stall_window_s, for_count=3,
            summary="replay store stopped serving samples (learner gone or "
                    "rate limiter starved of inserts)",
        ))
    if "arena" in roles:
        book.append(HealthRule(
            name="arena_rating_regression",
            # the store publishes the NEGATED main-lineage ELO, so a rising
            # trend here means the newest generation is shedding rating
            metric="distar_arena_main_rating_inverted", op="trending_up",
            threshold=0.0, window_s=300.0, for_count=3, severity="warning",
            summary="main-lineage arena rating is trending DOWN — the newest "
                    "generation is losing skill vs the ladder (check "
                    "opsctl arena for the payoff matrix)",
        ))
        book.append(HealthRule(
            name="arena_match_stall",
            metric="distar_arena_matches_applied", op="stalled",
            window_s=stall_window_s, for_count=3, severity="warning",
            summary="arena stopped applying matches — evaluator dead or "
                    "wedged (matches gauge flat with evaluators registered)",
        ))
    return book


# ------------------------------------------------------------- fleet bundle
class FleetHealth:
    """The assembled subsystem: TSDB store + registry sampler + telemetry
    ingest + rules evaluator + flight recorder, one handle per process."""

    def __init__(self, rules: Optional[Sequence[HealthRule]] = None,
                 registry: Optional[MetricsRegistry] = None,
                 sample_interval_s: float = 1.0,
                 eval_interval_s: float = 2.0,
                 source: str = "local",
                 recorder: Optional[FlightRecorder] = None,
                 stale_after_s: float = 30.0,
                 store: Optional[TimeSeriesStore] = None):
        self.store = store or TimeSeriesStore()
        self.recorder = recorder or get_flight_recorder()
        self.stale_after_s = stale_after_s
        self.sampler = RegistrySampler(
            self.store, registry=registry, interval_s=sample_interval_s, source=source
        )
        # fleet trace store: shipped span records land here (bounded per
        # source, evicted with the source's TSDB series); GET /traces and
        # GET /trace/<id> answer from it
        from .tracestore import TraceIngest

        self.traces = TraceIngest(registry=registry)
        self.ingest = TelemetryIngest(self.store, registry=registry,
                                      traces=self.traces)
        self.evaluator = HealthEvaluator(
            self.store, rules if rules is not None else default_rulebook(),
            recorder=self.recorder, registry=registry, interval_s=eval_interval_s,
        )
        self._started = False

    def start(self) -> "FleetHealth":
        self.sampler.start()
        self.evaluator.start()
        self._started = True
        return self

    def stop(self) -> None:
        self.evaluator.stop()
        self.sampler.stop()
        self._started = False

    def healthz(self) -> dict:
        """The ``GET /healthz`` payload: overall state, per-rule summary,
        per-source staleness."""
        alerts = self.evaluator.alerts()
        sources = {}
        for name, info in self.store.sources().items():
            info = dict(info)
            info["stale"] = info["age_s"] > self.stale_after_s
            sources[name] = info
        return {
            "ts": time.time(),
            "status": self.evaluator.overall_state(),
            "started": self._started,
            "firing": alerts["firing"],
            "warning": alerts["warning"],
            "rules": {n: r["state"] for n, r in alerts["rules"].items()},
            "sources": sources,
            "tsdb": self.store.stats(),
        }


_fleet_lock = threading.Lock()
_fleet: Optional[FleetHealth] = None


def get_fleet_health() -> FleetHealth:
    """The process-wide fleet-health handle; lazily created (NOT started —
    the HTTP surfaces always have something to answer from, but evaluation
    threads only run where an entrypoint called ``init_fleet_health``)."""
    global _fleet
    with _fleet_lock:
        if _fleet is None:
            _fleet = FleetHealth()
        return _fleet


def init_fleet_health(rules: Optional[Sequence[HealthRule]] = None,
                      start: bool = True, **kwargs) -> FleetHealth:
    """Install (and by default start) a fresh process fleet-health bundle;
    stops any previous one's threads first."""
    global _fleet
    with _fleet_lock:
        if _fleet is not None:
            _fleet.stop()
        _fleet = FleetHealth(rules=rules, **kwargs)
        fleet = _fleet
    return fleet.start() if start else fleet


def set_fleet_health(fleet: Optional[FleetHealth]) -> Optional[FleetHealth]:
    """Swap the process handle (tests install a fresh one); returns the
    previous handle (caller owns stopping it)."""
    global _fleet
    with _fleet_lock:
        prev = _fleet
        _fleet = fleet
        return prev

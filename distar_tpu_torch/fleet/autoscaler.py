"""Coordinator-side autoscaler: TSDB signals -> fleet membership decisions.

Counterpart of ``distar_tpu.fleet.autoscaler``, over the port's
time-series store (``obs/timeseries.py``). The obs stack already ships every
member's registry into the coordinator's ``TimeSeriesStore`` (and the
collector below folds member /status probes into the same store for fleets
that don't ship), so elasticity is a pure read-evaluate-act loop over data
that already exists:

  read      windowed per-member aggregates out of the TSDB
            (``TimeSeriesStore.query`` — the health-rules primitive),
            reduced across the fleet's member sources;
  evaluate  declarative ``ScalePolicy`` rules with HYSTERESIS (a breach
            must hold ``for_count`` consecutive evaluations, exactly the
            ``HealthRule`` debounce) and a per-fleet COOLDOWN (scale
            actions are rate-limited so up/down can't flap);
  act       drive the pluggable ``FleetSupervisor``: scale-up spawns a
            member (it self-registers; live-membership clients see the
            join on their next refresh), scale-down gracefully drains the
            newest member (sessions/items migrate via the typed drain
            handoff paths).

Signals worth scaling on (``default_policies``): gateway session residency
vs fleet slot capacity and shed rate; replay insert-limiter block time
(actors starving against a full fleet) and table residency. Anything in
the TSDB is a valid signal — feeder/actor starvation rules compose the
same way.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..obs import get_registry
from ..obs.timeseries import TimeSeriesStore
from .supervisor import FleetSupervisor

#: canonical TSDB signal names the collector records per member source
SIG_GW_ACTIVE = "distar_serve_sessions_active"
SIG_GW_SLOTS = "distar_serve_session_slots"
SIG_GW_SHED = "distar_serve_shed_total"
SIG_GW_QUEUE = "distar_serve_queue_depth"
SIG_RP_ITEMS = "distar_replay_items"
SIG_RP_CAPACITY = "distar_replay_capacity"
SIG_RP_BLOCK_INSERT = "distar_replay_limiter_block_seconds_total"


@dataclass
class ScalePolicy:
    """One declarative scaling rule over the TSDB.

    ``value = reduce_over_members(agg_over_window(signal)) [/ same(divide_by)]``

    Scale UP when ``value > up_when`` for ``for_count`` consecutive
    evaluations; scale DOWN when ``value < down_when`` holds the same way.
    ``agg`` follows the TSDB query fields (``last``/``mean``/``rate``...);
    ``rate`` turns counters (shed totals, limiter block seconds) into
    per-second slopes. Cooldown lives per FLEET (shared by its policies) so
    one rule's scale-up can't be immediately undone by another's
    scale-down."""

    name: str
    fleet: str
    signal: str
    agg: str = "last"
    reduce: str = "sum"              # sum | mean | max across member sources
    divide_by: Optional[str] = None  # ratio signals (residency / capacity)
    up_when: Optional[float] = None
    down_when: Optional[float] = None
    window_s: float = 30.0
    for_count: int = 2
    step: int = 1

    def __post_init__(self):
        assert self.reduce in ("sum", "mean", "max"), self.reduce
        assert self.up_when is not None or self.down_when is not None, \
            f"policy {self.name!r} has neither up_when nor down_when"


@dataclass
class _PolicyState:
    up_streak: int = 0
    down_streak: int = 0
    last_value: Optional[float] = None


def default_policies(gateway_fleet: str = "gateway",
                     replay_fleet: str = "replay",
                     residency_up: float = 0.85, residency_down: float = 0.30,
                     shed_rate_up: float = 0.5,
                     block_rate_up: float = 0.2,
                     window_s: float = 30.0,
                     for_count: int = 2) -> List[ScalePolicy]:
    """The stock elastic rulebook: gateway residency and shed rate, replay
    insert blocking and residency."""
    return [
        ScalePolicy(name="gateway_residency", fleet=gateway_fleet,
                    signal=SIG_GW_ACTIVE, divide_by=SIG_GW_SLOTS,
                    up_when=residency_up, down_when=residency_down,
                    window_s=window_s, for_count=for_count),
        ScalePolicy(name="gateway_shed_rate", fleet=gateway_fleet,
                    signal=SIG_GW_SHED, agg="rate",
                    up_when=shed_rate_up,
                    window_s=window_s, for_count=for_count),
        ScalePolicy(name="replay_insert_block", fleet=replay_fleet,
                    signal=SIG_RP_BLOCK_INSERT, agg="rate",
                    up_when=block_rate_up,
                    window_s=window_s, for_count=for_count),
        ScalePolicy(name="replay_residency", fleet=replay_fleet,
                    signal=SIG_RP_ITEMS, divide_by=SIG_RP_CAPACITY,
                    up_when=residency_up, down_when=residency_down,
                    window_s=window_s, for_count=for_count),
    ]


class MemberProbe:
    """Folds fleet-member /status probes into the TSDB so every fleet feeds
    the same store whether or not its members run a TelemetryShipper.
    Sources are named ``<fleet>:<addr>``; a member that left the fleet has
    its series EVICTED (the satellite contract: membership churn must not
    exhaust the series cap)."""

    def __init__(self, store: TimeSeriesStore, supervisor: FleetSupervisor):
        self.store = store
        self.supervisor = supervisor
        self._known: Dict[str, set] = {}

    def _record_gateway(self, source: str, info: dict, ts: float) -> None:
        sess = info.get("sessions") or {}
        reqs = info.get("requests") or {}
        self.store.record(SIG_GW_ACTIVE, float(sess.get("active", 0)),
                          ts=ts, source=source)
        self.store.record(SIG_GW_SLOTS, float(sess.get("num_slots", 0)),
                          ts=ts, source=source)
        self.store.record(SIG_GW_SHED, float(reqs.get("shed", 0.0)),
                          ts=ts, source=source)
        self.store.record(SIG_GW_QUEUE, float(info.get("queue_depth", 0)),
                          ts=ts, source=source)

    def _record_replay(self, source: str, stats: dict, ts: float) -> None:
        size = cap = 0.0
        block = 0.0
        for t in (stats.get("tables") or {}).values():
            size += float(t.get("size", 0))
            cap += float(t.get("max_size", 0))
            lim = t.get("limiter") or {}
            block += float(lim.get("block_insert_s", 0.0))
        self.store.record(SIG_RP_ITEMS, size, ts=ts, source=source)
        self.store.record(SIG_RP_CAPACITY, cap, ts=ts, source=source)
        self.store.record(SIG_RP_BLOCK_INSERT, block, ts=ts, source=source)

    def collect_once(self) -> int:
        """One probe pass over every active member; returns sources fed.
        Departed members' series are evicted from the store."""
        import json as _json
        import urllib.request

        fed = 0
        now = time.time()
        for name in self.supervisor.fleets():
            fleet = self.supervisor.fleet(name)
            current = set()
            for m in fleet.active_members():
                if not m.http_addr:
                    continue
                source = f"{name}:{m.addr}"
                current.add(source)
                try:
                    if fleet.kind == "gateway":
                        req = urllib.request.Request(
                            f"http://{m.http_addr}/serve/status", data=b"{}",
                            headers={"Content-Type": "application/json"},
                            method="POST")
                        with urllib.request.urlopen(req, timeout=3.0) as resp:
                            body = _json.loads(resp.read())
                        info = body.get("info") if body.get("code") == 0 else None
                        if info:
                            self._record_gateway(source, info, now)
                            fed += 1
                    else:
                        with urllib.request.urlopen(
                                f"http://{m.http_addr}/replay/stats",
                                timeout=3.0) as resp:
                            stats = _json.loads(resp.read())
                        self._record_replay(source, stats, now)
                        fed += 1
                except Exception:  # noqa: BLE001 - a dead member is the watcher's job
                    get_registry().counter(
                        "distar_autoscaler_probe_failures_total",
                        "member status probes that failed", fleet=name,
                    ).inc()
            for gone in self._known.get(name, set()) - current:
                self.store.evict_source(gone)
            self._known[name] = current
        return fed

    def member_sources(self, fleet: str) -> List[str]:
        return sorted(self._known.get(fleet, set()))


class Autoscaler:
    """The evaluate-act loop over ScalePolicies + a FleetSupervisor.

    One decision per fleet per pass: any up-policy winning outranks every
    down-policy (scale-up is the safe direction under load); a down needs
    EVERY down-capable policy below its threshold — a fleet at low
    residency but high shed rate is mis-balanced, not oversized. Cooldown
    is per fleet and applies to BOTH directions."""

    def __init__(self, store: TimeSeriesStore, supervisor: FleetSupervisor,
                 policies: List[ScalePolicy],
                 limits: Optional[Dict[str, tuple]] = None,
                 cooldown_s: float = 30.0, interval_s: float = 2.0,
                 probe: Optional[MemberProbe] = None):
        self.store = store
        self.supervisor = supervisor
        self.policies = list(policies)
        #: per-fleet (min_members, max_members); default (1, 8)
        self.limits = dict(limits or {})
        self.cooldown_s = float(cooldown_s)
        self.interval_s = float(interval_s)
        self.probe = probe
        self._states: Dict[str, _PolicyState] = {
            p.name: _PolicyState() for p in self.policies}
        self._cooldown_until: Dict[str, float] = {}
        self._last_decision: Optional[dict] = None
        self._decisions: List[dict] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        reg = get_registry()
        self._c_decisions = {
            d: reg.counter(
                "distar_autoscaler_decisions_total",
                "scaling actions taken, by direction", direction=d)
            for d in ("up", "down")
        }

    # -------------------------------------------------------------- signals
    def _reduce(self, policy: ScalePolicy, signal: str,
                sources: List[str]) -> Optional[float]:
        values: List[float] = []
        for source in sources:
            for name in self.store.matching_names(signal, source=source):
                q = self.store.query(name, window_s=policy.window_s,
                                     source=source)
                if q is None:
                    continue
                v = q["rate"] if policy.agg == "rate" else q.get(policy.agg)
                if v is not None:
                    values.append(float(v))
        if not values:
            return None
        if policy.reduce == "sum":
            return sum(values)
        if policy.reduce == "mean":
            return sum(values) / len(values)
        return max(values)

    def policy_value(self, policy: ScalePolicy) -> Optional[float]:
        """The fleet-level value this policy compares against its
        thresholds; None with no data (no data is never a breach — the
        health-rules convention)."""
        if self.probe is not None:
            sources = self.probe.member_sources(policy.fleet)
        else:
            sources = [s for s in self.store.sources()
                       if s.startswith(f"{policy.fleet}:")]
        if not sources:
            return None
        value = self._reduce(policy, policy.signal, sources)
        if value is None:
            return None
        if policy.divide_by:
            denom = self._reduce(policy, policy.divide_by, sources)
            if not denom:
                return None
            value = value / denom
        return value

    # ------------------------------------------------------------- evaluate
    def evaluate_once(self, now: Optional[float] = None) -> List[dict]:
        """One collect->evaluate->act pass; returns the decisions taken."""
        now = time.monotonic() if now is None else now
        if self.probe is not None:
            try:
                self.probe.collect_once()
            except Exception:  # noqa: BLE001 - probing must not kill the loop
                pass
        votes_up: Dict[str, List[str]] = {}
        votes_down: Dict[str, List[str]] = {}
        down_blocked: Dict[str, bool] = {}
        with self._lock:
            for policy in self.policies:
                st = self._states[policy.name]
                value = self.policy_value(policy)
                st.last_value = value
                up = value is not None and policy.up_when is not None \
                    and value > policy.up_when
                down = value is not None and policy.down_when is not None \
                    and value < policy.down_when
                st.up_streak = st.up_streak + 1 if up else 0
                st.down_streak = st.down_streak + 1 if down else 0
                if st.up_streak >= policy.for_count:
                    votes_up.setdefault(policy.fleet, []).append(
                        f"{policy.name}={value:.4g}>{policy.up_when:g}")
                if policy.down_when is not None:
                    if st.down_streak >= policy.for_count:
                        votes_down.setdefault(policy.fleet, []).append(
                            f"{policy.name}={value:.4g}<{policy.down_when:g}")
                    else:
                        # a down-capable policy not yet convinced blocks the
                        # whole fleet's scale-down (conservative direction)
                        down_blocked[policy.fleet] = True
        decisions = []
        for fleet in self.supervisor.fleets():
            if now < self._cooldown_until.get(fleet, 0.0):
                continue
            lo, hi = self.limits.get(fleet, (1, 8))
            actual = self.supervisor.actual(fleet)
            step = max((p.step for p in self.policies if p.fleet == fleet),
                       default=1)
            if fleet in votes_up and actual < hi:
                added = self.supervisor.scale_up(fleet, min(step, hi - actual))
                decision = {"ts": time.time(), "fleet": fleet,
                            "direction": "up", "from": actual,
                            "to": actual + len(added), "members": added,
                            "reason": "; ".join(votes_up[fleet])}
            elif fleet in votes_down and not down_blocked.get(fleet) \
                    and actual > lo:
                drained = self.supervisor.scale_down(
                    fleet, min(step, actual - lo))
                if not drained:
                    continue
                decision = {"ts": time.time(), "fleet": fleet,
                            "direction": "down", "from": actual,
                            "to": actual - len(drained), "members": drained,
                            "reason": "; ".join(votes_down[fleet])}
            else:
                continue
            self._cooldown_until[fleet] = now + self.cooldown_s
            self._c_decisions[decision["direction"]].inc()
            get_registry().gauge(
                "distar_autoscaler_target_members",
                "membership the autoscaler last decided for each fleet",
                fleet=fleet,
            ).set(decision["to"])
            with self._lock:
                # reset streaks so one sustained breach = one action per
                # cooldown window, not one per evaluation
                for policy in self.policies:
                    if policy.fleet == fleet:
                        st = self._states[policy.name]
                        st.up_streak = st.down_streak = 0
                self._last_decision = decision
                self._decisions.append(decision)
                del self._decisions[:-64]
            decisions.append(decision)
        for fleet in self.supervisor.fleets():
            get_registry().gauge(
                "distar_autoscaler_members",
                "actual live membership per supervised fleet", fleet=fleet,
            ).set(self.supervisor.actual(fleet))
        return decisions

    # -------------------------------------------------------------- control
    def start(self) -> "Autoscaler":
        if self._thread is not None:
            return self

        def run():
            while not self._stop.wait(self.interval_s):
                try:
                    self.evaluate_once()
                except Exception:  # noqa: BLE001 - the loop must never die
                    continue

        self._thread = threading.Thread(target=run, name="autoscaler",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -------------------------------------------------------------- surface
    def status(self) -> dict:
        """The ``GET /autoscaler`` payload (opsctl's digest): per-policy
        state, per-fleet target vs actual + in-progress drains, the last
        decision and its reason."""
        now = time.monotonic()
        with self._lock:
            policies = {
                p.name: {
                    "fleet": p.fleet, "signal": p.signal, "agg": p.agg,
                    "value": self._states[p.name].last_value,
                    "up_when": p.up_when, "down_when": p.down_when,
                    "up_streak": self._states[p.name].up_streak,
                    "down_streak": self._states[p.name].down_streak,
                    "for_count": p.for_count,
                }
                for p in self.policies
            }
            last = dict(self._last_decision) if self._last_decision else None
            history = list(self._decisions[-8:])
        fleets = {}
        for name in self.supervisor.fleets():
            lo, hi = self.limits.get(name, (1, 8))
            cooldown = max(0.0, self._cooldown_until.get(name, 0.0) - now)
            fleets[name] = {
                "actual": self.supervisor.actual(name),
                "min": lo, "max": hi,
                "draining": self.supervisor.fleet(name).draining_addrs(),
                "cooldown_remaining_s": round(cooldown, 1),
                "gave_up": self.supervisor.fleet(name).gave_up,
            }
        return {"ts": time.time(), "fleets": fleets, "policies": policies,
                "last_decision": last, "decisions": history,
                "cooldown_s": self.cooldown_s}


# --------------------------------------------------------- process handle
_scaler_lock = threading.Lock()
_scaler: Optional[Autoscaler] = None


def get_autoscaler() -> Optional[Autoscaler]:
    """The process-wide autoscaler handle (the coordinator's /autoscaler
    route answers from it); None when no entrypoint installed one."""
    with _scaler_lock:
        return _scaler


def set_autoscaler(scaler: Optional[Autoscaler]) -> Optional[Autoscaler]:
    """Install (or clear) the process handle; returns the previous one."""
    global _scaler
    with _scaler_lock:
        prev, _scaler = _scaler, scaler
        return prev

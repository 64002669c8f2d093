"""The inference gateway: sessions + batcher + registry around one engine.

Counterpart of ``distar_tpu.serve.gateway.InferenceGateway``, with its
metrics (``distar_serve_*``), trace spans and teacher-logit piggyback.
Request path (caller thread): resolve or allocate the sticky session slot,
mint a trace context, enqueue into the micro-batcher, block on the
rendezvous with the caller's timeout. Flush path (batcher thread): apply
any pending version swap at the flush boundary (in-flight forwards finish
on the old params), pad the fixed-shape batch with the zero template on
inactive lanes, run ONE engine forward (and one teacher forward for the
lanes that asked), deliver per request.

Shutdown is drain-then-stop: admissions shed with ``DrainingError`` while
everything already admitted flushes and completes.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..obs import (
    Span,
    annotate,
    finish_trace,
    get_registry,
    join_trace,
    note_exemplar,
    tracing_enabled,
)
from .batcher import MicroBatcher, PendingRequest
from .errors import DrainingError, ServeError, ShedError
from .registry import ModelRegistry
from .sessions import SessionTable


def _zeros_like_tree(t):
    """Host zero template with the request's exact structure and dtypes
    (the gateway never touches the device outside the engine)."""
    if isinstance(t, dict):
        return {k: _zeros_like_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_zeros_like_tree(v) for v in t)
    return np.zeros_like(np.asarray(t))


def transports_status(counts: List[Callable[[], Dict[str, int]]]) -> dict:
    """``status()``'s ``transports`` entry: the TCP frontends' live
    connection counts by transport, summed; no entry without a frontend."""
    if not counts:
        return {}
    total = {"tcp": 0, "shm": 0}
    for fn in counts:
        for kind, n in fn().items():
            total[kind] = total.get(kind, 0) + n
    return {"transports": total}


class InferenceGateway:
    def __init__(
        self,
        engine,
        registry: Optional[ModelRegistry] = None,
        max_batch: Optional[int] = None,
        max_delay_s: float = 0.005,
        queue_capacity: int = 256,
        idle_ttl_s: float = 300.0,
        default_timeout_s: float = 10.0,
    ):
        """The gateway runs where ``engine`` runs; the engine's
        ``BatchedInference`` holds the rule that CUDA is the default and the
        CPU must be asked for."""
        self.engine = engine
        self.registry = registry if registry is not None else ModelRegistry(
            warmup_fn=self._warmup
        )
        self.sessions = SessionTable(
            engine.num_slots, idle_ttl_s=idle_ttl_s, on_alloc=engine.reset_slot
        )
        self.batcher = MicroBatcher(
            self._flush,
            max_batch=min(max_batch or engine.num_slots, engine.num_slots),
            max_delay_s=max_delay_s,
            capacity=queue_capacity,
        )
        self.default_timeout_s = default_timeout_s
        self._template = None
        self._template_lock = threading.Lock()
        self._applied_generation = 0
        self._served_version: Optional[str] = None
        self._draining = False
        #: ``serve.fleet.register_gateway(..., target=gateway)`` sets this to
        #: its idempotent leave-the-fleet callable; ``begin_drain`` calls it
        #: first, so a draining gateway leaves discovery before it sheds
        #: instead of a lease TTL later
        self.deregister = None
        #: per-transport connection counts of the TCP frontends in front of
        #: this gateway (``add_transport_counts``), summed by ``status()``
        self._transport_counts: List[Callable[[], Dict[str, int]]] = []
        self.flushes = 0  # engine forwards run (policy; teacher forwards apart)
        self.teacher_flushes = 0
        reg = get_registry()
        self._c_req = {
            outcome: reg.counter(
                "distar_serve_requests_total", "requests by outcome", outcome=outcome
            )
            for outcome in ("ok", "shed", "error", "timeout")
        }
        self._h_latency = reg.histogram(
            "distar_serve_request_latency_seconds", "submit-to-response latency"
        )
        self._g_inflight = reg.gauge(
            "distar_serve_inflight", "requests admitted and not yet completed"
        )

    def _warmup(self, params) -> None:
        """Default registry warm-up: one scratch forward, needs a template
        observation — skipped before the first request taught us the shape
        (cold start compiles on the first real flush instead)."""
        template = self._template
        if template is not None and hasattr(self.engine, "warmup"):
            self.engine.warmup(template, params=params)

    def set_template(self, obs) -> None:
        """Teach the gateway the observation structure before its first
        request: the zero copy of ``obs`` pads inactive lanes and is what
        the registry's warm-up runs on (otherwise the first request sets it
        and a version loaded before then is not warmed up)."""
        with self._template_lock:
            self._template = _zeros_like_tree(obs)

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "InferenceGateway":
        self.batcher.start()
        return self

    def begin_drain(self) -> dict:
        """Enter graceful retirement, in this order:

          1. call the ``deregister`` hook (leave discovery now, so routers
             stop pinning new sessions here);
          2. shed every NEW request with the typed ``DrainingError`` while
             requests already admitted flush and complete on the live
             batcher (the batcher thread keeps running).

        A ``FleetClient`` seeing ``DrainingError`` re-pins the session to a
        survivor and ends it here, so ``resident_sessions()`` drains to
        zero. Idempotent."""
        if self.deregister is not None:
            self.deregister()
        if not self._draining:
            self._draining = True
            get_registry().counter(
                "distar_serve_drains_total",
                "graceful drains started on this gateway",
            ).inc()
        return {"draining": True, "resident": self.resident_sessions()}

    def resident_sessions(self) -> int:
        """Sessions still holding a slot — the number a drain waits on."""
        return self.sessions.stats()["active"]

    @property
    def draining(self) -> bool:
        return self._draining

    def drain_and_stop(self, timeout: Optional[float] = 30.0) -> None:
        """Stop admissions (deregistering first), serve out the queue, stop
        the batcher thread."""
        self.begin_drain()
        self.batcher.drain_and_stop(timeout)

    # ----------------------------------------------------------- client API
    def act(self, session_id: str, obs: Dict[str, Any], timeout_s: Optional[float] = None,
            want_teacher: bool = False, trace=None):
        """One agent step: returns the engine's per-slot output dict plus
        ``model_version``. Raises a typed ``ServeError`` (``ShedError``
        subclasses are retryable load sheds). ``trace`` is the caller's
        compact wire trace-context field — the gateway's span joins it."""
        req = {"session_id": session_id, "obs": obs, "want_teacher": want_teacher}
        if trace is not None:
            req["trace"] = trace
        out = self.act_many([req], timeout_s=timeout_s)[0]
        if isinstance(out, ServeError):
            raise out
        return out

    def act_many(self, requests, timeout_s: Optional[float] = None):
        """Submit one cycle of requests — ``[{"session_id", "obs",
        "want_teacher"?}, ...]`` — and wait for all of them. Returns a
        per-request list whose entries are either the output dict or a
        typed ``ServeError`` INSTANCE (never raised: partial success must
        not lose the lanes that did complete — the rollout plane retries
        shed lanes individually). This is the actor-grade surface: a whole
        env cycle lands in the micro-batcher in one call, with no
        per-slot caller threads, and coalesces with every other caller's
        cycle into the same fixed-shape flush."""
        timeout_s = self.default_timeout_s if timeout_s is None else timeout_s
        t0 = time.perf_counter()
        if self._draining:
            # graceful retirement: NEW work sheds typed at the door (before
            # any session slot is touched) while already-admitted requests
            # finish on the live batcher
            self._c_req["shed"].inc(len(requests))
            err = DrainingError("gateway is draining; sessions are migrating")
            return [err for _ in requests]
        results: List[Any] = [None] * len(requests)
        admitted: List[tuple] = []
        for i, r in enumerate(requests):
            session_id = r["session_id"]
            # server-side span: JOINS the caller's trace when the request
            # carries the compact wire field (client-minted span becomes the
            # parent — one trace_id across client/router/gateway), minted
            # fresh for untraced legacy callers
            ctx = None
            if tracing_enabled():
                ctx = join_trace(r.get("trace"), "serve_request",
                                 session=session_id)
            try:
                slot = self.sessions.acquire(session_id)
            except ShedError as e:  # CapacityError: no slot, nothing to evict
                self._c_req["shed"].inc()
                finish_trace(ctx, "shed", outcome="shed")
                results[i] = e
                continue
            with self._template_lock:
                if self._template is None:
                    self._template = _zeros_like_tree(r["obs"])
            req = PendingRequest(
                session_id, slot, r["obs"],
                deadline_ts=time.time() + timeout_s, ctx=ctx,
                want_teacher=bool(r.get("want_teacher", False)),
            )
            admitted.append((i, session_id, req))
        # the whole cycle enters the queue at once (QueueFull/Draining shed
        # here), so a slow admission above never splits it across flushes
        pending: List[tuple] = []
        sheds = self.batcher.submit_many([req for _, _, req in admitted])
        for (i, session_id, req), e in zip(admitted, sheds):
            if e is not None:
                self._c_req["shed"].inc()
                self.sessions.release(session_id)
                finish_trace(req.ctx, "shed", outcome="shed")
                results[i] = e
                continue
            self._g_inflight.inc()
            pending.append((i, session_id, req))
        wall_deadline = time.monotonic() + timeout_s + 0.25
        for i, session_id, req in pending:
            try:
                if not req.wait(max(0.0, wall_deadline - time.monotonic())):
                    # rendezvous never fired (flush wedged past the grace):
                    # abandon so a late delivery is discarded
                    if req.abandon():
                        self._c_req["timeout"].inc()
                        finish_trace(req.ctx, "timeout", outcome="error")
                        results[i] = ServeError(f"no response within {timeout_s}s")
                        continue
                if req.error is not None:
                    shed = req.error.shed
                    self._c_req["shed" if shed else "error"].inc()
                    finish_trace(req.ctx, "shed" if shed else "error",
                                 outcome="shed" if shed else "error")
                    results[i] = req.error
                    continue
                self._c_req["ok"].inc()
                latency = time.perf_counter() - t0
                self._h_latency.observe(latency)
                if req.ctx is not None:
                    # close the server span HERE (the waiter's thread) with
                    # the flush's queue/service attribution — the flush
                    # thread only stamped the cheap facts
                    annotate(req.ctx, "queue_s", req.queue_s)
                    annotate(req.ctx, "service_s", req.service_s)
                    finish_trace(req.ctx, "serve_done")
                    if req.ctx.get("_kept"):
                        # exemplar: the latency series names its last
                        # RETAINED witness (a dropped trace_id would 404 on
                        # retrieval) — a firing p99 SLO alert then names a
                        # retrievable trace
                        note_exemplar("distar_serve_request_latency_seconds",
                                      req.ctx.get("trace_id"), latency)
                results[i] = req.result
            finally:
                self._g_inflight.dec()
                self.sessions.release(session_id)
        return results

    def reserve_sessions(self, session_ids) -> Dict[str, int]:
        """Exact-capacity bulk admission: allocate (or confirm) a slot for
        every id atomically, shedding the WHOLE reservation typed
        (``CapacityError``) when the table can't host it — actors fail fast
        at job start instead of shedding mid-episode."""
        if self._draining:
            raise DrainingError("gateway is draining; no new reservations")
        return self.sessions.reserve(list(session_ids))

    def session_hidden(self, session_id: str):
        """The session's current policy carry (actors stamp it into
        trajectories as the learner's burn-in state). ``None`` when the
        session is unknown or the engine keeps no readable carry."""
        slot = self.sessions.slot_of(session_id)
        if slot is None or not hasattr(self.engine, "hidden_for_slot"):
            return None
        return self.engine.hidden_for_slot(slot)

    def set_teacher(self, params) -> bool:
        """Install frozen-teacher weights on the engine (the rollout
        plane's teacher-logits path batches through the same flushes)."""
        if not hasattr(self.engine, "set_teacher_params"):
            raise ServeError("engine has no teacher surface")
        self.engine.set_teacher_params(params)
        return True

    def reset_session(self, session_id: str) -> bool:
        """Episode boundary: zero the session's LSTM carry (policy AND
        teacher), restart its step counter, keep the slot."""
        slot = self.sessions.slot_of(session_id)
        if slot is None:
            return False
        self.engine.reset_slot(slot)
        self.sessions.reset_steps(session_id)
        return True

    def end_session(self, session_id: str) -> bool:
        return self.sessions.end(session_id)

    # ---------------------------------------------------------------- admin
    def load_version(self, version: str, source: Optional[str] = None, params=None,
                     activate: bool = False) -> dict:
        return self.registry.load(version, source=source, params=params, activate=activate)

    def activate_version(self, version: str) -> int:
        return self.registry.activate(version)

    def add_transport_counts(self, counts: Callable[[], Dict[str, int]]) -> None:
        """A TCP frontend mounted on this gateway hands in its live
        connection count by transport (shm, tcp); ``status()["transports"]``
        sums the counts of every frontend."""
        self._transport_counts.append(counts)

    def status(self) -> dict:
        requests = {name: c.value for name, c in self._c_req.items()}
        total = sum(requests.values())
        return {
            **transports_status(self._transport_counts),
            "draining": self._draining,
            "queue_depth": self.batcher.depth,
            "served_version": self._served_version,
            # the generation actually serving (applied at a flush boundary),
            # which trails registry.generation during an in-progress swap
            "generation": self._applied_generation,
            "sessions": self.sessions.stats(),
            "registry": self.registry.status(),
            # cumulative outcome counters + latency tails: what the fleet
            # rollout's canary-vs-stable compare reads per gateway
            "requests": requests,
            "shed_rate": round(requests.get("shed", 0.0) / total, 6) if total else 0.0,
            "latency_s": {"p50": self._h_latency.quantile(0.5),
                          "p99": self._h_latency.quantile(0.99)},
        }

    # ---------------------------------------------------------------- flush
    def _flush(self, batch: List[PendingRequest], reason: str) -> None:
        generation, version, params = self.registry.current()
        if params is not None and generation != self._applied_generation:
            # the swap boundary: the previous flush (and anything still
            # executing) used the old params reference; from here on the
            # engine serves the new generation
            self.engine.set_params(params)
            self._applied_generation = generation
            self._served_version = version
            self.registry.swap_applied(generation)
        template = self._template
        prepared: List[dict] = [template] * self.engine.num_slots
        active = [False] * self.engine.num_slots
        flush_ts = time.time()
        for r in batch:
            prepared[r.slot] = r.obs
            active[r.slot] = True
            if r.ctx is not None:
                # bare hop append, NO histogram: the flush thread is the
                # gateway's serial bottleneck, so per-request trace work
                # here costs throughput one-for-one — everything heavier
                # (service annotation, finish, exemplar) runs on the
                # waiter's thread, which overlaps the next forward
                r.ctx["hops"].append({"hop": "serve_flush", "ts": flush_ts})
        with Span("serve_forward") as fwd:
            outs = self.engine.forward(prepared, active)
        self.flushes += 1
        for r in batch:
            # service-time attribution: the whole batched forward serves
            # every lane of the flush (fixed-shape batching — a lane cannot
            # pay less than the flush it rode); annotated at completion
            r.service_s = fwd.elapsed
        # teacher logits piggyback on the same flush (one extra batched
        # forward serving every lane that asked, not one per caller); lanes
        # that didn't ask must not advance their teacher carry
        t_outs = None
        wanting = [r for r in batch if r.want_teacher]
        if wanting and getattr(self.engine, "has_teacher", False):
            t_active = [False] * self.engine.num_slots
            for r in wanting:
                t_active[r.slot] = True
            with Span("serve_teacher_forward"):
                t_outs = self.engine.teacher_forward(prepared, outs, t_active)
            self.teacher_flushes += 1
        for r in batch:
            out = dict(outs[r.slot])
            out["model_version"] = self._served_version
            if t_outs is not None and r.want_teacher:
                out["teacher_logit"] = t_outs[r.slot]
            # episode-local forward count: clients detect a server-side
            # carry reset (gateway restart, eviction) when it runs backwards
            out["session_step"] = self.sessions.note_step(r.session_id)
            if not r.complete(result=out):
                # waiter already abandoned (its timeout fired): nobody will
                # finish this span downstream — close it here so the trace
                # is retained with the truth
                finish_trace(r.ctx, "abandoned", outcome="error")

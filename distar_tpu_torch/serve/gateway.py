"""The inference gateway: sessions + batcher + registry around one engine.

Counterpart of ``distar_tpu.serve.gateway.InferenceGateway`` (its metrics,
trace spans and teacher-logit piggyback are left out). Request path (caller
thread): resolve or allocate the sticky session slot, enqueue into the
micro-batcher, block on the rendezvous with the caller's timeout. Flush path
(batcher thread): apply any pending version swap at the flush boundary, pad
the fixed-shape batch with the zero template on inactive lanes, run ONE
engine forward, deliver per request.

Shutdown is drain-then-stop: admissions shed with ``DrainingError`` while
everything already admitted flushes and completes.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from .batcher import MicroBatcher, PendingRequest
from .errors import DrainingError, ServeError, ShedError
from .registry import ModelRegistry
from .sessions import SessionTable


def _zeros_like_tree(t):
    """Host zero template with the request's exact structure and dtypes."""
    if isinstance(t, dict):
        return {k: _zeros_like_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_zeros_like_tree(v) for v in t)
    return np.zeros_like(np.asarray(t))


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
        self.registry = registry if registry is not None else ModelRegistry(warmup_fn=self._warmup)
        self.sessions = SessionTable(engine.num_slots, idle_ttl_s=idle_ttl_s,
                                     on_alloc=engine.reset_slot)
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
        #: set by whoever registered this gateway for discovery: a callable
        #: that leaves discovery; drain invokes it first
        self.deregister = None
        self._deregistered = False
        self._drain_lock = threading.Lock()
        self.flushes = 0  # engine forwards run

    def _warmup(self, params) -> None:
        """Default registry warm-up: one scratch forward once a request has
        taught the gateway the observation template."""
        template = self._template
        if template is not None and hasattr(self.engine, "warmup"):
            self.engine.warmup(template, params=params)

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "InferenceGateway":
        self.batcher.start()
        return self

    def _deregister_once(self) -> None:
        with self._drain_lock:
            if self._deregistered:
                return
            self._deregistered = True
            fn = self.deregister
        if fn is not None:
            try:
                fn()
            except Exception:  # noqa: BLE001 - best effort
                pass

    def begin_drain(self) -> dict:
        """Leave discovery, then shed every NEW request with
        ``DrainingError`` while admitted requests flush. Idempotent."""
        self._deregister_once()
        self._draining = True
        return {"draining": True, "resident": self.resident_sessions()}

    def resident_sessions(self) -> int:
        return self.sessions.stats()["active"]

    @property
    def draining(self) -> bool:
        return self._draining

    def drain_and_stop(self, timeout: Optional[float] = 30.0) -> None:
        """Stop admissions, serve out the queue, stop the batcher thread."""
        self.begin_drain()
        self.batcher.drain_and_stop(timeout)

    # ----------------------------------------------------------- client API
    def act(self, session_id: str, obs: Dict[str, Any], timeout_s: Optional[float] = None):
        """One agent step: the engine's per-slot output dict plus
        ``model_version`` and ``session_step``. Raises a typed
        ``ServeError``."""
        out = self.act_many([{"session_id": session_id, "obs": obs}], timeout_s=timeout_s)[0]
        if isinstance(out, ServeError):
            raise out
        return out

    def act_many(self, requests, timeout_s: Optional[float] = None):
        """Submit one cycle of requests — ``[{"session_id", "obs"}, ...]`` —
        and wait for all of them. Returns a per-request list of output dicts
        or typed ``ServeError`` instances (never raised, so lanes that did
        complete are not lost)."""
        timeout_s = self.default_timeout_s if timeout_s is None else timeout_s
        if self._draining:
            err = DrainingError("gateway is draining; sessions are migrating")
            return [err for _ in requests]
        results: List[Any] = [None] * len(requests)
        pending: List[tuple] = []
        for i, r in enumerate(requests):
            session_id = r["session_id"]
            try:
                slot = self.sessions.acquire(session_id)
            except ShedError as e:  # no slot, nothing to evict
                results[i] = e
                continue
            with self._template_lock:
                if self._template is None:
                    self._template = _zeros_like_tree(r["obs"])
            req = PendingRequest(session_id, slot, r["obs"], deadline_ts=time.time() + timeout_s)
            try:
                self.batcher.submit(req)
            except ShedError as e:
                self.sessions.release(session_id)
                results[i] = e
                continue
            pending.append((i, session_id, req))
        wall_deadline = time.monotonic() + timeout_s + 0.25
        for i, session_id, req in pending:
            try:
                if not req.wait(max(0.0, wall_deadline - time.monotonic())) and req.abandon():
                    results[i] = ServeError(f"no response within {timeout_s}s")
                    continue
                results[i] = req.error if req.error is not None else req.result
            finally:
                self.sessions.release(session_id)
        return results

    def reserve_sessions(self, session_ids) -> Dict[str, int]:
        """All-or-nothing bulk admission (``CapacityError`` when the table
        cannot host every id)."""
        if self._draining:
            raise DrainingError("gateway is draining; no new reservations")
        return self.sessions.reserve(list(session_ids))

    def session_hidden(self, session_id: str):
        """The session's current policy carry, or None when unknown."""
        slot = self.sessions.slot_of(session_id)
        if slot is None or not hasattr(self.engine, "hidden_for_slot"):
            return None
        return self.engine.hidden_for_slot(slot)

    def reset_session(self, session_id: str) -> bool:
        """Episode boundary: zero the session's LSTM carry, restart its step
        counter, keep the slot."""
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

    def status(self) -> dict:
        return {
            "draining": self._draining,
            "queue_depth": self.batcher.depth,
            "served_version": self._served_version,
            "generation": self._applied_generation,
            "sessions": self.sessions.stats(),
            "registry": self.registry.status(),
        }

    # ---------------------------------------------------------------- flush
    def _flush(self, batch: List[PendingRequest], reason: str) -> None:
        generation, version, params = self.registry.current()
        if params is not None and generation != self._applied_generation:
            # the swap boundary: earlier flushes ran the old params
            self.engine.set_params(params)
            self._applied_generation = generation
            self._served_version = version
        prepared: List[dict] = [self._template] * self.engine.num_slots
        active = [False] * self.engine.num_slots
        for r in batch:
            prepared[r.slot] = r.obs
            active[r.slot] = True
        outs = self.engine.forward(prepared, active)
        self.flushes += 1
        for r in batch:
            out = dict(outs[r.slot])
            out["model_version"] = self._served_version
            out["session_step"] = self.sessions.note_step(r.session_id)
            r.complete(result=out)

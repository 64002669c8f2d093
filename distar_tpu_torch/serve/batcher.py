"""Request queue + deadline-aware micro-batcher.

Counterpart of ``distar_tpu.serve.batcher``. Concurrent
``act`` calls land in one bounded queue; a single batcher thread coalesces
them into fixed-shape flushes. A flush fires when

  * **full**     — the queue holds requests for ``max_batch`` distinct slots
                   (one request per slot per flush: a session's steps are
                   sequential because its LSTM carry advances per forward);
  * **deadline** — the oldest admitted request has waited ``max_delay_s``;
  * **drain**    — shutdown flushes whatever is queued, then stops.

Admission control is synchronous in ``submit``: a full queue sheds with
``QueueFullError``, and requests whose own deadline lapsed while queued are
shed with ``DeadlineExceededError`` before reaching the engine.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from ..obs import get_registry
from .errors import DeadlineExceededError, DrainingError, QueueFullError, ServeError


class PendingRequest:
    """One queued ``act`` request: observation + slot + timing + the rendezvous
    the submitting thread blocks on. Completion is once-only (``complete``
    returns False if the request was already completed or abandoned)."""

    __slots__ = (
        "session_id", "slot", "obs", "enqueue_ts", "deadline_ts", "ctx",
        "want_teacher", "result", "error", "service_s", "queue_s", "_event",
        "_state", "_lock",
    )

    def __init__(self, session_id: str, slot: int, obs, deadline_ts: Optional[float],
                 ctx: Optional[dict] = None, want_teacher: bool = False):
        self.session_id = session_id
        self.slot = slot
        self.obs = obs
        self.enqueue_ts = time.time()
        self.deadline_ts = deadline_ts
        self.ctx = ctx  # obs.trace context riding the request
        self.want_teacher = want_teacher  # piggyback teacher logits on the flush
        self.service_s = 0.0  # the flush's engine-forward share (trace attribution)
        self.queue_s = 0.0  # admission-to-flush residency (trace attribution)
        self.result = None
        self.error: Optional[ServeError] = None
        self._event = threading.Event()
        self._state = "pending"
        self._lock = threading.Lock()

    def complete(self, result=None, error: Optional[ServeError] = None) -> bool:
        with self._lock:
            if self._state != "pending":
                return False
            self._state = "done"
        self.result = result
        self.error = error
        self._event.set()
        return True

    def abandon(self) -> bool:
        """The submitter stopped waiting (its timeout fired). The batcher may
        still run the forward for this slot — the hidden state advances — but
        the output is discarded."""
        with self._lock:
            if self._state != "pending":
                return False
            self._state = "abandoned"
            return True

    def wait(self, timeout: Optional[float]) -> bool:
        return self._event.wait(timeout)

    @property
    def done(self) -> bool:
        return self._state == "done"


class MicroBatcher:
    def __init__(
        self,
        flush_fn: Callable[[List[PendingRequest], str], None],
        max_batch: int,
        max_delay_s: float = 0.005,
        capacity: int = 256,
    ):
        assert max_batch > 0 and capacity > 0
        self._flush_fn = flush_fn
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self.capacity = capacity
        self._queue: List[PendingRequest] = []
        self._cond = threading.Condition()
        self._draining = False
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        reg = get_registry()
        self._g_depth = reg.gauge(
            "distar_serve_queue_depth", "admitted requests waiting for a flush"
        )
        self._h_occupancy = reg.histogram(
            "distar_serve_batch_occupancy", "requests per flushed batch"
        )
        self._h_wait = reg.histogram(
            "distar_serve_queue_wait_seconds", "admission-to-flush queue wait"
        )
        self._c_flush = {
            reason: reg.counter(
                "distar_serve_flush_total", "batch flushes by trigger", reason=reason
            )
            for reason in ("full", "deadline", "drain")
        }
        self._c_shed = {
            code: reg.counter(
                "distar_serve_shed_total", "requests shed by admission/deadline control",
                reason=code,
            )
            for code in ("shed_queue_full", "shed_deadline", "draining", "shed_capacity")
        }

    # ------------------------------------------------------------- admission
    def submit(self, req: PendingRequest) -> None:
        """Admit a request or shed it (typed, never blocking)."""
        err = self.submit_many([req])[0]
        if err is not None:
            raise err

    def submit_many(self, reqs: List[PendingRequest]) -> List[Optional[ServeError]]:
        """Admit a cycle of requests under one hold of the lock, so no
        flush can take part of it: the lanes of one ``act_many`` share a
        flush (and its noise draw) however slowly the caller built them.
        Returns, per request, None (admitted) or the typed shed."""
        out: List[Optional[ServeError]] = []
        with self._cond:
            for req in reqs:
                if self._draining or self._stopped:
                    self._c_shed["draining"].inc()
                    out.append(DrainingError("gateway is draining; not accepting requests"))
                elif len(self._queue) >= self.capacity:
                    self._c_shed["shed_queue_full"].inc()
                    out.append(QueueFullError(
                        f"request queue at capacity ({self.capacity}); retry with backoff"))
                else:
                    self._queue.append(req)
                    out.append(None)
            self._g_depth.set(len(self._queue))
            self._cond.notify()
        return out

    def shed_count(self, reason: str) -> float:
        """Convenience for admission-control callers (gateway status)."""
        return self._c_shed[reason].value if reason in self._c_shed else 0.0

    # ----------------------------------------------------------------- loop
    def start(self) -> None:
        assert self._thread is None, "batcher already started"
        self._thread = threading.Thread(target=self._run, name="serve-batcher", daemon=True)
        self._thread.start()

    def drain_and_stop(self, timeout: Optional[float] = 30.0) -> None:
        """Stop admissions, flush everything already admitted, stop the
        thread. Idempotent."""
        with self._cond:
            self._draining = True
            self._cond.notify()
        t = self._thread
        if t is not None:
            t.join(timeout)
            self._thread = None

    def _run(self) -> None:
        while True:
            batch, reason = self._next_batch()
            if batch is None:
                break
            if not batch:
                continue
            now = time.time()
            for r in batch:
                wait = max(0.0, now - r.enqueue_ts)
                self._h_wait.observe(wait)
                # queue-wait attribution: stashed for the waiter's thread to
                # annotate at completion (the waterfall separates "sat in
                # the micro-batcher" from "ran the engine"; this loop is the
                # serial flush path, so it only stamps the number)
                r.queue_s = wait
            self._h_occupancy.observe(len(batch))
            self._c_flush[reason].inc()
            try:
                self._flush_fn(batch, reason)
            except Exception as e:  # flush must never kill the loop
                err = ServeError(f"flush failed: {e!r}")
                for r in batch:
                    r.complete(error=err)

    def _next_batch(self):
        """Block until a flush should happen; returns (requests, reason) or
        (None, ...) when drained-and-empty. Runs entirely under the lock
        except the final timed waits."""
        with self._cond:
            while True:
                now = time.time()
                self._shed_expired_locked(now)
                if self._queue:
                    slots = set()
                    for r in self._queue:
                        slots.add(r.slot)
                        if len(slots) >= self.max_batch:
                            return self._take_locked(), "full"
                    if self._draining:
                        return self._take_locked(), "drain"
                    flush_at = self._queue[0].enqueue_ts + self.max_delay_s
                    if now >= flush_at:
                        return self._take_locked(), "deadline"
                    self._cond.wait(min(flush_at - now, 0.05))
                    continue
                if self._draining or self._stopped:
                    self._stopped = True
                    return None, "stopped"
                self._cond.wait(0.05)

    def _take_locked(self) -> List[PendingRequest]:
        """Pop up to ``max_batch`` requests with distinct slots, preserving
        arrival order; a second request for a slot already in the batch
        stays queued for the next flush (its session's carry must see the
        first step's update before the second runs)."""
        taken, rest, slots = [], [], set()
        for r in self._queue:
            if len(taken) < self.max_batch and r.slot not in slots:
                taken.append(r)
                slots.add(r.slot)
            else:
                rest.append(r)
        self._queue = rest
        self._g_depth.set(len(self._queue))
        return taken

    def _shed_expired_locked(self, now: float) -> None:
        alive = []
        for r in self._queue:
            if r.deadline_ts is not None and now >= r.deadline_ts:
                self._c_shed["shed_deadline"].inc()
                r.complete(
                    error=DeadlineExceededError(
                        f"deadline passed after {now - r.enqueue_ts:.3f}s in queue"
                    )
                )
            else:
                alive.append(r)
        if len(alive) != len(self._queue):
            self._queue = alive
            self._g_depth.set(len(self._queue))

    @property
    def depth(self) -> int:
        with self._cond:
            return len(self._queue)

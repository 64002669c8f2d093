"""Request queue + deadline-aware micro-batcher.

Counterpart of ``distar_tpu.serve.batcher`` (metrics left out). Concurrent
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

from .errors import DeadlineExceededError, DrainingError, QueueFullError, ServeError


class PendingRequest:
    """One queued ``act`` request: observation + slot + the rendezvous the
    submitting thread blocks on. Completion is once-only (``complete``
    returns False if the request was already completed or abandoned)."""

    __slots__ = ("session_id", "slot", "obs", "enqueue_ts", "deadline_ts", "result", "error",
                 "_event", "_state", "_lock")

    def __init__(self, session_id: str, slot: int, obs, deadline_ts: Optional[float]):
        self.session_id = session_id
        self.slot = slot
        self.obs = obs
        self.enqueue_ts = time.time()
        self.deadline_ts = deadline_ts
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
        """The submitter stopped waiting; a later delivery is discarded (the
        forward may still run and advance the slot's hidden state)."""
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
    def __init__(self, flush_fn: Callable[[List[PendingRequest], str], None], max_batch: int,
                 max_delay_s: float = 0.005, capacity: int = 256):
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

    def submit(self, req: PendingRequest) -> None:
        """Admit a request or shed it (typed, never blocking)."""
        with self._cond:
            if self._draining or self._stopped:
                raise DrainingError("gateway is draining; not accepting requests")
            if len(self._queue) >= self.capacity:
                raise QueueFullError(
                    f"request queue at capacity ({self.capacity}); retry with backoff")
            self._queue.append(req)
            self._cond.notify()

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
            try:
                self._flush_fn(batch, reason)
            except Exception as e:  # a flush must never kill the loop
                err = ServeError(f"flush failed: {e!r}")
                for r in batch:
                    r.complete(error=err)

    def _next_batch(self):
        """Block until a flush should happen; returns (requests, reason) or
        (None, ...) when drained and empty."""
        with self._cond:
            while True:
                now = time.time()
                self._shed_expired_locked(now)
                if self._queue:
                    if len({r.slot for r in self._queue}) >= self.max_batch:
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
        """Pop up to ``max_batch`` requests with distinct slots, in arrival
        order; a second request for a slot already in the batch waits for
        the next flush (its carry must see the first step's update)."""
        taken, rest, slots = [], [], set()
        for r in self._queue:
            if len(taken) < self.max_batch and r.slot not in slots:
                taken.append(r)
                slots.add(r.slot)
            else:
                rest.append(r)
        self._queue = rest
        return taken

    def _shed_expired_locked(self, now: float) -> None:
        alive = []
        for r in self._queue:
            if r.deadline_ts is not None and now >= r.deadline_ts:
                r.complete(error=DeadlineExceededError(
                    f"deadline passed after {now - r.enqueue_ts:.3f}s in queue"))
            else:
                alive.append(r)
        self._queue = alive

    @property
    def depth(self) -> int:
        with self._cond:
            return len(self._queue)

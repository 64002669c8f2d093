"""Typed retry primitive: jittered exponential backoff, deadline budgets,
an error taxonomy, and circuit-breaker state.

Counterpart of ``distar_tpu.resilience.policy``:

* ``RetryableError`` / ``FatalError`` taxonomy — transport faults retry,
  logic faults surface immediately. ``CommError`` subclasses both
  ``RetryableError`` and ``ConnectionError``.
* ``RetryPolicy`` — max attempts, jittered exponential backoff, and a
  per-call ``deadline_s`` budget shared across attempts.
* ``CircuitBreaker`` — after ``failure_threshold`` consecutive failures the
  circuit opens and calls fail fast with ``CircuitOpenError``; after
  ``reset_after_s`` one probe is let through (half-open).
* Every retry, giveup and breaker transition counts in the
  ``distar_resilience_*`` metrics of the port's ``obs`` registry and is
  recorded as a flight-recorder event (``retry``, ``retry_giveup``,
  ``breaker_open``).
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type


class RetryableError(Exception):
    """A transient fault: the operation may succeed if repeated."""


class FatalError(Exception):
    """A permanent fault: retrying cannot help (bad request, logic bug)."""


class CommError(RetryableError, ConnectionError):
    """Typed transport failure (connect refused, timeout, truncated reply).

    Wraps ``URLError``/``socket.timeout``/JSON-decode faults so call sites
    never see raw transport exceptions; ``op`` names the failing call."""

    def __init__(self, message: str, op: str = "", cause: Optional[BaseException] = None):
        super().__init__(message)
        self.op = op
        self.cause = cause


class CircuitOpenError(RetryableError):
    """Fail-fast rejection while a circuit breaker is open."""

    def __init__(self, op: str, retry_after_s: float = 0.0):
        super().__init__(f"circuit open for {op!r} (retry in ~{retry_after_s:.1f}s)")
        self.op = op
        self.retry_after_s = retry_after_s


def _metrics():
    from ..obs import get_registry

    return get_registry()


def _recorder():
    from ..obs import get_flight_recorder

    return get_flight_recorder()


@dataclass(frozen=True)
class RetryPolicy:
    """Backoff/deadline contract for one logical call.

    ``deadline_s`` is a budget across ALL attempts (including sleeps): once
    exceeded the call gives up even with attempts left, and a backoff sleep
    is truncated so it can never overshoot the budget. ``jitter`` is the
    fractional +/- spread on each sleep (0.5 = 50%), decorrelating retry
    storms from a fleet that failed in lockstep."""

    max_attempts: int = 4
    backoff_base_s: float = 0.1
    backoff_multiplier: float = 2.0
    backoff_max_s: float = 5.0
    jitter: float = 0.5
    deadline_s: Optional[float] = None
    retry_on: Tuple[Type[BaseException], ...] = (RetryableError, ConnectionError, OSError)

    def backoff_s(self, attempt: int, rng: Optional[random.Random] = None) -> float:
        """Sleep before retry number ``attempt`` (0-based)."""
        base = min(
            self.backoff_base_s * (self.backoff_multiplier ** attempt),
            self.backoff_max_s,
        )
        if self.jitter <= 0:
            return base
        r = rng.random() if rng is not None else random.random()
        return base * (1.0 + self.jitter * (2.0 * r - 1.0))


#: single attempt, no sleeping — the "without the resilience layer" contract
NO_RETRY = RetryPolicy(max_attempts=1, backoff_base_s=0.0, jitter=0.0)

#: broker/league RPCs: survive a several-second peer restart by default
DEFAULT_COMM_POLICY = RetryPolicy(
    max_attempts=5, backoff_base_s=0.2, backoff_max_s=3.0, deadline_s=30.0
)


class CircuitBreaker:
    """Thread-safe closed -> open -> half-open failure gate for one peer."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
    _LEVEL = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

    def __init__(self, op: str = "", failure_threshold: int = 5,
                 reset_after_s: float = 30.0):
        assert failure_threshold >= 1
        self.op = op or "anonymous"
        self.failure_threshold = failure_threshold
        self.reset_after_s = reset_after_s
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_ts = 0.0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _set_state(self, state: str, now: float) -> None:
        if state == self._state:
            return
        self._state = state
        if state == self.OPEN:
            self._opened_ts = now
            _metrics().counter(
                "distar_resilience_breaker_open_total",
                "circuit-breaker open transitions", op=self.op,
            ).inc()
            _recorder().record("breaker_open", op=self.op,
                               failures=self._failures)
        _metrics().gauge(
            "distar_resilience_breaker_state",
            "0 closed / 1 half-open / 2 open", op=self.op,
        ).set(self._LEVEL[state])

    def allow(self, now: Optional[float] = None) -> bool:
        """May a call proceed right now? Open circuits let one probe through
        once ``reset_after_s`` has elapsed (half-open)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if self._state == self.OPEN:
                if now - self._opened_ts >= self.reset_after_s:
                    self._set_state(self.HALF_OPEN, now)
                    return True
                return False
            return True

    def retry_after_s(self, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        with self._lock:
            if self._state != self.OPEN:
                return 0.0
            return max(0.0, self.reset_after_s - (now - self._opened_ts))

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._set_state(self.CLOSED, time.monotonic())

    def record_failure(self) -> None:
        now = time.monotonic()
        with self._lock:
            self._failures += 1
            if self._state == self.HALF_OPEN or self._failures >= self.failure_threshold:
                self._set_state(self.OPEN, now)


def retry_call(fn: Callable, *args, op: str = "", policy: Optional[RetryPolicy] = None,
               breaker: Optional[CircuitBreaker] = None,
               rng: Optional[random.Random] = None,
               sleep: Callable[[float], None] = time.sleep, **kwargs):
    """Invoke ``fn(*args, **kwargs)`` under ``policy``.

    Retries only exceptions matching ``policy.retry_on`` that are not
    ``FatalError``; everything else propagates untouched on the first
    occurrence. With a ``breaker``, an open circuit raises
    ``CircuitOpenError`` without consuming an attempt's worth of connect
    timeout. ``rng``/``sleep`` are injection points for deterministic tests."""
    policy = policy or DEFAULT_COMM_POLICY
    op = op or getattr(fn, "__name__", "call")
    start = time.monotonic()
    last: Optional[BaseException] = None
    for attempt in range(policy.max_attempts):
        if breaker is not None and not breaker.allow():
            raise CircuitOpenError(op, breaker.retry_after_s()) from last
        try:
            result = fn(*args, **kwargs)
        except FatalError:
            if breaker is not None:
                breaker.record_failure()
            raise
        except policy.retry_on as e:
            if breaker is not None:
                breaker.record_failure()
            last = e
            elapsed = time.monotonic() - start
            out_of_budget = (
                policy.deadline_s is not None and elapsed >= policy.deadline_s
            )
            if attempt + 1 >= policy.max_attempts or out_of_budget:
                _metrics().counter(
                    "distar_resilience_giveups_total",
                    "calls abandoned after exhausting retries/deadline", op=op,
                ).inc()
                _recorder().record(
                    "retry_giveup", op=op, attempts=attempt + 1,
                    elapsed_s=round(elapsed, 3), error=repr(e),
                )
                raise
            pause = policy.backoff_s(attempt, rng)
            if policy.deadline_s is not None:
                pause = min(pause, max(0.0, policy.deadline_s - elapsed))
            _metrics().counter(
                "distar_resilience_retries_total", "retried call attempts", op=op,
            ).inc()
            _recorder().record(
                "retry", op=op, attempt=attempt + 1, backoff_s=round(pause, 3),
                error=repr(e),
            )
            if pause > 0:
                sleep(pause)
        else:
            if breaker is not None:
                breaker.record_success()
            return result
    raise RuntimeError(f"unreachable: retry_call({op}) fell through")  # pragma: no cover


def retryable(op: str = "", policy: Optional[RetryPolicy] = None,
              breaker: Optional[CircuitBreaker] = None):
    """Decorator form of ``retry_call`` for functions that are always
    retried under the same policy."""

    def deco(fn):
        import functools

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return retry_call(fn, *args, op=op or fn.__name__, policy=policy,
                              breaker=breaker, **kwargs)

        return wrapped

    return deco

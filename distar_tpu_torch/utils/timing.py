"""Timing helpers.

Counterpart of ``distar_tpu.utils.timing``: ``EasyTimer`` (a wall-clock
context manager; a caller timing CUDA work synchronizes inside the block)
and ``StopWatch``, named regions timed from any thread and reported into
the port's metrics registry.
"""
from __future__ import annotations

import functools
import threading
import time


class EasyTimer:
    """``with timer: ...`` then ``timer.value`` in seconds."""

    def __init__(self):
        self.value = 0.0
        self._start = 0.0

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.value = time.perf_counter() - self._start
        return False


class StopWatch:
    """Named timed regions, ``with sw("name"):`` or ``@sw.decorate("name")``,
    recorded only while ``enabled``; thread-safe."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.times = {}
        self._lock = threading.Lock()

    def __call__(self, name: str):
        return _SWContext(self, name)

    def decorate(self, name: str):
        def wrapper(fn):
            @functools.wraps(fn)
            def inner(*args, **kwargs):
                with self(name):
                    return fn(*args, **kwargs)

            return inner

        return wrapper

    def _record(self, name: str, dt: float) -> None:
        with self._lock:
            self.times.setdefault(name, []).append(dt)

    def summary(self):
        with self._lock:
            snap = {k: list(v) for k, v in self.times.items()}
        return {k: {"sum": sum(v), "num": len(v), "avg": sum(v) / len(v)} for k, v in snap.items() if v}

    def report(self, registry=None, prefix: str = "distar_stopwatch") -> dict:
        """Feed every sample into the ``<prefix>_seconds`` histogram of its
        region (label ``region``), empty the store so the next report
        counts only new samples, and return the summary reported."""
        from ..obs import get_registry

        reg = registry or get_registry()
        with self._lock:
            snap, self.times = self.times, {}
        summary = {}
        for name, samples in snap.items():
            if not samples:
                continue
            hist = reg.histogram(f"{prefix}_seconds", "stopwatch timed regions", region=name)
            for dt in samples:
                hist.observe(dt)
            summary[name] = {"sum": sum(samples), "num": len(samples),
                             "avg": sum(samples) / len(samples)}
        return summary


class _SWContext:
    def __init__(self, sw: StopWatch, name: str):
        self._sw = sw
        self._name = name
        self._start = 0.0

    def __enter__(self):
        if self._sw.enabled:
            self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sw.enabled:
            self._sw._record(self._name, time.perf_counter() - self._start)
        return False


sw = StopWatch()

"""Versioned model registry with zero-downtime hot swap.

Counterpart of ``distar_tpu.serve.registry`` (metrics left out). Every
version loads under an explicit name — through the injected ``load_fn``, or
as params handed in directly — is warmed up with one forward off the
serving path, and only then becomes swappable. ``activate`` is an atomic
pointer bump guarded by a generation counter; the gateway applies the new
params at its next flush boundary.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Tuple

from .errors import ServeError, UnknownVersionError


class _Version:
    __slots__ = ("name", "params", "source", "loaded_at", "load_s", "warmup_s")

    def __init__(self, name, params, source, load_s, warmup_s):
        self.name = name
        self.params = params
        self.source = source
        self.loaded_at = time.time()
        self.load_s = load_s
        self.warmup_s = warmup_s


class ModelRegistry:
    def __init__(self, load_fn: Optional[Callable[[str], dict]] = None,
                 warmup_fn: Optional[Callable[[dict], None]] = None):
        """``load_fn(source) -> params`` loads a version by source name;
        ``warmup_fn(params)`` runs one forward on freshly loaded params
        before they are swappable."""
        self._load_fn = load_fn
        self._warmup_fn = warmup_fn
        self._versions: Dict[str, _Version] = {}
        self._current: Optional[str] = None
        self._generation = 0
        self._lock = threading.RLock()

    def load(self, version: str, source: Optional[str] = None, params=None,
             activate: bool = False) -> dict:
        """Load ``version`` from ``source`` (through ``load_fn``) or take
        ``params`` directly, and warm it up, outside the registry lock."""
        if (source is None) == (params is None):
            raise ValueError("pass exactly one of source and params")
        t0 = time.perf_counter()
        if params is None:
            if self._load_fn is None:
                raise ServeError("this registry has no load_fn; pass params")
            params = self._load_fn(source)
        load_s = time.perf_counter() - t0
        warmup_s = 0.0
        if self._warmup_fn is not None:
            t1 = time.perf_counter()
            self._warmup_fn(params)
            warmup_s = time.perf_counter() - t1
        with self._lock:
            self._versions[version] = _Version(version, params, source, load_s, warmup_s)
        if activate:
            self.activate(version)
        return {"version": version, "load_s": load_s, "warmup_s": warmup_s}

    def activate(self, version: str) -> int:
        """Atomically make ``version`` current; returns the new generation."""
        with self._lock:
            if version not in self._versions:
                raise UnknownVersionError(f"version {version!r} not loaded")
            self._current = version
            self._generation += 1
            return self._generation

    def current(self) -> Tuple[int, Optional[str], Optional[dict]]:
        """(generation, version, params) under one lock acquisition."""
        with self._lock:
            if self._current is None:
                return self._generation, None, None
            return self._generation, self._current, self._versions[self._current].params

    def unload(self, version: str) -> bool:
        """Drop a non-current version."""
        with self._lock:
            if version == self._current:
                raise UnknownVersionError(f"version {version!r} is current; swap first")
            return self._versions.pop(version, None) is not None

    def status(self) -> dict:
        with self._lock:
            return {
                "current": self._current,
                "generation": self._generation,
                "versions": {
                    v.name: {"source": v.source, "loaded_at": v.loaded_at,
                             "load_s": round(v.load_s, 6), "warmup_s": round(v.warmup_s, 6)}
                    for v in self._versions.values()
                },
            }

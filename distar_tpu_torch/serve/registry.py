"""Versioned model registry with zero-downtime hot swap.

Counterpart of ``distar_tpu.serve.registry``. Every checkpoint loads under
an explicit version name through ``utils.checkpoint`` — so sources are
``utils.storage`` URLs (plain paths, ``mem://``) — or as params handed in
directly, is warmed up with one forward off the serving path, and only then
becomes swappable. ``activate`` is an atomic pointer bump guarded by a
generation counter; the gateway applies the new params at its next flush
boundary, so a forward already executing finishes on the old params.
Params are the port's ``state_dict``s.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Tuple

from ..obs import get_registry
from .errors import UnknownVersionError


def default_load_fn(source: str):
    """``utils.checkpoint.load_params`` over storage URLs (checkpoint state
    -> bare inference params, opt_state stripped), then the flax tree ->
    the port's ``state_dict`` (``model.convert.params_from_flax``)."""
    from ..model.convert import params_from_flax
    from ..utils.checkpoint import load_params

    return params_from_flax(load_params(source))


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
    def __init__(
        self,
        load_fn: Optional[Callable[[str], dict]] = None,
        warmup_fn: Optional[Callable[[dict], None]] = None,
    ):
        """``load_fn(source) -> params`` (default: a checkpoint through
        ``utils.checkpoint`` via storage URLs, as a ``state_dict``);
        ``warmup_fn(params)`` runs one forward on the freshly
        loaded params before they are swappable (the gateway wires the
        engine's scratch-state warmup here)."""
        self._load_fn = load_fn or default_load_fn
        self._warmup_fn = warmup_fn
        self._versions: Dict[str, _Version] = {}
        self._current: Optional[str] = None
        self._generation = 0
        self._activated_at = 0.0
        self._lock = threading.RLock()
        reg = get_registry()
        self._h_load = reg.histogram(
            "distar_serve_model_load_seconds", "checkpoint load + warmup wall time"
        )
        self._h_swap = reg.histogram(
            "distar_serve_swap_duration_seconds",
            "activate() to first flush on the new params",
        )
        self._c_swap = reg.counter("distar_serve_swaps_total", "version activations")
        self._g_gen = reg.gauge(
            "distar_serve_model_generation", "monotonic active-params generation"
        )
        self._g_versions = reg.gauge(
            "distar_serve_model_versions", "versions resident in the registry"
        )

    # ------------------------------------------------------------------ load
    def load(self, version: str, source: Optional[str] = None, params=None,
             activate: bool = False) -> dict:
        """Load ``version`` from a storage URL (or take ``params`` directly,
        e.g. pushed over the wire by a learner) and warm it up. Loading
        happens outside the registry lock — the serving path never waits on
        checkpoint IO or warm-up compilation."""
        if (source is None) == (params is None):
            raise ValueError("pass exactly one of source and params")
        t0 = time.perf_counter()
        if params is None:
            params = self._load_fn(source)
        load_s = time.perf_counter() - t0
        warmup_s = 0.0
        if self._warmup_fn is not None:
            t1 = time.perf_counter()
            self._warmup_fn(params)
            warmup_s = time.perf_counter() - t1
        self._h_load.observe(load_s + warmup_s)
        with self._lock:
            self._versions[version] = _Version(version, params, source, load_s, warmup_s)
            self._g_versions.set(len(self._versions))
        if activate:
            self.activate(version)
        return {"version": version, "load_s": load_s, "warmup_s": warmup_s}

    # ------------------------------------------------------------------ swap
    def activate(self, version: str) -> int:
        """Atomically make ``version`` current; returns the new generation."""
        with self._lock:
            if version not in self._versions:
                raise UnknownVersionError(f"version {version!r} not loaded")
            self._current = version
            self._generation += 1
            self._activated_at = time.perf_counter()
            self._c_swap.inc()
            self._g_gen.set(self._generation)
            return self._generation

    def current(self) -> Tuple[int, Optional[str], Optional[dict]]:
        """(generation, version, params) under one lock acquisition — the
        batcher reads this at every flush and applies on generation change."""
        with self._lock:
            if self._current is None:
                return self._generation, None, None
            return self._generation, self._current, self._versions[self._current].params

    def swap_applied(self, generation: int) -> None:
        """The batcher installed generation ``generation`` on the engine —
        close the swap-duration measurement (activate -> first flush that
        serves the new params)."""
        with self._lock:
            if generation == self._generation and self._activated_at:
                self._h_swap.observe(time.perf_counter() - self._activated_at)
                self._activated_at = 0.0

    # ----------------------------------------------------------------- admin
    def unload(self, version: str) -> bool:
        """Drop a non-current version (old params are only reclaimable once
        nothing can flush on them)."""
        with self._lock:
            if version == self._current:
                raise UnknownVersionError(f"version {version!r} is current; swap first")
            dropped = self._versions.pop(version, None) is not None
            self._g_versions.set(len(self._versions))
            return dropped

    def status(self) -> dict:
        with self._lock:
            return {
                "current": self._current,
                "generation": self._generation,
                "versions": {
                    v.name: {
                        "source": v.source,
                        "loaded_at": v.loaded_at,
                        "load_s": round(v.load_s, 6),
                        "warmup_s": round(v.warmup_s, 6),
                    }
                    for v in self._versions.values()
                },
            }

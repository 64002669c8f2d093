"""TSDB-lite: bounded ring-buffer time series over registry snapshots.

Counterpart of ``distar_tpu.obs.timeseries``. The registry answers "what is
the value now"; a ``TimeSeriesStore`` keeps a small ring of ``(ts, value)``
points per flattened-snapshot key, keyed also by *source*, so one store
holds the whole fleet (the coordinator ingests the snapshots every actor,
learner and gateway ships, ``obs/shipper.py``). Windowed queries (last,
mean, min, max, rate over the most recent N seconds) are what the health
rules (``obs/health.py``) evaluate. Writes take an explicit ``ts`` where
the caller pins time; ``query`` windows back from a series' newest point,
``points`` and ``sources`` from the wall clock.

Memory is bounded by construction: ``points_per_series`` ring slots x
``max_series`` series, a few MB at the defaults, whatever the run length.
The series cap refuses only NEW series; a departed source's series are
reclaimed with ``evict_source``.
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from .registry import MetricsRegistry, get_registry

SeriesKey = Tuple[str, str]  # (source, name)


class TimeSeriesStore:
    """Thread-safe bounded store of (ts, value) rings keyed by (source, name)."""

    def __init__(self, points_per_series: int = 240, max_series: int = 4096):
        assert points_per_series > 0 and max_series > 0
        self._points = points_per_series
        self._max_series = max_series
        self._lock = threading.Lock()
        self._series: Dict[SeriesKey, deque] = {}
        self._source_seen: Dict[str, float] = {}
        self._dropped = 0  # series refused past the max_series cap
        self._evicted = 0  # series reclaimed when their source departed

    # ------------------------------------------------------------------ write
    def record(self, name: str, value: float, ts: Optional[float] = None,
               source: str = "local") -> bool:
        """Append one point; returns False when the series cap refused a NEW
        series (existing series always accept)."""
        ts = time.time() if ts is None else float(ts)
        key = (source, name)
        with self._lock:
            ring = self._series.get(key)
            if ring is None:
                if len(self._series) >= self._max_series:
                    self._dropped += 1
                    return False
                ring = deque(maxlen=self._points)
                self._series[key] = ring
            ring.append((ts, float(value)))
            prev = self._source_seen.get(source, 0.0)
            if ts > prev:
                self._source_seen[source] = ts
            return True

    def record_snapshot(self, snapshot: Dict[str, float], ts: Optional[float] = None,
                        source: str = "local") -> int:
        """Append one point per scalar of a flattened registry snapshot
        (``MetricsRegistry.snapshot()`` keys); returns the number recorded."""
        ts = time.time() if ts is None else float(ts)
        n = 0
        for name, value in snapshot.items():
            try:
                value = float(value)
            except (TypeError, ValueError):
                continue
            if self.record(name, value, ts=ts, source=source):
                n += 1
        return n

    def evict_source(self, source: str) -> int:
        """Reclaim every series a departed source left behind. Without this
        an elastic fleet exhausts the ``max_series`` cap permanently: each
        drained/evicted member's series sit in their rings forever and
        ``record`` refuses every NEW series from its replacement. The
        coordinator calls this (via ``TelemetryIngest.evict_endpoint``)
        whenever an endpoint's lease expires or it deregisters. Returns the
        number of series evicted (counted in
        ``distar_obs_series_evicted_total``)."""
        with self._lock:
            dead = [k for k in self._series if k[0] == source]
            for k in dead:
                del self._series[k]
            self._source_seen.pop(source, None)
            self._evicted += len(dead)
        if dead:
            get_registry().counter(
                "distar_obs_series_evicted_total",
                "TSDB series reclaimed because their source's lease expired "
                "or it deregistered",
            ).inc(len(dead))
        return len(dead)

    # ------------------------------------------------------------------- read
    def names(self, source: Optional[str] = None) -> List[str]:
        with self._lock:
            return sorted({n for (s, n) in self._series if source is None or s == source})

    def sources(self) -> Dict[str, dict]:
        """Per-source last-seen accounting: {source: {last_ts, age_s, series}}."""
        now = time.time()
        with self._lock:
            counts: Dict[str, int] = {}
            for (s, _n) in self._series:
                counts[s] = counts.get(s, 0) + 1
            return {
                s: {
                    "last_ts": last,
                    "age_s": max(0.0, now - last),
                    "series": counts.get(s, 0),
                }
                for s, last in self._source_seen.items()
            }

    def matching_names(self, metric: str, source: Optional[str] = None) -> List[str]:
        """Series keys for a metric reference: the exact flattened key, or —
        for a labelled family — every series of the family (``metric{...}``
        prefix). Lets rules name a family (``distar_coordinator_queue_depth``)
        and cover all its tokens."""
        prefix = metric + "{"
        return [n for n in self.names(source)
                if n == metric or n.startswith(prefix)]

    def query(self, name: str, window_s: float = 60.0,
              source: Optional[str] = None) -> Optional[dict]:
        """Windowed aggregate over the most recent ``window_s`` seconds of one
        series. ``source=None`` picks the single source holding the series
        when unambiguous, else the freshest. Returns None for unknown series
        or an empty window. ``rate`` is (last-first)/(t_last-t_first) — the
        counter-increase slope; 0.0 for a flat window, None with <2 points."""
        with self._lock:
            if source is None:
                candidates = [(s, n) for (s, n) in self._series if n == name]
                if not candidates:
                    return None
                key = max(candidates, key=lambda k: self._series[k][-1][0]
                          if self._series[k] else 0.0)
            else:
                key = (source, name)
                if key not in self._series:
                    return None
            pts = list(self._series[key])
        if not pts:
            return None
        cutoff = pts[-1][0] - float(window_s)
        window = [(t, v) for (t, v) in pts if t >= cutoff]
        if not window:
            return None
        values = [v for (_t, v) in window]
        finite = [v for v in values if math.isfinite(v)]
        t0, v0 = window[0]
        t1, v1 = window[-1]
        rate: Optional[float] = None
        if len(window) >= 2 and t1 > t0:
            rate = (v1 - v0) / (t1 - t0)
        elif len(window) >= 2:
            rate = 0.0
        return {
            "name": name,
            "source": key[0],
            "count": len(window),
            "last": v1,
            "mean": (sum(finite) / len(finite)) if finite else v1,
            "min": min(finite) if finite else v1,
            "max": max(finite) if finite else v1,
            "rate": rate,
            "first_ts": t0,
            "last_ts": t1,
            "age_s": max(0.0, time.time() - t1),
        }

    def points(self, name: str, window_s: float = 300.0,
               source: Optional[str] = None, limit: int = 240) -> Dict[str, list]:
        """Raw windowed points per source: {source: [[ts, value], ...]} —
        the /timeseries route's payload (opsctl query renders it)."""
        with self._lock:
            keys = [(s, n) for (s, n) in self._series
                    if n == name and (source is None or s == source)]
            snap = {k: list(self._series[k]) for k in keys}
        out: Dict[str, list] = {}
        cutoff = time.time() - float(window_s)
        for (s, _n), pts in snap.items():
            window = [[t, v] for (t, v) in pts if t >= cutoff]
            out[s] = window[-limit:]
        return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "series": len(self._series),
                "max_series": self._max_series,
                "points_per_series": self._points,
                "dropped_series": self._dropped,
                "evicted_series": self._evicted,
            }


class RegistrySampler:
    """Background thread snapshotting a ``MetricsRegistry`` into a store at a
    fixed cadence — the feed that turns the registry's "now" into history.
    ``sample_once()`` is exposed for deterministic tests."""

    def __init__(self, store: TimeSeriesStore, registry: Optional[MetricsRegistry] = None,
                 interval_s: float = 1.0, source: str = "local"):
        assert interval_s > 0
        self.store = store
        self.interval_s = interval_s
        self.source = source
        self._registry = registry
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def sample_once(self, ts: Optional[float] = None) -> int:
        reg = self._registry or get_registry()
        snap = reg.snapshot()
        n = self.store.record_snapshot(snap, ts=ts, source=self.source)
        reg.counter(
            "distar_tsdb_samples_total", "registry snapshots folded into the TSDB"
        ).inc()
        reg.gauge(
            "distar_tsdb_series", "series resident in the TSDB ring store"
        ).set(self.store.stats()["series"])
        return n

    def start(self) -> "RegistrySampler":
        if self._thread is not None:
            return self
        self._stop.clear()

        def run():
            while not self._stop.wait(self.interval_s):
                try:
                    self.sample_once()
                except Exception:
                    pass  # sampling must never kill the host process

        self._thread = threading.Thread(target=run, daemon=True, name="obs-sampler")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

"""Trace collection: the tail-sampled per-process buffer and latency
exemplars.

Counterpart of ``distar_tpu.obs.tracestore``. Every finished span becomes a
compact record offered to the process ``TraceBuffer``, whose tail-based
sampler (deciding after the outcome is known) keeps every non-``ok``
outcome, the slowest tail per span name, and 1-in-N of everything else;
the rest is dropped and counted (``distar_tracebuf_dropped_total``). The
``TelemetryShipper`` drains the buffer past a ship cursor into its
periodic message, and the coordinator's ``TelemetryIngest`` folds the
records into the ``TraceIngest`` here: bounded per source, evicted when
the member departs (the TSDB series contract), served at ``GET /traces``
and ``GET /trace/<id>``. Key latency histograms ``note_exemplar`` the last
retained trace id, so a firing health rule names a retrievable trace.
Buffer, ingest and exemplar store are bounded with counted drops.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

from .registry import MetricsRegistry, get_registry
from .trace import _instrument

#: drop-reason vocabulary for ``distar_tracebuf_dropped_total``
DROP_SAMPLED = "sampled_out"     # tail sampler decided against keeping
DROP_EVICTED = "evicted"         # bounded ring evicted the oldest kept record
DROP_EXEMPLAR = "exemplar_cap"   # exemplar map full for a new metric key
DROP_INGEST = "ingest_cap"       # coordinator refused a new source past cap


def _count_drop(reason: str, n: int = 1,
                registry: Optional[MetricsRegistry] = None) -> None:
    _instrument(
        "counter", registry or get_registry(), "distar_tracebuf_dropped_total",
        "trace records/exemplars dropped by the bounded collection path",
        reason=reason,
    ).inc(n)


class TraceBuffer:
    """Bounded per-process span-record buffer with tail-based sampling.

    Records retained here serve the local ``GET /traces`` surface AND feed
    the shipper (``unshipped()`` advances a cursor without removing — the
    ring bound is the only eviction)."""

    def __init__(self, maxlen: int = 512, random_one_in: int = 16,
                 slow_quantile: float = 0.98, duration_reservoir: int = 128,
                 registry: Optional[MetricsRegistry] = None):
        assert maxlen > 0 and random_one_in >= 1
        self.maxlen = int(maxlen)
        self.random_one_in = int(random_one_in)
        self.slow_quantile = float(slow_quantile)
        self._registry = registry
        self._lock = threading.Lock()
        self._records: deque = deque()
        self._durations: Dict[str, deque] = {}
        #: per-name cached slow threshold [threshold, adds_since_recompute]
        #: — recomputing the reservoir quantile on EVERY add was a
        #: measurable share of the per-request cost; staleness of up to
        #: _thresh_every adds only blurs the p90 boundary, never loses an
        #: error/shed trace
        self._thresh: Dict[str, list] = {}
        self._thresh_every = 16
        self._duration_reservoir = int(duration_reservoir)
        self._seq = 0
        self._n = 0
        self._shipped_seq = 0
        #: counter handles cached per registry epoch (offer runs per span)
        self._cc_reg = None
        self._cc: Dict[str, object] = {}

    # ------------------------------------------------------------- sampling
    def _keep_reason(self, name: str, dur: float, outcome: str) -> Optional[str]:
        """Caller holds the lock. Updates the per-name duration reservoir
        either way (the slow threshold must see the whole population)."""
        res = self._durations.get(name)
        if res is None:
            res = self._durations[name] = deque(maxlen=self._duration_reservoir)
        res.append(dur)
        if outcome != "ok":
            return "outcome"
        if len(res) >= 8:
            info = self._thresh.get(name)
            if info is None or info[1] >= self._thresh_every:
                ordered = sorted(res)
                idx = min(len(ordered) - 1,
                          int(self.slow_quantile * len(ordered)))
                info = self._thresh[name] = [ordered[idx], 0]
            else:
                info[1] += 1
            # STRICTLY above the threshold: a tightly-clustered latency
            # population ties at its own p90, and >= would retain nearly
            # every span (cost and volume) instead of the genuine tail
            if dur > info[0] > 0.0:
                return "slow"
        self._n += 1
        if self._n % self.random_one_in == 0:
            return "random"
        return None

    def _counter(self, reason: str, kept: bool):
        """Counter handle cached on the buffer per registry epoch — offer()
        runs once per finished span and must not pay the registry's
        lock+label-sort, nor even the instrument-memo tuple build."""
        reg = self._registry or get_registry()
        if self._cc_reg is not reg:
            self._cc_reg = reg
            self._cc = {}
        key = f"{'k' if kept else 'd'}:{reason}"
        c = self._cc.get(key)
        if c is None:
            if kept:
                c = reg.counter("distar_tracebuf_kept_total",
                                "trace records the tail sampler kept",
                                reason=reason)
            else:
                c = reg.counter(
                    "distar_tracebuf_dropped_total",
                    "trace records/exemplars dropped by the bounded "
                    "collection path", reason=reason)
            self._cc[key] = c
        return c

    def add(self, rec: Optional[dict]) -> bool:
        """Offer one finished span record; returns True when kept."""
        if not isinstance(rec, dict):
            return False
        return self.offer(rec.get("name", "?"), float(rec.get("dur_s", 0.0)),
                          rec.get("outcome", "ok"), lambda: rec) is not None

    def offer(self, name: str, dur_s: float, outcome: str, build) -> Optional[str]:
        """Tail-sampling front door: decide keep/drop from (name, duration,
        outcome) alone, and only call ``build()`` — the record construction,
        which is the expensive half — for the kept minority. Returns the
        keep reason or None. The per-request cost of a dropped span is one
        lock, one reservoir append and one counter increment."""
        evicted = False
        with self._lock:
            reason = self._keep_reason(name, dur_s, outcome)
            if reason is not None:
                rec = build()
                if not isinstance(rec, dict):
                    reason = None
                else:
                    rec = dict(rec)
                    rec["keep"] = reason
                    self._seq += 1
                    rec["seq"] = self._seq
                    if len(self._records) >= self.maxlen:
                        self._records.popleft()
                        evicted = True
                    self._records.append(rec)
        if reason is None:
            self._counter(DROP_SAMPLED, kept=False).inc()
            return None
        if evicted:
            self._counter(DROP_EVICTED, kept=False).inc()
        self._counter(reason, kept=True).inc()
        return reason

    # --------------------------------------------------------------- reads
    def records(self, limit: Optional[int] = None) -> List[dict]:
        with self._lock:
            out = list(self._records)
        return out[-limit:] if limit else out

    def unshipped(self, max_records: int = 128) -> List[dict]:
        """Records kept since the last ship, advancing the cursor (shipping
        is best-effort: a lost POST loses this batch, like any telemetry)."""
        with self._lock:
            fresh = [r for r in self._records if r["seq"] > self._shipped_seq]
            fresh = fresh[-max_records:]
            if fresh:
                self._shipped_seq = fresh[-1]["seq"]
        return fresh

    def get(self, trace_id: str) -> List[dict]:
        with self._lock:
            return [dict(r) for r in self._records
                    if r.get("trace_id") == trace_id]

    def stats(self) -> dict:
        with self._lock:
            return {"resident": len(self._records), "maxlen": self.maxlen,
                    "offered": self._n, "kept_seq": self._seq,
                    "shipped_seq": self._shipped_seq}

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._durations.clear()


def _listing(rec: dict, source: str) -> dict:
    """Compact ``GET /traces`` row for one span record."""
    return {
        "trace_id": rec.get("trace_id"),
        "name": rec.get("name"),
        "ts": rec.get("ts"),
        "dur_ms": round(float(rec.get("dur_s", 0.0)) * 1000.0, 3),
        "outcome": rec.get("outcome", "ok"),
        "keep": rec.get("keep"),
        "source": source,
        **({"skew": True} if rec.get("skew") else {}),
    }


class TraceIngest:
    """Coordinator-side trace store: shipped span records, bounded per
    source, evicted on member departure (the TSDB series contract)."""

    def __init__(self, max_per_source: int = 512, max_sources: int = 64,
                 registry: Optional[MetricsRegistry] = None):
        assert max_per_source > 0 and max_sources > 0
        self.max_per_source = int(max_per_source)
        self.max_sources = int(max_sources)
        self._registry = registry
        self._lock = threading.Lock()
        self._by_source: Dict[str, deque] = {}

    def ingest(self, source: str, records) -> int:
        if not isinstance(records, (list, tuple)):
            return 0
        source = str(source or "unknown")
        accepted = 0
        evicted = 0
        with self._lock:
            ring = self._by_source.get(source)
            if ring is None:
                if len(self._by_source) >= self.max_sources:
                    _count_drop(DROP_INGEST, n=len(records),
                                registry=self._registry)
                    return 0
                ring = self._by_source[source] = deque()
            for rec in records:
                if not isinstance(rec, dict) or "trace_id" not in rec:
                    continue
                if len(ring) >= self.max_per_source:
                    ring.popleft()
                    evicted += 1
                ring.append(rec)
                accepted += 1
        if evicted:
            _count_drop(DROP_EVICTED, n=evicted, registry=self._registry)
        if accepted:
            (self._registry or get_registry()).counter(
                "distar_trace_ingest_records_total",
                "shipped span records folded into the coordinator trace store",
            ).inc(accepted)
        return accepted

    def evict_source(self, source: str) -> int:
        """A member departed (lease expiry / graceful unregister): reclaim
        its traces like its TSDB series. Returns records reclaimed."""
        with self._lock:
            ring = self._by_source.pop(source, None)
            return len(ring) if ring else 0

    # --------------------------------------------------------------- reads
    def query(self, name: Optional[str] = None, min_ms: float = 0.0,
              outcome: Optional[str] = None, limit: int = 50) -> List[dict]:
        """Compact listings, slowest first, across every source."""
        with self._lock:
            snap = {s: list(ring) for s, ring in self._by_source.items()}
        rows = []
        for source, recs in snap.items():
            for rec in recs:
                if name and rec.get("name") != name:
                    continue
                if outcome and rec.get("outcome", "ok") != outcome:
                    continue
                if float(rec.get("dur_s", 0.0)) * 1000.0 < float(min_ms):
                    continue
                rows.append(_listing(rec, source))
        rows.sort(key=lambda r: r["dur_ms"], reverse=True)
        return rows[: max(1, int(limit))]

    def get(self, trace_id: str) -> List[dict]:
        """Every span record of one trace, across sources (the waterfall
        input — a trace's spans come from several processes)."""
        with self._lock:
            snap = {s: list(ring) for s, ring in self._by_source.items()}
        out = []
        for source, recs in snap.items():
            for rec in recs:
                if rec.get("trace_id") == trace_id:
                    rec = dict(rec)
                    rec["source"] = source
                    out.append(rec)
        out.sort(key=lambda r: r.get("ts", 0.0))
        return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "sources": len(self._by_source),
                "records": sum(len(r) for r in self._by_source.values()),
                "max_per_source": self.max_per_source,
                "max_sources": self.max_sources,
            }


class ExemplarStore:
    """Bounded last-wins map: metric key -> the most recent trace that fed
    that latency series. Keys use the flattened-snapshot family spelling
    (``distar_trace_e2e_seconds{span=trajectory}``) so a health rule's
    metric reference (``..._p99``) finds its exemplar by prefix."""

    def __init__(self, max_entries: int = 128,
                 registry: Optional[MetricsRegistry] = None):
        assert max_entries > 0
        self.max_entries = int(max_entries)
        self._registry = registry
        self._lock = threading.Lock()
        self._entries: Dict[str, dict] = {}

    def note(self, metric: str, trace_id: str, value: float,
             ts: Optional[float] = None) -> bool:
        entry = {"trace_id": str(trace_id), "value": float(value),
                 "ts": time.time() if ts is None else float(ts)}
        with self._lock:
            if metric not in self._entries and len(self._entries) >= self.max_entries:
                capped = True
            else:
                capped = False
                self._entries[str(metric)] = entry
        if capped:
            _count_drop(DROP_EXEMPLAR, registry=self._registry)
        return not capped

    def lookup(self, metric_ref: str) -> Optional[dict]:
        """Exemplar for a rule's metric reference: exact key, else the
        freshest key the reference extends (``family{...}_p99`` matches
        ``family{...}``)."""
        with self._lock:
            entry = self._entries.get(metric_ref)
            if entry is not None:
                return dict(entry)
            best = None
            for key, e in self._entries.items():
                if metric_ref.startswith(key) and (
                        best is None or e["ts"] > best["ts"]):
                    best = e
            return dict(best) if best else None

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._entries.items()}

    def merge(self, entries) -> int:
        """Fold a shipped exemplar snapshot in (freshest ts wins per key) —
        how the coordinator's rules see fleet-process exemplars."""
        if not isinstance(entries, dict):
            return 0
        merged = 0
        for key, e in entries.items():
            if not isinstance(e, dict) or "trace_id" not in e:
                continue
            with self._lock:
                cur = self._entries.get(key)
                if cur is None and len(self._entries) >= self.max_entries:
                    capped = True
                else:
                    capped = False
                    if cur is None or float(e.get("ts", 0.0)) >= cur["ts"]:
                        self._entries[str(key)] = {
                            "trace_id": str(e["trace_id"]),
                            "value": float(e.get("value", 0.0)),
                            "ts": float(e.get("ts", 0.0)),
                        }
                        merged += 1
            if capped:
                _count_drop(DROP_EXEMPLAR, registry=self._registry)
        return merged


# ------------------------------------------------------- process defaults
_buffer_lock = threading.Lock()
_buffer: Optional[TraceBuffer] = None
_exemplars_lock = threading.Lock()
_exemplars: Optional[ExemplarStore] = None


def get_trace_buffer() -> TraceBuffer:
    """The process-wide trace buffer (created on first use)."""
    global _buffer
    with _buffer_lock:
        if _buffer is None:
            _buffer = TraceBuffer()
        return _buffer


def set_trace_buffer(buffer: Optional[TraceBuffer]) -> Optional[TraceBuffer]:
    """Swap the process default (tests install a fresh one)."""
    global _buffer
    with _buffer_lock:
        prev = _buffer
        _buffer = buffer
        return prev


def get_exemplar_store() -> ExemplarStore:
    """The process-wide exemplar store (created on first use)."""
    global _exemplars
    with _exemplars_lock:
        if _exemplars is None:
            _exemplars = ExemplarStore()
        return _exemplars


def set_exemplar_store(store: Optional[ExemplarStore]) -> Optional[ExemplarStore]:
    global _exemplars
    with _exemplars_lock:
        prev = _exemplars
        _exemplars = store
        return prev


def note_exemplar(metric: str, trace_id: Optional[str], value: float) -> None:
    """Record ``trace_id`` as the latest witness of ``metric`` (no-op
    without an id — untraced observes cost one None check)."""
    if trace_id:
        get_exemplar_store().note(metric, trace_id, value)

"""Process-wide metrics registry: counters, gauges, bounded-reservoir histograms.

Counterpart of ``distar_tpu.obs.registry``, with the same names, types and
rendering, so the two packages' ``/metrics`` scrapes name the same series.
One registry per process; every instrument is thread-safe.

Naming convention (docs/observability.md): ``distar_<subsystem>_<name>_<unit>``
with ``_total`` for counters. Labels are for *bounded* dimensions only
(token, race, hop — never per-trajectory ids).
"""
from __future__ import annotations

import re
import threading
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKey:
    for k in labels:
        if not _LABEL_RE.match(k):
            raise ValueError(f"invalid label name {k!r}")
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic counter. ``inc`` with a negative amount raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter can only go up (inc {amount})")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value; set/inc/dec."""

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Distribution over a bounded reservoir (last ``reservoir`` observations)
    plus lifetime count/sum. Quantiles come from the reservoir — recent-window
    semantics, which for step-time/latency series is what operators want."""

    def __init__(self, reservoir: int = 1024):
        assert reservoir > 0
        self._lock = threading.Lock()
        self._reservoir: deque = deque(maxlen=reservoir)
        self._count = 0
        self._sum = 0.0

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._reservoir.append(value)
            self._count += 1
            self._sum += value

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile over the reservoir (0.0 when empty)."""
        assert 0.0 <= q <= 1.0
        with self._lock:
            if not self._reservoir:
                return 0.0
            ordered = sorted(self._reservoir)
        idx = min(len(ordered) - 1, max(0, int(q * len(ordered))))
        return ordered[idx]

    def quantiles(self, qs: Iterable[float]) -> Dict[float, float]:
        with self._lock:
            ordered = sorted(self._reservoir)
        out = {}
        for q in qs:
            if not ordered:
                out[q] = 0.0
            else:
                out[q] = ordered[min(len(ordered) - 1, max(0, int(q * len(ordered))))]
        return out


_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Thread-safe instrument store keyed by (name, labelset).

    The same (name, labels) always returns the same instrument; re-declaring a
    name with a different type raises (one name = one metric family)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._types: Dict[str, str] = {}
        self._helps: Dict[str, str] = {}
        self._metrics: Dict[str, Dict[LabelKey, object]] = {}
        self._hist_reservoir: Dict[str, int] = {}

    def _get(self, kind: str, name: str, help: str, labels: Dict[str, str], **kwargs):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        key = _label_key(labels)
        with self._lock:
            existing = self._types.get(name)
            if existing is not None and existing != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {existing}, not {kind}"
                )
            self._types[name] = kind
            if help and not self._helps.get(name):
                self._helps[name] = help
            family = self._metrics.setdefault(name, {})
            inst = family.get(key)
            if inst is None:
                inst = _TYPES[kind](**kwargs)
                family[key] = inst
            return inst

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get("counter", name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get("gauge", name, help, labels)

    def histogram(self, name: str, help: str = "", reservoir: int = 1024, **labels) -> Histogram:
        with self._lock:
            # all series of one family share the reservoir size (first wins)
            reservoir = self._hist_reservoir.setdefault(name, reservoir)
        return self._get("histogram", name, help, labels, reservoir=reservoir)

    # ------------------------------------------------------------- inspection
    def collect(self) -> List[dict]:
        """Stable snapshot: [{name, type, help, series: [(labels, instrument)]}]
        sorted by name then labelset (deterministic rendering)."""
        with self._lock:
            names = sorted(self._metrics)
            out = []
            for name in names:
                out.append(
                    {
                        "name": name,
                        "type": self._types[name],
                        "help": self._helps.get(name, ""),
                        "series": sorted(self._metrics[name].items()),
                    }
                )
            return out

    def snapshot(self) -> Dict[str, float]:
        """Flat scalar view ``name{k=v,...} -> value`` (histograms expand to
        _count/_sum/p50/p99) — the JSONL exporter's input."""
        flat: Dict[str, float] = {}
        for fam in self.collect():
            for key, inst in fam["series"]:
                suffix = "{" + ",".join(f"{k}={v}" for k, v in key) + "}" if key else ""
                base = fam["name"] + suffix
                if fam["type"] == "histogram":
                    flat[base + "_count"] = float(inst.count)
                    flat[base + "_sum"] = inst.sum
                    qs = inst.quantiles((0.5, 0.99))
                    flat[base + "_p50"] = qs[0.5]
                    flat[base + "_p99"] = qs[0.99]
                else:
                    flat[base] = inst.value
        return flat


_registry_lock = threading.Lock()
_registry: Optional[MetricsRegistry] = None


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (created on first use)."""
    global _registry
    reg = _registry
    if reg is not None:  # lock-free fast path: hot paths call this per event
        return reg
    with _registry_lock:
        if _registry is None:
            _registry = MetricsRegistry()
        return _registry


def set_registry(registry: Optional[MetricsRegistry]) -> MetricsRegistry:
    """Swap the process default (tests install a fresh one); returns the
    previous registry (None when unset)."""
    global _registry
    with _registry_lock:
        prev = _registry
        _registry = registry
        return prev

"""Distributed trace spans with explicit context propagation.

Counterpart of ``distar_tpu.obs.trace``. Kept span completions and span
errors also land in the crash flight recorder's ring
(``obs/flightrecorder.py``), as in the JAX package.

A trace context is a plain picklable dict minted at the head of a request or
pipeline (the actor when a trajectory is born, the serve client when a
request leaves the process) that rides the payload through every hop —
adapter push, shuttle transfer, serve TCP frame, replay insert frame —
into the consumer. Each ``mark_hop`` records the hop-to-hop latency into the
registry (``distar_trace_hop_seconds{hop=...}``); ``finish_trace`` records
the end-to-end age (``distar_trace_e2e_seconds{name=...}``) AND folds the
completed span into the process ``TraceBuffer`` (``obs/tracestore.py``),
whose tail sampler decides what ships to the coordinator's trace store.

Cross-process propagation is a **compact wire field** (``wire_ctx``: just
``{trace_id, span_id}``) stamped into request frames and ``traceparent``
HTTP headers; the receiving process ``join_trace``s it — minting its own
child span under the SAME trace_id with ``parent_span_id`` set — so the
client span, router span and gateway span of one request assemble into one
waterfall (``obs/waterfall.py``) on the coordinator.

Attribution: hops say *when* a context moved; ``annotate`` accumulates
*why time passed* onto the live span under a small closed vocabulary —
``queue_s`` (waiting for a flush/slot), ``blocked_s`` (flow control: replay
rate limiter, shm ring-full), ``service_s`` (actual compute), ``retry_s``
(fleet re-route/retry) — which is what the waterfall decomposes. Blocking
primitives that cannot see the request's context (the rate limiter, the
ring writer) annotate the thread's *active* context instead
(``set_active_trace`` / ``annotate_active``).

Explicit-context (dict in the payload) rather than implicit (contextvars)
because the pipeline crosses process and host boundaries through pickled
payloads — the context must serialize with the data it describes.

``set_tracing(False)`` (or ``DISTAR_TRACE=0``) disables span *minting* at
every client/server site, for the overhead A/B and byte-identical wire runs;
retention cost is bounded by the tail sampler either way.
"""
from __future__ import annotations

import os
import random
import threading
import time
from typing import List, Optional

from .registry import MetricsRegistry, get_registry

#: annotation vocabulary the waterfall analyzer decomposes (free-form keys
#: still render, under "other")
ANNOTATION_KINDS = ("queue_s", "blocked_s", "service_s", "retry_s")

_tracing_enabled = os.environ.get("DISTAR_TRACE", "1").lower() not in (
    "0", "false", "no")


def tracing_enabled() -> bool:
    return _tracing_enabled


def set_tracing(enabled: bool) -> bool:
    """Flip span minting process-wide; returns the previous setting (tests
    and the overhead A/B restore it)."""
    global _tracing_enabled
    prev = _tracing_enabled
    _tracing_enabled = bool(enabled)
    return prev


#: PRNG for span ids: seeded from the OS once, then syscall-free — ids are
#: correlation handles, not secrets, and the urandom syscall per id was a
#: measurable share of the per-request tracing cost
_id_rand = random.Random(os.urandom(16))


def mint_span_id() -> str:
    """64-bit random hex span/trace id (w3c-traceparent-sized)."""
    return f"{_id_rand.getrandbits(64):016x}"


def _instrument(kind: str, reg: MetricsRegistry, name: str, help_: str,
                **labels):
    """Per-registry memo around instrument resolution: ``registry._get``
    takes a lock and sorts the label set on every call, which a per-request
    hot path pays thousands of times for the same instrument. The memo
    lives ON the registry so it dies with it (tests swap registries
    freely)."""
    cache = getattr(reg, "_trace_inst_cache", None)
    if cache is None:
        cache = reg._trace_inst_cache = {}
    key = (kind, name) + tuple(sorted(labels.items()))
    inst = cache.get(key)
    if inst is None:
        inst = cache[key] = getattr(reg, kind)(name, help_, **labels)
    return inst


def start_trace(name: str, registry: Optional[MetricsRegistry] = None, **attrs) -> dict:
    """Mint a new trace context. ``attrs`` are free-form, low-cardinality
    annotations (player id, token) carried for debugging, not used as labels."""
    now = time.time()
    ctx = {
        "name": str(name),
        "trace_id": mint_span_id(),
        "span_id": mint_span_id(),
        "t_start": now,
        "hops": [{"hop": "start", "ts": now}],
    }
    if attrs:
        ctx["attrs"] = {k: str(v) for k, v in attrs.items()}
    return ctx


def is_trace(ctx) -> bool:
    return (
        isinstance(ctx, dict)
        and "trace_id" in ctx
        and "span_id" in ctx
        and isinstance(ctx.get("hops"), list)
    )


# -------------------------------------------------------- wire propagation
def wire_ctx(ctx: Optional[dict]) -> Optional[dict]:
    """The compact cross-process trace-context field: rides request frames
    (``req["trace"]``) and ``traceparent`` headers. Carries only identity —
    the receiver minting a child span is what makes it cheap."""
    if not is_trace(ctx):
        return None
    return {"trace_id": ctx["trace_id"], "span_id": ctx["span_id"]}


def is_wire_ctx(w) -> bool:
    return (isinstance(w, dict)
            and isinstance(w.get("trace_id"), str)
            and isinstance(w.get("span_id"), str))


def join_trace(wire, name: str, registry: Optional[MetricsRegistry] = None,
               **attrs) -> dict:
    """Server-side join: mint a child context under the caller's trace.
    A missing/garbage wire field degrades to a fresh root trace — a legacy
    client must never break a tracing server."""
    if not is_wire_ctx(wire):
        return start_trace(name, registry=registry, **attrs)
    now = time.time()
    ctx = {
        "name": str(name),
        "trace_id": str(wire["trace_id"]),
        "parent_span_id": str(wire["span_id"]),
        "span_id": mint_span_id(),
        "t_start": now,
        "hops": [{"hop": "start", "ts": now}],
    }
    if attrs:
        ctx["attrs"] = {k: str(v) for k, v in attrs.items()}
    return ctx


_TP_VERSION = "00"


def format_traceparent(ctx_or_wire) -> Optional[str]:
    """W3C ``traceparent`` header for a context (or compact wire field).
    Our ids are 8 bytes; the 16-byte w3c trace-id is left-zero-padded."""
    w = wire_ctx(ctx_or_wire) if is_trace(ctx_or_wire) else ctx_or_wire
    if not is_wire_ctx(w):
        return None
    return f"{_TP_VERSION}-{w['trace_id'].zfill(32)}-{w['span_id']}-01"


def parse_traceparent(header: Optional[str]) -> Optional[dict]:
    """Parse a ``traceparent`` header into the compact wire field (None on
    anything malformed — a garbage header is ignored, never an error)."""
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().split("-")
    if len(parts) < 4:
        return None
    _ver, tid, sid = parts[0], parts[1], parts[2]
    if len(tid) != 32 or len(sid) != 16:
        return None
    try:
        int(tid, 16), int(sid, 16)
    except ValueError:
        return None
    # our ids are the low 8 bytes; a foreign full-width id keeps its tail
    return {"trace_id": tid[-16:], "span_id": sid}


# ------------------------------------------------------------- annotations
def annotate(ctx: Optional[dict], key: str, seconds: float) -> None:
    """Accumulate wall-clock attribution onto the live span (``queue_s``,
    ``blocked_s``, ``service_s``, ``retry_s`` — the waterfall vocabulary)."""
    if not is_trace(ctx) or seconds <= 0:
        return
    annot = ctx.setdefault("annot", {})
    annot[key] = annot.get(key, 0.0) + float(seconds)


_active = threading.local()


def set_active_trace(ctx: Optional[dict]):
    """Install ``ctx`` as this THREAD's active trace and return the previous
    one (callers restore it in a finally). Blocking primitives that can't
    see the request's context — the replay rate limiter, the shm ring
    writer — attribute their waits to the active context."""
    prev = getattr(_active, "ctx", None)
    _active.ctx = ctx
    return prev


def current_trace() -> Optional[dict]:
    return getattr(_active, "ctx", None)


def annotate_active(key: str, seconds: float) -> None:
    annotate(getattr(_active, "ctx", None), key, seconds)


# -------------------------------------------------------------------- hops
def mark_hop(ctx: dict, hop: str, registry: Optional[MetricsRegistry] = None) -> float:
    """Append a hop to the context and record the latency since the previous
    hop into ``distar_trace_hop_seconds{hop=...}``. Returns that latency.

    Cross-host clock skew can make the raw delta NEGATIVE; the histogram
    clamps to 0 (a latency series must not go negative) but the clamp is
    never silent: the raw delta rides the hop record (``raw_dt``) so the
    waterfall analyzer can flag skewed traces instead of rendering lies,
    and every clamp is counted in ``distar_trace_clock_skew_total{hop}``."""
    if not is_trace(ctx):
        return 0.0
    now = time.time()
    prev_ts = ctx["hops"][-1]["ts"] if ctx["hops"] else ctx["t_start"]
    raw = now - prev_ts
    dt = max(0.0, raw)
    rec = {"hop": str(hop), "ts": now}
    reg = registry or get_registry()
    if raw < 0:
        rec["raw_dt"] = raw
        _instrument(
            "counter", reg, "distar_trace_clock_skew_total",
            "hop deltas clamped to 0 because the clock ran backwards "
            "(cross-host skew — the raw delta stays on the hop record)",
            hop=str(hop),
        ).inc()
    ctx["hops"].append(rec)
    _instrument(
        "histogram", reg, "distar_trace_hop_seconds",
        "per-hop pipeline latency", hop=str(hop),
    ).observe(dt)
    return dt


def trace_record(ctx: dict, outcome: str = "ok") -> Optional[dict]:
    """Flatten a finished context into the compact span record the
    ``TraceBuffer`` keeps and ships (plain JSON-able types only)."""
    if not is_trace(ctx):
        return None
    end_ts = ctx["hops"][-1]["ts"] if ctx["hops"] else time.time()
    rec = {
        "trace_id": ctx["trace_id"],
        "span_id": ctx["span_id"],
        "name": ctx["name"],
        "ts": ctx["t_start"],
        "dur_s": max(0.0, end_ts - ctx["t_start"]),
        "outcome": str(outcome),
        # the context is dead after finish: hop dicts are safe to share
        "hops": list(ctx["hops"]),
        "pid": os.getpid(),
    }
    if "parent_span_id" in ctx:
        rec["parent_span_id"] = ctx["parent_span_id"]
    if ctx.get("annot"):
        rec["annot"] = {k: round(float(v), 6) for k, v in ctx["annot"].items()}
    if ctx.get("attrs"):
        rec["attrs"] = dict(ctx["attrs"])
    if any("raw_dt" in h for h in ctx["hops"]):
        rec["skew"] = True
    return rec


def finish_trace(ctx: dict, hop: str = "end",
                 registry: Optional[MetricsRegistry] = None,
                 outcome: str = "ok") -> float:
    """Terminal hop: records the hop latency plus the end-to-end trace age
    (``distar_trace_e2e_seconds{name=...}``), folds the completed span into
    the process ``TraceBuffer`` (tail-sampled; error/shed outcomes are
    always kept) and notes the trace as the latency exemplar for its e2e
    series. Idempotent per context. Returns the e2e age."""
    if not is_trace(ctx) or ctx.get("_finished"):
        return 0.0
    ctx["_finished"] = True
    mark_hop(ctx, hop, registry=registry)
    age = max(0.0, ctx["hops"][-1]["ts"] - ctx["t_start"])
    reg = registry or get_registry()
    _instrument(
        "histogram", reg, "distar_trace_e2e_seconds",
        "end-to-end pipeline trace age", span=ctx["name"],
    ).observe(age)
    kept = tracestore.get_trace_buffer().offer(
        ctx["name"], age, outcome, lambda: trace_record(ctx, outcome=outcome))
    ctx["_kept"] = kept  # observers gate their exemplar notes on retention
    if kept:
        # exemplars point only at RETAINED traces (an exemplar naming a
        # sampled-out trace_id would 404 on retrieval); the slow tail is
        # always retained, so the freshest exemplar is the one that matters
        tracestore.note_exemplar(_exemplar_key(ctx["name"]), ctx["trace_id"], age)
        # KEPT span completions land in the crash flight recorder's bounded
        # ring, trace_id included so a crash bundle cross-references the
        # coordinator's trace store (sampled-out ok spans would wash the
        # 512-event ring out in milliseconds at serve rates)
        from .flightrecorder import get_flight_recorder

        event = {"name": ctx["name"], "trace_id": ctx["trace_id"],
                 "age_s": round(age, 4), "hops": hop_names(ctx)}
        if outcome != "ok":
            event["outcome"] = str(outcome)
        get_flight_recorder().record("span", **event)
    return age


_exemplar_keys: dict = {}


def _exemplar_key(name: str) -> str:
    key = _exemplar_keys.get(name)
    if key is None:
        key = _exemplar_keys[name] = f"distar_trace_e2e_seconds{{span={name}}}"
    return key


def hop_names(ctx: dict) -> List[str]:
    return [h["hop"] for h in ctx.get("hops", [])] if is_trace(ctx) else []


class Span:
    """In-process timed region publishing ``distar_span_seconds{name=...}``.

    ``with Span("collate"): ...`` — the lightweight sibling of the
    cross-process trace context, for regions that never leave the process.
    The exit path records the region's ``outcome`` (``ok``/``error``); a
    span that exits on an exception counts ``distar_span_errors_total``."""

    def __init__(self, name: str, registry: Optional[MetricsRegistry] = None,
                 trace: Optional[dict] = None):
        self.name = name
        self.span_id = mint_span_id()
        self.trace_id = trace["trace_id"] if is_trace(trace) else None
        self.outcome = "ok"
        self._registry = registry
        self._start = 0.0
        self.elapsed = 0.0

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.elapsed = time.perf_counter() - self._start
        self.outcome = "ok" if exc_type is None else "error"
        reg = self._registry or get_registry()
        reg.histogram(
            "distar_span_seconds", "in-process span duration", span=self.name
        ).observe(self.elapsed)
        if exc_type is not None:
            reg.counter(
                "distar_span_errors_total",
                "in-process spans that exited on an exception", span=self.name,
            ).inc()
            from .flightrecorder import get_flight_recorder

            event = {"name": self.name,
                     "error": getattr(exc_type, "__name__", str(exc_type)),
                     "elapsed_s": round(self.elapsed, 4)}
            if self.trace_id:
                event["trace_id"] = self.trace_id
            get_flight_recorder().record("span_error", **event)
        return False


# ------------------------------------------------------- payload envelope
# The adapter wraps payloads carrying a trace in this envelope; the receive
# side unwraps transparently so non-instrumented consumers see plain data.
_ENVELOPE_KEY = "__distar_trace__"


def wrap_payload(data, ctx: Optional[dict]):
    if ctx is None:
        return data
    return {_ENVELOPE_KEY: ctx, "payload": data}


def unwrap_payload(data):
    """Returns (payload, ctx_or_None)."""
    if isinstance(data, dict) and _ENVELOPE_KEY in data:
        return data.get("payload"), data[_ENVELOPE_KEY]
    return data, None


# bottom import (cycle-safe: tracestore needs _instrument from above) so the
# per-span hot path doesn't pay a sys.modules lookup per finish
from . import tracestore  # noqa: E402

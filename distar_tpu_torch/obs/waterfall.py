"""Waterfall / critical-path analyzer over one trace's span records.

Counterpart of ``distar_tpu.obs.waterfall``, the consumption side of distributed tracing (the ``obs/traceview.py``
conventions: a JSON report plus ranked markdown). Input is the span-record
list ``TraceIngest.get(trace_id)`` returns — the client span, router span,
gateway/store span of ONE request, possibly from several processes. Output:

  * a **waterfall**: every span with its offset from the root, duration,
    and a per-span time decomposition — ``queue`` (micro-batcher residency),
    ``blocked`` (replay rate-limiter / shm ring-full waits), ``retry``
    (fleet re-route), ``service`` (compute), ``child`` (time covered by a
    child span) and ``network/other`` (the unexplained remainder, which for
    a parent whose child ran in another process is mostly the wire);
  * the **critical path**: root -> longest child chain, with its segments
    ranked by seconds — the "what do I fix first" list;
  * a **skew flag**: cross-host clocks are not synchronized, so a child
    starting "before" its parent or a clamped-negative hop delta marks the
    whole waterfall suspect instead of rendering lies (the raw deltas stay
    on the hop records).

Stdlib-only and pure: callers (opsctl, tests, the /trace route) feed
records in, JSON comes out.
"""
from __future__ import annotations

from typing import Dict, List, Optional

#: decomposition vocabulary, render order
SEGMENT_KINDS = ("queue", "blocked", "retry", "service", "network/other")

_ANNOT_TO_KIND = {"queue_s": "queue", "blocked_s": "blocked",
                  "retry_s": "retry", "service_s": "service"}

_SKEW_EPS_S = 0.001


def _decompose(rec: dict, child_s: float) -> Dict[str, float]:
    """Per-span seconds by kind. Annotated seconds are authoritative;
    ``service`` falls back to the un-annotated self-time remainder when the
    span never annotated compute; whatever is left after annotations, child
    coverage and service is ``network/other`` (wire + untracked)."""
    dur = max(0.0, float(rec.get("dur_s", 0.0)))
    annot = rec.get("annot") or {}
    out = {k: 0.0 for k in SEGMENT_KINDS}
    explained = 0.0
    for key, kind in _ANNOT_TO_KIND.items():
        v = max(0.0, float(annot.get(key, 0.0)))
        out[kind] = v
        explained += v
    child_s = min(child_s, max(0.0, dur - min(explained, dur)))
    remainder = max(0.0, dur - explained - child_s)
    if out["service"] == 0.0 and child_s == 0.0:
        # a leaf that never annotated compute: its self-time IS service
        out["service"] = remainder
    else:
        out["network/other"] = remainder
    return out


def build_waterfall(records: List[dict]) -> dict:
    """Assemble one trace's records into the waterfall report dict."""
    spans = [dict(r) for r in records
             if isinstance(r, dict) and r.get("span_id")]
    if not spans:
        return {"trace_id": None, "spans": [], "critical_path": [],
                "segments": [], "skewed": False, "total_s": 0.0}
    spans.sort(key=lambda r: float(r.get("ts", 0.0)))
    by_id = {r["span_id"]: r for r in spans}
    children: Dict[str, List[dict]] = {}
    roots: List[dict] = []
    for r in spans:
        parent = r.get("parent_span_id")
        if parent and parent in by_id:
            children.setdefault(parent, []).append(r)
        else:
            roots.append(r)
    root = roots[0] if roots else spans[0]
    t0 = float(root.get("ts", 0.0))
    total = max(float(root.get("dur_s", 0.0)),
                max(float(r.get("ts", 0.0)) + float(r.get("dur_s", 0.0))
                    for r in spans) - t0)

    skewed = any(r.get("skew") for r in spans)
    rows: List[dict] = []

    def _emit(rec: dict, depth: int) -> None:
        nonlocal skewed
        kids = sorted(children.get(rec["span_id"], ()),
                      key=lambda r: float(r.get("ts", 0.0)))
        child_s = sum(float(k.get("dur_s", 0.0)) for k in kids)
        start = float(rec.get("ts", 0.0)) - t0
        dur = float(rec.get("dur_s", 0.0))
        parent = by_id.get(rec.get("parent_span_id") or "")
        if parent is not None:
            p_start = float(parent.get("ts", 0.0)) - t0
            p_end = p_start + float(parent.get("dur_s", 0.0))
            if start < p_start - _SKEW_EPS_S or start + dur > p_end + _SKEW_EPS_S:
                skewed = True
        rows.append({
            "span_id": rec["span_id"],
            "parent_span_id": rec.get("parent_span_id"),
            "name": rec.get("name", "?"),
            "source": rec.get("source", f"pid:{rec.get('pid', '?')}"),
            "depth": depth,
            "start_ms": round(start * 1000.0, 3),
            "dur_ms": round(dur * 1000.0, 3),
            "outcome": rec.get("outcome", "ok"),
            "segments_ms": {k: round(v * 1000.0, 3)
                            for k, v in _decompose(rec, child_s).items() if v},
            "hops": [h.get("hop") for h in rec.get("hops", ())],
        })
        for k in kids:
            _emit(k, depth + 1)

    _emit(root, 0)
    # orphans (parent span never collected — e.g. a process whose buffer
    # sampled it out): rendered flat after the root tree, never dropped
    emitted = {r["span_id"] for r in rows}
    for r in spans:
        if r["span_id"] not in emitted:
            _emit(r, 0)

    # critical path: root -> longest child at each level
    path: List[dict] = []
    cur: Optional[dict] = root
    while cur is not None:
        path.append(cur)
        kids = children.get(cur["span_id"], ())
        cur = max(kids, key=lambda r: float(r.get("dur_s", 0.0)), default=None)

    # ranked segments along the critical path: (span name/source, kind, s)
    segments: List[dict] = []
    for rec in path:
        kids = children.get(rec["span_id"], ())
        child_s = sum(float(k.get("dur_s", 0.0)) for k in kids)
        for kind, v in _decompose(rec, child_s).items():
            if v > 0.0:
                segments.append({
                    "name": rec.get("name", "?"),
                    "source": rec.get("source", f"pid:{rec.get('pid', '?')}"),
                    "kind": kind,
                    "seconds": round(v, 6),
                    "share": round(v / total, 4) if total > 0 else 0.0,
                })
    segments.sort(key=lambda s: s["seconds"], reverse=True)

    return {
        "trace_id": root.get("trace_id"),
        "name": root.get("name"),
        "outcome": root.get("outcome", "ok"),
        "total_s": round(total, 6),
        "skewed": bool(skewed),
        "spans": rows,
        "critical_path": [r["span_id"] for r in path],
        "segments": segments,
    }


def render_waterfall(report: dict, width: int = 32) -> str:
    """Markdown waterfall + ranked critical-path segments for one trace."""
    lines: List[str] = []
    tid = report.get("trace_id") or "?"
    total_ms = float(report.get("total_s", 0.0)) * 1000.0
    lines.append(f"# trace {tid} — {report.get('name', '?')} "
                 f"({total_ms:.2f} ms, outcome={report.get('outcome', 'ok')})")
    if report.get("skewed"):
        lines.append("")
        lines.append("> **CLOCK SKEW**: spans from different hosts disagree "
                     "on ordering — durations are per-host truth, offsets "
                     "and the network/other split are suspect.")
    lines.append("")
    lines.append("| span | source | start ms | dur ms | bar | breakdown |")
    lines.append("|---|---|---:|---:|---|---|")
    total = max(report.get("total_s", 0.0), 1e-9)
    critical = set(report.get("critical_path", ()))
    for row in report.get("spans", ()):
        indent = "&nbsp;" * 2 * row.get("depth", 0)
        off = int(width * (row["start_ms"] / 1000.0) / total)
        bar_len = max(1, int(width * (row["dur_ms"] / 1000.0) / total))
        bar = "·" * min(off, width - 1) + "█" * min(bar_len, width - min(off, width - 1))
        seg = " ".join(f"{k}={v:.2f}" for k, v in
                       sorted(row.get("segments_ms", {}).items(),
                              key=lambda kv: -kv[1]))
        mark = "**" if row["span_id"] in critical else ""
        outcome = "" if row.get("outcome", "ok") == "ok" \
            else f" [{row['outcome']}]"
        lines.append(
            f"| {indent}{mark}{row['name']}{mark}{outcome} | {row['source']} "
            f"| {row['start_ms']:.2f} | {row['dur_ms']:.2f} | `{bar}` | {seg} |")
    lines.append("")
    lines.append("## critical path (ranked)")
    lines.append("")
    lines.append("| rank | segment | kind | ms | share |")
    lines.append("|---:|---|---|---:|---:|")
    for i, seg in enumerate(report.get("segments", ())[:12], 1):
        lines.append(
            f"| {i} | {seg['name']} @ {seg['source']} | {seg['kind']} "
            f"| {seg['seconds'] * 1000.0:.2f} | {seg['share'] * 100.0:.1f}% |")
    return "\n".join(lines) + "\n"


def render_listing(rows: List[dict]) -> str:
    """One-line-per-trace listing for ``opsctl trace`` (GET /traces rows)."""
    if not rows:
        return "no traces retained (is tracing on? is anything shipping?)\n"
    lines = ["| trace_id | name | dur ms | outcome | keep | source |",
             "|---|---|---:|---|---|---|"]
    for r in rows:
        lines.append(
            f"| {r.get('trace_id')} | {r.get('name')} | "
            f"{r.get('dur_ms', 0.0):.2f} | {r.get('outcome', 'ok')}"
            f"{' SKEW' if r.get('skew') else ''} | {r.get('keep', '')} | "
            f"{r.get('source', '')} |")
    return "\n".join(lines) + "\n"

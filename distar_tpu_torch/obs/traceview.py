"""Trace-event analyser: from a captured ``torch.profiler`` trace to ranked
per-bucket step-time shares.

Counterpart of ``distar_tpu.obs.traceview``. ``ProfilerSession``
(obs/profiler.py) writes Chrome trace-event files under
``<logdir>/plugins/profile/<stamp>/<host>.trace.json``. The JAX analyser
reads XLA's ``hlo_op`` rows; a ``torch.profiler`` trace has none, so this
one reads its rows instead:

* on the card, the device activities: ``kernel``, ``gpu_memcpy`` and
  ``gpu_memset`` rows, each scoped by the name of the operator that
  launched it (its ``External id``) and, for a copy, by its direction
  (``h2d``, ``d2h``, ``d2d``); the module is the stream;
* where a trace holds no device rows (a CPU run), the top-level
  ``cpu_op`` rows, those no other ``cpu_op`` of their thread encloses; the
  module is the thread.

The taxonomy (``BUCKET_PATTERNS``), the report's keys, ``render_markdown``
and the ``main`` CLI are the JAX package's. The hand-written kernels
classify by their own names: ``masked_attention_kernel`` in
entity-attention, ``scatter_owner_kernel`` and
``scatter_add_onehot_kernel`` in scatter, cuBLAS and CUTLASS ``*gemm*``
kernels in matmul. Shares are rounded to 6 decimals, as the JAX report
rounds them, so they sum to 1 within about 1e-6.

Stdlib-only: the analyser runs on traces shipped off the training host.
"""
from __future__ import annotations

import gzip
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Tuple

# Classification taxonomy: first match wins, most-specific first. Patterns
# run over ``<name> <scope>`` lowercased.
BUCKET_PATTERNS: Tuple[Tuple[str, re.Pattern], ...] = (
    ("collectives", re.compile(
        r"all-reduce|all_reduce|allreduce|all-gather|all_gather|reduce-scatter|"
        r"reduce_scatter|all-to-all|collective-permute|collective_permute|"
        r"psum|ppermute|partition-id|replica-id")),
    ("host/infeed", re.compile(
        r"infeed|outfeed|copy-start|copy-done|copy_start|copy_done|"
        r"\bsend\b|\brecv\b|send-done|recv-done|host-transfer|h2d|d2h|"
        r"transferto|transferfrom")),
    ("scatter", re.compile(r"scatter|segment_sum|dynamic-update-slice|dynamic_update_slice")),
    ("entity-attention", re.compile(
        r"attention|attn|entityencoder|entity_encoder|softmax|masked_fill|"
        r"flash_attention|ring_attention")),
    ("lstm-scan", re.compile(r"lstm|\bscan\b|while|core_lstm|selected_units|pointer_decode")),
    ("matmul/MXU", re.compile(
        r"dot_general|\bdot\b|dot\.|^dot|gemm|matmul|einsum|convolution|"
        r"\bconv\b|cublas|mxu")),
)
OTHER_BUCKET = "other"
BUCKETS = tuple(name for name, _ in BUCKET_PATTERNS) + (OTHER_BUCKET,)

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_COPY_DIRECTION = (("htod", "h2d"), ("dtoh", "d2h"), ("dtod", "d2d"))


def classify(name: str, scope: str = "") -> str:
    """Bucket for one device op; ``scope`` is optional framework metadata."""
    text = f"{name} {scope}".lower()
    for bucket, pat in BUCKET_PATTERNS:
        if pat.search(text):
            return bucket
    return OTHER_BUCKET


def find_trace_files(path: str) -> List[str]:
    """Trace-event files under a profiler logdir (or the file itself),
    newest session first."""
    if os.path.isfile(path):
        return [path]
    found = []
    for dirpath, _dirnames, filenames in os.walk(path):
        for fn in filenames:
            if fn.endswith(".trace.json.gz") or fn.endswith(".trace.json"):
                found.append(os.path.join(dirpath, fn))
    found.sort(key=lambda p: (os.path.getmtime(p), p), reverse=True)
    return found


def _load_events(path: str) -> List[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8", errors="replace") as f:
        doc = json.load(f)
    if isinstance(doc, list):  # bare event-array form of the trace format
        return doc
    events = doc.get("traceEvents", [])
    return events if isinstance(events, list) else []


def _duration(e: dict) -> Optional[Tuple[str, float]]:
    """(name, dur) of a well-formed ``X`` row, else None."""
    try:
        dur = float(e.get("dur", 0.0))
        name = str(e.get("name", ""))
    except (TypeError, ValueError):
        return None
    if not name or dur < 0:
        return None
    return name, dur


def _top_level_cpu_ops(rows: List[dict]) -> List[dict]:
    """The rows no other row of their (pid, tid) encloses."""
    out = []
    rows = sorted(rows, key=lambda e: (str(e.get("pid")), str(e.get("tid")),
                                       float(e["ts"]), -float(e["dur"])))
    key, end = None, -1.0
    for e in rows:
        k = (e.get("pid"), e.get("tid"))
        ts, dur = float(e["ts"]), float(e["dur"])
        if k != key:
            key, end = k, -1.0
        if ts >= end:
            out.append(e)
            end = ts + dur
    return out


def device_op_events(events: Iterable[dict]) -> Tuple[List[dict], int]:
    """Filter to the device activities (or, in a trace with none, the
    top-level ``cpu_op`` rows); returns (ops, malformed_count). Malformed
    events (non-dict, missing or bad ``ts``/``dur``, a negative ``dur``, no
    name) are counted, never fatal: a truncated capture still reports."""
    device, cpu, op_names = [], [], {}
    malformed = 0
    for e in events:
        if not isinstance(e, dict):
            malformed += 1
            continue
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat not in DEVICE_CATS and cat != "cpu_op":
            continue
        got = _duration(e)
        try:
            ts = float(e.get("ts"))
        except (TypeError, ValueError):
            got = None
        if got is None:
            malformed += 1
            continue
        args = e.get("args") if isinstance(e.get("args"), dict) else {}
        row = {"name": got[0], "dur": got[1], "ts": ts, "pid": e.get("pid"),
               "tid": e.get("tid"), "args": args}
        if cat == "cpu_op":
            cpu.append(row)
            if "External id" in args:
                op_names[args["External id"]] = got[0]
        else:
            device.append(row)
    ops: List[dict] = []
    if device:
        for e in device:
            args = e["args"]
            scope = op_names.get(args.get("External id"), "")
            low = e["name"].lower()
            for word, direction in _COPY_DIRECTION:
                if word in low:
                    scope = f"{direction} {scope}".strip()
            ops.append({"name": e["name"], "dur_us": e["dur"],
                        "module": f"stream {args.get('stream', e['tid'])}", "scope": scope})
    else:
        for e in _top_level_cpu_ops(cpu):
            ops.append({"name": e["name"], "dur_us": e["dur"],
                        "module": f"thread {e['tid']}", "scope": ""})
    return ops, malformed


def _infer_steps(ops: List[dict], module: str) -> int:
    """Executions of ``module``: the MINIMUM per-op occurrence count over
    the module's ops (every step runs each of its ops at least once)."""
    counts: Dict[str, int] = {}
    for op in ops:
        if op["module"] == module:
            counts[op["name"]] = counts.get(op["name"], 0) + 1
    return min(counts.values()) if counts else 0


def analyze_events(events: Iterable[dict], steps: Optional[int] = None,
                   top_ops: int = 5) -> dict:
    """Aggregate device-op events into the ranked bucket report.

    ``steps`` pins the per-step divisor (the admin route knows how many
    iterations it captured); otherwise it is inferred from the dominant
    module's execution count. Bucket shares partition total device time."""
    ops, malformed = device_op_events(events)
    total_us = sum(op["dur_us"] for op in ops)
    module_us: Dict[str, float] = {}
    for op in ops:
        module_us[op["module"]] = module_us.get(op["module"], 0.0) + op["dur_us"]
    dominant = max(module_us, key=module_us.get) if module_us else ""
    inferred = _infer_steps(ops, dominant) if dominant else 0
    n_steps = int(steps) if steps else (inferred or 1)

    per_bucket: Dict[str, dict] = {
        b: {"time_us": 0.0, "events": 0, "ops": {}} for b in BUCKETS
    }
    for op in ops:
        b = per_bucket[classify(op["name"], op["scope"])]
        b["time_us"] += op["dur_us"]
        b["events"] += 1
        # per-op rollup keyed by the dotless root (dot.3/dot.4 -> dot)
        root = op["name"].split(".")[0] or op["name"]
        agg = b["ops"].setdefault(root, [0.0, 0])
        agg[0] += op["dur_us"]
        agg[1] += 1

    buckets = []
    for name, b in per_bucket.items():
        if not b["events"]:
            continue
        ranked_ops = sorted(b["ops"].items(), key=lambda kv: -kv[1][0])[:top_ops]
        buckets.append({
            "bucket": name,
            "time_us": round(b["time_us"], 3),
            "share": round(b["time_us"] / total_us, 6) if total_us else 0.0,
            "events": b["events"],
            "per_step_us": round(b["time_us"] / max(n_steps, 1), 3),
            "top_ops": [
                {"op": op_name, "time_us": round(us, 3), "count": count}
                for op_name, (us, count) in ranked_ops
            ],
        })
    buckets.sort(key=lambda b: -b["time_us"])
    return {
        "total_device_us": round(total_us, 3),
        "device_op_events": len(ops),
        "malformed_events": malformed,
        "steps": n_steps,
        "steps_inferred": inferred,
        "dominant_module": dominant,
        "modules": {
            m: round(us, 3) for m, us in
            sorted(module_us.items(), key=lambda kv: -kv[1])
        },
        "step_time_device_us": round(total_us / max(n_steps, 1), 3),
        "buckets": buckets,
    }


def analyze_trace(path: str, steps: Optional[int] = None) -> dict:
    """Analyse one trace file (or the newest capture under a logdir)."""
    files = find_trace_files(path)
    if not files:
        raise FileNotFoundError(f"no *.trace.json(.gz) under {path!r}")
    report = analyze_events(_load_events(files[0]), steps=steps)
    report["trace_path"] = files[0]
    return report


def render_markdown(report: dict) -> str:
    """The ranked bucket table as markdown."""
    lines = [
        "| bucket | step-time share | per-step ms | total ms | events | top ops |",
        "|---|---|---|---|---|---|",
    ]
    for b in report.get("buckets", []):
        tops = ", ".join(
            f"{o['op']} ({o['time_us'] / 1e3:.2f}ms)" for o in b.get("top_ops", [])[:3]
        )
        lines.append(
            f"| {b['bucket']} | {b['share'] * 100:.1f}% "
            f"| {b['per_step_us'] / 1e3:.2f} | {b['time_us'] / 1e3:.2f} "
            f"| {b['events']} | {tops} |"
        )
    total_ms = report.get("total_device_us", 0.0) / 1e3
    lines.append(
        f"\ndevice time {total_ms:.2f} ms over {report.get('steps', 1)} step(s) "
        f"({report.get('device_op_events', 0)} device-op events, "
        f"module {report.get('dominant_module') or '?'})"
    )
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import sys

    p = argparse.ArgumentParser(
        description="rank device-op buckets from a torch.profiler trace")
    p.add_argument("path", help="trace file or profiler logdir")
    p.add_argument("--steps", type=int, default=0,
                   help="iterations captured (default: inferred)")
    p.add_argument("--json", default="", help="also write the JSON report here")
    args = p.parse_args(argv)
    report = analyze_trace(args.path, steps=args.steps or None)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    sys.stdout.write(render_markdown(report) + "\n")
    return 0


if __name__ == "__main__":  # pragma: no cover - CLI shim
    raise SystemExit(main())

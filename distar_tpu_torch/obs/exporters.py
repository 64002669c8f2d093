"""Registry exporters: Prometheus text exposition and JSON responses.

Counterpart of ``distar_tpu.obs.exporters``. Prometheus rendering follows
the text exposition format (v0.0.4): counters and gauges render one sample
per labelset; histograms render as summaries (quantile-labelled samples +
``_sum``/``_count``), which matches their bounded-reservoir semantics.
``handle_health_get`` answers the fleet-health routes (``/healthz``,
``/alerts``, ``/timeseries``, ``/traces``, ``/trace/<id>``) on every HTTP
surface, as the JAX package's does. ``JsonlExporter`` writes registry
snapshots as JSON lines.
"""
from __future__ import annotations

import json
import math
from typing import Optional

from .registry import MetricsRegistry, get_registry

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_QUANTILES = (0.5, 0.9, 0.99)


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v: float) -> str:
    v = float(v)
    # non-finite values per the Prometheus text format: "NaN", "+Inf",
    # "-Inf" — repr() would emit "nan"/"inf", which scrapers reject
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _labels_text(key, extra: str = "") -> str:
    parts = [f'{k}="{_escape_label(v)}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def render_prometheus(registry: Optional[MetricsRegistry] = None) -> str:
    """Render the registry in Prometheus text exposition format."""
    registry = registry or get_registry()
    lines = []
    for fam in registry.collect():
        name, kind = fam["name"], fam["type"]
        prom_type = {"counter": "counter", "gauge": "gauge", "histogram": "summary"}[kind]
        if fam["help"]:
            lines.append(f"# HELP {name} {_escape_help(fam['help'])}")
        lines.append(f"# TYPE {name} {prom_type}")
        for key, inst in fam["series"]:
            if kind == "histogram":
                qs = inst.quantiles(_QUANTILES)
                for q in _QUANTILES:
                    qlabel = 'quantile="%s"' % q
                    lines.append(f"{name}{_labels_text(key, qlabel)} {_fmt(qs[q])}")
                lines.append(f"{name}_sum{_labels_text(key)} {_fmt(inst.sum)}")
                lines.append(f"{name}_count{_labels_text(key)} {_fmt(inst.count)}")
            else:
                lines.append(f"{name}{_labels_text(key)} {_fmt(inst.value)}")
    return "\n".join(lines) + "\n" if lines else ""


def write_scrape_response(handler, refresh=None, registry: Optional[MetricsRegistry] = None) -> None:
    """Answer a ``GET /metrics`` scrape on a ``BaseHTTPRequestHandler``.

    The one scrape route every HTTP surface shares (coordinator broker,
    serve gateway): run ``refresh()`` (scrape-time gauge publication), render
    the registry, write the response. A failing refresh/render answers 500
    with the repr — a scrape must never wedge the serving process."""
    try:
        if refresh is not None:
            refresh()
        data = render_prometheus(registry).encode()
        status, ctype = 200, PROMETHEUS_CONTENT_TYPE
    except Exception as e:
        data = repr(e).encode()
        status, ctype = 500, "text/plain"
    handler.send_response(status)
    handler.send_header("Content-Type", ctype)
    handler.send_header("Content-Length", str(len(data)))
    handler.end_headers()
    handler.wfile.write(data)


def write_json_response(handler, obj, status: int = 200) -> None:
    """Answer a GET with a JSON body on a ``BaseHTTPRequestHandler``."""
    data = json.dumps(obj, default=str).encode()
    handler.send_response(status)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(data)))
    handler.end_headers()
    handler.wfile.write(data)


def handle_health_get(handler, path: str) -> bool:
    """Answer the fleet-health GET routes shared by every HTTP surface
    (coordinator broker, serve gateway, replay admin):

      GET /healthz                           overall state + per-source staleness
                                             (HTTP 503 while any rule is firing)
      GET /alerts                            per-rule states + transition history
      GET /timeseries?name=&window_s=&source=  windowed stats + raw points
      GET /traces?name=&min_ms=&outcome=&limit=  retained trace listings
                                             (shipped ingest + this process's
                                             tail-sampled buffer)
      GET /trace/<id>                        one trace's span records + the
                                             assembled waterfall report

    Returns False when ``path`` is not a health route (caller 404s). Route
    failures answer 500 — an ops probe must never wedge the serving process."""
    from urllib.parse import parse_qs, urlparse

    parsed = urlparse(path)
    route = parsed.path.rstrip("/")
    if route not in ("/healthz", "/alerts", "/timeseries", "/traces") \
            and not route.startswith("/trace/"):
        return False
    try:
        from .health import get_fleet_health

        fleet = get_fleet_health()
        if route == "/healthz":
            body = fleet.healthz()
            write_json_response(handler, body,
                                status=503 if body["status"] == "firing" else 200)
        elif route == "/alerts":
            write_json_response(handler, fleet.evaluator.alerts())
        elif route == "/traces":
            from .tracestore import _listing, get_trace_buffer

            q = parse_qs(parsed.query)
            name = (q.get("name") or [None])[0] or None
            outcome = (q.get("outcome") or [None])[0] or None
            min_ms = float((q.get("min_ms") or ["0"])[0])
            limit = int((q.get("limit") or ["50"])[0])
            rows = fleet.traces.query(name=name, min_ms=min_ms,
                                      outcome=outcome, limit=limit)
            # the process's OWN tail-sampled buffer answers too, so a lone
            # gateway/store is inspectable without a coordinator in front
            for rec in get_trace_buffer().records():
                if name and rec.get("name") != name:
                    continue
                if outcome and rec.get("outcome", "ok") != outcome:
                    continue
                if float(rec.get("dur_s", 0.0)) * 1000.0 < min_ms:
                    continue
                rows.append(_listing(rec, "local"))
            rows.sort(key=lambda r: r["dur_ms"], reverse=True)
            write_json_response(handler, {
                "traces": rows[:limit],
                "ingest": fleet.traces.stats(),
                "buffer": get_trace_buffer().stats(),
            })
        elif route.startswith("/trace/"):
            from .tracestore import get_trace_buffer
            from .waterfall import build_waterfall

            trace_id = route.rsplit("/", 1)[1]
            spans = fleet.traces.get(trace_id)
            seen = {r.get("span_id") for r in spans}
            for rec in get_trace_buffer().get(trace_id):
                if rec.get("span_id") not in seen:
                    rec = dict(rec)
                    rec["source"] = "local"
                    spans.append(rec)
            if not spans:
                write_json_response(
                    handler, {"error": f"no spans for trace {trace_id!r}"},
                    status=404)
                return True
            write_json_response(handler, {
                "trace_id": trace_id,
                "spans": spans,
                "waterfall": build_waterfall(spans),
            })
        else:
            q = parse_qs(parsed.query)
            name = (q.get("name") or [""])[0]
            if not name:
                write_json_response(
                    handler, {"error": "query parameter 'name' is required"}, status=400
                )
                return True
            window_s = float((q.get("window_s") or ["300"])[0])
            source = (q.get("source") or [None])[0]
            points = fleet.store.points(name, window_s=window_s, source=source)
            stats = {
                s: fleet.store.query(name, window_s=window_s, source=s)
                for s in points
            }
            write_json_response(handler, {
                "name": name,
                "window_s": window_s,
                "stats": stats,
                "points": points,
            })
    except Exception as e:
        write_json_response(handler, {"error": repr(e)}, status=500)
    return True


class JsonlExporter:
    """Registry snapshots into the JSON-lines scalar stream: each
    ``export(step)`` writes one line per scalar of the flattened snapshot
    through ``utils.log.ScalarSink`` (always JSON lines), so tooling that
    tails ``scalars.jsonl`` reads the registry's series too."""

    def __init__(self, path: str, registry: Optional[MetricsRegistry] = None):
        from ..utils.log import ScalarSink

        self._sink = ScalarSink(path, force_jsonl=True)
        self._registry = registry

    def export(self, step: int = 0) -> int:
        """Write the current snapshot; returns the number of scalars."""
        snap = (self._registry or get_registry()).snapshot()
        self._sink.add_scalars(snap, global_step=step)
        return len(snap)

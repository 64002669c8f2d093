"""Registry exporters: Prometheus text exposition and JSON responses.

Counterpart of ``distar_tpu.obs.exporters``. Prometheus rendering follows
the text exposition format (v0.0.4): counters and gauges render one sample
per labelset; histograms render as summaries (quantile-labelled samples +
``_sum``/``_count``), which matches their bounded-reservoir semantics.

Not here yet: the fleet-health routes (``/healthz``, ``/alerts``,
``/timeseries``, ``/traces``, ``/trace/<id>``) answer 404 through
``handle_health_get`` until ``obs/health.py`` is ported (ROADMAP Queue 1
item 9). ``JsonlExporter`` writes registry snapshots as JSON lines.
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


HEALTH_ROUTES = ("/healthz", "/alerts", "/timeseries", "/traces")


def handle_health_get(handler, path: str) -> bool:
    """The fleet-health GET routes of every HTTP surface. Until
    ``obs/health.py`` is ported (ROADMAP Queue 1 item 9) each answers 404
    with a JSON body saying so. Returns False when ``path`` is not a health
    route (the caller answers it)."""
    from urllib.parse import urlparse

    route = urlparse(path).path.rstrip("/")
    if route not in HEALTH_ROUTES and not route.startswith("/trace/"):
        return False
    write_json_response(handler, {"error": f"{route} needs fleet health (obs/health.py), which the "
                                           f"port has not ported yet: ROADMAP Queue 1 item 9"},
                        status=404)
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

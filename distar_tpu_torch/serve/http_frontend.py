"""Stdlib HTTP/JSON frontend: control plane + light data plane.

Counterpart of ``distar_tpu.serve.http_frontend``: a ThreadingHTTPServer
whose POST routes answer ``{"code": 0, "info": ...}`` with HTTP 200 and
serve errors as their typed wire dict (``{"code": "shed_queue_full",
"shed": true, ...}``). Observation arrays JSON-ify as nested lists — fine
for showmatch and eval callers; actor-grade traffic belongs on the
framed-TCP data plane (``tcp_frontend``), which carries real numpy.

Routes:
  POST /serve/act     {session_id, obs, timeout_s?}
  POST /serve/reset   {session_id}
  POST /serve/end     {session_id}
  POST /serve/load    {version, source, activate?}
  POST /serve/swap    {version}
  POST /serve/status  {}
  POST /serve/drain   {}   -> begin graceful retirement (idempotent)
  GET  /metrics       Prometheus scrape (shared obs helper)
  GET  /healthz /alerts /timeseries /traces /trace/<id>
                      fleet health (shared obs helper)

Drain contract: after ``POST /serve/drain`` a shed NEW request answers
HTTP **503** with the typed ``DrainingError`` wire body (every other typed
serve error keeps the 200-with-wire-dict shape), while requests admitted
before the drain complete normally. A ``traceparent`` header joins the
frontend's span to the caller's trace and is echoed on the response.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from .errors import DrainingError, ServeError


def jsonable(obj):
    """numpy trees -> plain JSON types (arrays to nested lists)."""
    if isinstance(obj, dict):
        return {k: jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    return obj


def arrayify(obj):
    """JSON obs -> numpy trees (lists/scalars to arrays; dicts recurse)."""
    if isinstance(obj, dict):
        return {k: arrayify(v) for k, v in obj.items()}
    if isinstance(obj, (list, int, float)):
        return np.asarray(obj)
    return obj


class ServeHTTPServer:
    def __init__(self, gateway, host: str = "127.0.0.1", port: int = 0):
        root = gateway

        def routes(name: str, body: dict, trace=None):
            # multiplexed gateways resolve the optional ``player`` field
            # (absent = default player; single-model gateways ignore it)
            gw = root
            if hasattr(gw, "resolve"):
                gw = gw.resolve(body.get("player"))
            if name == "act":
                out = gw.act(
                    body["session_id"], arrayify(body["obs"]), body.get("timeout_s"),
                    trace=trace,
                )
                return jsonable(out)
            if name == "reset":
                return {"reset": gw.reset_session(body["session_id"])}
            if name == "end":
                return {"ended": gw.end_session(body["session_id"])}
            if name == "load":
                return gw.load_version(
                    body["version"], source=body["source"],
                    activate=bool(body.get("activate", False)),
                )
            if name == "swap":
                return {"generation": gw.activate_version(body["version"])}
            if name == "status":
                return gw.status()
            if name == "drain":
                # drain is ADDRESS-level (never per-player): begin graceful
                # retirement of the whole serving process
                if not hasattr(root, "begin_drain"):
                    raise ServeError("target has no drain surface")
                return root.begin_drain()
            return None

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                from ..obs import handle_health_get, write_scrape_response

                if self.path.rstrip("/") == "/metrics":
                    write_scrape_response(self)
                    return
                if handle_health_get(self, self.path):
                    return
                self.send_response(404)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_POST(self):
                from ..obs import (
                    finish_trace,
                    format_traceparent,
                    join_trace,
                    parse_traceparent,
                    wire_ctx,
                )

                name = self.path.strip("/").split("/")[-1]
                length = int(self.headers.get("Content-Length", 0))
                status = 200
                # w3c traceparent propagation: a caller-supplied header joins
                # this frontend's span under the caller's trace_id, and the
                # gateway span joins under THAT — client-minted and
                # server-side spans assemble into one waterfall
                wire = parse_traceparent(self.headers.get("traceparent"))
                ctx = join_trace(wire, f"http_{name}") if wire is not None else None
                outcome = "ok"
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                    info = routes(name, body,
                                  trace=wire_ctx(ctx) if ctx is not None else None)
                    payload = (
                        {"code": 404, "info": f"no route {name}"}
                        if info is None
                        else {"code": 0, "info": info}
                    )
                except DrainingError as e:
                    # the drain contract: shed-while-draining is visible at
                    # the HTTP layer too (load balancers and dumb probes key
                    # on the status line, not the body) — 503 + typed body
                    payload = e.to_wire()
                    status = 503
                    outcome = "shed"
                except ServeError as e:
                    payload = e.to_wire()
                    outcome = "shed" if e.shed else "error"
                except Exception as e:
                    payload = {"code": 1, "info": repr(e)}
                    outcome = "error"
                if ctx is not None and isinstance(payload, dict):
                    payload.setdefault("trace_id", ctx["trace_id"])
                data = json.dumps(payload, default=str).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                if ctx is not None:
                    # echo the joined context so HTTP callers can correlate
                    self.send_header("traceparent", format_traceparent(ctx))
                    finish_trace(ctx, "http_done", outcome=outcome)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._server.server_address
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ServeHTTPServer":
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        # reap the serve loop before closing its socket under it
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self._server.server_close()

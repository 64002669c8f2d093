"""The learner's live admin API.

Counterpart of ``distar_tpu.learner.admin``: ``POST
/learner/<status|save_ckpt|update_config|reset_value|profile>`` with a JSON
body answers ``{"code": 0, "info": ...}``, 404 for an unknown route or one
the learner lacks, 1 with the error's repr when the route raised. The
server only queues a request; the learner applies it at the next iteration
boundary, never inside a step. ``POST /learner/profile?steps=N`` is the
exception to fire-and-forget: it arms a bounded ``torch.profiler`` capture
that the run loop starts and stops at iteration boundaries, blocks until
the trace is analysed (``obs/traceview.py``) and answers the ranked
per-bucket report.
"""
from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional


class LearnerAdminServer:
    def __init__(self, learner, host: str = "127.0.0.1", port: int = 0):
        self.learner = learner

        def routes(name: str, body: dict, query: dict):
            if name == "update_config":
                if not hasattr(learner, "request_update_config"):
                    return None  # the SL learner takes no config patches
                learner.request_update_config(body.get("config", {}))
                return "queued"
            if name == "reset_value":
                if not hasattr(learner, "request_value_reset"):
                    return None
                learner.request_value_reset()
                return "queued"
            if name == "save_ckpt":
                learner.request_save()
                return "queued"
            if name == "status":
                return {"last_iter": learner.last_iter.val,
                        "meters": {k: m.avg for k, m in learner.variable_record.vars().items()},
                        "perf": learner._perf.snapshot()}
            if name == "profile":
                return learner.request_profile(
                    steps=int(query.get("steps", body.get("steps", 2))),
                    timeout_s=float(query.get("timeout_s", body.get("timeout_s", 600.0))))
            return None

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_POST(self):
                parsed = urllib.parse.urlsplit(self.path)
                name = parsed.path.strip("/").split("/")[-1]
                query = {k: v[-1] for k, v in urllib.parse.parse_qs(parsed.query).items()}
                length = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                    info = routes(name, body, query)
                    payload = ({"code": 404, "info": f"no route {name}"} if info is None
                               else {"code": 0, "info": info})
                except Exception as e:  # noqa: BLE001 - answered to the caller
                    payload = {"code": 1, "info": repr(e)}
                data = json.dumps(payload, default=str).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._server.server_address
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def stop(self):
        self._server.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self._server.server_close()

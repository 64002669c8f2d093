"""Coordinator: token-keyed metadata broker for the peer-to-peer data plane.

Counterpart of ``distar_tpu.comm.coordinator``. Producers register
"endpoint at ip:port" records under a token; consumers pop a record
(``ask``) or list a token's live records without consuming them (``peers``,
the service-discovery read) and connect directly: the broker never touches
payloads. Registrations may carry a lease that heartbeats refresh; an
endpoint whose lease lapses is evicted, one that leaves gracefully
``unregister``-s at once, and one that fails fetches is dropped after five
strikes.

``CoordinatorServer`` answers the same HTTP/JSON routes as the JAX
package's (``POST /coordinator/<route>``, ``GET /metrics``), so either
package's ``coordinator_request`` talks to either's server. The arena and
league routes (``arena_*``, ``league_*``, ``GET /league/status``,
``/arena/ratings``, ``/arena/payoff``) answer from the process-global
``ArenaStore`` and ``LeagueService`` when this process hosts them, and as
the JAX coordinator does when it does not. ``telemetry`` folds a shipped
snapshot (an ``application/x-distar-serialized`` body, the comm
serializer's codec) into the process fleet health's store and trace store,
and an endpoint that leaves (its lease lapses, or it unregisters) takes
its shipped series and traces with it (``add_evict_callback``); the
fleet-health GET routes answer from the same handle
(``obs.handle_health_get``). The coordinator's high availability (``comm/ha.py``: journaled state, leader
failover, the multi-address client) is item 11: ``attach_ha`` and an
address list given to ``coordinator_request`` raise
``NotImplementedError``.
"""
from __future__ import annotations

import json
import threading
import time
from collections import defaultdict, deque
from typing import Dict, Optional

#: the ROADMAP item that brings the surfaces not ported yet
HA_ITEM = "ROADMAP Queue 1 item 11"


class Coordinator:
    def __init__(self, maxlen_per_token: int = 512, max_age_s: Optional[float] = None,
                 default_lease_s: Optional[float] = None):
        """``max_age_s``: the age filter ``depth()`` and ``stats()`` apply
        by default (records older than the producers' serve window are
        loss, not backlog); None = no filtering. ``default_lease_s``: the
        lease of every registration that passes no ``lease_s`` of its own;
        None = such registrations never expire by lease."""
        self._maxlen = maxlen_per_token
        self._max_age_s = max_age_s
        self._default_lease_s = default_lease_s
        self._records: Dict[str, deque] = defaultdict(lambda: deque(maxlen=self._maxlen))
        self._strikes: Dict[str, int] = defaultdict(int)
        # "ip:port" -> monotonic expiry: a wall-clock step can neither evict
        # a healthy fleet nor keep dead endpoints alive (record ages in
        # depth()/stats() stay wall-clock: they describe data, not liveness)
        self._leases: Dict[str, float] = {}
        self._last_sweep = 0.0  # monotonic
        self._evict_callbacks: list = []
        self._lock = threading.RLock()

    def add_evict_callback(self, fn) -> None:
        """Subscribe to endpoint departures: ``fn("ip:port")`` runs whenever
        an endpoint's records leave the broker through the lease sweep or
        an explicit ``unregister`` (not per-fetch strikes: a struck endpoint
        may still be alive). Callbacks run under the broker lock, must be
        quick and never call back into the coordinator; their exceptions
        are swallowed. ``TelemetryIngest`` evicts a departed member's TSDB
        series through this."""
        with self._lock:
            self._evict_callbacks.append(fn)

    def _notify_evicted(self, key: str) -> None:
        for fn in self._evict_callbacks:
            try:
                fn(key)
            except Exception:  # noqa: BLE001 - observers must not break the broker
                pass

    def register(self, token: str, ip: str, port: int, meta: Optional[dict] = None,
                 lease_s: Optional[float] = None) -> bool:
        lease_s = self._default_lease_s if lease_s is None else lease_s
        with self._lock:
            self._records[token].append({"ip": ip, "port": port, "meta": meta or {}, "ts": time.time()})
            if lease_s is not None:
                self._leases[f"{ip}:{port}"] = time.monotonic() + lease_s
            return True

    def heartbeat(self, ip: str, port: int, lease_s: Optional[float] = None) -> bool:
        """Refresh an endpoint's lease. True when the broker still holds
        records for it; False tells the producer its records are gone
        (broker restarted, or evicted) and it must register again."""
        lease_s = self._default_lease_s if lease_s is None else lease_s
        key = f"{ip}:{port}"
        with self._lock:
            self._sweep_leases()
            if lease_s is not None:
                self._leases[key] = time.monotonic() + lease_s
            from ..obs import get_registry

            get_registry().counter(
                "distar_coordinator_heartbeats_total", "endpoint lease refreshes"
            ).inc()
            return any(f"{r['ip']}:{r['port']}" == key for q in self._records.values() for r in q)

    def _purge_endpoint(self, key: str) -> int:
        """Drop every record registered by ``key`` ("ip:port"): the removal
        behind strikes, lease eviction and unregister. Caller holds lock."""
        removed = 0
        for q in self._records.values():
            dead = [r for r in q if f"{r['ip']}:{r['port']}" == key]
            for r in dead:
                q.remove(r)
            removed += len(dead)
        self._strikes.pop(key, None)
        self._leases.pop(key, None)
        return removed

    def _sweep_leases(self, min_interval_s: float = 1.0) -> None:
        """Evict endpoints whose lease expired, at most once per
        ``min_interval_s`` (the read paths call this). Caller holds lock."""
        now = time.monotonic()
        if now - self._last_sweep < min_interval_s:
            return
        self._last_sweep = now
        expired = [k for k, exp in self._leases.items() if exp < now]
        if not expired:
            return
        from ..obs import get_registry

        evictions = get_registry().counter(
            "distar_coordinator_evictions_total", "endpoints evicted on lease expiry")
        for key in expired:
            self._purge_endpoint(key)
            evictions.inc()
            self._notify_evicted(key)

    def unregister(self, ip: str, port: int) -> int:
        """Graceful departure: drop every record of ``ip:port`` now (a
        draining member leaves discovery before it sheds, not ``lease_s``
        later). Returns the number of records removed."""
        key = f"{ip}:{port}"
        with self._lock:
            removed = self._purge_endpoint(key)
            from ..obs import get_registry

            get_registry().counter(
                "distar_coordinator_unregisters_total",
                "endpoints that deregistered gracefully (drain path)",
            ).inc()
            self._notify_evicted(key)
            return removed

    def ask(self, token: str) -> Optional[dict]:
        """Pop the oldest ready record for a token (None when empty)."""
        with self._lock:
            self._sweep_leases()
            q = self._records.get(token)
            if not q:
                return None
            return q.popleft()

    def peers(self, token: str) -> list:
        """A token's live records, not consumed (``ask`` pops): the
        service-discovery read. The lease sweep runs first, so an evicted
        endpoint never appears in a fresh map."""
        with self._lock:
            self._sweep_leases()
            return [dict(r) for r in self._records.get(token, ())]

    _UNSET = object()  # sentinel: "use the instance default max_age_s"

    @staticmethod
    def _filtered_len(q, max_age_s: Optional[float]) -> int:
        if max_age_s is None:
            return len(q)
        cutoff = time.time() - max_age_s
        return sum(1 for r in q if r.get("ts", 0) >= cutoff)

    def depth(self, token: str, max_age_s=_UNSET) -> int:
        """Registered but unconsumed records for a token, without those
        older than ``max_age_s`` (the instance default unless given)."""
        if max_age_s is Coordinator._UNSET:
            max_age_s = self._max_age_s
        with self._lock:
            self._sweep_leases()
            q = self._records.get(token)
            if not q:
                return 0
            return self._filtered_len(q, max_age_s)

    def strike(self, ip: str, port: int) -> None:
        """Report a dead producer endpoint; 5 strikes purge its records."""
        key = f"{ip}:{port}"
        with self._lock:
            self._strikes[key] += 1
            if self._strikes[key] >= 5:
                self._purge_endpoint(key)

    def stats(self, max_age_s=_UNSET) -> dict:
        """Per-token depth under the same age filter as ``depth()``; pass
        ``max_age_s=None`` for raw lengths."""
        if max_age_s is Coordinator._UNSET:
            max_age_s = self._max_age_s
        with self._lock:
            self._sweep_leases()
            return {token: self._filtered_len(q, max_age_s) for token, q in self._records.items()}

    def publish_metrics(self, registry=None) -> None:
        """Refresh the ``distar_coordinator_queue_depth{token=...}`` gauges
        and the strike gauge; the /metrics route calls this at scrape time."""
        from ..obs import get_registry

        reg = registry or get_registry()
        for token, depth in self.stats().items():
            reg.gauge("distar_coordinator_queue_depth", "broker backlog per token (age-filtered)",
                      token=token).set(depth)
        with self._lock:
            strikes = sum(self._strikes.values())
        reg.gauge("distar_coordinator_endpoint_strikes", "outstanding dead-endpoint strikes").set(strikes)


class CoordinatorServer:
    """HTTP wrapper: ``POST /coordinator/<route>`` with a JSON body (the
    ``telemetry`` route: a serialized one) answers ``{"code": 0, "info":
    ...}`` (1 with the error's repr when the route raised, 404 for an
    unknown route); ``GET /metrics`` is the Prometheus scrape, and the
    fleet-health routes answer JSON."""

    def __init__(self, coordinator: Optional[Coordinator] = None, host="127.0.0.1", port=0):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.coordinator = coordinator or Coordinator()
        co = self.coordinator

        def _ingest_telemetry(msg: dict) -> int:
            # fold shipped snapshots into the process fleet store: the broker
            # is the one place that sees every actor, learner and gateway
            from ..obs import get_fleet_health

            return get_fleet_health().ingest.ingest(msg)

        def _evict_telemetry(key: str) -> None:
            # an endpoint left (lease lapsed or graceful unregister): free
            # its series and traces, so a churning fleet cannot exhaust the
            # series cap (the ingest maps endpoint -> shipped sources)
            from ..obs import get_fleet_health

            get_fleet_health().ingest.evict_endpoint(key)

        co.add_evict_callback(_evict_telemetry)
        routes = {
            # explicit arguments, never **body: a wire body reaches no other
            # keyword of the broker
            "register": lambda b: co.register(b["token"], b["ip"], b["port"], meta=b.get("meta"),
                                              lease_s=b.get("lease_s")),
            "ask": lambda b: co.ask(b["token"]),
            "peers": lambda b: co.peers(b["token"]),
            "strike": lambda b: co.strike(b["ip"], b["port"]),
            "heartbeat": lambda b: co.heartbeat(b["ip"], b["port"], lease_s=b.get("lease_s")),
            "unregister": lambda b: co.unregister(b["ip"], b["port"]),
            # no max_age_s: the coordinator's own default filter
            "stats": lambda b: co.stats(b["max_age_s"]) if "max_age_s" in b else co.stats(),
            "depth": lambda b: (co.depth(b["token"], b["max_age_s"]) if "max_age_s" in b
                                else co.depth(b["token"])),
            "telemetry": _ingest_telemetry,
            # the arena's wire plane (served when this process hosts the
            # ArenaStore; its idempotent keys make arena_report exactly-once
            # even when the retry policy replays a POST)
            "arena_next": lambda b: _arena_call("next_match", b.get("players", []),
                                                episodes=int(b.get("episodes", 8))),
            "arena_report": lambda b: _arena_call("report_batch", b.get("matches", [])),
            # the league runtime's (served when this process hosts the
            # LeagueService; the body is passed whole, the service does its
            # own explicit field extraction)
            "league_register": lambda b: _league_call("register_learner", b),
            "league_ask": lambda b: _league_call("ask_job", b),
            "league_report": lambda b: _league_call("report", b),
            "league_train_info": lambda b: _league_call("train_info", b),
            "league_status": lambda b: _league_call("status", b),
        }

        def _arena_call(method: str, *args, **kwargs):
            from ..arena import get_arena_store

            store = get_arena_store()
            if store is None:
                raise RuntimeError("no arena store hosted on this coordinator")
            return getattr(store, method)(*args, **kwargs)

        def _league_call(method: str, body: dict):
            from ..league.runtime import get_league_service

            service = get_league_service()
            if service is None:
                raise RuntimeError("no league service hosted on this coordinator")
            return getattr(service, method)(body)

        def _hosted_snapshot(path: str):
            """The GET snapshot of the arena store or league service this
            process hosts at ``path``; None when it hosts none (404)."""
            if path == "/league/status":
                from ..league.runtime import get_league_service

                service = get_league_service()
                return None if service is None else service.status()
            from ..arena import get_arena_store

            store = get_arena_store()
            if store is None:
                return None
            return store.ratings_snapshot() if path.endswith("ratings") else store.payoff_snapshot()

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                """GET /metrics: the process registry in Prometheus text (the
                queue-depth gauges refreshed at scrape time); GET
                /league/status, /arena/ratings and /arena/payoff: the hosted
                league service's and arena store's snapshots (404 where none
                is hosted); GET /healthz, /alerts, /timeseries, /traces and
                /trace/<id>: fleet-health JSON."""
                from ..obs import handle_health_get, write_json_response, write_scrape_response

                path = self.path.rstrip("/")
                if path == "/metrics":
                    write_scrape_response(self, refresh=co.publish_metrics)
                    return
                if path in ("/league/status", "/arena/ratings", "/arena/payoff"):
                    snap = _hosted_snapshot(path)
                    if snap is not None:
                        write_json_response(self, snap)
                        return
                elif handle_health_get(self, self.path):
                    return
                self.send_response(404)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_POST(self):
                from ..obs import finish_trace, format_traceparent, join_trace, parse_traceparent

                name = self.path.strip("/").split("/")[-1]
                length = int(self.headers.get("Content-Length", 0))
                # a caller's w3c traceparent joins this route's span
                wire = parse_traceparent(self.headers.get("traceparent"))
                ctx = join_trace(wire, f"coordinator_{name}") if wire is not None else None
                outcome = "ok"
                try:
                    raw = self.rfile.read(length)
                    if name == "telemetry" and self.headers.get("Content-Type", "").startswith(
                            "application/x-distar"):
                        # shipped snapshots ride the comm serializer's codec
                        # (pickle+LZ4), the data plane's, not JSON
                        from .serializer import loads as _loads

                        body = _loads(raw)
                    else:
                        body = json.loads(raw or b"{}")
                    fn = routes.get(name)
                    if fn is None:
                        payload = {"code": 404, "info": f"no route {name}"}
                    else:
                        payload = {"code": 0, "info": fn(body)}
                except Exception as e:
                    payload = {"code": 1, "info": repr(e)}
                    outcome = "error"
                data = json.dumps(payload, default=str).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                if ctx is not None:
                    self.send_header("traceparent", format_traceparent(ctx))
                    finish_trace(ctx, "coordinator_done", outcome=outcome)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._server.server_address
        self._thread: Optional[threading.Thread] = None

    def attach_ha(self, ha_state) -> None:
        raise NotImplementedError(f"coordinator high availability (comm/ha.py) is not ported yet "
                                  f"({HA_ITEM})")

    def start(self):
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def stop(self):
        self._server.shutdown()
        # reap the serve loop before closing its socket under it
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self._server.server_close()


def _coordinator_request_once(host: str, port: int, route: str, body: Optional[dict],
                              timeout: float) -> dict:
    """One transport attempt; a typed ``CommError`` instead of a raw
    ``URLError``, timeout or JSON-decode exception."""
    import urllib.error
    import urllib.request

    from ..resilience import CommError

    op = f"coordinator:{route}"
    req = urllib.request.Request(
        f"http://{host}:{port}/coordinator/{route}", data=json.dumps(body or {}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read())
    except (urllib.error.URLError, ConnectionError, TimeoutError, OSError, ValueError) as e:
        # ValueError: a truncated JSON body from a peer dying mid-response,
        # as transient as the connection reset it really is
        raise CommError(f"{op} @ {host}:{port} failed: {e!r}", op=op, cause=e) from e


def coordinator_request(host: str, port: Optional[int], route: str, body: Optional[dict] = None,
                        timeout=10.0, policy=None):
    """Broker RPC to one coordinator under the resilience retry policy
    (``resilience.DEFAULT_COMM_POLICY`` rides through a broker restart of
    a few seconds; ``resilience.NO_RETRY`` makes one attempt). Raises
    ``resilience.CommError`` once the policy is exhausted.

    An address list (``"h1:p1,h2:p2"`` as ``host`` with ``port=None``) is
    the JAX package's HA client, not ported yet: NotImplementedError."""
    from ..resilience import DEFAULT_COMM_POLICY, retry_call

    if port is None or (isinstance(host, str) and "," in host):
        spec = host if port is None else f"{host}:{port}"
        addrs = [a for a in str(spec).split(",") if a.strip()]
        if len(addrs) != 1:
            raise NotImplementedError(f"coordinator address list {spec!r}: the HA client "
                                      f"(comm/ha.py) is not ported yet ({HA_ITEM})")
        host, _, p = addrs[0].strip().rpartition(":")
        host, port = host or "127.0.0.1", int(p)
    return retry_call(_coordinator_request_once, host, port, route, body, timeout,
                      op=f"coordinator:{route}", policy=policy or DEFAULT_COMM_POLICY)

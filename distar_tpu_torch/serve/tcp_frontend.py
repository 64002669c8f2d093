"""Framed-TCP data plane for actor-grade serve callers.

Counterpart of ``distar_tpu.serve.tcp_frontend``. Wire format =
``comm.serializer``: 8-byte big-endian length prefix around a pickled (and
compressed) payload, so obs trees with real numpy arrays round-trip
losslessly. One request/response pair per frame; the ``session_id`` field
is authoritative, so a pool of connections can front many sessions.

Requests are ``{"op": ..., ...}`` dicts:
  hello    {transports?, codecs?, host?}   -> {code: 0, transport, shm_*?}
  act      {session_id, obs, timeout_s?, want_teacher?} -> {code: 0, outputs}
  act_many {requests: [{session_id, obs, want_teacher?}], timeout_s?}
                                           -> {code: 0, results: [entry]}
                                              entry = {ok: outputs} | wire error
  reserve  {session_ids: [...]}            -> {code: 0, slots: {sid: slot}}
  hidden   {session_id}                    -> {code: 0, hidden}
  set_teacher {params}                     -> {code: 0, ok: True}
  reset    {session_id}                    -> {code: 0, reset: bool}
  end      {session_id}                    -> {code: 0, ended: bool}
  load     {version, source|params, activate?} -> {code: 0, info}
  swap     {version}                       -> {code: 0, generation}
  status   {}                              -> {code: 0, status}
  drain    {}                              -> {code: 0, draining, resident}
  ping     {}                              -> {code: 0, pong: True}

``act_many`` carries a whole env cycle in one frame, with per-lane results
(typed sheds included) in one answer frame.

``hello`` is the transport negotiation (``comm.shm_ring``): a client
advertising ``transports: [shm, tcp]`` from the same host gets a
shared-memory ring pair minted, and its data frames move over the rings
with the socket as control channel and fallback leg. ``transport="tcp"``
on the server refuses rings; on the client it sends no hello, so the wire
stays the pre-negotiation one byte for byte. A hello whose preference
lists name nothing known is NACKed with the typed ``bad_hello`` code; a
garbage frame answers ``bad_frame``; both close the connection. A frame
larger than the ring goes over the TCP leg, counted in
``distar_shm_fallbacks_total``.

Every request may carry an optional ``player`` field: a multiplexed server
(``serve.mux.GatewayMux``) resolves it to the right model; a single-model
server ignores it.

Serve errors answer ``{code: <wire code>, error, shed}`` (errors.to_wire);
the client rehydrates them into the typed exceptions.
"""
from __future__ import annotations

import socket
import threading
from typing import Optional

from ..comm import shm_ring
from ..comm.serializer import recv_msg, send_msg
from ..obs import (
    finish_trace,
    get_registry,
    is_trace,
    set_active_trace,
    start_trace,
    tracing_enabled,
    wire_ctx,
)
from ..resilience import RetryPolicy, retry_call
from .errors import BadFrameError, BadRequestError, ServeError, error_from_wire


class ServeTCPServer:
    def __init__(self, gateway, host: str = "127.0.0.1", port: int = 0,
                 transport: str = "auto",
                 ring_bytes: int = shm_ring.DEFAULT_RING_BYTES):
        self.gateway = gateway
        if transport not in ("auto", "shm", "tcp"):
            raise ValueError(f"transport must be auto|shm|tcp, got {transport!r}")
        self.transport = transport
        self.ring_bytes = int(ring_bytes)
        self._transports = {"tcp": 0, "shm": 0}
        self._transports_lock = threading.Lock()
        # gateway.status() reports the live per-connection transport split
        # of every frontend mounted on it (a router's adapter keeps none)
        if hasattr(gateway, "add_transport_counts"):
            gateway.add_transport_counts(self.transport_counts)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(128)
        self.host, self.port = self._listener.getsockname()
        self._stop = threading.Event()
        self._accept_thread: Optional[threading.Thread] = None
        self._conns: set = set()
        self._ring_services: set = set()
        self._conns_lock = threading.Lock()
        reg = get_registry()
        self._g_conns = reg.gauge(
            "distar_serve_tcp_connections", "open data-plane connections"
        )
        self._c_frames = reg.counter(
            "distar_serve_tcp_frames_total", "request frames handled"
        )

    def start(self) -> "ServeTCPServer":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="serve-tcp-accept", daemon=True
        )
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            # shutdown BEFORE close: closing the fd from this thread does not
            # wake an accept() blocked in another — the kernel socket (and
            # the port) would live until a final connection arrived
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        # close live connections too: their handler threads otherwise sit in
        # recv until every peer goes away, pinning the port past stop()
        with self._conns_lock:
            conns = list(self._conns)
            rings = list(self._ring_services)
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass
        # sever the shm leg synchronously: a closed socket does not stop a
        # ring pump, and a stopped server must not keep answering data
        # frames out of shared memory
        for svc in rings:
            svc.stop()
        t = self._accept_thread
        if t is not None:
            t.join(5.0)
            self._accept_thread = None

    # ------------------------------------------------------------------ loop
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:  # listener closed by stop()
                return
            # REUSEADDR on accepted sockets too: after stop(), lingering
            # FIN_WAIT conns must not block a restarted gateway from
            # rebinding the same port (the crash-restart path)
            conn.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            threading.Thread(
                target=self._serve_conn, args=(conn,), name="serve-tcp-conn", daemon=True
            ).start()

    def _count_transport(self, kind: str, delta: int) -> None:
        with self._transports_lock:
            self._transports[kind] = max(0, self._transports[kind] + delta)

    def transport_counts(self) -> dict:
        with self._transports_lock:
            return dict(self._transports)

    def _handle_hello(self, req: dict, have_rings: bool) -> "tuple[dict, object]":
        """Negotiate one connection's transport. Returns (reply, peer) —
        ``peer`` is the server ring endpoint when shm was agreed."""
        nack = shm_ring.hello_nack(req)
        if nack:
            return {"code": "bad_hello", "error": nack, "shed": False}, None
        reply = {"code": 0, "transport": "tcp"}
        if have_rings:  # one ring pair per connection, ever
            return reply, None
        extra, peer = shm_ring.negotiate_server(
            req, self.transport, self.ring_bytes, op="serve")
        reply.update(extra)
        return reply, peer

    def _serve_conn(self, conn: socket.socket) -> None:
        self._g_conns.inc()
        with self._conns_lock:
            self._conns.add(conn)
        ring_svc = None
        self._count_transport("tcp", +1)
        try:
            with conn:
                while not self._stop.is_set():
                    try:
                        req = recv_msg(conn)
                    except (ConnectionError, OSError):
                        return  # peer closed (possibly mid-frame)
                    except ValueError as e:
                        # garbage frame header/codec: answer typed, then
                        # close — the stream can no longer be trusted
                        send_msg(conn, BadFrameError(repr(e)).to_wire())
                        return
                    self._c_frames.inc()
                    if isinstance(req, dict) and req.get("op") == "hello":
                        reply, peer = self._handle_hello(req, ring_svc is not None)
                        if peer is not None:
                            ring_svc = shm_ring.RingService(
                                peer, self._dispatch, name="serve-shm-ring").start()
                            with self._conns_lock:
                                self._ring_services.add(ring_svc)
                            self._count_transport("tcp", -1)
                            self._count_transport("shm", +1)
                        try:
                            send_msg(conn, reply)
                        except (ConnectionError, OSError):
                            return
                        if reply.get("code") == "bad_hello":
                            return  # a desynced peer can't be trusted framed
                        continue
                    try:
                        send_msg(conn, self._dispatch(req))
                    except (ConnectionError, OSError):
                        return
        finally:
            if ring_svc is not None:
                ring_svc.stop()
                self._count_transport("shm", -1)
            else:
                self._count_transport("tcp", -1)
            with self._conns_lock:
                self._conns.discard(conn)
                if ring_svc is not None:
                    self._ring_services.discard(ring_svc)
            self._g_conns.dec()

    def _dispatch(self, req) -> dict:
        if not isinstance(req, dict) or "op" not in req:
            return BadRequestError(f"not a request dict: {type(req)}").to_wire()
        op = req["op"]
        gw = self.gateway
        try:
            # multiplexed gateways (serve.mux.GatewayMux, the fleet router's
            # adapter) resolve the optional wire ``player`` field to the
            # right model; a plain single-model gateway ignores it
            if hasattr(gw, "resolve"):
                gw = gw.resolve(req.get("player"))
            if op == "act":
                out = gw.act(req["session_id"], req["obs"], req.get("timeout_s"),
                             want_teacher=bool(req.get("want_teacher", False)),
                             trace=req.get("trace"))
                return {"code": 0, "outputs": out}
            if op == "act_many":
                results = gw.act_many(req["requests"], req.get("timeout_s"))
                return {"code": 0, "results": [
                    r.to_wire() if isinstance(r, ServeError) else {"ok": r}
                    for r in results
                ]}
            if op == "reserve":
                return {"code": 0,
                        "slots": gw.reserve_sessions(req["session_ids"])}
            if op == "hidden":
                return {"code": 0, "hidden": gw.session_hidden(req["session_id"])}
            if op == "set_teacher":
                return {"code": 0, "ok": gw.set_teacher(req["params"])}
            if op == "reset":
                return {"code": 0, "reset": gw.reset_session(req["session_id"])}
            if op == "end":
                return {"code": 0, "ended": gw.end_session(req["session_id"])}
            if op == "load":
                info = gw.load_version(
                    req["version"], source=req.get("source"), params=req.get("params"),
                    activate=bool(req.get("activate", False)),
                )
                return {"code": 0, "info": info}
            if op == "swap":
                return {"code": 0, "generation": gw.activate_version(req["version"])}
            if op == "status":
                return {"code": 0, "status": gw.status()}
            if op == "drain":
                # address-level graceful retirement (never per-player)
                root = self.gateway
                if not hasattr(root, "begin_drain"):
                    return BadRequestError("target has no drain surface").to_wire()
                return {"code": 0, **root.begin_drain()}
            if op == "ping":
                return {"code": 0, "pong": True}
            return BadRequestError(f"unknown op {op!r}").to_wire()
        except ServeError as e:
            return e.to_wire()
        except Exception as e:  # a handler bug must not kill the connection
            return {"code": "serve_error", "error": repr(e), "shed": False}


class ServeClient:
    """Blocking data-plane client: one connection, one request in flight
    (callers wanting pipelining open one client per worker thread).

    Transport faults reconnect-and-retry under ``retry_policy`` (resilience
    fabric: a gateway restart is invisible to callers as long as it comes
    back inside the policy's budget). Typed ``ServeError`` responses — sheds,
    deadlines — are application answers, never retried here: shed/backoff
    decisions belong to the caller. NOTE: a retried ``act`` may execute twice
    on the server (at-least-once); inference is idempotent per (session,
    obs), so replays are safe for every current op.

    ``player`` (ctor default and/or per-call) stamps the wire ``player``
    field so one multiplexed gateway address can serve several player
    models (``serve.mux.GatewayMux``); a single-model server ignores the
    field, so stamped clients interoperate with legacy gateways."""

    def __init__(self, host: str, port: int, timeout_s: float = 30.0,
                 retry_policy: Optional[RetryPolicy] = None,
                 player: Optional[str] = None, transport: str = "auto"):
        self._addr = (host, port)
        self._timeout_s = timeout_s
        self._player = player
        self._policy = retry_policy or RetryPolicy(
            max_attempts=3, backoff_base_s=0.2, backoff_max_s=2.0,
            deadline_s=4 * timeout_s,
        )
        shm_ring.offer_transports(transport)  # validate the name early
        self._transport = transport
        self._shm: Optional[shm_ring.ShmPeer] = None
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self._connect()

    @property
    def transport_active(self) -> str:
        """The leg this connection's data frames currently ride."""
        return "shm" if self._shm is not None else "tcp"

    def _connect(self) -> None:
        self.close()
        self._sock = socket.create_connection(self._addr, timeout=self._timeout_s)
        self._sock.settimeout(self._timeout_s)
        offers = shm_ring.offer_transports(self._transport)
        if "shm" not in offers:
            return  # tcp-only clients keep the pre-shm wire byte-identical
        try:
            send_msg(self._sock, {"op": "hello", "transports": offers,
                                  "host": shm_ring.host_identity()})
            resp = recv_msg(self._sock)
        except (ConnectionError, OSError, ValueError):
            self.close()
            raise
        if isinstance(resp, dict) and resp.get("code") == 0:
            self._shm = shm_ring.maybe_attach(resp, op="serve")
        # a pre-negotiation gateway answers bad_request: stay on TCP

    def _drop_shm(self) -> None:
        shm, self._shm = self._shm, None
        if shm is not None:
            shm.close()

    def _call_once(self, req: dict) -> dict:
        with self._lock:
            if self._sock is None:
                self._connect()
            resp = None
            if self._shm is not None:
                try:
                    resp = self._shm.request(req, timeout_s=self._timeout_s)
                except shm_ring.ShmTimeout:
                    self._drop_shm()
                    self.close()
                    raise
                except shm_ring.ShmError as e:
                    # typed ring fault (peer death mid-frame, oversized
                    # frame, corruption): counted, then THIS call falls
                    # back to the TCP leg on the same connection
                    shm_ring.note_fallback(e.reason)
                    self._drop_shm()
            if resp is None:
                try:
                    send_msg(self._sock, req)
                    resp = recv_msg(self._sock)
                except (ConnectionError, OSError, ValueError):
                    # the stream is no longer trustworthy (peer died
                    # mid-frame / garbage header): drop it so the retry
                    # dials fresh
                    self.close()
                    raise
        if resp.get("code") != 0:
            raise error_from_wire(resp)
        return resp

    def _call(self, req: dict) -> dict:
        return retry_call(
            self._call_once, req, op=f"serve:{req.get('op', '?')}",
            policy=self._policy,
        )

    def _stamp(self, req: dict, player: Optional[str]) -> dict:
        p = self._player if player is None else player
        if p is not None:
            req["player"] = p
        return req

    def act(self, session_id: str, obs, timeout_s: Optional[float] = None,
            want_teacher: bool = False, player: Optional[str] = None,
            trace: Optional[dict] = None) -> dict:
        """One agent step. A client-side span rides the wire as the compact
        ``trace`` field, so the gateway's server span joins under the same
        trace_id (client -> gateway in one waterfall). ``trace`` lets the
        caller supply its own context (it then owns finishing it, as
        ``FleetClient`` does); otherwise one is minted and finished
        here. Typed errors gain ``.trace_id`` either way."""
        owned = None
        ctx = trace
        if ctx is None and tracing_enabled():
            ctx = owned = start_trace("serve_client", session=session_id)
        req = {"op": "act", "session_id": session_id, "obs": obs}
        if timeout_s is not None:
            req["timeout_s"] = timeout_s
        if want_teacher:
            req["want_teacher"] = True
        if is_trace(ctx):
            req["trace"] = wire_ctx(ctx)
        # active trace: transport-level blocking (shm ring-full) attributes
        # its wait to this request's span — only the shm leg consumes it
        on_shm = self._shm is not None
        prev = set_active_trace(ctx) if on_shm else None
        try:
            out = self._call(self._stamp(req, player))["outputs"]
        except BaseException as e:
            if is_trace(ctx) and isinstance(e, ServeError):
                e.trace_id = ctx["trace_id"]
            finish_trace(owned, "client_done",
                         outcome="shed" if getattr(e, "shed", False) else "error")
            raise
        finally:
            if on_shm:
                set_active_trace(prev)
        if is_trace(ctx) and isinstance(out, dict):
            out.setdefault("trace_id", ctx["trace_id"])
        finish_trace(owned, "client_done")
        return out

    def act_many(self, requests, timeout_s: Optional[float] = None,
                 player: Optional[str] = None) -> list:
        """One cycle of requests in one frame; returns a per-request list of
        output dicts or typed ``ServeError`` INSTANCES (per-lane sheds come
        back as values, not raises — partial success keeps its lanes).
        Each request dict may carry a caller-minted full context under
        ``trace_ctx`` (client-side only — never serialized; the caller owns
        finishing it); lanes without one get a span minted and finished
        here. Either way only the compact wire field crosses the socket.
        NOTE: a transport retry re-executes the WHOLE cycle server-side
        (at-least-once), which advances succeeded lanes' carries once more —
        acceptable on the restart path, where carries re-materialize from
        zero anyway."""
        requests = list(requests)
        if not tracing_enabled() and not any("trace_ctx" in r for r in requests):
            # untraced fast path: byte-identical to the pre-tracing wire,
            # zero per-lane copies
            req = {"op": "act_many", "requests": requests}
            if timeout_s is not None:
                req["timeout_s"] = timeout_s
            entries = self._call(self._stamp(req, player))["results"]
            return [e["ok"] if isinstance(e, dict) and "ok" in e
                    else error_from_wire(e) for e in entries]
        ctxs, owned, wire_reqs = [], [], []
        for r in requests:
            ctx = r.get("trace_ctx")
            mine = None
            if ctx is None and tracing_enabled():
                ctx = mine = start_trace("serve_client",
                                         session=r.get("session_id", "?"))
            wr = {k: v for k, v in r.items() if k != "trace_ctx"}
            if is_trace(ctx):
                wr["trace"] = wire_ctx(ctx)
            else:
                ctx = None
            ctxs.append(ctx)
            owned.append(mine)
            wire_reqs.append(wr)
        req = {"op": "act_many", "requests": wire_reqs}
        if timeout_s is not None:
            req["timeout_s"] = timeout_s
        on_shm = self._shm is not None
        prev = set_active_trace(
            next((c for c in ctxs if c is not None), None)) if on_shm else None
        try:
            entries = self._call(self._stamp(req, player))["results"]
        except BaseException:
            for mine in owned:
                finish_trace(mine, "client_done", outcome="error")
            raise
        finally:
            if on_shm:
                set_active_trace(prev)
        out = []
        for ctx, mine, e in zip(ctxs, owned, entries):
            if isinstance(e, dict) and "ok" in e:
                val = e["ok"]
                if ctx is not None and isinstance(val, dict):
                    val.setdefault("trace_id", ctx["trace_id"])
                finish_trace(mine, "client_done")
                out.append(val)
            else:
                err = error_from_wire(e)
                if ctx is not None:
                    err.trace_id = ctx["trace_id"]
                finish_trace(mine, "client_done",
                             outcome="shed" if err.shed else "error")
                out.append(err)
        return out

    def reserve(self, session_ids, player: Optional[str] = None) -> dict:
        """Bulk session pre-allocation; typed ``CapacityError`` on shortfall
        (exact-capacity admission — nothing sheds mid-episode)."""
        return self._call(self._stamp(
            {"op": "reserve", "session_ids": list(session_ids)}, player))["slots"]

    def hidden(self, session_id: str, player: Optional[str] = None):
        return self._call(self._stamp(
            {"op": "hidden", "session_id": session_id}, player))["hidden"]

    def set_teacher(self, params, player: Optional[str] = None) -> bool:
        return self._call(self._stamp(
            {"op": "set_teacher", "params": params}, player))["ok"]

    def reset(self, session_id: str, player: Optional[str] = None) -> bool:
        return self._call(self._stamp(
            {"op": "reset", "session_id": session_id}, player))["reset"]

    def end(self, session_id: str, player: Optional[str] = None) -> bool:
        return self._call(self._stamp(
            {"op": "end", "session_id": session_id}, player))["ended"]

    def load(self, version: str, source: Optional[str] = None, params=None,
             activate: bool = False, player: Optional[str] = None) -> dict:
        return self._call(self._stamp(
            {"op": "load", "version": version, "source": source, "params": params,
             "activate": activate}, player)
        )["info"]

    def swap(self, version: str, player: Optional[str] = None) -> int:
        return self._call(self._stamp(
            {"op": "swap", "version": version}, player))["generation"]

    def status(self) -> dict:
        return self._call({"op": "status"})["status"]

    def drain(self) -> dict:
        """Ask the gateway to begin graceful retirement (idempotent);
        returns ``{"draining": True, "resident": N}``."""
        resp = self._call({"op": "drain"})
        return {"draining": bool(resp.get("draining")),
                "resident": int(resp.get("resident", 0))}

    def ping(self) -> bool:
        return self._call({"op": "ping"})["pong"]

    def close(self) -> None:
        self._drop_shm()
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

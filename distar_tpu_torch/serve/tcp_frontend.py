"""Framed-TCP data plane for actor-grade serve callers.

Counterpart of ``distar_tpu.serve.tcp_frontend``. Wire format =
``comm.serializer``: 8-byte big-endian length prefix around a pickled (and
compressed) payload, so obs trees with real numpy arrays round-trip
losslessly. One request/response pair per frame; the ``session_id`` field
is authoritative, so a pool of connections can front many sessions.

Requests are ``{"op": ..., ...}`` dicts:
  hello    {transports?, codecs?, host?}   -> {code: 0, transport: "tcp"}
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

Every request may carry an optional ``player`` field: a multiplexed server
(``serve.mux.GatewayMux``) resolves it to the right model; a single-model
server ignores it.

Transports: TCP only. The JAX package negotiates shared-memory rings for
colocated callers in ``hello`` (``comm/shm_ring.py``); the port answers
every well-formed hello ``{"code": 0, "transport": "tcp"}``, as the JAX
server does under ``transport="tcp"``, and NACKs a hello whose preference
lists name nothing known with the typed ``bad_hello`` code. ``transport=
"auto"`` and ``"shm"`` raise ``NotImplementedError``: the rings come with
ROADMAP Queue 1 item 2. A garbage frame answers the typed ``bad_frame``
code and closes the connection.

Serve errors answer ``{code: <wire code>, error, shed}`` (errors.to_wire);
the client rehydrates them into the typed exceptions.
"""
from __future__ import annotations

import socket
import threading
from typing import Optional

from ..comm.serializer import KNOWN_CODECS, recv_msg, send_msg
from ..obs import (
    finish_trace,
    get_registry,
    is_trace,
    start_trace,
    tracing_enabled,
    wire_ctx,
)
from ..resilience import RetryPolicy, retry_call
from .errors import BadFrameError, BadRequestError, ServeError, error_from_wire

#: transport names the hello protocol defines (the JAX package's
#: ``comm.shm_ring.KNOWN_TRANSPORTS``)
KNOWN_TRANSPORTS = ("shm", "tcp")


def check_transport(transport: str) -> None:
    """Only ``"tcp"`` is ported; ``"auto"`` and ``"shm"`` need the
    shared-memory rings."""
    if transport in ("auto", "shm"):
        raise NotImplementedError(
            f"transport {transport!r} needs the shared-memory rings (comm/shm_ring.py), which "
            f"come with ROADMAP Queue 1 item 2; the port serves transport='tcp'")
    if transport != "tcp":
        raise ValueError(f"transport must be auto|shm|tcp, got {transport!r}")


def hello_nack(req: dict) -> Optional[str]:
    """The reason when a hello's preference lists contain no recognized
    name at all (a garbage or hostile hello, NACKed typed); None when the
    hello is answerable. A recognized but unavailable preference degrades
    to TCP. The port's copy of ``comm.shm_ring.hello_nack``."""
    codecs = req.get("codecs")
    if codecs and not any(c in KNOWN_CODECS for c in codecs):
        return f"no recognized codec in {list(codecs)!r} (know {list(KNOWN_CODECS)})"
    transports = req.get("transports")
    if transports and not any(t in KNOWN_TRANSPORTS for t in transports):
        return f"no recognized transport in {list(transports)!r} (know {list(KNOWN_TRANSPORTS)})"
    return None


class ServeTCPServer:
    def __init__(self, gateway, host: str = "127.0.0.1", port: int = 0, transport: str = "tcp"):
        self.gateway = gateway
        check_transport(transport)
        self.transport = transport
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(128)
        self.host, self.port = self._listener.getsockname()
        self._stop = threading.Event()
        self._accept_thread: Optional[threading.Thread] = None
        self._conns: set = set()
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
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass
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

    def _serve_conn(self, conn: socket.socket) -> None:
        self._g_conns.inc()
        with self._conns_lock:
            self._conns.add(conn)
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
                        nack = hello_nack(req)
                        reply = ({"code": "bad_hello", "error": nack, "shed": False} if nack
                                 else {"code": 0, "transport": "tcp"})
                        try:
                            send_msg(conn, reply)
                        except (ConnectionError, OSError):
                            return
                        if nack:
                            return  # a desynced peer can't be trusted framed
                        continue
                    try:
                        send_msg(conn, self._dispatch(req))
                    except (ConnectionError, OSError):
                        return
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            self._g_conns.dec()

    def _dispatch(self, req) -> dict:
        if not isinstance(req, dict) or "op" not in req:
            return BadRequestError(f"not a request dict: {type(req)}").to_wire()
        op = req["op"]
        gw = self.gateway
        try:
            # a multiplexed gateway (serve.mux.GatewayMux) resolves the
            # optional wire ``player`` field to the right model; a plain
            # single-model gateway ignores it — legacy clients never send
            # it and keep working unchanged
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
                 player: Optional[str] = None, transport: str = "tcp"):
        check_transport(transport)
        self._addr = (host, port)
        self._timeout_s = timeout_s
        self._player = player
        self._policy = retry_policy or RetryPolicy(
            max_attempts=3, backoff_base_s=0.2, backoff_max_s=2.0,
            deadline_s=4 * timeout_s,
        )
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self._connect()

    @property
    def transport_active(self) -> str:
        """The leg this connection's data frames ride: always TCP here."""
        return "tcp"

    def _connect(self) -> None:
        # a TCP-only client sends no hello: the wire stays the JAX
        # package's pre-negotiation one, byte for byte
        self.close()
        self._sock = socket.create_connection(self._addr, timeout=self._timeout_s)
        self._sock.settimeout(self._timeout_s)

    def _call_once(self, req: dict) -> dict:
        with self._lock:
            if self._sock is None:
                self._connect()
            try:
                send_msg(self._sock, req)
                resp = recv_msg(self._sock)
            except (ConnectionError, OSError, ValueError):
                # the stream is no longer trustworthy (peer died mid-frame,
                # garbage header): drop it so the retry dials fresh
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
        caller supply its own context (it then owns finishing it); otherwise one is minted and finished
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
        try:
            out = self._call(self._stamp(req, player))["outputs"]
        except BaseException as e:
            if is_trace(ctx) and isinstance(e, ServeError):
                e.trace_id = ctx["trace_id"]
            finish_trace(owned, "client_done",
                         outcome="shed" if getattr(e, "shed", False) else "error")
            raise
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
        try:
            entries = self._call(self._stamp(req, player))["results"]
        except BaseException:
            for mine in owned:
                finish_trace(mine, "client_done", outcome="error")
            raise
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

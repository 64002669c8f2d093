"""Replay-store service: framed-TCP data plane + HTTP admin surface.

Counterpart of ``distar_tpu.replay.server``, with its wire and its
``REPLAY-SHARD`` line.

Wire format = ``comm.serializer`` (8-byte big-endian length prefix around a
pickled+compressed payload) with the ``serve/tcp_frontend`` conventions:
one request/response dict pair per frame, ``{"code": 0, ...}`` on success,
``{"code": <wire code>, "error": ...}`` typed on failure (errors.to_wire).

Requests:
  hello   {compress?, codecs?}            -> {code: 0, compress, codec, shard}
  insert  {table, item, priority?, timeout_s?, idem?} -> {code: 0, seq}
  sample  {table, batch_size?, timeout_s?}        -> {code: 0, items, info}
  update_priorities {table, updates}              -> {code: 0, applied}
  stats   {}                                      -> {code: 0, stats}
  tables  {}                                      -> {code: 0, tables}
  ping    {}                                      -> {code: 0, pong: True}

Blocking semantics live server-side: an insert/sample request parks its
connection's handler thread in the table's ``RateLimiter`` until the
operation is admitted or its ``timeout_s`` lapses (then answers the
retryable ``rate_limited`` wire error). The admin surface
(``ReplayAdminServer``) follows the CoordinatorServer pattern: GET
``/metrics`` (Prometheus scrape), the fleet-health routes, and GET
``/replay/stats`` for opsctl.

Wire compression is negotiated per connection: the optional ``hello``
frame declares whether the client wants payload compression, the server
answers with the setting both sides will use (its own enablement ANDed
in), and every later frame on the connection honours it. A client that
never says hello gets the legacy always-compressed behaviour. Responses
whose bulk is already through the codec — ``Opaque`` spill re-serves —
skip the frame-level compression pass regardless (recompressing lz output
buys bytes-per-CPU nothing). ``distar_replay_{tx,rx}_bytes_{raw,wire}``
counters account both directions so the compression ratio actually paid
for is a scrapeable number, not a guess.

Transport is negotiated in the same ``hello``: a client advertising
``transports: [shm, tcp]`` plus this host's identity gets a shm ring pair
minted (``comm.shm_ring``) and the connection's data frames move over the
rings — zero socket, zero codec, pickle straight into mapped memory —
while the TCP socket stays open as the control channel and fallback leg
(a ring fault or peer death is detected typed and the client's next
attempt rides TCP). A hello whose codec/transport preference lists
contain no recognized name at all is answered with the typed
``bad_hello`` NACK instead of silently degrading.
"""
from __future__ import annotations

import json
import socket
import threading
from typing import Optional

from ..comm import shm_ring
from ..comm.serializer import (
    Opaque,
    dumps_sized,
    frame,
    loads_sized,
    negotiate_codec,
    read_frame,
    sock_recv_exact,
    supported_codecs,
)
from ..obs import (
    finish_trace,
    get_registry,
    join_trace,
    set_active_trace,
    tracing_enabled,
)
from .errors import BadFrameError, BadRequestError, ReplayError
from .store import ReplayStore


class ReplayServer:
    """Thread-per-connection framed-TCP server over one ``ReplayStore``."""

    def __init__(self, store: ReplayStore, host: str = "127.0.0.1", port: int = 0,
                 default_timeout_s: float = 30.0, compress: bool = True,
                 codecs: Optional[tuple] = None, transport: str = "auto",
                 ring_bytes: int = shm_ring.DEFAULT_RING_BYTES):
        self.store = store
        self.default_timeout_s = default_timeout_s
        #: server-side compression enablement; the per-connection setting is
        #: this ANDed with whatever the client's hello asks for
        self.compress = bool(compress)
        #: codecs this server is willing to speak (restrictable per deploy);
        #: the per-connection codec is the client's first preference in here
        self.codecs = tuple(codecs) if codecs is not None else supported_codecs()
        #: transport policy: "auto" negotiates shm with colocated clients,
        #: "shm" the same (shm never *forces* — the TCP leg always remains),
        #: "tcp" refuses rings entirely (the cross-host / drill posture)
        if transport not in ("auto", "shm", "tcp"):
            raise ValueError(f"transport must be auto|shm|tcp, got {transport!r}")
        self.transport = transport
        self.ring_bytes = int(ring_bytes)
        #: live per-transport connection counts (the opsctl digest's
        #: "active transport per connection" answer, served via /replay/stats)
        self._transports = {"tcp": 0, "shm": 0}
        self._transports_lock = threading.Lock()
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
        shard = getattr(store, "shard_id", "") or ""
        extra = {"shard": shard} if shard else {}
        self._g_conns = reg.gauge(
            "distar_replay_server_connections", "open replay data-plane connections",
            **extra)
        self._c_requests = reg.counter(
            "distar_replay_server_requests_total", "replay request frames handled",
            **extra)
        self._c_tx_raw = reg.counter(
            "distar_replay_tx_bytes_raw_total",
            "response payload bytes before wire compression", **extra)
        self._c_tx_wire = reg.counter(
            "distar_replay_tx_bytes_wire_total",
            "response payload bytes actually sent on the wire", **extra)
        self._c_rx_raw = reg.counter(
            "distar_replay_rx_bytes_raw_total",
            "request payload bytes after wire decompression", **extra)
        self._c_rx_wire = reg.counter(
            "distar_replay_rx_bytes_wire_total",
            "request payload bytes actually received on the wire", **extra)

    def start(self) -> "ReplayServer":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="replay-accept", daemon=True)
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            # shutdown BEFORE close: closing the fd does not wake an accept()
            # blocked in another thread (tcp_frontend.py lesson)
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        with self._conns_lock:
            conns = list(self._conns)
            rings = list(self._ring_services)
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass
        # sever the shm leg SYNCHRONOUSLY: a closed socket does not stop a
        # ring pump, and a stopped server must not keep answering data
        # frames out of shared memory (the in-process kill-drill contract)
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
            conn.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            threading.Thread(
                target=self._serve_conn, args=(conn,), name="replay-conn",
                daemon=True,
            ).start()

    # --------------------------------------------------------- counted wire IO
    def _recv_counted(self, conn: socket.socket):
        blob = read_frame(lambda n: sock_recv_exact(conn, n))
        obj, raw_len = loads_sized(blob)
        self._c_rx_wire.inc(len(blob))
        self._c_rx_raw.inc(raw_len)
        return obj

    def _send_counted(self, conn: socket.socket, obj, compress: bool,
                      codec: str = "lz4") -> None:
        # skip the compression pass when the response bulk is already
        # through the codec (Opaque spill re-serves): lz-of-lz costs a full
        # CPU pass for ~zero byte savings
        if compress and isinstance(obj, dict):
            items = obj.get("items")
            if items and any(isinstance(i, Opaque) for i in items):
                compress = False
        blob, raw_len = dumps_sized(obj, compress=compress, codec=codec)
        conn.sendall(frame(blob))
        self._c_tx_wire.inc(len(blob))
        self._c_tx_raw.inc(raw_len)

    def _count_transport(self, kind: str, delta: int) -> None:
        with self._transports_lock:
            self._transports[kind] = max(0, self._transports[kind] + delta)

    def transport_counts(self) -> dict:
        with self._transports_lock:
            return dict(self._transports)

    def _serve_conn(self, conn: socket.socket) -> None:
        self._g_conns.inc()
        with self._conns_lock:
            self._conns.add(conn)
        compress = self.compress  # legacy clients never negotiate: stay on
        codec = "lz4"  # ...and never leave the legacy codec
        ring_svc = None  # set when this connection negotiates shm
        self._count_transport("tcp", +1)
        try:
            with conn:
                while not self._stop.is_set():
                    try:
                        req = self._recv_counted(conn)
                    except (ConnectionError, OSError):
                        return  # peer closed (possibly mid-frame)
                    except ValueError as e:
                        self._send_counted(
                            conn, BadFrameError(repr(e)).to_wire(),
                            compress, codec)
                        return
                    self._c_requests.inc()
                    if isinstance(req, dict) and req.get("op") == "hello":
                        # a hello whose preference lists name NOTHING this
                        # protocol knows is garbage: NACK typed, never
                        # silently degrade (then drop the stream — a peer
                        # that desynced once can't be trusted framed)
                        nack = shm_ring.hello_nack(req)
                        if nack:
                            self._send_counted(
                                conn, {"code": "bad_hello", "error": nack},
                                compress, codec)
                            return
                        # per-connection negotiation: both sides commit to
                        # the ANDed compression setting and the intersected
                        # codec choice for every later frame
                        compress = self.compress and bool(req.get("compress", True))
                        codec = negotiate_codec(req.get("codecs"), self.codecs)
                        reply = {"code": 0, "compress": compress, "codec": codec,
                                 "shard": getattr(self.store, "shard_id", "")}
                        if ring_svc is None:
                            # transport leg: mint a ring pair when client +
                            # server share this host; data frames then move
                            # over shm while this socket stays the control/
                            # fallback channel
                            extra, peer = shm_ring.negotiate_server(
                                req, self.transport, self.ring_bytes,
                                op="replay")
                            reply.update(extra)
                            if peer is not None:
                                ring_svc = shm_ring.RingService(
                                    peer, self._dispatch,
                                    name="replay-shm-ring").start()
                                with self._conns_lock:
                                    self._ring_services.add(ring_svc)
                                self._count_transport("tcp", -1)
                                self._count_transport("shm", +1)
                        try:
                            self._send_counted(conn, reply, compress, codec)
                        except (ConnectionError, OSError):
                            return
                        continue
                    try:
                        self._send_counted(conn, self._dispatch(req), compress,
                                           codec)
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
        timeout_s = float(req.get("timeout_s", self.default_timeout_s))
        # server-side span joining the client's wire trace field (both
        # transports — the field is inside the pickled frame either way);
        # installed as this handler thread's ACTIVE trace so the table's
        # rate limiter attributes its block time (blocked_s) to the request
        ctx = None
        if op in ("insert", "sample") and req.get("trace") and tracing_enabled():
            ctx = join_trace(req.get("trace"), f"replay_{op}",
                             table=str(req.get("table", "")),
                             shard=getattr(self.store, "shard_id", "") or "")
        prev = set_active_trace(ctx) if ctx is not None else None
        try:
            out = self._dispatch_op(req, op, timeout_s)
        finally:
            if ctx is not None:
                set_active_trace(prev)
        if ctx is not None:
            code = out.get("code")
            outcome = ("ok" if code == 0 else
                       "shed" if code in ("rate_limited", "draining") else "error")
            finish_trace(ctx, "replay_done", outcome=outcome)
        return out

    def _dispatch_op(self, req: dict, op: str, timeout_s: float) -> dict:
        try:
            if op == "insert":
                seq = self.store.insert(
                    req["table"], req["item"],
                    priority=float(req.get("priority", 1.0)), timeout_s=timeout_s,
                    idem=req.get("idem"),
                )
                return {"code": 0, "seq": seq}
            if op == "sample":
                sampled = self.store.sample(
                    req["table"], batch_size=int(req.get("batch_size", 1)),
                    timeout_s=timeout_s,
                )
                return {
                    "code": 0,
                    "items": [s.data for s in sampled],
                    "info": [s.info() for s in sampled],
                }
            if op == "update_priorities":
                return {"code": 0,
                        "applied": self.store.update_priorities(
                            req["table"], req["updates"])}
            if op == "stats":
                return {"code": 0, "stats": self.store.stats()}
            if op == "tables":
                return {"code": 0, "tables": self.store.tables()}
            if op == "ping":
                return {"code": 0, "pong": True}
            return BadRequestError(f"unknown op {op!r}").to_wire()
        except ReplayError as e:
            wire = e.to_wire()
            if wire.get("code") == "rate_limited":
                wire.update(side=getattr(e, "side", "?"), timeout_s=timeout_s,
                            state=getattr(e, "state", {}))
            return wire
        except Exception as e:  # a handler bug must not kill the connection
            return {"code": "replay_error", "error": repr(e)}


class ReplayAdminServer:
    """HTTP admin/stats surface on the CoordinatorServer pattern: GET
    ``/metrics`` (Prometheus text of this process's registry), the
    fleet-health routes (``/healthz``, ``/alerts``, ``/timeseries``), and
    GET ``/replay/stats`` (tables + limiter + spill JSON, the opsctl feed)."""

    def __init__(self, store: ReplayStore, host: str = "127.0.0.1", port: int = 0,
                 server: Optional[ReplayServer] = None,
                 on_drain: Optional[callable] = None):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.store = store
        #: optional data-plane server handle: lets /replay/stats report the
        #: live per-connection transport split (shm vs tcp) for opsctl
        self.data_server = server
        #: drain hook the serving entrypoint installs: runs BEFORE the
        #: store flips to draining (deregister the coordinator lease first —
        #: a draining shard must leave discovery before it starts refusing)
        self.on_drain = on_drain
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                from ..obs import handle_health_get, write_scrape_response

                path = self.path.split("?", 1)[0].rstrip("/")
                if path == "/metrics":
                    write_scrape_response(self)
                    return
                if path == "/replay/stats":
                    stats = outer.store.stats()
                    if outer.data_server is not None:
                        stats["transports"] = outer.data_server.transport_counts()
                    data = json.dumps(stats, default=str).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                if handle_health_get(self, self.path):
                    return
                self.send_response(404)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_POST(self):
                path = self.path.split("?", 1)[0].rstrip("/")
                if path != "/drain":
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                # graceful retirement: deregister first (leave discovery
                # NOW), then refuse new inserts typed while the resident
                # tail keeps draining to samplers; the serving process
                # exits once residency reaches zero or its drain timeout
                try:
                    if outer.on_drain is not None:
                        try:
                            outer.on_drain()
                        except Exception:  # noqa: BLE001 - lease still lapses
                            # best-effort by contract (the lease expires on
                            # its own) but never silent: a deregister hook
                            # that always fails means every drain leaves a
                            # zombie discovery entry for a full lease
                            get_registry().counter(
                                "distar_replay_drain_hook_errors_total",
                                "drain deregister-hook failures (lease "
                                "expiry is the fallback)",
                            ).inc()
                    info = outer.store.begin_drain()
                    data = json.dumps({"code": 0, "info": info}).encode()
                except Exception as e:  # noqa: BLE001 - probe must not wedge us
                    data = json.dumps({"code": 1, "info": repr(e)}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._server.server_address
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ReplayAdminServer":
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


def main(argv=None) -> int:
    """Minimal standalone shard: ``python -m distar_tpu_torch.replay.server``.

    The lighter twin of ``bin/rl_train --type replay`` (no health stack, no
    supervisor) — what the sharded bench and chaos drills spawn per shard so
    fleet members are real OS processes (separate GILs, real sockets), not
    threads sharing the parent's interpreter. Prints one parseable
    ``REPLAY-SHARD <host> <port>`` line once serving, then runs until
    SIGTERM/SIGINT or stdin EOF (so a dying parent reaps the fleet)."""
    import argparse
    import signal
    import sys
    import time

    from .spill import SpillRing
    from .store import TableConfig

    p = argparse.ArgumentParser(description="standalone replay shard")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--shard-id", default="")
    p.add_argument("--spill-dir", default="")
    p.add_argument("--spill-max", type=int, default=4096)
    p.add_argument("--max-size", type=int, default=4096)
    p.add_argument("--sampler", default="uniform",
                   choices=("fifo", "uniform", "prioritized"))
    p.add_argument("--spi", type=float, default=0.0,
                   help="samples-per-insert ratio (<=0 disables)")
    p.add_argument("--min-size", type=int, default=1)
    p.add_argument("--error-buffer", type=float, default=None)
    p.add_argument("--no-compress", dest="compress", action="store_false",
                   help="refuse wire compression in the hello negotiation")
    p.add_argument("--codecs", default="",
                   help="comma list restricting the codecs this shard will "
                        "negotiate (default: everything the host supports; "
                        "lz4 always remains the fallback)")
    p.add_argument("--transport", default="auto", choices=("auto", "shm", "tcp"),
                   help="data-plane transport policy: auto/shm negotiate "
                        "shared-memory rings with colocated clients, tcp "
                        "refuses rings (cross-host posture)")
    p.add_argument("--coordinator", default="",
                   help="coordinator host:port to register under the "
                        "replay_shard token (lease/heartbeat; sharded "
                        "clients and opsctl discover the fleet there)")
    p.add_argument("--lease-s", type=float, default=10.0)
    p.add_argument("--admin-port", type=int, default=-1,
                   help=">= 0 starts the HTTP admin surface (/replay/stats, "
                        "/metrics, POST /drain) on that port (0 = ephemeral; "
                        "default off). Advertised as admin_port meta on the "
                        "coordinator registration.")
    p.add_argument("--drain-timeout-s", type=float, default=30.0,
                   help="graceful-retirement budget: after POST /drain, "
                        "exit once every resident item drained out, or when "
                        "this many seconds passed — whichever comes first")
    args = p.parse_args(argv)

    cfg = TableConfig(
        max_size=args.max_size, sampler=args.sampler,
        samples_per_insert=None if args.spi <= 0 else args.spi,
        min_size_to_sample=max(args.min_size, 1),
        error_buffer=args.error_buffer,
    )
    spill = SpillRing(args.spill_dir, max_items=args.spill_max) \
        if args.spill_dir else None
    store = ReplayStore(table_factory=lambda name: cfg, spill=spill,
                        shard_id=args.shard_id, recover_encoded=True)
    recovered = store.recover()
    codecs = tuple(c for c in args.codecs.split(",") if c.strip()) or None
    server = ReplayServer(store, host=args.host, port=args.port,
                          compress=args.compress, codecs=codecs,
                          transport=args.transport).start()

    deregister = None
    admin = None
    if args.coordinator:
        from ..comm.discovery import unregister_endpoint
        from .sharding import register_shard

        chost, _, cport = args.coordinator.rpartition(":")
        coord = (chost or "127.0.0.1", int(cport))

    if args.admin_port >= 0:
        admin = ReplayAdminServer(store, host=args.host, port=args.admin_port,
                                  server=server).start()

    if args.coordinator:
        beat = register_shard(
            coord, server.host, server.port,
            meta={"shard_id": args.shard_id,
                  **({"admin_port": admin.port} if admin is not None else {})},
            lease_s=args.lease_s,
        )

        def deregister(beat=beat, coord=coord, host=server.host,
                       port=server.port):
            beat.stop_event.set()
            try:
                unregister_endpoint(coord, host, port)
            except Exception:  # noqa: BLE001 - best-effort; lease still lapses
                pass

        if admin is not None:
            # drain step 1: leave discovery before refusing any insert
            admin.on_drain = deregister

    # CLI entrypoint output: the parseable serving line callers wait for
    print(f"REPLAY-SHARD {server.host} {server.port} "  # lint: allow-print
          f"recovered={recovered}"
          + (f" admin={admin.port}" if admin is not None else ""), flush=True)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    drain_deadline = None
    try:
        import select

        while not stop.is_set():
            # poll (not block) stdin so a signal still exits promptly; EOF
            # on a piped stdin means the parent went away — reap ourselves
            ready, _, _ = select.select([sys.stdin], [], [], 0.5)
            if ready and not sys.stdin.buffer.read(1):
                break
            # graceful-retirement exit: once POST /drain flipped the store,
            # serve until the resident tail drained out (samples keep
            # flowing), bounded by --drain-timeout-s
            if store.draining:
                if drain_deadline is None:
                    drain_deadline = time.monotonic() + args.drain_timeout_s
                if (store.resident_items() == 0
                        or time.monotonic() > drain_deadline):
                    break
    except (OSError, ValueError, KeyboardInterrupt):
        pass
    if deregister is not None:
        deregister()
    server.stop()
    if admin is not None:
        admin.stop()
    if spill is not None:
        spill.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

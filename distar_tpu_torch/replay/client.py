"""Replay-store clients: acked inserts and blocking samples over framed TCP.

Counterpart of ``distar_tpu.replay.client``, with its wire (the hello, the
codec and the shm negotiation), so either package's client talks to either
package's server.

Both clients follow the ``serve/tcp_frontend`` ServeClient shape — one
connection, one request in flight, transport faults reconnect-and-retry
under a ``resilience.RetryPolicy`` behind a per-client ``CircuitBreaker``
(no connect storms against a dead store). Typed wire errors rehydrate into
the ``replay.errors`` taxonomy; ``rate_limited`` is *retryable* (the store
is pacing, not failing), so a default-policy client transparently rides
through limiter blocks AND store restarts within its deadline budget.

Exactly-once inserts: every logical ``insert`` mints one idempotency key
that rides EVERY retry of that insert. A retry after the ambiguous failure
(server committed, ack lost when the connection died) is answered from the
store's idem cache with the original seq instead of re-applying — no
duplicate item, no duplicate spill blob. (A retry that crosses a store
*restart* still lands as the documented at-least-once duplicate: the cache
is process-lifetime, and a duplicate trajectory is benign for RL training.)

Wire compression is negotiated once per connection: ``_connect`` sends a
``hello`` declaring this client's preference — on/off AND a codec
preference list (``lz4`` default, ``zstd`` when the host has a binding) —
the server answers the ANDed setting plus the chosen codec name, and both
directions honour them. A pre-negotiation server (or one that answers
hello with an error) degrades to the legacy always-compressed lz4
contract, so mixed-version fleets interoperate.

Transport rides the same ``hello`` (``transport="auto"``, the default):
when client and server share a host the server mints a shared-memory ring
pair (``comm.shm_ring``) and every data frame moves over the rings —
pickle straight into mapped memory, no socket, no codec — while the TCP
socket stays connected as the control channel and fallback leg. Any shm
fault (peer death mid-frame, oversized frame, CRC corruption) is typed:
the client counts the fallback, drops the rings, and the SAME logical
call completes over TCP — with inserts carrying their idempotency key
across the legs, the fallback is exactly-once from the caller's seat.
``transport="tcp"`` keeps the hello byte-identical to the pre-shm wire.
"""
from __future__ import annotations

import socket
import threading
import uuid
from typing import Any, Dict, List, Optional, Tuple

from ..comm import shm_ring
from ..comm.serializer import maybe_decode, recv_msg, send_msg, supported_codecs
from ..obs import (
    finish_trace,
    set_active_trace,
    start_trace,
    tracing_enabled,
    wire_ctx,
)
from ..resilience import CircuitBreaker, RetryPolicy, retry_call
from .errors import error_from_wire

#: store RPCs ride through limiter blocks and a several-second store
#: restart by default; the deadline bounds how long an actor/learner can
#: be parked before the fault surfaces to its supervisor
DEFAULT_REPLAY_POLICY = RetryPolicy(
    max_attempts=6, backoff_base_s=0.2, backoff_max_s=3.0, deadline_s=120.0,
)


class _ReplayClientBase:
    def __init__(self, host: str, port: int, timeout_s: float = 60.0,
                 retry_policy: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 op_prefix: str = "replay", compress: bool = True,
                 codec: str = "lz4", transport: str = "auto"):
        self._addr = (host, port)
        self._timeout_s = timeout_s
        self._policy = retry_policy or DEFAULT_REPLAY_POLICY
        self._breaker = breaker or CircuitBreaker(
            op=f"{op_prefix}:{host}:{port}", failure_threshold=8, reset_after_s=5.0)
        self._op_prefix = op_prefix
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        #: what this side ASKS for; the per-connection negotiated settings
        #: (server's enablement/choice ANDed in) land in _neg_* on connect
        self._want_compress = bool(compress)
        self._neg_compress = bool(compress)
        # preference list: the asked-for codec first, lz4 as the universal
        # fallback; only codecs THIS host can decode are ever offered
        prefs = [c for c in dict.fromkeys((codec, "lz4"))
                 if c in supported_codecs()]
        self._want_codecs = prefs or ["lz4"]
        self._neg_codec = "lz4"
        #: transport preference; the per-connection outcome lands in _shm
        #: (a live ring pair) — None means this connection runs framed TCP
        shm_ring.offer_transports(transport)  # validate the name early
        self._transport = transport
        self._shm: Optional[shm_ring.ShmPeer] = None
        self.server_shard_id: str = ""

    @property
    def transport_active(self) -> str:
        """The leg this connection's data frames currently ride."""
        return "shm" if self._shm is not None else "tcp"

    def _connect(self) -> None:
        self.close()
        self._sock = socket.create_connection(self._addr, timeout=self._timeout_s)
        self._sock.settimeout(self._timeout_s)
        hello = {"op": "hello", "compress": self._want_compress,
                 "codecs": list(self._want_codecs)}
        offers = shm_ring.offer_transports(self._transport)
        if "shm" in offers:
            # only a hello that can actually lead to rings carries the
            # transport keys — a --transport tcp client stays byte-identical
            # to the pre-shm wire
            hello["transports"] = offers
            hello["host"] = shm_ring.host_identity()
        try:
            send_msg(self._sock, hello, compress=False)
            resp = recv_msg(self._sock)
        except (ConnectionError, OSError, ValueError):
            self.close()
            raise
        if isinstance(resp, dict) and resp.get("code") == "bad_hello":
            # the server recognized NOTHING we offered: a config/version
            # fault that degrading would only hide — surface it typed
            self.close()
            raise error_from_wire(resp)
        if isinstance(resp, dict) and resp.get("code") == 0 and "compress" in resp:
            self._neg_compress = bool(resp["compress"])
            self._neg_codec = str(resp.get("codec") or "lz4")
            self.server_shard_id = str(resp.get("shard", "") or "")
            if "shm" in offers:
                self._shm = shm_ring.maybe_attach(resp, op=self._op_prefix)
        else:
            # pre-negotiation server: it answered hello with an error frame
            # and will compress every response — mirror the legacy contract
            self._neg_compress = True
            self._neg_codec = "lz4"

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
                    # peer alive but wedged past the budget: same contract
                    # as a socket timeout — drop everything, let the retry
                    # dial (and renegotiate) fresh
                    self._drop_shm()
                    self.close()
                    raise
                except shm_ring.ShmError as e:
                    # ring fault (peer death mid-frame, oversized frame,
                    # corruption): typed + counted, then THIS call falls
                    # back to the TCP leg below — zero loss for the caller
                    shm_ring.note_fallback(e.reason)
                    self._drop_shm()
            if resp is None:
                try:
                    send_msg(self._sock, req, compress=self._neg_compress,
                             codec=self._neg_codec)
                    resp = recv_msg(self._sock)
                except (ConnectionError, OSError, ValueError):
                    # stream no longer trustworthy: drop it so the retry dials
                    self.close()
                    raise
        if resp.get("code") != 0:
            raise error_from_wire(resp)
        return resp

    def _call(self, req: dict) -> dict:
        # NOTE rate_limited subclasses RetryableError, so retry_call backs
        # off and re-offers; repeated full-timeout blocks eventually open the
        # breaker, which is the desired fail-fast once a store is truly wedged
        return retry_call(
            self._call_once, req, op=f"{self._op_prefix}:{req.get('op', '?')}",
            policy=self._policy, breaker=self._breaker,
        )

    def _traced_call(self, req: dict, name: str) -> dict:
        """Data-plane RPC under a client span: the compact wire trace field
        rides the frame (TCP or shm leg alike — it's inside the pickled
        request), the store's server span joins it, and shm ring-full waits
        annotate this span via the active-trace threadlocal. The span
        resolves ``shed`` when the limiter paced us out (retryable wire
        answers), ``error`` on real faults."""
        ctx = None
        if tracing_enabled():
            ctx = start_trace(name, table=str(req.get("table", "")))
            req = dict(req)
            req["trace"] = wire_ctx(ctx)
        on_shm = self._shm is not None  # only the shm leg reads the active trace
        prev = set_active_trace(ctx) if on_shm else None
        try:
            resp = self._call(req)
        except BaseException as e:
            shed = getattr(e, "code", "") in ("rate_limited", "draining")
            finish_trace(ctx, "client_done",
                         outcome="shed" if shed else "error")
            raise
        finally:
            if on_shm:
                set_active_trace(prev)
        finish_trace(ctx, "client_done")
        return resp

    def ping(self) -> bool:
        return self._call({"op": "ping"})["pong"]

    def stats(self) -> dict:
        return self._call({"op": "stats"})["stats"]

    def tables(self) -> List[str]:
        return self._call({"op": "tables"})["tables"]

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


class InsertClient(_ReplayClientBase):
    """Actor-side writer: ``insert`` returns only once the store acked (item
    resident + spilled to disk when the store runs with a spill ring)."""

    def __init__(self, host: str, port: int, **kwargs):
        kwargs.setdefault("op_prefix", "replay_insert")
        super().__init__(host, port, **kwargs)

    def insert(self, table: str, item: Any, priority: float = 1.0,
               timeout_s: Optional[float] = None) -> int:
        # one idem key per LOGICAL insert, minted here so every retry of
        # this call carries the same token: a commit whose ack the wire ate
        # answers the cached seq on re-offer instead of double-applying
        req = {"op": "insert", "table": table, "item": item,
               "priority": priority, "idem": uuid.uuid4().hex}
        if timeout_s is not None:
            req["timeout_s"] = timeout_s
        return self._traced_call(req, "replay_insert")["seq"]


class SampleClient(_ReplayClientBase):
    """Learner-side reader: blocking batched samples plus the PER
    priority-refresh hook."""

    def __init__(self, host: str, port: int, **kwargs):
        kwargs.setdefault("op_prefix", "replay_sample")
        super().__init__(host, port, **kwargs)

    def sample(self, table: str, batch_size: int = 1,
               timeout_s: Optional[float] = None) -> Tuple[List[Any], List[dict]]:
        req = {"op": "sample", "table": table, "batch_size": batch_size}
        if timeout_s is not None:
            req["timeout_s"] = timeout_s
        resp = self._traced_call(req, "replay_sample")
        # spill re-serves arrive as pre-encoded Opaque payloads (the server
        # skipped recompression); unwrap here so consumers never see them
        return [maybe_decode(i) for i in resp["items"]], resp["info"]

    def update_priorities(self, table: str, updates: Dict[int, float]) -> int:
        return self._call(
            {"op": "update_priorities", "table": table, "updates": updates}
        )["applied"]

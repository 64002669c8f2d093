"""Shared-memory ring transport: the data plane for colocated hops.

Counterpart of ``distar_tpu.comm.shm_ring``, with its wire: a framed-TCP
connection (serve ``act``/``act_many``) can negotiate a pair of
single-writer/single-reader byte rings over ``multiprocessing.
shared_memory`` in its ``hello`` frame; the TCP socket stays open as the
control channel and the cross-host (or post-fault) fallback leg. Either
package's client attaches either package's rings.

Ring layout (one shm segment per direction)::

    [ 128-byte header | capacity bytes of frame data ]

    header words (8-byte aligned, little-endian):
      magic, capacity, write_pos, read_pos,
      writer_gen, reader_gen, writer_closed, reader_closed,
      writer_heartbeat, reader_heartbeat

``write_pos``/``read_pos`` are monotonic byte counters (offset = pos %
capacity), so free space and frame availability are plain subtractions and
wraparound needs no special frames. A frame is ``u32 length | u32 crc32 |
payload`` where the payload is a ``comm.serializer`` blob, serialized
straight into the ring (``serializer.dump_stream``) and deserialized
straight out of it (a frame that does not wrap hands ``loads`` a
memoryview of the ring). The CRC is the native slice-by-8 ``shuttle.
crc32``.

Doorbell: each endpoint owns a loopback UDP socket and the peer rings it
with a 1-byte datagram after every publish or consume, so a blocked side
sleeps in the kernel (``select``) instead of spinning. The datagram is
only a wake hint: the ring header is the truth (the woken side re-checks,
and waits slice every 250 ms). Peer death is read from the header: each
endpoint's beat thread refreshes its heartbeat word every ``window/4``
seconds and a clean close sets the closed flag, so a blocked reader (or a
writer blocked on a full ring) raises the typed ``ShmPeerDeadError``
within one heartbeat window of a SIGKILL, and the client falls back to the
TCP leg (``distar_shm_fallbacks_total``).

Negotiation (server: ``hello_nack`` + ``negotiate_server``; client:
``offer_transports`` + ``maybe_attach``): the client's hello advertises
``transports: [shm, tcp]`` and its host identity (hostname + boot id);
when both sides share a host the server mints the ring pair and names the
segments in its reply.

Lifecycle: the server owns the segments and unlinks them on connection
teardown and at interpreter exit (atexit). The JAX package also unlinks
them from the flight recorder's crash hook; the port's flight recorder
comes with ROADMAP Queue 1 item 9, and with it that hook. A SIGKILLed
process runs none of these: its peer sees the death typed, and the stale
segments go at reboot.
"""
from __future__ import annotations

import atexit
import os
import pickle
import select
import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

from ..resilience import CommError
from . import serializer
from .shuttle import crc32 as _crc32  # native slice-by-8, equal to zlib.crc32

#: transport names a hello may legitimately ask for; anything else is a
#: hostile/garbage preference and the server NACKs it typed (bad_hello)
KNOWN_TRANSPORTS = ("shm", "tcp")

MAGIC = b"DSHMRG1\x00"
HEADER_SIZE = 128
_OFF_MAGIC = 0
_OFF_CAPACITY = 8
_OFF_WRITE_POS = 16
_OFF_READ_POS = 24
_OFF_WRITER_GEN = 32
_OFF_READER_GEN = 40
_OFF_WRITER_CLOSED = 48
_OFF_READER_CLOSED = 56
_OFF_WRITER_HB = 64
_OFF_READER_HB = 72

#: per-direction ring capacity (bytes). One request is in flight per
#: connection, so the ring only ever holds ~one frame; 4 MiB covers real
#: trajectory payloads with room for the occasional big weight blob to
#: stream through in chunks (a frame LARGER than the ring is rejected
#: typed — the TCP leg carries it instead).
DEFAULT_RING_BYTES = int(os.environ.get("DISTAR_SHM_RING_BYTES", 4 << 20))

#: a peer whose heartbeat word is older than this is dead (SIGKILL'd /
#: hung); its beat thread refreshes every window/4 while alive
DEFAULT_HEARTBEAT_WINDOW_S = 2.0

_FRAME_HDR = struct.Struct("<II")  # length, crc32
_U64 = struct.Struct("<Q")
_F64 = struct.Struct("<d")

# ----------------------------------------------------------------- errors


class ShmError(CommError):
    """Typed shm-transport failure. Subclasses ``CommError`` (retryable +
    ``ConnectionError``) so every transport-fault handler catches it;
    ``reason`` labels the fallback counter. ``code``/``to_wire`` follow the
    serve wire-error contract: ``serve.errors`` registers ``shm_error`` as
    ``RingServiceError``, so a ring-pump reply rehydrates typed."""

    reason = "shm_error"
    code = "shm_error"

    def __init__(self, message: str, op: str = "", reason: str = ""):
        super().__init__(message, op=op)
        if reason:
            self.reason = reason

    def to_wire(self) -> dict:
        return {"code": self.code, "error": str(self)}


class ShmPeerDeadError(ShmError):
    """The ring peer died (stale heartbeat / generation change / closed
    flag) while this side was blocked on it."""

    reason = "peer_dead"


class ShmFrameTooLargeError(ShmError):
    """The frame being written can never fit the ring — rejected typed at
    send so the caller can route it over the TCP leg instead of blocking
    forever on space that cannot appear."""

    reason = "frame_too_large"


class ShmCorruptError(ShmError):
    """A frame failed its CRC (or the header desynced): the ring contents
    are no longer trustworthy."""

    reason = "corrupt"


class ShmTimeout(ShmError, TimeoutError):
    """The peer is alive but did not produce/consume within the timeout —
    the shm analogue of ``socket.timeout``."""

    reason = "timeout"


class ShmUnavailableError(ShmError):
    """This host cannot speak shm (no ``multiprocessing.shared_memory``)."""

    reason = "unavailable"


# ------------------------------------------------------- host environment

# injectable module handle: tests patch this to None to simulate a host
# without multiprocessing.shared_memory (the fallback-negotiation case)
try:
    from multiprocessing import shared_memory as _sm  # noqa: N813
except ImportError:  # pragma: no cover - every CPython >= 3.8 has it
    _sm = None


def shm_available() -> bool:
    return _sm is not None


def host_identity() -> str:
    """Same-host rendezvous token: hostname plus the kernel boot id, so a
    spoofed hostname alone never matches (and even a forged full token
    fails at segment-attach time — the names don't exist cross-host)."""
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            boot = f.read().strip()
    except OSError:  # non-Linux: hostname-only (attach still self-verifies)
        boot = ""
    return f"{socket.gethostname()}|{boot}"


def offer_transports(prefer: str = "auto") -> list:
    """The ``transports`` preference list a client hello should carry.
    ``tcp`` means "never shm" (no list sent at all keeps the legacy wire
    byte-identical, so callers skip the key when this returns ['tcp'])."""
    if prefer not in ("auto", "shm", "tcp"):
        raise ValueError(f"transport must be auto|shm|tcp, got {prefer!r}")
    if prefer == "tcp" or not shm_available():
        return ["tcp"]
    return ["shm", "tcp"]


def hello_nack(req: dict) -> Optional[str]:
    """Reason string when a hello's preference lists contain no recognized
    name at all (garbage/hostile hello — NACK typed instead of silently
    degrading); None when the hello is answerable. A preference that is
    recognized but unavailable on this host still degrades gracefully."""
    codecs = req.get("codecs")
    if codecs and not any(c in serializer.KNOWN_CODECS for c in codecs):
        return (f"no recognized codec in {list(codecs)!r} "
                f"(know {list(serializer.KNOWN_CODECS)})")
    transports = req.get("transports")
    if transports and not any(t in KNOWN_TRANSPORTS for t in transports):
        return (f"no recognized transport in {list(transports)!r} "
                f"(know {list(KNOWN_TRANSPORTS)})")
    return None


# ------------------------------------------------------------ observability


def _metrics():
    from ..obs import get_registry

    return get_registry()


def note_fallback(reason: str) -> None:
    """Count one shm->tcp fallback (peer death, attach failure, oversized
    frame, corruption) under its reason label."""
    _metrics().counter(
        "distar_shm_fallbacks_total",
        "shm-transport operations that fell back to the TCP leg",
        reason=reason,
    ).inc()


# ------------------------------------------------------------- ring segment

_live_lock = threading.Lock()
_live_rings: Dict[str, "ShmRing"] = {}
_cleanup_hooked = False


def _register_owned(ring: "ShmRing") -> None:
    global _cleanup_hooked
    with _live_lock:
        _live_rings[ring.name] = ring
        if not _cleanup_hooked:
            _cleanup_hooked = True
            atexit.register(unlink_all)


def _deregister_owned(ring: "ShmRing") -> None:
    with _live_lock:
        _live_rings.pop(ring.name, None)


def unlink_all() -> int:
    """Unlink every ring this process still owns (registered with atexit,
    so an exiting server leaves no /dev/shm entries)."""
    with _live_lock:
        rings = list(_live_rings.values())
    for ring in rings:
        ring.unlink()
    return len(rings)


def _untrack(shm) -> None:
    """Detach an ATTACHED (non-owning) segment from this process's
    resource tracker: on 3.8-3.12 ``SharedMemory(name=...)`` registers the
    segment as ours, and the tracker would unlink the server's ring (with
    a leak warning) when the client exits."""
    try:  # stdlib-private, so fail soft on future layout changes
        from multiprocessing import resource_tracker

        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:
        pass


class ShmRing:
    """One shared-memory ring segment (header + data region). Create on
    the owning side, attach by name on the peer; ``RingWriter``/
    ``RingReader`` are the single-writer/single-reader endpoints."""

    def __init__(self, shm, owner: bool):
        self._shm = shm
        self.owner = owner
        self.name = shm.name
        self.buf = shm.buf
        self._closed = False
        self._unlinked = False
        if owner:
            self.buf[_OFF_MAGIC:_OFF_MAGIC + 8] = MAGIC
            capacity = shm.size - HEADER_SIZE
            _U64.pack_into(self.buf, _OFF_CAPACITY, capacity)
            for off in (_OFF_WRITE_POS, _OFF_READ_POS, _OFF_WRITER_GEN,
                        _OFF_READER_GEN, _OFF_WRITER_CLOSED, _OFF_READER_CLOSED):
                _U64.pack_into(self.buf, off, 0)
            _F64.pack_into(self.buf, _OFF_WRITER_HB, 0.0)
            _F64.pack_into(self.buf, _OFF_READER_HB, 0.0)
            _register_owned(self)
        else:
            if bytes(self.buf[_OFF_MAGIC:_OFF_MAGIC + 8]) != MAGIC:
                shm.close()
                raise ShmCorruptError(
                    f"segment {self.name!r} is not a distar shm ring")
        self.capacity = _U64.unpack_from(self.buf, _OFF_CAPACITY)[0]

    # ------------------------------------------------------------ factories
    @classmethod
    def create(cls, capacity: int = DEFAULT_RING_BYTES) -> "ShmRing":
        if _sm is None:
            raise ShmUnavailableError("no multiprocessing.shared_memory on this host")
        if capacity < 4096:
            raise ValueError(f"ring capacity {capacity} is below the 4 KiB floor")
        shm = _sm.SharedMemory(create=True, size=HEADER_SIZE + int(capacity))
        return cls(shm, owner=True)

    @classmethod
    def attach(cls, name: str) -> "ShmRing":
        if _sm is None:
            raise ShmUnavailableError("no multiprocessing.shared_memory on this host")
        try:
            shm = _sm.SharedMemory(name=name)
        except (FileNotFoundError, OSError, ValueError) as e:
            raise ShmError(f"cannot attach ring {name!r}: {e!r}",
                           reason="attach_failed") from e
        _untrack(shm)
        return cls(shm, owner=False)

    # -------------------------------------------------------- header access
    # every accessor guards against a locally-closed ring (buf = None):
    # another thread tearing the connection down mid-wait must surface as
    # a TYPED ShmError to the pump/caller, not a raw TypeError
    def _hdr(self):
        buf = self.buf
        if buf is None:
            raise ShmError(f"ring {self.name} closed locally", reason="closed")
        return buf

    def _u64(self, off: int) -> int:
        return _U64.unpack_from(self._hdr(), off)[0]

    def _set_u64(self, off: int, value: int) -> None:
        _U64.pack_into(self._hdr(), off, value)

    def _f64(self, off: int) -> float:
        return _F64.unpack_from(self._hdr(), off)[0]

    def _set_f64(self, off: int, value: float) -> None:
        _F64.pack_into(self._hdr(), off, value)

    # ------------------------------------------------------------- lifecycle
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            # release our memoryview before closing the mapping (CPython
            # refuses to close an shm with exported buffers)
            self.buf = None
            self._shm.close()
        except (OSError, BufferError):
            pass

    def unlink(self) -> None:
        if not self.owner or self._unlinked:
            return
        self._unlinked = True
        _deregister_owned(self)
        self.close()
        try:
            # re-balance the resource tracker before unlink: a same-process
            # attach (in-process servers, tests) already _untrack'd the
            # name, and SharedMemory.unlink's own unregister would then
            # KeyError-spam the tracker daemon. register is set-idempotent.
            from multiprocessing import resource_tracker

            resource_tracker.register(self._shm._name, "shared_memory")
        except Exception:
            pass
        try:
            self._shm.unlink()
        except (FileNotFoundError, OSError):
            pass


def _copy_into(buf, capacity: int, pos: int, data) -> None:
    """Copy ``data`` into the ring data region at absolute position
    ``pos`` (mod capacity), splitting across the wrap point as needed."""
    off = pos % capacity
    n = len(data)
    first = min(n, capacity - off)
    buf[HEADER_SIZE + off:HEADER_SIZE + off + first] = data[:first]
    if n > first:
        buf[HEADER_SIZE:HEADER_SIZE + (n - first)] = data[first:]


def _view_out(buf, capacity: int, pos: int, n: int):
    """Payload at absolute ``pos``: a zero-copy memoryview when the frame
    is contiguous, an assembled bytes object when it wraps."""
    off = pos % capacity
    if off + n <= capacity:
        return buf[HEADER_SIZE + off:HEADER_SIZE + off + n]
    first = capacity - off
    return (bytes(buf[HEADER_SIZE + off:HEADER_SIZE + capacity])
            + bytes(buf[HEADER_SIZE:HEADER_SIZE + (n - first)]))


class Doorbell:
    """One endpoint's wake channel: a loopback UDP socket the PEER rings
    with a 1-byte datagram whenever it publishes a frame or frees ring
    space. Purely a latency device — the ring header remains the truth,
    so lost/spurious dings are harmless. The remote address is either set
    from the hello fields (client side) or learned from the source
    address of the first ding (server side), so no extra handshake frame
    is needed."""

    #: wait-slice: an upper bound on wake latency when a ding is lost AND
    #: the cadence of peer-death re-checks while blocked
    SLICE_S = 0.25

    def __init__(self):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind(("127.0.0.1", 0))
        self._sock.setblocking(False)  # waits go through select (GIL-free)
        self.port = self._sock.getsockname()[1]
        self._remote: Optional[Tuple[str, int]] = None
        self._closed = False

    def set_remote(self, port: int) -> None:
        self._remote = ("127.0.0.1", int(port))

    def ring(self) -> None:
        remote = self._remote
        if remote is None or self._closed:
            return
        try:
            self._sock.sendto(b"\x01", remote)
        except OSError:
            pass

    def _drain(self) -> None:
        """Consume pending dings without blocking (learning the remote
        address from the first sender when unknown)."""
        try:
            while True:
                _, addr = self._sock.recvfrom(16)
                if self._remote is None:
                    self._remote = addr
        except (BlockingIOError, OSError, ValueError):
            pass

    def wait(self, cond: Callable[[], bool], timeout_s: float,
             check: Callable[[], None], op: str) -> None:
        """Block until ``cond()`` holds: kernel-sleep on the doorbell in
        slices (``select``, so the GIL is released), re-checking the
        header (``check`` raises typed on peer death) each wake. Raises
        ``ShmTimeout`` past the deadline."""
        if cond():
            if self._remote is None:
                self._drain()  # learn the remote from any queued ding
            return
        deadline = time.monotonic() + timeout_s
        while True:
            check()
            if cond():
                self._drain()
                return
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise ShmTimeout(
                    f"{op} timed out after {timeout_s:.1f}s on shm ring", op=op)
            try:
                select.select([self._sock], [], [],
                              min(self.SLICE_S, remaining))
            except (OSError, ValueError):
                pass
            self._drain()

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass


class _RingFile:
    """Writable file-like over the staged (unpublished) region of a ring:
    what ``serializer.dump_stream`` pickles into. Blocks for space when
    the ring is full (counted into the ring-full-wait histogram), raises
    typed when the frame can never fit, and CRCs incrementally so the
    frame header needs no second pass over the payload."""

    def __init__(self, writer: "RingWriter", frame_start: int, timeout_s: float):
        self._w = writer
        self._frame_start = frame_start
        self.pos = frame_start + _FRAME_HDR.size  # payload starts past the header
        self.crc = 0
        self._timeout_s = timeout_s
        self._read_cache = writer.read_pos()

    def write(self, data) -> int:
        w = self._w
        ring = w.ring
        if not isinstance(data, bytes):
            data = memoryview(data).cast("B")
        n = len(data)
        if self.pos + n - self._frame_start > ring.capacity:
            raise ShmFrameTooLargeError(
                f"frame exceeds ring capacity {ring.capacity} "
                f"(>= {self.pos + n - self._frame_start} bytes)", op=w.op)
        # common case: the whole chunk fits the cached free-space estimate
        # (read_pos only moves forward, so a stale cache under-estimates)
        if n <= ring.capacity - (self.pos - self._read_cache):
            _copy_into(ring.buf, ring.capacity, self.pos, data)
            self.crc = _crc32(data, self.crc)
            self.pos += n
            return n
        taken = 0
        while taken < n:
            self._read_cache = w.read_pos()
            free = ring.capacity - (self.pos - self._read_cache)
            if free <= 0:
                w.wait_for_space(self.pos, self._timeout_s)
                continue
            chunk = data[taken:taken + min(free, n - taken)]
            _copy_into(ring.buf, ring.capacity, self.pos, chunk)
            self.crc = _crc32(chunk, self.crc)
            self.pos += len(chunk)
            taken += len(chunk)
        return n


class RingWriter:
    """The single writing endpoint of one ring."""

    def __init__(self, ring: ShmRing, op: str = "shm",
                 bell: Optional[Doorbell] = None):
        self.ring = ring
        self.op = op
        self.bell = bell if bell is not None else Doorbell()
        self._gen = (int.from_bytes(os.urandom(7), "big") | 1)
        ring._set_u64(_OFF_WRITER_GEN, self._gen)
        self.beat()
        self._pos = ring._u64(_OFF_WRITE_POS)
        self._peer_gen = 0
        reg = _metrics()
        self._c_frames = reg.counter(
            "distar_shm_tx_frames_total", "frames written to shm rings")
        self._c_bytes = reg.counter(
            "distar_shm_tx_bytes_total", "bytes written to shm rings")
        self._h_full_wait = reg.histogram(
            "distar_shm_ring_full_wait_seconds",
            "writer wall-clock blocked on a full ring waiting for the reader")

    # ------------------------------------------------------------- liveness
    def beat(self) -> None:
        self.ring._set_f64(_OFF_WRITER_HB, time.time())

    def read_pos(self) -> int:
        return self.ring._u64(_OFF_READ_POS)

    def _check_reader_alive(self) -> None:
        ring = self.ring
        if ring._u64(_OFF_READER_CLOSED):
            raise ShmPeerDeadError("shm reader closed the ring", op=self.op)
        gen = ring._u64(_OFF_READER_GEN)
        if gen:
            if self._peer_gen == 0:
                self._peer_gen = gen
            elif gen != self._peer_gen:
                raise ShmPeerDeadError(
                    "shm reader generation changed (peer restarted)", op=self.op)
            hb = ring._f64(_OFF_READER_HB)
            if hb and time.time() - hb > DEFAULT_HEARTBEAT_WINDOW_S:
                raise ShmPeerDeadError(
                    f"shm reader heartbeat stale ({time.time() - hb:.2f}s)",
                    op=self.op)

    def wait_for_space(self, staged_end: int, timeout_s: float) -> None:
        t0 = time.monotonic()
        try:
            self.bell.wait(
                lambda: self.ring.capacity - (staged_end - self.read_pos()) > 0,
                timeout_s, self._check_reader_alive, f"{self.op}:send")
        finally:
            waited = time.monotonic() - t0
            self._h_full_wait.observe(waited)
            if waited > 0.0005:
                # the blocked producer charges its ring-full wait to the
                # request span riding this thread (obs.set_active_trace)
                from ..obs.trace import annotate_active

                annotate_active("blocked_s", waited)

    # ------------------------------------------------------------------ api
    def send(self, obj: Any, timeout_s: float = 30.0) -> int:
        """Serialize ``obj`` straight into the ring and publish it as one
        CRC'd frame; returns the frame's payload length."""
        ring = self.ring
        start = self._pos
        f = _RingFile(self, start, timeout_s)
        serializer.dump_stream(obj, f)
        length = f.pos - start - _FRAME_HDR.size
        _copy_into(ring.buf, ring.capacity, start,
                   _FRAME_HDR.pack(length, f.crc))
        self.beat()
        self._pos = f.pos
        ring._set_u64(_OFF_WRITE_POS, self._pos)  # the publish
        self.bell.ring()  # wake a reader blocked on an empty ring
        self._c_frames.inc()
        self._c_bytes.inc(length + _FRAME_HDR.size)
        return length

    def close(self) -> None:
        try:
            if self.ring.buf is not None:
                self.ring._set_u64(_OFF_WRITER_CLOSED, 1)
        except (ShmError, TypeError, ValueError):
            pass


class RingReader:
    """The single reading endpoint of one ring."""

    def __init__(self, ring: ShmRing, op: str = "shm",
                 bell: Optional[Doorbell] = None):
        self.ring = ring
        self.op = op
        self.bell = bell if bell is not None else Doorbell()
        self._gen = (int.from_bytes(os.urandom(7), "big") | 1)
        ring._set_u64(_OFF_READER_GEN, self._gen)
        self.beat()
        self._pos = ring._u64(_OFF_READ_POS)
        self._peer_gen = 0
        reg = _metrics()
        self._c_frames = reg.counter(
            "distar_shm_rx_frames_total", "frames read from shm rings")
        self._c_bytes = reg.counter(
            "distar_shm_rx_bytes_total", "bytes read from shm rings")

    # ------------------------------------------------------------- liveness
    def beat(self) -> None:
        self.ring._set_f64(_OFF_READER_HB, time.time())

    def write_pos(self) -> int:
        return self.ring._u64(_OFF_WRITE_POS)

    def _check_writer_alive(self) -> None:
        ring = self.ring
        if self.write_pos() > self._pos:
            return  # data is ready: serve it even if the peer died after
        if ring._u64(_OFF_WRITER_CLOSED):
            raise ShmPeerDeadError("shm writer closed the ring", op=self.op)
        gen = ring._u64(_OFF_WRITER_GEN)
        if gen:
            if self._peer_gen == 0:
                self._peer_gen = gen
            elif gen != self._peer_gen:
                raise ShmPeerDeadError(
                    "shm writer generation changed (peer restarted)", op=self.op)
            hb = ring._f64(_OFF_WRITER_HB)
            if hb and time.time() - hb > DEFAULT_HEARTBEAT_WINDOW_S:
                raise ShmPeerDeadError(
                    f"shm writer heartbeat stale ({time.time() - hb:.2f}s)",
                    op=self.op)

    # ------------------------------------------------------------------ api
    def recv(self, timeout_s: float = 30.0) -> Any:
        """Block for the next frame (typed ``ShmTimeout`` /
        ``ShmPeerDeadError``), CRC-check it, and deserialize — zero-copy
        when the frame did not wrap the ring edge."""
        ring = self.ring
        self.bell.wait(lambda: self.write_pos() > self._pos, timeout_s,
                       self._check_writer_alive, f"{self.op}:recv")
        off = self._pos % ring.capacity
        if off + _FRAME_HDR.size <= ring.capacity:  # contiguous header
            length, crc = _FRAME_HDR.unpack_from(ring.buf, HEADER_SIZE + off)
        else:
            length, crc = _FRAME_HDR.unpack(bytes(_view_out(
                ring.buf, ring.capacity, self._pos, _FRAME_HDR.size)))
        if length > ring.capacity - _FRAME_HDR.size \
                or self._pos + _FRAME_HDR.size + length > self.write_pos():
            raise ShmCorruptError(
                f"implausible frame length {length} at pos {self._pos} "
                f"(capacity {ring.capacity})", op=self.op)
        payload = _view_out(ring.buf, ring.capacity,
                            self._pos + _FRAME_HDR.size, length)
        try:
            if _crc32(payload) != crc:
                raise ShmCorruptError(
                    f"frame CRC mismatch at pos {self._pos} (length {length})",
                    op=self.op)
            try:
                obj = serializer.loads(payload)
            except (pickle.UnpicklingError, ValueError, EOFError) as e:
                raise ShmCorruptError(f"undecodable shm frame: {e!r}",
                                      op=self.op) from e
        finally:
            # release on EVERY path: a leaked export keeps the mapping
            # pinned and SharedMemory.close() raises BufferError at GC
            if isinstance(payload, memoryview):
                payload.release()
        # consume AFTER decode: a zero-copy view must not be overwritten
        # by the writer while loads is still reading it
        self._pos += _FRAME_HDR.size + length
        ring._set_u64(_OFF_READ_POS, self._pos)
        self.bell.ring()  # wake a writer blocked on a full ring
        self.beat()
        self._c_frames.inc()
        self._c_bytes.inc(length + _FRAME_HDR.size)
        return obj

    def close(self) -> None:
        try:
            if self.ring.buf is not None:
                self.ring._set_u64(_OFF_READER_CLOSED, 1)
        except (ShmError, TypeError, ValueError):
            pass


# ------------------------------------------------------------- connections


class ShmPeer:
    """One side of a negotiated ring pair: a writer on the outbound ring,
    a reader on the inbound one, and a beat thread keeping both heartbeat
    words fresh while this side is alive (so idleness is never mistaken
    for death). The server side ``owner=True`` unlinks the segments on
    close; the client side only detaches."""

    def __init__(self, tx: ShmRing, rx: ShmRing, owner: bool, op: str = "shm"):
        self._tx_ring = tx
        self._rx_ring = rx
        self.owner = owner
        self.op = op
        #: ONE doorbell socket per endpoint: the peer rings it on publish
        #: (data ready) and on consume (space freed); both this side's
        #: writer and reader sleep on it and re-check their own condition
        self.bell = Doorbell()
        self.writer = RingWriter(tx, op=op, bell=self.bell)
        self.reader = RingReader(rx, op=op, bell=self.bell)
        self._closed = threading.Event()
        self._beat_thread = threading.Thread(
            target=self._beat_loop, name=f"shm-beat-{op}", daemon=True)
        self._beat_thread.start()

    def _beat_loop(self) -> None:
        interval = DEFAULT_HEARTBEAT_WINDOW_S / 4.0
        while not self._closed.wait(interval):
            try:
                self.writer.beat()
                self.reader.beat()
            except (ShmError, TypeError, ValueError):  # released under us
                return

    # ------------------------------------------------------------------ api
    def send(self, obj: Any, timeout_s: float = 30.0) -> int:
        return self.writer.send(obj, timeout_s=timeout_s)

    def recv(self, timeout_s: float = 30.0) -> Any:
        return self.reader.recv(timeout_s=timeout_s)

    def request(self, req: Any, timeout_s: float = 30.0) -> Any:
        """One RPC over the rings: send the request frame, block for the
        response frame (the client-side data-plane hot path)."""
        self.send(req, timeout_s=timeout_s)
        return self.recv(timeout_s=timeout_s)

    @property
    def names(self) -> Tuple[str, str]:
        return (self._tx_ring.name, self._rx_ring.name)

    def close(self) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        # join BEFORE tearing the rings down: a beat mid-flight would race
        # the unlink below (tolerated by its except, but joining removes
        # the window entirely); the loop re-checks _closed every wait tick
        if self._beat_thread is not threading.current_thread():
            self._beat_thread.join(timeout=DEFAULT_HEARTBEAT_WINDOW_S)
        self.writer.close()
        self.reader.close()
        self.bell.ring()  # nudge a blocked peer so it re-checks the flags
        self.bell.close()
        for ring in (self._tx_ring, self._rx_ring):
            if self.owner:
                ring.unlink()
            else:
                ring.close()


def mint_ring_pair(ring_bytes: int = DEFAULT_RING_BYTES,
                   op: str = "shm") -> Tuple[ShmPeer, dict]:
    """Server side: create both direction rings and return (server peer,
    the hello-reply fields the client needs to attach)."""
    c2s = ShmRing.create(ring_bytes)
    try:
        s2c = ShmRing.create(ring_bytes)
    except Exception:
        c2s.unlink()
        raise
    peer = ShmPeer(tx=s2c, rx=c2s, owner=True, op=op)
    fields = {"transport": "shm", "shm_c2s": c2s.name, "shm_s2c": s2c.name,
              "ring_bytes": int(ring_bytes), "doorbell_port": peer.bell.port}
    return peer, fields


def attach_ring_pair(reply: dict, op: str = "shm") -> ShmPeer:
    """Client side: attach the rings a hello reply named (client writes
    c2s, reads s2c)."""
    c2s = ShmRing.attach(reply["shm_c2s"])
    try:
        s2c = ShmRing.attach(reply["shm_s2c"])
    except Exception:
        c2s.close()
        raise
    peer = ShmPeer(tx=c2s, rx=s2c, owner=False, op=op)
    port = reply.get("doorbell_port")
    if port:
        peer.bell.set_remote(int(port))
        peer.bell.ring()  # announce our doorbell address to the server
    return peer


def maybe_attach(reply: dict, op: str = "shm") -> Optional[ShmPeer]:
    """Attach when the server's hello reply negotiated shm; None (counted)
    when it didn't or the attach fails — the caller stays on TCP."""
    if not isinstance(reply, dict) or reply.get("transport") != "shm":
        return None
    try:
        return attach_ring_pair(reply, op=op)
    except Exception:
        note_fallback("attach_failed")
        return None


def negotiate_server(req: dict, transport: str = "auto",
                     ring_bytes: int = DEFAULT_RING_BYTES,
                     op: str = "shm") -> Tuple[dict, Optional[ShmPeer]]:
    """Server side of the hello: decide the connection's transport.

    Returns ``(reply_fields, peer)`` — ``peer`` is the live server ring
    endpoint when shm was agreed (caller starts a ``RingService`` on it
    and must close it on connection teardown), else None. shm is agreed
    only when the client offered it, this server allows it, both report
    the same host identity, and the segments actually mint."""
    prefs = req.get("transports")
    if prefs is None:
        return {}, None  # legacy client: no negotiation, no reply fields
    want_shm = ("shm" in prefs and transport in ("auto", "shm")
                and shm_available()
                and str(req.get("host", "")) == host_identity())
    if want_shm:
        try:
            peer, fields = mint_ring_pair(ring_bytes, op=op)
            return fields, peer
        except Exception:
            note_fallback("mint_failed")
    return {"transport": "tcp"}, None


class RingService:
    """Server-side pump for one negotiated connection: a daemon thread
    that answers ring frames with ``dispatch(req)`` until the connection
    tears down or the client dies (detected typed). Owns the peer's
    lifecycle — ``stop()`` closes and unlinks the rings."""

    POLL_S = 0.25

    def __init__(self, peer: ShmPeer, dispatch: Callable[[Any], Any],
                 name: str = "shm-ring-service"):
        self._peer = peer
        self._dispatch = dispatch
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, name=name, daemon=True)

    def start(self) -> "RingService":
        self._thread.start()
        return self

    def _loop(self) -> None:
        try:
            while not self._stop.is_set():
                try:
                    req = self._peer.recv(timeout_s=self.POLL_S)
                except ShmTimeout:
                    continue
                except ShmError:
                    return  # peer dead/corrupt: the TCP leg owns recovery
                try:
                    resp = self._dispatch(req)
                except Exception as e:  # dispatch bug must not kill the pump
                    resp = ShmError(repr(e), op=self._thread.name).to_wire()
                try:
                    self._peer.send(resp, timeout_s=30.0)
                except ShmError:
                    return
        finally:
            self._peer.close()

    def stop(self, join_s: float = 2.0) -> None:
        self._stop.set()
        self._thread.join(join_s)
        self._peer.close()  # idempotent; covers a wedged pump thread

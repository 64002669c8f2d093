"""Payload (de)serialization and framing for the serve data plane.

Counterpart of ``distar_tpu.comm.serializer``: a payload is a 4-byte magic
and a pickle (protocol 5), compressed or not; a frame is an 8-byte
big-endian length prefix around one payload. Both packages' frontends and
clients speak this, so either package's client talks to either's server.

Encoding: the JAX package's ``lz4`` codec name writes ``DTL0`` (LZ4 block)
through its native library and falls back to zlib-1 (``DTZ0``) on a host
without it. The port has no native LZ codec yet, so ``lz4`` writes the
zlib-1 fallback, as the JAX package does on such a host; ``zlib`` writes
zlib-1 too, and ``zstd`` (``DTS0``) only where a ``zstandard`` binding
imports. Decoding takes every magic the JAX package writes: ``DTL0``
through a pure-Python LZ4-block decoder (a copy of the JAX shuttle's
fallback decoder), ``DTS0`` gated on ``zstandard``. A native LZ codec is
not in the port yet.
"""
from __future__ import annotations

import pickle
import struct
import zlib
from typing import Any, Optional, Sequence, Tuple

MAGIC_RAW = b"DTR0"
MAGIC_ZLIB = b"DTZ0"
MAGIC_LZ = b"DTL0"  # + u64 LE decompressed size + lz4-block stream
MAGIC_ZSTD = b"DTS0"  # + u64 LE decompressed size + zstd stream

try:  # optional, as in the JAX package: everything zstd is gated on it
    import zstandard as _zstd  # type: ignore[import-not-found]
except ImportError:
    _zstd = None

#: every codec name the protocol defines, available here or not: a hello
#: preference list holding none of these is garbage and answered typed
KNOWN_CODECS = ("lz4", "zlib", "zstd")


def supported_codecs() -> Tuple[str, ...]:
    """The codec names this host negotiates, preference-ordered."""
    return ("lz4", "zlib") + (("zstd",) if _zstd is not None else ())


def negotiate_codec(client_prefs: Optional[Sequence[str]],
                    server_codecs: Optional[Sequence[str]] = None) -> str:
    """The client's first preference the server also speaks, else the
    legacy ``"lz4"``."""
    server = tuple(server_codecs) if server_codecs is not None else supported_codecs()
    for pref in client_prefs or ():
        if pref in server and pref in supported_codecs():
            return str(pref)
    return "lz4"


def lz_decompress(blob, decompressed_len: int) -> bytes:
    """Pure-Python LZ4-block decoder (the JAX shuttle's fallback decoder).
    Raises ValueError, never IndexError, on a truncated or malformed
    stream."""
    src = memoryview(blob)
    out = bytearray()
    i, end = 0, len(src)

    def read_byte(pos: int) -> int:
        if pos >= end:
            raise ValueError("malformed lz stream (truncated)")
        return src[pos]

    while i < end:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = read_byte(i)
                i += 1
                lit += b
                if b != 255:
                    break
        if i + lit > end:
            raise ValueError("malformed lz stream (truncated literals)")
        out += src[i:i + lit]
        i += lit
        if i >= end:
            break
        if i + 2 > end:
            raise ValueError("malformed lz stream (truncated offset)")
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0 or offset > len(out):
            raise ValueError("malformed lz stream (bad offset)")
        mlen = token & 0x0F
        if mlen == 15:
            while True:
                b = read_byte(i)
                i += 1
                mlen += b
                if b != 255:
                    break
        mlen += 4
        start = len(out) - offset
        if offset >= mlen:
            out += out[start:start + mlen]
        else:
            for k in range(mlen):  # an overlapping copy runs byte by byte
                out.append(out[start + k])
    if len(out) != decompressed_len:
        raise ValueError(f"decompressed {len(out)} != expected {decompressed_len}")
    return bytes(out)


def dumps_sized(obj: Any, compress: bool = True, codec: str = "lz4") -> "tuple[bytes, int]":
    """``(blob, raw_len)``: ``raw_len`` is the pickle's size before
    compression."""
    payload = pickle.dumps(obj, protocol=5)
    raw_len = len(payload)
    if not compress:
        return MAGIC_RAW + payload, raw_len
    if codec == "zstd":
        if _zstd is None:
            raise ValueError("zstd codec requested but no zstd binding on this host")
        return (MAGIC_ZSTD + struct.pack("<Q", raw_len)
                + _zstd.ZstdCompressor(level=3).compress(payload), raw_len)
    if codec not in ("lz4", "zlib"):
        raise ValueError(f"unknown wire codec {codec!r} (know {supported_codecs()})")
    return MAGIC_ZLIB + zlib.compress(payload, level=1), raw_len


def dumps(obj: Any, compress: bool = True, codec: str = "lz4") -> bytes:
    return dumps_sized(obj, compress=compress, codec=codec)[0]


def _checked_size(body, what: str) -> int:
    if len(body) < 8:
        raise ValueError(f"truncated {what} payload header")
    (n,) = struct.unpack("<Q", body[:8])
    # neither LZ4 blocks nor zstd expand past ~255x: a larger claim is a
    # corrupt or hostile header, refused before allocating
    if n > max(1024, (len(body) - 8) * 255):
        raise ValueError(f"implausible decompressed size {n} for {len(body) - 8}-byte stream")
    return n


def loads_sized(blob: bytes) -> "tuple[Any, int]":
    """``(obj, raw_len)``, the decode twin of ``dumps_sized``."""
    magic, body = blob[:4], memoryview(blob)[4:]
    if magic == MAGIC_ZSTD:
        n = _checked_size(body, "zstd")
        if _zstd is None:
            raise ValueError("zstd-compressed payload but no zstd binding on this host "
                             "(negotiation should have prevented this)")
        return pickle.loads(_zstd.ZstdDecompressor().decompress(bytes(body[8:]), max_output_size=n)), n
    if magic == MAGIC_LZ:
        n = _checked_size(body, "lz")
        return pickle.loads(lz_decompress(body[8:], n)), n
    if magic == MAGIC_ZLIB:
        payload = zlib.decompress(body)
        return pickle.loads(payload), len(payload)
    if magic == MAGIC_RAW:
        return pickle.loads(body), len(body)
    raise ValueError(f"unknown payload magic {bytes(magic)!r}")


def loads(blob: bytes) -> Any:
    return loads_sized(blob)[0]


#: a frame header claiming more than this is garbage (another protocol, or
#: a desynced stream): refused typed instead of a multi-GiB allocation
DEFAULT_MAX_FRAME = 1 << 32  # 4 GiB


def frame(blob: bytes) -> bytes:
    """Length-prefix a payload (8-byte big-endian)."""
    return struct.pack(">Q", len(blob)) + blob


def read_frame(recv_exact, max_frame_bytes: int = DEFAULT_MAX_FRAME) -> bytes:
    """One frame through a ``recv_exact(n) -> bytes`` callable; ValueError
    on an implausible header."""
    (n,) = struct.unpack(">Q", recv_exact(8))
    if n > max_frame_bytes:
        raise ValueError(f"implausible frame length {n} (max {max_frame_bytes})")
    return recv_exact(n)


def sock_recv_exact(sock, n: int) -> bytes:
    """Exactly ``n`` bytes from a connected socket; ``ConnectionError`` on
    EOF mid-frame."""
    chunks = []
    while n > 0:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionError("connection closed mid-frame")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def send_msg(sock, obj: Any, compress: bool = True, codec: str = "lz4") -> None:
    """Serialize, frame and send one message on a connected socket."""
    sock.sendall(frame(dumps(obj, compress=compress, codec=codec)))


def recv_msg(sock, max_frame_bytes: int = DEFAULT_MAX_FRAME) -> Any:
    """Receive and deserialize one framed message from a connected socket."""
    return loads(read_frame(lambda n: sock_recv_exact(sock, n), max_frame_bytes))

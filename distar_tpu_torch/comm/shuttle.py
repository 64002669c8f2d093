"""ctypes binding of the data plane's native library.

Counterpart of ``distar_tpu.comm.shuttle``: the socket shuttle (``serve``,
``fetch``), the LZ4-block codec behind the serializer's ``DTL0`` frames
(``lz_compress``, ``lz_decompress``) and the slice-by-8 ``crc32`` the
shared-memory rings checksum frames with, all from ``native/shuttle.cpp``
(a copy of the JAX package's source, so both packages write the same
bytes).

Build: host C++, ``g++ -O2 -shared -fPIC -std=c++17 -lpthread`` (the JAX
package's flags), at first use, into ``distar_tpu_torch/_build/shuttle-
<hash>.so`` keyed by the source and the flags. Several processes may build
at once (pytest workers, a fleet's gateways): the build runs under a file
lock, writes a temporary name and ``os.replace``-s it into place, so no
process loads a half-written library. A failed build raises with the
compiler's output; nothing falls back to Python framing or zlib.

The pure-Python decoder and socket paths (``py_lz_decompress``,
``py_serve``, ``py_fetch``) are the JAX package's fallbacks, kept here only
as the plain versions the tests hold the native code against.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import socket
import struct
import subprocess
import threading
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "native" / "shuttle.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
GXX_LIBS = ("-lpthread",)

_lib = None
_lib_lock = threading.Lock()


def library_path() -> Path:
    """The library's path, keyed by the source and the flags."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS + GXX_LIBS).encode())
    return BUILD_DIR / f"shuttle-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``native/shuttle.cpp`` unless its library exists. Raises with
    the compiler's output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "shuttle.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one builder; the rest wait, then load
        if out.exists():
            return out
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: the data plane's native library "
                               "(comm/native/shuttle.cpp) builds with g++")
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SRC), *GXX_LIBS],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building {SRC.name} failed (g++ exited {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The native library, built first if missing; C signatures set."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        P8 = ctypes.POINTER(ctypes.c_uint8)
        lib.shuttle_serve.argtypes = [P8, ctypes.c_uint64, ctypes.c_int, ctypes.c_int]
        lib.shuttle_serve.restype = ctypes.c_int
        lib.shuttle_fetch.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                      ctypes.POINTER(P8), ctypes.POINTER(ctypes.c_uint64)]
        lib.shuttle_fetch.restype = ctypes.c_int
        lib.shuttle_free.argtypes = [P8]
        lib.shuttlez_bound.argtypes = [ctypes.c_uint64]
        lib.shuttlez_bound.restype = ctypes.c_uint64
        for fn in (lib.shuttlez_compress, lib.shuttlez_decompress):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64]
            fn.restype = ctypes.c_int64
        lib.shuttlez_crc32.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32]
        lib.shuttlez_crc32.restype = ctypes.c_uint32
        _lib = lib
        return _lib


def _view(data):
    """(address, length, keep-alive) of a bytes-like object, zero-copy.
    Views go through numpy's data pointer, not ctypes ``from_buffer``: the
    latter keeps a reference cycle that pins a shared-memory mapping until a
    GC pass (and ``SharedMemory.close`` then raises BufferError)."""
    import numpy as np

    arr = np.frombuffer(data, dtype=np.uint8)
    return arr.ctypes.data, arr.nbytes, arr


# ----------------------------------------------------------------- checksum
def crc32(data, crc: int = 0) -> int:
    """IEEE CRC-32 of a bytes-like object, equal to ``zlib.crc32``."""
    lib = load()
    if not len(data):
        return crc
    addr, n, keep = _view(data)
    out = lib.shuttlez_crc32(addr, n, crc)
    del keep
    return out


# ------------------------------------------------------- lz4-block codec
def lz_compress(data) -> bytes:
    """The LZ4 block stream of ``data``, from the native encoder."""
    lib = load()
    n = len(data)
    cap = lib.shuttlez_bound(n)
    out = ctypes.create_string_buffer(cap)
    addr, _, keep = _view(data) if n else (None, 0, None)
    got = lib.shuttlez_compress(addr, n, out, cap)
    del keep
    if got < 0:
        raise OSError(f"shuttlez_compress failed: {got}")
    return ctypes.string_at(out, got)


def lz_decompress(blob, decompressed_len: int) -> bytes:
    """Decode an LZ4 block stream with the native decoder. Raises
    ValueError on a malformed stream or a length other than
    ``decompressed_len``."""
    lib = load()
    out = ctypes.create_string_buffer(max(decompressed_len, 1))
    addr, n, keep = _view(blob) if len(blob) else (None, 0, None)
    got = lib.shuttlez_decompress(addr, n, out, decompressed_len)
    del keep
    if got < 0:
        raise ValueError(f"shuttlez_decompress failed: {got}")
    if got != decompressed_len:
        raise ValueError(f"decompressed {got} != expected {decompressed_len}")
    return ctypes.string_at(out, got)


def py_lz_decompress(blob, decompressed_len: int) -> bytes:
    """Plain LZ4-block decoder in Python (the JAX package's fallback
    decoder): the version ``lz_decompress`` is held against. Raises
    ValueError, never IndexError, on a truncated or malformed stream."""
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


# ------------------------------------------------------------------ shuttle
def _metrics():
    from ..obs import get_registry

    return get_registry()


def serve(payload: bytes, accept_count: int = 1, timeout_ms: int = 30_000) -> int:
    """Serve ``payload`` (framed) on an ephemeral port to up to
    ``accept_count`` connections from a native thread; returns the port."""
    reg = _metrics()
    reg.counter("distar_shuttle_serves_total", "serve windows opened").inc()
    reg.counter("distar_shuttle_tx_bytes_total", "payload bytes offered").inc(len(payload))
    lib = load()
    buf = (ctypes.c_uint8 * len(payload)).from_buffer_copy(payload)
    port = lib.shuttle_serve(buf, len(payload), accept_count, timeout_ms)
    if port <= 0:
        raise OSError(f"shuttle_serve failed: {port}")
    return port


def fetch(host: str, port: int, timeout_ms: int = 30_000) -> bytes:
    """Fetch one framed payload from host:port."""
    reg = _metrics()
    lib = load()
    try:
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_uint64()
        rc = lib.shuttle_fetch(host.encode(), port, timeout_ms, ctypes.byref(out),
                               ctypes.byref(out_len))
        if rc != 0:
            raise OSError(f"shuttle_fetch failed: {rc}")
        try:
            blob = ctypes.string_at(out, out_len.value)
        finally:
            lib.shuttle_free(out)
    except (OSError, ConnectionError):
        reg.counter("distar_shuttle_fetch_errors_total", "failed fetches").inc()
        raise
    reg.counter("distar_shuttle_fetches_total", "payloads fetched").inc()
    reg.counter("distar_shuttle_rx_bytes_total", "payload bytes received").inc(len(blob))
    return blob


def py_serve(payload: bytes, accept_count: int, timeout_ms: int) -> int:
    """Plain version of ``serve``: a Python thread and stdlib sockets."""
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    listener.bind(("0.0.0.0", 0))
    listener.listen(16)
    listener.settimeout(timeout_ms / 1000.0)
    port = listener.getsockname()[1]
    framed = struct.pack(">Q", len(payload)) + payload

    def run():
        try:
            for _ in range(accept_count):
                try:
                    conn, _ = listener.accept()
                except socket.timeout:
                    break
                # accepted sockets do not inherit the listener's timeout
                conn.settimeout(timeout_ms / 1000.0)
                try:
                    with conn:
                        conn.sendall(framed)
                except OSError:
                    continue  # a hung or reset consumer: the window stays open
        finally:
            listener.close()

    threading.Thread(target=run, daemon=True).start()
    return port


def py_fetch(host: str, port: int, timeout_ms: int) -> bytes:
    """Plain version of ``fetch``; ``timeout_ms`` bounds the whole fetch."""
    deadline = time.monotonic() + timeout_ms / 1000.0
    with socket.create_connection((host, port), timeout=timeout_ms / 1000.0) as s:

        def recv_exact(n: int) -> bytes:
            chunks = []
            while n > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise socket.timeout(f"fetch deadline ({timeout_ms}ms) exceeded")
                s.settimeout(remaining)
                chunk = s.recv(min(n, 1 << 20))
                if not chunk:
                    raise ConnectionError("short read")
                chunks.append(chunk)
                n -= len(chunk)
            return b"".join(chunks)

        (length,) = struct.unpack(">Q", recv_exact(8))
        return recv_exact(length)

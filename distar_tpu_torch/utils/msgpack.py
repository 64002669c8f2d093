"""A MessagePack reader and writer for the format of flax checkpoints.

The JAX package writes checkpoints with ``flax.serialization.
msgpack_serialize``: MessagePack (https://github.com/msgpack/msgpack/blob/
master/spec.md) of a tree of dicts whose leaves are arrays, numpy scalars,
complex numbers and plain values. The port has neither flax nor the
``msgpack`` package on the card, so it keeps this codec of its own.

* ``packb`` / ``unpackb`` cover nil, bool, int, float (32- and 64-bit in,
  64-bit out), str, bin, array, map and ext, byte for byte as the
  ``msgpack`` package writes them with ``use_bin_type=True``.
* ``serialize`` / ``restore`` are flax's ``msgpack_serialize`` /
  ``msgpack_restore``: ext 1 an array as the packed ``(shape, dtype name,
  C-order bytes)``, ext 3 a numpy scalar packed the same way, ext 2 a
  complex number as ``(real, imag)``; leaves over ``MAX_CHUNK_SIZE`` bytes
  split into ``{'__msgpack_chunked_array__': True, 'shape', 'chunks'}``.
  A ``bfloat16`` leaf (numpy has no bf16) comes back as a torch tensor
  read with ``torch.frombuffer``; torch tensors are written as arrays.
"""
from __future__ import annotations

import struct
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

NDARRAY, NATIVE_COMPLEX, NPSCALAR = 1, 2, 3  # flax's ext type codes
MAX_CHUNK_SIZE = 2 ** 30  # flax's: a leaf above this many bytes is chunked
CHUNKED = "__msgpack_chunked_array__"


class ExtType(NamedTuple):
    code: int
    data: bytes


# ------------------------------------------------------------------ writer
def _pack_int(n: int, out: list) -> None:
    if 0 <= n < 0x80:
        out.append(struct.pack("B", n))
    elif -0x20 <= n < 0:
        out.append(struct.pack("b", n))
    elif 0 < n <= 0xFF:
        out.append(struct.pack(">BB", 0xCC, n))
    elif -0x80 <= n < 0:
        out.append(struct.pack(">Bb", 0xD0, n))
    elif 0 < n <= 0xFFFF:
        out.append(struct.pack(">BH", 0xCD, n))
    elif -0x8000 <= n < 0:
        out.append(struct.pack(">Bh", 0xD1, n))
    elif 0 < n <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", 0xCE, n))
    elif -0x80000000 <= n < 0:
        out.append(struct.pack(">Bi", 0xD2, n))
    elif 0 < n <= 0xFFFFFFFFFFFFFFFF:
        out.append(struct.pack(">BQ", 0xCF, n))
    elif -0x8000000000000000 <= n < 0:
        out.append(struct.pack(">Bq", 0xD3, n))
    else:
        raise OverflowError(f"int {n} does not fit MessagePack's 64 bits")


def _pack_len(n: int, fix: Optional[int], fix_max: int, heads, out: list) -> None:
    """A length header: the fix form up to ``fix_max``, else the smallest of
    ``heads`` ((code, struct format, max), ...)."""
    if fix is not None and n <= fix_max:
        out.append(struct.pack("B", fix | n))
        return
    for code, fmt, top in heads:
        if n <= top:
            out.append(struct.pack(">B" + fmt, code, n))
            return
    raise ValueError(f"length {n} is too long for MessagePack")


_STR = ((0xD9, "B", 0xFF), (0xDA, "H", 0xFFFF), (0xDB, "I", 0xFFFFFFFF))
_BIN = ((0xC4, "B", 0xFF), (0xC5, "H", 0xFFFF), (0xC6, "I", 0xFFFFFFFF))
_ARRAY = ((0xDC, "H", 0xFFFF), (0xDD, "I", 0xFFFFFFFF))
_MAP = ((0xDE, "H", 0xFFFF), (0xDF, "I", 0xFFFFFFFF))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _pack(obj, out: list, default, strict: bool, depth: int = 0) -> None:
    if depth > 512:
        raise ValueError("MessagePack tree too deep")
    t = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif t is bool or (not strict and isinstance(obj, bool)):
        out.append(b"\xc3" if obj else b"\xc2")
    elif t is int or (not strict and isinstance(obj, int) and not isinstance(obj, bool)):
        _pack_int(int(obj), out)
    elif t is float or (not strict and isinstance(obj, float)):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif t is str or (not strict and isinstance(obj, str)):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 0x1F, _STR, out)
        out.append(data)
    elif t in (bytes, bytearray, memoryview) or (
            not strict and isinstance(obj, (bytes, bytearray, memoryview))):
        data = bytes(obj)
        _pack_len(len(data), None, 0, _BIN, out)
        out.append(data)
    elif t is list or (not strict and isinstance(obj, (list, tuple))):
        _pack_len(len(obj), 0x90, 0x0F, _ARRAY, out)
        for x in obj:
            _pack(x, out, default, strict, depth + 1)
    elif t is dict or (not strict and isinstance(obj, dict)):
        _pack_len(len(obj), 0x80, 0x0F, _MAP, out)
        for k, v in obj.items():
            _pack(k, out, default, strict, depth + 1)
            _pack(v, out, default, strict, depth + 1)
    elif t is ExtType:
        code, data = obj
        n = len(data)
        if n in _FIXEXT:
            out.append(struct.pack(">Bb", _FIXEXT[n], code))
        else:
            _pack_len(n, None, 0, ((0xC7, "B", 0xFF), (0xC8, "H", 0xFFFF), (0xC9, "I", 0xFFFFFFFF)),
                      out)
            out.append(struct.pack("b", code))
        out.append(bytes(data))
    else:
        new = default(obj) if default is not None else obj
        if new is obj:
            raise TypeError(f"can not serialize {t.__name__!r} object")
        _pack(new, out, default, strict, depth + 1)


def packb(obj, default: Optional[Callable[[Any], Any]] = None, strict_types: bool = False) -> bytes:
    """``obj`` as MessagePack, as ``msgpack.packb(obj, default=default,
    use_bin_type=True, strict_types=strict_types)`` writes it: with
    ``strict_types`` only exact types pack directly (tuples and subclasses
    go through ``default``)."""
    out: list = []
    _pack(obj, out, default, strict_types)
    return b"".join(out)


# ------------------------------------------------------------------ reader
class _Reader:
    def __init__(self, data, ext_hook, raw: bool):
        self.buf = memoryview(data)
        self.pos = 0
        self.ext_hook = ext_hook
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("MessagePack data ends early")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def text(self, n: int):
        data = bytes(self.take(n))
        return data if self.raw else data.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack("b")
        data = bytes(self.take(n))
        return self.ext_hook(code, data) if self.ext_hook is not None else ExtType(code, data)

    def read(self, depth: int = 0):
        if depth > 512:
            raise ValueError("MessagePack tree too deep")
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, depth)
        if 0x90 <= b <= 0x9F:
            return [self.read(depth + 1) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        if b in (0xD9, 0xDA, 0xDB):
            return self.text(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b]))
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])))
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.read(depth + 1) for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"), depth)
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b]))
        raise ValueError(f"MessagePack: unknown type byte {b:#04x}")

    def map(self, n: int, depth: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read(depth + 1)
            out[key] = self.read(depth + 1)
        return out


def unpackb(data, ext_hook: Optional[Callable[[int, bytes], Any]] = None, raw: bool = False):
    """The object in ``data`` (one MessagePack value, nothing after it), as
    ``msgpack.unpackb(data, ext_hook=ext_hook, raw=raw)`` reads it: arrays
    as lists, str as str (bytes with ``raw``), ext through ``ext_hook``."""
    reader = _Reader(data, ext_hook, raw)
    obj = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(f"MessagePack: {len(reader.buf) - reader.pos} bytes after the value")
    return obj


# ------------------------------------------------------- flax's ext types
def _array_bytes(x) -> bytes:
    """flax's ``_ndarray_to_bytes``: the packed (shape, dtype name, bytes)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return packb((tuple(x.shape), "bfloat16", x.view(torch.int16).numpy().tobytes()))
        x = x.numpy()
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serialised")
    return packb((x.shape, x.dtype.name, x.tobytes("C")))


def _array_from_bytes(data: bytes):
    shape, name, buf = unpackb(data, raw=True)
    if name == b"bfloat16":
        if not buf:
            return torch.empty(shape, dtype=torch.bfloat16)
        return torch.frombuffer(bytearray(buf), dtype=torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name.decode())).reshape(shape, order="C")


def _ext_pack(x):
    if isinstance(x, (np.ndarray, torch.Tensor)):
        return ExtType(NDARRAY, _array_bytes(x))
    if isinstance(x, np.generic):
        return ExtType(NPSCALAR, _array_bytes(np.asarray(x)))
    if isinstance(x, complex):
        return ExtType(NATIVE_COMPLEX, packb((x.real, x.imag)))
    return x


def _ext_unpack(code: int, data: bytes):
    if code == NDARRAY:
        return _array_from_bytes(data)
    if code == NATIVE_COMPLEX:
        re, im = unpackb(data)
        return complex(re, im)
    if code == NPSCALAR:
        return _array_from_bytes(data)[()]
    return ExtType(code, data)


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes


def _chunk(x) -> dict:
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = flat.numel() if isinstance(flat, torch.Tensor) else flat.size
    return {CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(i): flat[s:s + size] for i, s in enumerate(range(0, n, size))}}


def _chunked(tree):
    """A copy of the dict tree, keys sorted (flax copies the tree through
    ``jax.tree_util``, which sorts them), with leaves over MAX_CHUNK_SIZE
    bytes chunked (flax chunks only leaves reached through dicts)."""
    if isinstance(tree, dict):
        return {k: _chunked(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (np.ndarray, torch.Tensor)) and _nbytes(tree) > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunked(tree):
    if isinstance(tree, dict):
        if CHUNKED in tree:
            return _unchunk(tree)
        return {k: _unchunked(v) for k, v in tree.items()}
    return tree


def serialize(tree) -> bytes:
    """flax's ``msgpack_serialize(tree)``."""
    return packb(_chunked(tree), default=_ext_pack, strict_types=True)


def restore(data):
    """flax's ``msgpack_restore(data)``: arrays as read-only numpy arrays
    (bf16 leaves as torch tensors)."""
    return _unchunked(unpackb(data, ext_hook=_ext_unpack))

"""Sharded checkpoints: one self-CRC'd blob per parameter shard, restorable
onto any mesh.

Counterpart of ``distar_tpu.parallel.ckpt``, writing and reading the same
directory byte for byte:

    <path>/
      sharding.json        layout manifest (written LAST: its presence
                           implies every blob below it landed)
      skeleton.msgpack     the state tree with array leaves replaced by
                           {"__shard_ref__": "leafNNNNN"} (+ non-array leaves)
      leafNNNNN.o<offsets>.shard   header "<4sIQ" (b"DTSH", crc32, payload
                                   bytes) + the shard's C-order bytes

Leaves are numbered in ``jax.tree.map`` order over the state (dict keys
sorted, tuples in order). The state is in flax layouts (the learner's
``model.convert.learner_state_to_flax``), so shapes, offsets and each
leaf's ``spec`` (``str(PartitionSpec(...))``) are the JAX learner's: on a
mesh every leaf's spec comes from ``mesh.placement`` applied to its tree
path and flax shape, exactly the rule the JAX learner places its arrays
by. A leaf is a full array (the rank slices the shards it owns out of it)
or a ``LocalShard`` (the rank holds only its own block, as the learner's
fsdp/tp-sharded Adam moments). A rank writes the shards it owns, the copy
JAX gives ``replica_id == 0``: the lowest rank holding that block, i.e.
the one at index 0 on every axis the leaf does not split. Rank 0 writes the
skeleton and then the manifest, after every rank's blobs are on disk (the
caller's barrier, ``write_sharded(barrier=)``).

Every blob is its own fsync'd file: they are written in one batch
(``utils.storage.write_many``: one directory fsync for all, where JAX's
``write_bytes`` a blob fsyncs the directory and lists it each time) and
read ``IO_THREADS`` at a time.

``restore_sharded`` reassembles host-global arrays whatever mesh the
checkpoint was saved on (reading and checking each blob once); a ``bfloat16`` leaf comes back as a CPU torch
tensor (numpy has no bf16 without ``ml_dtypes``). ``utils.checkpoint``
routes directories with a ``sharding.json`` here, so its
``CheckpointManager`` fallback applies: one flipped bit fails the
generation with ``CheckpointCorruptError``.
"""
from __future__ import annotations

import json
import struct
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils import msgpack, storage
from ..utils.checkpoint import CheckpointCorruptError, _partial_restore, _to_serialisable
from .mesh import AXES, placement, spec_string

MANIFEST = "sharding.json"
SKELETON = "skeleton.msgpack"
_SHARD_MAGIC = b"DTSH"
_HEADER = struct.Struct("<4sIQ")  # magic, crc32, payload bytes
_REF_KEY = "__shard_ref__"
IO_THREADS = 32  # blob files read at once


class LocalShard:
    """A leaf of which this rank holds only its own block: ``data`` (flax
    layout) of the global ``shape`` placed by the mesh's rule."""

    def __init__(self, data, shape):
        self.data = data
        self.shape = tuple(int(d) for d in shape)
        self.dtype = data.dtype


def _join(path: str, name: str) -> str:
    return path.rstrip("/") + "/" + name


def manifest_path(path: str) -> str:
    return _join(path, MANIFEST)


def is_sharded_checkpoint(path: str) -> bool:
    try:
        return storage.exists(manifest_path(path))
    except (OSError, ValueError):
        return False


# ------------------------------------------------------------------ snapshot
def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return "bfloat16" if x.dtype == torch.bfloat16 else torch.empty((), dtype=x.dtype).numpy().dtype.name
    return np.dtype(x.dtype).name


def _host_bytes(x) -> np.ndarray:
    """A C-order numpy copy of ``x`` (a bf16 tensor as its raw uint16)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().copy()
    return np.array(x, copy=True, order="C")


def _layout(shape: Tuple[int, ...], spec: Tuple, sizes: Dict[str, int]) -> List[Dict]:
    """The global shard layout: every distinct block, sorted by offsets."""
    per_dim = []
    for d, n in enumerate(shape):
        axis = spec[d] if d < len(spec) else None
        parts = sizes.get(axis, 1) if axis else 1
        step = n // parts
        per_dim.append([(i * step, step) for i in range(parts)])
    out = [{"offsets": [], "shape": []}]
    for choices in per_dim:
        out = [{"offsets": e["offsets"] + [o], "shape": e["shape"] + [s]} for e in out for o, s in choices]
    return sorted(out, key=lambda e: tuple(e["offsets"]))


def _fname(leaf_id: str, offsets) -> str:
    return f"{leaf_id}.o{'_'.join(str(o) for o in offsets)}.shard"


def _walk(tree, fn, names=()):
    """``jax.tree.map`` over dicts (sorted keys), lists and tuples; None is
    an empty node; a leaf is anything with a ``shape``."""
    if isinstance(tree, dict):
        return {k: _walk(tree[k], fn, names + (str(k),)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        vals = [_walk(v, fn, names + (f"[{i}]",)) for i, v in enumerate(tree)]
        return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)
    if tree is None or not hasattr(tree, "shape"):
        return tree
    return fn(names, tree)


def snapshot_sharded(state: Any, mesh=None) -> Dict:
    """Host copies of every shard this rank writes, with the skeleton and
    the global layout. Takes no collective: each rank reads only what it
    holds. Without ``mesh`` every leaf is one shard (spec "") written by
    rank 0, as JAX writes a host-array tree."""
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_initialized() else 0
    sizes = dict(mesh.shape) if mesh is not None else {}
    coords = mesh.coords if mesh is not None else {}
    leaves_meta: Dict[str, Dict] = {}
    local_blobs: Dict[str, np.ndarray] = {}
    counter = [0]

    def visit(names, x):
        leaf_id = f"leaf{counter[0]:05d}"
        counter[0] += 1
        shape = tuple(int(d) for d in x.shape)
        if mesh is None:
            spec, spec_str = (None,) * len(shape), ""
        else:
            spec = placement(sizes, names, shape)
            spec_str = spec_string(spec)
        layout = _layout(shape, spec, sizes)
        leaves_meta[leaf_id] = {
            "shape": list(shape),
            "dtype": _dtype_name(x),
            "spec": spec_str,
            "shards": [{**e, "file": _fname(leaf_id, e["offsets"])} for e in layout],
        }
        split = {a for a in spec if a}
        if mesh is None:
            owner = rank == 0
        else:
            owner = all(coords[a] == 0 for a in AXES if a not in split)
        if owner:
            offsets, index = [], []
            for d, n in enumerate(shape):
                a = spec[d]
                step = n // sizes[a] if a else n
                start = coords[a] * step if a else 0
                offsets.append(start)
                index.append(slice(start, start + step))
            if isinstance(x, LocalShard):
                data = _host_bytes(x.data)
            else:
                data = _host_bytes(x[tuple(index)] if index else x)
            local_blobs[_fname(leaf_id, offsets)] = data
        return {_REF_KEY: leaf_id}

    skeleton = _walk(state, visit)
    return {
        "skeleton": skeleton,
        "leaves": leaves_meta,
        "blobs": local_blobs,
        "process_index": rank,
        "mesh_shape": sizes or None,
    }


# --------------------------------------------------------------------- write
def _pack_blob(data: np.ndarray) -> bytes:
    payload = np.ascontiguousarray(data).tobytes()
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    return _HEADER.pack(_SHARD_MAGIC, crc, len(payload)) + payload


def _unpack_blob(path: str, blob: bytes) -> bytes:
    if len(blob) < _HEADER.size:
        raise CheckpointCorruptError(f"{path}: shard blob shorter than header")
    magic, crc, size = _HEADER.unpack_from(blob)
    payload = blob[_HEADER.size:]
    if magic != _SHARD_MAGIC:
        raise CheckpointCorruptError(f"{path}: bad shard magic {magic!r}")
    if len(payload) != size:
        raise CheckpointCorruptError(
            f"{path}: shard payload {len(payload)} B != header {size} B "
            "(truncated write?)"
        )
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        raise CheckpointCorruptError(f"{path}: shard crc mismatch (bit rot?)")
    return payload


def write_sharded(path: str, snap: Dict, metadata: Optional[Dict] = None,
                  barrier: Optional[Callable[[], None]] = None) -> str:
    """Write a ``snapshot_sharded`` result: this rank's blobs, then (after
    ``barrier``, which returns once every rank's blobs are written) rank
    0's skeleton and manifest, the manifest last."""
    from ..obs import get_registry

    reg = get_registry()
    writes = reg.counter("distar_ckpt_shard_writes_total", "parameter-shard blobs written")
    shard_bytes = reg.counter("distar_ckpt_shard_bytes_total", "bytes written as shard blobs")
    blobs = [(_join(path, fname), _pack_blob(data)) for fname, data in snap["blobs"].items()]
    storage.write_many(blobs)
    writes.inc(len(blobs))
    shard_bytes.inc(sum(len(b) for _, b in blobs))
    if barrier is not None:
        barrier()
    if snap.get("process_index", 0) == 0:
        skel_blob = msgpack.serialize(_to_serialisable(snap["skeleton"]))
        storage.write_bytes(_join(path, SKELETON), skel_blob)
        manifest = {
            "format": "distar-sharded-v1",
            "metadata": metadata or {},
            "mesh_shape": snap.get("mesh_shape"),
            "skeleton": {
                "file": SKELETON,
                "crc32": zlib.crc32(skel_blob) & 0xFFFFFFFF,
                "size": len(skel_blob),
            },
            "leaves": snap["leaves"],
            "ts": time.time(),
        }
        storage.write_bytes(manifest_path(path), json.dumps(manifest, indent=1).encode())
    return path


def save_sharded(path: str, state: Any, metadata: Optional[Dict] = None, mesh=None,
                 barrier: Optional[Callable[[], None]] = None) -> str:
    """Synchronous sharded save (snapshot + write in one call)."""
    return write_sharded(path, snapshot_sharded(state, mesh), metadata, barrier=barrier)


# -------------------------------------------------------------------- verify
def _read_manifest(path: str) -> Dict:
    try:
        return json.loads(storage.read_bytes(manifest_path(path)))
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(f"{path}: unreadable shard manifest: {e!r}") from e


def _corrupt_counter():
    from ..obs import get_registry

    return get_registry().counter("distar_ckpt_shard_corrupt_total",
                                  "shard blobs failing CRC/size verification")


def _read_shards(path: str, manifest: Dict) -> Dict[str, bytes]:
    """Every shard's checked payload, by file name, read ``IO_THREADS`` at
    a time; a missing or corrupt blob raises ``CheckpointCorruptError`` (a
    corrupt one counted in ``distar_ckpt_shard_corrupt_total``)."""
    files = [s["file"] for meta in manifest.get("leaves", {}).values() for s in meta["shards"]]

    def read_one(fname):
        fpath = _join(path, fname)
        try:
            blob = storage.read_bytes(fpath)
        except OSError as e:
            raise CheckpointCorruptError(f"{fpath}: missing shard blob: {e!r}") from e
        try:
            return _unpack_blob(fpath, blob)
        except CheckpointCorruptError:
            _corrupt_counter().inc()
            raise

    with ThreadPoolExecutor(IO_THREADS) as pool:
        return dict(zip(files, pool.map(read_one, files)))


def _check_skeleton(path: str, manifest: Dict) -> bytes:
    skel = manifest.get("skeleton", {})
    try:
        skel_blob = storage.read_bytes(_join(path, skel.get("file", SKELETON)))
    except OSError as e:
        raise CheckpointCorruptError(f"{path}: missing skeleton: {e!r}") from e
    if len(skel_blob) != int(skel.get("size", -1)) or (
        zlib.crc32(skel_blob) & 0xFFFFFFFF
    ) != int(skel.get("crc32", -1)):
        raise CheckpointCorruptError(f"{path}: skeleton blob fails manifest CRC")
    return skel_blob


def verify_sharded(path: str) -> None:
    """Raise ``CheckpointCorruptError`` unless every shard blob named by the
    manifest exists and passes its self-CRC (and the skeleton its CRC)."""
    manifest = _read_manifest(path)
    _check_skeleton(path, manifest)
    _read_shards(path, manifest)


# ------------------------------------------------------------------- restore
def _assemble_leaf(path: str, meta: Dict, payloads: Dict[str, bytes]):
    shape = tuple(meta["shape"])
    bf16 = meta["dtype"] == "bfloat16"
    dtype = np.dtype(np.int16) if bf16 else np.dtype(meta["dtype"])
    out = np.empty(shape, dtype)
    for shard in meta["shards"]:
        payload = payloads[shard["file"]]
        sub_shape = tuple(shard["shape"])
        expect = int(np.prod(sub_shape, dtype=np.int64)) * dtype.itemsize
        if len(payload) != expect:
            raise CheckpointCorruptError(
                f"{_join(path, shard['file'])}: shard payload {len(payload)} B != "
                f"{expect} B implied by shape {sub_shape} {meta['dtype']}"
            )
        data = np.frombuffer(payload, dtype).reshape(sub_shape)
        if shape == ():
            out = data.reshape(()).copy()
        else:
            out[tuple(slice(o, o + s) for o, s in zip(shard["offsets"], sub_shape))] = data
    if bf16:
        return torch.from_numpy(np.ascontiguousarray(out)).view(torch.bfloat16)
    return out


def _resolve_refs(node, path: str, leaves: Dict[str, Dict], payloads: Dict[str, bytes], cache: Dict):
    if isinstance(node, dict):
        if set(node.keys()) == {_REF_KEY}:
            leaf_id = node[_REF_KEY]
            if leaf_id not in cache:
                if leaf_id not in leaves:
                    raise CheckpointCorruptError(f"{path}: skeleton references unknown leaf {leaf_id}")
                cache[leaf_id] = _assemble_leaf(path, leaves[leaf_id], payloads)
            return cache[leaf_id]
        return {k: _resolve_refs(v, path, leaves, payloads, cache) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_resolve_refs(v, path, leaves, payloads, cache) for v in node)
    return node


def restore_sharded(path: str, target: Any = None, verify: bool = True) -> Dict:
    """``{"state", "metadata", "sharding_layout"}`` of a sharded checkpoint,
    the state as host-global arrays whatever mesh wrote it; with ``target``
    the state is overlaid on the target's structure (``_partial_restore``).
    Every blob is read and its self-CRC checked once; ``verify`` also holds
    the skeleton to the manifest's CRC."""
    manifest = _read_manifest(path)
    if verify:
        skel_blob = _check_skeleton(path, manifest)
    else:
        skel_blob = storage.read_bytes(_join(path, manifest.get("skeleton", {}).get("file", SKELETON)))
    payloads = _read_shards(path, manifest)
    try:
        skeleton = msgpack.restore(skel_blob)
    except Exception as e:  # noqa: BLE001 - any decode failure is corruption
        raise CheckpointCorruptError(f"{path}: undecodable skeleton: {e!r}") from e
    state = _resolve_refs(skeleton, path, manifest.get("leaves", {}), payloads, {})
    if target is not None:
        state = _partial_restore(target, state)
    return {
        "state": state,
        "metadata": manifest.get("metadata", {}),
        "sharding_layout": {
            "mesh_shape": manifest.get("mesh_shape"),
            "leaves": {
                k: {"spec": v.get("spec", ""), "shards": len(v["shards"])}
                for k, v in manifest.get("leaves", {}).items()
            },
        },
    }


def saved_mesh_shape(path: str) -> Optional[Dict[str, int]]:
    """The mesh the checkpoint was written under (None for a host tree)."""
    try:
        return _read_manifest(path).get("mesh_shape")
    except CheckpointCorruptError:
        return None

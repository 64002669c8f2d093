"""Checkpoints in the JAX package's format: write, verify, read.

Counterpart of the format half of ``distar_tpu.utils.checkpoint``. A
checkpoint is one blob, flax's msgpack of ``{"state", "metadata"}``
(lists and tuples stored as ``{"__seq_<i>": ...}`` dicts), and after it a
``<path>.manifest`` sidecar with the blob's CRC32 and size, both through
``utils.storage``. The port decodes and encodes that blob with its own
codec (``utils.msgpack``): the card has neither flax nor ``msgpack``. A
checkpoint written here is read by the JAX package and the other way round.

Not here yet: ``CheckpointManager``, ``AsyncCheckpointer`` and
``auto_checkpoint`` (ROADMAP Queue 1 item 4), and sharded checkpoint
directories (``sharding.json``; item 7), which raise.
"""
from __future__ import annotations

import json
import time
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import msgpack, storage


class CheckpointCorruptError(Exception):
    """The checkpoint's bytes do not match what was written (a truncated
    write, bit rot) or do not decode."""


class CheckpointMismatchError(ValueError):
    """The checkpoint decodes but does not fit the state it is restored
    into."""


def _manifest_path(path: str) -> str:
    return path + ".manifest"


def _refuse_sharded(path: str) -> None:
    try:
        sharded = storage.exists(path.rstrip("/") + "/sharding.json")
    except (OSError, ValueError):
        return
    if sharded:
        raise NotImplementedError(
            f"{path} is a sharded checkpoint directory; sharded checkpoints come with the "
            f"port's parallel/ (ROADMAP Queue 1 item 7)")


def _host(tree):
    """A host copy of every array leaf, as the JAX package's snapshot takes
    it: tensors to numpy (bf16 stays a CPU tensor), numpy arrays and
    scalars to fresh arrays (a scalar becomes a 0-d array), so later writes
    to the caller's arrays do not reach the blob."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return t.clone() if t.dtype == torch.bfloat16 else t.numpy().copy()
    if isinstance(tree, (np.ndarray, np.generic)):
        return np.array(tree)
    return tree


def _to_serialisable(tree):
    if isinstance(tree, dict):
        return {str(k): _to_serialisable(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {f"__seq_{i}": _to_serialisable(v) for i, v in enumerate(tree)}
    return tree


def _from_seq(d):
    """A ``{"__seq_<i>": ...}`` dict back to its list (one level)."""
    if isinstance(d, dict) and d and all(isinstance(k, str) and k.startswith("__seq_") for k in d):
        return [d[f"__seq_{i}"] for i in range(len(d))]
    return d


def _write_checkpoint(path: str, host_state: Any, metadata: Optional[Dict]) -> str:
    blob = msgpack.serialize(_to_serialisable({"state": host_state, "metadata": metadata or {}}))
    storage.write_bytes(path, blob)
    # the sidecar after the blob: a manifest present means its blob landed
    manifest = {"crc32": zlib.crc32(blob) & 0xFFFFFFFF, "size": len(blob), "ts": time.time(),
                "metadata_keys": sorted((metadata or {}).keys())}
    storage.write_bytes(_manifest_path(path), json.dumps(manifest).encode())
    return path


def save_checkpoint(path: str, state: Any, metadata: Optional[Dict] = None) -> str:
    """Write ``state`` (a tree of dicts, lists and tuples whose leaves are
    numpy arrays, tensors or plain values; a learner checkpoint is
    ``{"params", "opt_state"}`` in flax layouts, ``model.convert.
    params_to_flax``) to ``path`` with its CRC/size manifest."""
    return _write_checkpoint(path, _host(state), metadata)


def _verify_blob(path: str, blob: bytes) -> None:
    mpath = _manifest_path(path)
    if not storage.exists(mpath):
        return  # a checkpoint without a manifest: decode errors still raise, typed
    try:
        manifest = json.loads(storage.read_bytes(mpath))
    except (ValueError, OSError) as e:
        raise CheckpointCorruptError(f"{path}: unreadable manifest: {e!r}") from e
    if len(blob) != int(manifest.get("size", -1)):
        raise CheckpointCorruptError(
            f"{path}: size {len(blob)} != manifest {manifest.get('size')} (truncated write?)")
    crc = zlib.crc32(blob) & 0xFFFFFFFF
    if crc != int(manifest.get("crc32", -1)):
        raise CheckpointCorruptError(
            f"{path}: crc32 {crc:#010x} != manifest {int(manifest.get('crc32', 0)):#010x}")


def verify_checkpoint(path: str) -> bool:
    """True when ``path`` exists and its bytes match its manifest (a
    checkpoint without one only has to exist). Never raises."""
    try:
        _refuse_sharded(path)
        _verify_blob(path, storage.read_bytes(path))
        return True
    except (CheckpointCorruptError, OSError, ValueError, NotImplementedError):
        return False


def load_checkpoint(path: str, verify: bool = True) -> Dict:
    """``{"state", "metadata"}`` of the checkpoint at ``path``; with
    ``verify`` the blob is held to its manifest first. A bad manifest or
    bytes that do not decode raise ``CheckpointCorruptError``. Lists and
    tuples come back as ``{"__seq_<i>": ...}`` dicts, as from the JAX
    package (``_from_seq`` undoes one level)."""
    _refuse_sharded(path)
    blob = storage.read_bytes(path)
    if verify:
        _verify_blob(path, blob)
    try:
        payload = msgpack.restore(blob)
    except Exception as e:  # noqa: BLE001 - any decode failure is corruption
        raise CheckpointCorruptError(f"{path}: undecodable msgpack: {e!r}") from e
    if not isinstance(payload, dict) or "state" not in payload:
        raise CheckpointCorruptError(f"{path}: no 'state' in the checkpoint")
    return {"state": payload["state"], "metadata": payload.get("metadata", {})}


def load_params(path: str) -> Any:
    """The model params of a checkpoint: a learner checkpoint's
    ``{"params", "opt_state"}`` loses its optimizer state; a bare params
    tree passes through."""
    state = load_checkpoint(path)["state"]
    if isinstance(state, dict) and "params" in state and "opt_state" in state:
        return state["params"]
    return state

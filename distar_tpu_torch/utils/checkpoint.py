"""Checkpoints in the JAX package's format, and the crash-safe machinery
around them.

Counterpart of ``distar_tpu.utils.checkpoint``. A checkpoint is one blob,
flax's msgpack of ``{"state", "metadata"}`` (lists and tuples stored as
``{"__seq_<i>": ...}`` dicts), and after it a
``<path>.manifest`` sidecar with the blob's CRC32 and size, both through
``utils.storage``. The port decodes and encodes that blob with its own
codec (``utils.msgpack``): the card has neither flax nor ``msgpack``. A
checkpoint written here is read by the JAX package and the other way round.

Around the format: ``load_checkpoint(..., target=)`` restores into a
given tree (leaves the checkpoint lacks keep the target's, extra ones are
dropped); ``AsyncCheckpointer`` snapshots on the caller's thread and writes
on a background one; ``CheckpointManager`` keeps the ``latest.json``
pointer over the newest generations, whose schema both packages read and
write; ``auto_checkpoint`` saves on an exception, SIGTERM or SIGINT.

Sharded checkpoint directories (``sharding.json``, ``parallel.ckpt``) are
routed there by ``verify_checkpoint`` and ``load_checkpoint`` (which then
also returns the ``sharding_layout``), so the manager's pointer and its
corrupt-generation fallback cover them too.
"""
from __future__ import annotations

import json
import os
import signal
import threading
import time
import traceback
import zlib
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from . import msgpack, storage


class CheckpointCorruptError(Exception):
    """The checkpoint's bytes do not match what was written (a truncated
    write, bit rot) or do not decode."""


class CheckpointMismatchError(ValueError):
    """The checkpoint decodes but does not fit the state it is restored
    into."""


class CountVar:
    """A named persistent counter (the learner's ``last_iter``)."""

    def __init__(self, value: int = 0):
        self._value = int(value)

    @property
    def val(self) -> int:
        return self._value

    def add(self, n: int = 1) -> None:
        self._value += n

    def update(self, value: int) -> None:
        self._value = int(value)


def _manifest_path(path: str) -> str:
    return path + ".manifest"


def _is_sharded(path: str) -> bool:
    """A sharded checkpoint directory (its manifest is there)."""
    try:
        return storage.exists(path.rstrip("/") + "/sharding.json")
    except (OSError, ValueError):
        return False


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
        if _is_sharded(path):
            from ..parallel import ckpt as sharded

            sharded.verify_sharded(path)
            return True
        _verify_blob(path, storage.read_bytes(path))
        return True
    except (CheckpointCorruptError, OSError, ValueError):
        return False


def load_checkpoint(path: str, target: Any = None, verify: bool = True) -> Dict:
    """``{"state", "metadata"}`` of the checkpoint at ``path``; with
    ``verify`` the blob is held to its manifest first. A bad manifest or
    bytes that do not decode raise ``CheckpointCorruptError``. Lists and
    tuples come back as ``{"__seq_<i>": ...}`` dicts, as from the JAX
    package (``_from_seq`` undoes one level); given a ``target`` tree, the
    state is restored into its structure (``_partial_restore``). A sharded
    directory is read by ``parallel.ckpt.restore_sharded``."""
    if _is_sharded(path):
        from ..parallel import ckpt as sharded

        return sharded.restore_sharded(path, target=target, verify=verify)
    blob = storage.read_bytes(path)
    if verify:
        _verify_blob(path, blob)
    try:
        payload = msgpack.restore(blob)
    except Exception as e:  # noqa: BLE001 - any decode failure is corruption
        raise CheckpointCorruptError(f"{path}: undecodable msgpack: {e!r}") from e
    if not isinstance(payload, dict) or "state" not in payload:
        raise CheckpointCorruptError(f"{path}: no 'state' in the checkpoint")
    state = payload["state"]
    if target is not None:
        state = _partial_restore(target, state)
    return {"state": state, "metadata": payload.get("metadata", {})}


def _partial_restore(target, state):
    """``state`` overlaid on ``target``'s structure, matched by path: a leaf
    the checkpoint lacks keeps the target's value, one the target lacks is
    dropped; tuples (and named tuples) keep their type."""
    state = _from_seq(state)
    if isinstance(target, dict):
        src = state if isinstance(state, dict) else {}
        return {k: _partial_restore(v, src[str(k)]) if str(k) in src else v
                for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        src = state if isinstance(state, (list, dict)) else []
        if isinstance(src, dict):
            src = _from_seq(src)
        vals = [_partial_restore(t, src[i]) if i < len(src) else t for i, t in enumerate(target)]
        if hasattr(target, "_fields"):
            return type(target)(*vals)
        return type(target)(vals)
    return state if state is not None else target


def load_params(path: str) -> Any:
    """The model params of a checkpoint: a learner checkpoint's
    ``{"params", "opt_state"}`` loses its optimizer state; a bare params
    tree passes through."""
    state = load_checkpoint(path)["state"]
    if isinstance(state, dict) and "params" in state and "opt_state" in state:
        return state["params"]
    return state


class AsyncCheckpointer:
    """Writes a checkpoint while training goes on: ``save`` copies the state
    to the host on the caller's thread (the next step updates the tensors
    in place), then one background thread serializes and writes it and only
    then calls ``on_complete``, so whatever it publishes names durable
    bytes. At most one write is in flight: a new save first joins the last
    one, which bounds the extra host memory to one copy and keeps the files
    in order. ``wait()`` drains it and raises a failed write's error."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, path: str, state: Any, metadata: Optional[Dict] = None,
             on_complete: Optional[Callable[[str], None]] = None,
             snapshot_fn: Optional[Callable[[Any], Any]] = None,
             write_fn: Optional[Callable[[str, Any, Optional[Dict]], Any]] = None) -> str:
        """``snapshot_fn(state)`` makes the host copy (default: a copy of
        every array leaf); the learner passes a function that converts to
        the JAX package's layout on the way. ``write_fn(path, snapshot,
        metadata)`` writes it (default: one blob; the sharded layout passes
        ``parallel.ckpt.write_sharded``)."""
        self.wait()  # join before the snapshot: one host copy at a time
        host_state = (snapshot_fn or _host)(state)
        writer = write_fn or _write_checkpoint

        def write():
            try:
                writer(path, host_state, metadata)
                if on_complete is not None:
                    on_complete(path)
            except BaseException as e:  # noqa: BLE001 - raised by the next wait() or save()
                self._error = e

        t = threading.Thread(target=write, name="async-ckpt-writer", daemon=True)
        # started before it is published: a signal handler's sync save between
        # the two statements joins a finished thread, never an unstarted one
        t.start()
        self._thread = t
        return path

    def wait(self) -> None:
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err


class CheckpointManager:
    """The durable ``latest`` pointer over checkpoint generations.

    ``latest.json`` in the checkpoint directory (``latest_<role>.json`` for
    a role) holds ``{"generations": [{"path", "step", "ts"(, "role")}, ...]}``
    newest first, at most ``keep`` of them, written atomically through
    ``storage``; the JAX package's manager writes and reads the same file.
    A torn pointer reads as no generation. ``resolve_latest`` and
    ``load_latest`` walk the list and skip a generation whose bytes no
    longer verify, counting each skip in
    ``distar_resilience_ckpt_fallbacks_total``. A manager reads only its own
    role's generations, so a teacher never resumes from a student's even
    where both share a directory or a pointer was edited by hand."""

    POINTER = "latest.json"

    def __init__(self, directory: str, keep: int = 5, role: str = ""):
        if keep < 1:
            raise ValueError(f"keep must be at least 1, got {keep}")
        self.directory = directory
        self.keep = keep
        self.role = str(role or "")
        self._lock = threading.Lock()

    @property
    def pointer_path(self) -> str:
        name = self.POINTER if not self.role else f"latest_{self.role}.json"
        return os.path.join(self.directory, name)

    def record(self, path: str, step: int = 0) -> None:
        """Publish ``path`` as the newest generation. Call it only once the
        checkpoint's bytes are durable."""
        with self._lock:
            gens = [g for g in self.generations() if g.get("path") != path]
            entry = {"path": path, "step": int(step), "ts": time.time()}
            if self.role:
                entry["role"] = self.role
            gens.insert(0, entry)
            storage.write_bytes(self.pointer_path,
                                json.dumps({"generations": gens[: self.keep]}, indent=1).encode())

    def generations(self) -> List[Dict]:
        """This role's recorded generations, newest first ([] without a
        pointer, or with a torn one)."""
        if not storage.exists(self.pointer_path):
            return []
        try:
            data = json.loads(storage.read_bytes(self.pointer_path))
            gens = data.get("generations", [])
        except (ValueError, OSError, AttributeError):
            return []
        return [g for g in gens if isinstance(g, dict) and g.get("path")
                and str(g.get("role", "") or "") == self.role]

    def resolve_latest(self) -> Optional[Dict]:
        """The newest generation whose checkpoint still verifies, or None.
        A generation that fails is skipped, not deleted: its bytes stay for
        whoever wants to look at them."""
        for gen in self.generations():
            if verify_checkpoint(gen["path"]):
                return gen
            self._note_fallback(gen["path"])
        return None

    @staticmethod
    def _note_fallback(path: str) -> None:
        from ..obs import get_flight_recorder, get_registry

        get_registry().counter(
            "distar_resilience_ckpt_fallbacks_total",
            "corrupt/missing checkpoint generations skipped on resume",
        ).inc()
        get_flight_recorder().record("ckpt_fallback", path=path)

    def load_latest(self, target: Any = None) -> Optional[Dict]:
        """``load_checkpoint`` of the newest generation that loads, with its
        ``path``; None when none does."""
        for gen in self.generations():
            try:
                out = load_checkpoint(gen["path"], target=target, verify=True)
            except (CheckpointCorruptError, OSError, ValueError):
                self._note_fallback(gen["path"])
                continue
            out["path"] = gen["path"]
            return out
        return None


class SignalGuard:
    """``with guard:`` marks a span in which the state is being updated in
    place. A SIGTERM or SIGINT that ``auto_checkpoint`` receives inside it
    is held until the span ends, so the crash save never copies a state
    half-way through an optimizer step (the port's step is many in-place
    tensor updates, where the JAX package's is one compiled call)."""

    def __init__(self):
        self._depth = 0
        self._held: Optional[Callable[[], None]] = None

    def __enter__(self):
        self._depth += 1
        return self

    def __exit__(self, *exc):
        self._depth -= 1
        if self._depth == 0 and self._held is not None:
            act, self._held = self._held, None
            act()
        return False

    def hold(self, act: Callable[[], None]) -> bool:
        """Keep ``act`` for the span's end and return True, or return False
        outside a span."""
        if self._depth == 0:
            return False
        self._held = act
        return True


def auto_checkpoint(save_fn: Callable[[], None], guard: Optional[SignalGuard] = None):
    """Wrap a run loop so an exception, SIGTERM or SIGINT calls ``save_fn``
    first: an exception is re-raised after the save, a signal becomes
    ``SystemExit`` (the handlers are installed only in the main thread). A
    signal arriving inside ``guard`` acts when the guarded span ends."""

    def decorator(fn):
        def wrapped(*args, **kwargs):
            previous = {}

            def exit_on(sig):
                save_fn()
                for s, prev in previous.items():
                    signal.signal(s, prev)
                raise SystemExit(f"signal {sig}: checkpoint saved")

            def handler(sig, frame):
                if guard is None or not guard.hold(lambda: exit_on(sig)):
                    exit_on(sig)

            for s in (signal.SIGTERM, signal.SIGINT):
                try:
                    previous[s] = signal.signal(s, handler)
                except ValueError:  # not the main thread
                    pass
            try:
                return fn(*args, **kwargs)
            except SystemExit:
                raise
            except BaseException:
                traceback.print_exc()
                save_fn()
                raise
            finally:
                for s, prev in previous.items():
                    try:
                        signal.signal(s, prev)
                    except ValueError:
                        pass

        return wrapped

    return decorator

"""Disk spill for acked inserts: the durability half of the replay store.

Counterpart of ``distar_tpu.replay.spill``, over the port's
``utils.storage``: the blob and the ``MANIFEST`` are the JAX package's, and
the key sequence continues across restarts, so a spill directory written
by either package is recovered by the other.

An insert is acked only after its trajectory is on disk, so a store crash
loses nothing a producer was told is safe. Layout under one spill root:

  ``<root>/<key>.spill``   one self-describing blob per item, written
                           through ``utils/storage`` (atomic tmp+rename,
                           fsync'd — the same write discipline checkpoints
                           use). The blob carries table/priority/CRC next to
                           the payload, so every file verifies standalone.
  ``<root>/MANIFEST``      periodically-rewritten CRC index (checkpoint
                           style): live keys + per-file crc32. Recovery
                           trusts the per-file CRC first and uses the
                           manifest as a cross-check / post-mortem record.

Ring semantics: at most ``max_items`` live files; appending past the cap
drops the oldest (counted — durability is bounded by configuration, never
silently). ``release(key)`` deletes a file once its item left the table
(first sample or eviction); ``recover()`` yields every live, CRC-valid item
for re-insertion after a restart.
"""
from __future__ import annotations

import json
import os
import threading
import zlib
from typing import Dict, Iterator, List, Optional

from ..comm.serializer import dumps, loads
from ..obs import get_registry
from ..utils import storage

_SUFFIX = ".spill"
_MANIFEST = "MANIFEST"


class SpillRing:
    def __init__(self, root: str, max_items: int = 4096, manifest_every: int = 16):
        assert max_items >= 1
        self.root = root
        self.max_items = max_items
        self._manifest_every = max(1, manifest_every)
        self._lock = threading.Lock()
        self._seq = 0
        self._live: Dict[str, int] = {}  # key -> crc32 (insertion-ordered)
        self._ops_since_manifest = 0
        if "://" not in root:  # scheme'd backends (mem://, gs://) need no dir
            os.makedirs(root, exist_ok=True)
        reg = get_registry()
        self._g_items = reg.gauge(
            "distar_replay_spill_items", "acked-but-unsampled items on disk")
        self._c_writes = reg.counter(
            "distar_replay_spill_writes_total", "spill blobs written")
        self._c_dropped = reg.counter(
            "distar_replay_spill_dropped_total",
            "spilled items dropped by the ring bound (durability ceiling hit)")
        self._c_recovered = reg.counter(
            "distar_replay_spill_recovered_total", "items recovered on restart")
        self._c_corrupt = reg.counter(
            "distar_replay_spill_corrupt_total",
            "spill blobs failing CRC on recovery (skipped)")
        self._bootstrap_seq()

    # ------------------------------------------------------------- plumbing
    def _path(self, key: str) -> str:
        return os.path.join(self.root, key + _SUFFIX)

    def _bootstrap_seq(self) -> None:
        """Continue the key sequence past any pre-crash files so a restarted
        store never reuses (and silently overwrites) a live key."""
        top = 0
        backend, rest = storage.resolve(self.root)
        for path in backend.list(os.path.join(rest, "")):
            name = os.path.basename(path)
            if not name.endswith(_SUFFIX):
                continue
            try:
                top = max(top, int(name[:-len(_SUFFIX)].rsplit("-", 1)[-1]) + 1)
            except ValueError:
                continue
        self._seq = top

    def reserve_key(self, table: str) -> str:
        with self._lock:
            key = f"{table}-{self._seq:012d}"
            self._seq += 1
            return key

    def _write_manifest_locked(self, force: bool = False) -> None:
        self._ops_since_manifest += 1
        if not force and self._ops_since_manifest < self._manifest_every:
            return
        self._ops_since_manifest = 0
        manifest = {"count": len(self._live), "files": dict(self._live)}
        storage.write_bytes(
            os.path.join(self.root, _MANIFEST), json.dumps(manifest).encode())

    # ------------------------------------------------------------------ api
    def append(self, key: str, table: str, item: object, priority: float) -> None:
        payload = dumps(item, compress=True)
        blob = dumps(
            {
                "key": key,
                "table": table,
                "priority": float(priority),
                "crc32": zlib.crc32(payload) & 0xFFFFFFFF,
                "payload": payload,
            },
            compress=False,  # payload is already compressed
        )
        storage.write_bytes(self._path(key), blob)
        with self._lock:
            self._live[key] = zlib.crc32(blob) & 0xFFFFFFFF
            dropped: List[str] = []
            while len(self._live) > self.max_items:
                oldest = next(iter(self._live))
                del self._live[oldest]
                dropped.append(oldest)
            self._write_manifest_locked()
        self._c_writes.inc()
        self._g_items.set(len(self._live))
        for old in dropped:
            self._c_dropped.inc()
            self._unlink(old)

    def release(self, key: str) -> None:
        """The item left the table (sampled or evicted): its durability
        obligation is over."""
        with self._lock:
            was_live = self._live.pop(key, None) is not None
            if was_live:
                self._write_manifest_locked()
        if was_live:
            self._unlink(key)
        self._g_items.set(self.live_count())

    def _unlink(self, key: str) -> None:
        try:
            storage.delete(self._path(key))
        except (FileNotFoundError, OSError):
            pass

    def recover(self, keep_encoded: bool = False) -> Iterator[dict]:
        """Yield ``{key, table, priority, item}`` for every live CRC-valid
        blob (oldest first); corrupt blobs are counted, unlinked and
        skipped. Rebuilds the in-memory index as it goes, so a recovered
        ring keeps ring/release semantics.

        ``keep_encoded=True`` yields the item as a ``serializer.Opaque``
        wrapper around the stored (already-compressed) payload instead of
        decoding it: recovery skips the unpickle pass, and a later wire
        re-serve ships the blob without recompressing (CRC still verifies
        integrity either way)."""
        from ..comm.serializer import Opaque

        backend, rest = storage.resolve(self.root)
        paths = sorted(
            p for p in backend.list(os.path.join(rest, ""))
            if p.endswith(_SUFFIX)
        )
        manifest = self._read_manifest()
        for path in paths:
            key = os.path.basename(path)[: -len(_SUFFIX)]
            try:
                rec = loads(backend.read_bytes(path))
                payload = rec["payload"]
                if (zlib.crc32(payload) & 0xFFFFFFFF) != rec["crc32"]:
                    raise ValueError(f"crc mismatch for {key}")
                if manifest is not None and key in manifest:
                    blob = backend.read_bytes(path)
                    if (zlib.crc32(blob) & 0xFFFFFFFF) != manifest[key]:
                        raise ValueError(f"manifest crc mismatch for {key}")
                item = Opaque(payload) if keep_encoded else loads(payload)
            except Exception:
                self._c_corrupt.inc()
                self._unlink(key)
                continue
            with self._lock:
                self._live[key] = zlib.crc32(backend.read_bytes(path)) & 0xFFFFFFFF
            self._c_recovered.inc()
            yield {"key": key, "table": rec["table"],
                   "priority": rec["priority"], "item": item}
        with self._lock:
            self._write_manifest_locked(force=True)
        self._g_items.set(self.live_count())

    def _read_manifest(self) -> Optional[Dict[str, int]]:
        path = os.path.join(self.root, _MANIFEST)
        try:
            return dict(json.loads(storage.read_bytes(path))["files"])
        except Exception:
            return None  # manifest-less/garbled: per-file CRCs still verify

    def live_count(self) -> int:
        with self._lock:
            return len(self._live)

    def flush(self) -> None:
        """Force a manifest write (shutdown path)."""
        with self._lock:
            self._write_manifest_locked(force=True)

    def stats(self) -> dict:
        with self._lock:
            return {
                "root": self.root,
                "live": len(self._live),
                "max_items": self.max_items,
                "next_seq": self._seq,
            }

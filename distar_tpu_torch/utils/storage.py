"""Byte-blob storage routed by URL scheme.

Counterpart of ``distar_tpu.utils.storage``: checkpoints and the
checkpoint manager's pointer go through ``read_bytes`` / ``write_bytes`` /
``exists`` / ``delete``, so a path may name a local file or an in-process
blob; each backend also lists the paths under a prefix.

Schemes:
  * plain paths and ``file://`` -> ``LocalBackend`` (unique tmp, fsync,
    rename, and the rename itself fsynced)
  * ``mem://``                  -> ``MemBackend`` (a process-local dict; tests)

Any other scheme (the JAX package's ``gs://`` stub, a registered pod
backend) raises ``NotImplementedError``: those backends come with ROADMAP
Queue 1 item 10.
"""
from __future__ import annotations

import glob
import os
import threading
import time
from typing import Dict, Iterable, Tuple

WRITE_THREADS = 8  # blobs written and fsynced at once by write_many


class StorageBackend:
    """Byte-blob store. Paths are backend-native (scheme stripped)."""

    def write_bytes(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def read_bytes(self, path: str) -> bytes:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def delete(self, path: str) -> None:
        raise NotImplementedError

    def list(self, prefix: str) -> Iterable[str]:
        raise NotImplementedError

    def write_many(self, items: Iterable[Tuple[str, bytes]]) -> None:
        """Several blobs, each as durable as ``write_bytes`` once this
        returns."""
        for path, data in items:
            self.write_bytes(path, data)


def _fsync_dir(parent: str) -> None:
    try:  # not every filesystem lets a directory be fsynced
        dirfd = os.open(parent, os.O_RDONLY)
        try:
            os.fsync(dirfd)
        finally:
            os.close(dirfd)
    except OSError:
        pass


class LocalBackend(StorageBackend):
    """The local filesystem, written atomically: a tmp file unique to the
    process and thread, fsynced, renamed over the target, and the directory
    fsynced so the rename is durable; tmps older than 10 minutes that a
    killed writer left behind are reaped."""

    def write_bytes(self, path: str, data: bytes) -> None:
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            _fsync_dir(parent)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._reap(glob.escape(path) + ".tmp.*")

    @staticmethod
    def _reap(pattern: str) -> None:
        for stale in glob.glob(pattern):
            try:
                if time.time() - os.path.getmtime(stale) > 600:
                    os.unlink(stale)
            except OSError:
                pass

    def write_many(self, items: Iterable[Tuple[str, bytes]]) -> None:
        """Every blob to a tmp file and fsynced (``WRITE_THREADS`` at once),
        then every rename, then one fsync of each directory: the guarantees
        of ``write_bytes`` per blob, with one directory fsync and one reap of
        stale tmps per directory instead of one per blob (a sharded
        checkpoint is thousands of blobs in one directory)."""
        from concurrent.futures import ThreadPoolExecutor

        items = list(items)
        parents = sorted({os.path.dirname(os.path.abspath(p)) for p, _ in items})
        for parent in parents:
            os.makedirs(parent, exist_ok=True)

        def write_tmp(item):
            path, data = item
            tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            return tmp, path

        # a failed batch leaves its tmps to the reaper, as a killed writer does
        with ThreadPoolExecutor(WRITE_THREADS) as pool:
            for tmp, path in pool.map(write_tmp, items):
                os.replace(tmp, path)
        for parent in parents:
            _fsync_dir(parent)
            self._reap(os.path.join(glob.escape(parent), "*.tmp.*"))

    def read_bytes(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def delete(self, path: str) -> None:
        os.unlink(path)

    def list(self, prefix: str) -> Iterable[str]:
        return sorted(glob.glob(prefix + "*"))


class MemBackend(StorageBackend):
    """A process-local blob dict."""

    def __init__(self):
        self._blobs: Dict[str, bytes] = {}
        self._lock = threading.Lock()

    def write_bytes(self, path: str, data: bytes) -> None:
        with self._lock:
            self._blobs[path] = bytes(data)

    def read_bytes(self, path: str) -> bytes:
        with self._lock:
            if path not in self._blobs:
                raise FileNotFoundError(f"mem://{path}")
            return self._blobs[path]

    def exists(self, path: str) -> bool:
        with self._lock:
            return path in self._blobs

    def delete(self, path: str) -> None:
        with self._lock:
            if path not in self._blobs:
                raise FileNotFoundError(f"mem://{path}")
            del self._blobs[path]

    def list(self, prefix: str) -> Iterable[str]:
        with self._lock:
            return sorted(k for k in self._blobs if k.startswith(prefix))


_BACKENDS: Dict[str, StorageBackend] = {"file": LocalBackend(), "mem": MemBackend()}


def resolve(path: str) -> Tuple[StorageBackend, str]:
    """``scheme://rest`` -> (backend, rest); a path without ``://`` is local."""
    if "://" in path:
        scheme, rest = path.split("://", 1)
        backend = _BACKENDS.get(scheme)
        if backend is None:
            raise NotImplementedError(
                f"storage scheme {scheme}:// is not ported (file and mem:// are); other "
                f"backends come with ROADMAP Queue 1 item 10")
        return backend, rest
    return _BACKENDS["file"], path


def write_bytes(path: str, data: bytes) -> None:
    backend, rest = resolve(path)
    backend.write_bytes(rest, data)


def write_many(items: Iterable[Tuple[str, bytes]]) -> None:
    """``write_bytes`` of every (path, data), batched per backend."""
    by_backend: Dict[int, Tuple[StorageBackend, list]] = {}
    for path, data in items:
        backend, rest = resolve(path)
        by_backend.setdefault(id(backend), (backend, []))[1].append((rest, data))
    for backend, batch in by_backend.values():
        backend.write_many(batch)


def read_bytes(path: str) -> bytes:
    backend, rest = resolve(path)
    return backend.read_bytes(rest)


def exists(path: str) -> bool:
    backend, rest = resolve(path)
    return backend.exists(rest)


def delete(path: str) -> None:
    backend, rest = resolve(path)
    backend.delete(rest)

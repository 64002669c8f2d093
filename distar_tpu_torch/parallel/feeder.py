"""Sharded batch feeding: host batches to this rank's placed rows.

Counterpart of ``distar_tpu.parallel.feeder``:

* ``assemble_global(x, sharding)`` — a global host array to this rank's
  block under ``sharding`` (a ``mesh.NamedSharding``), or, on the
  multi-host path (``local=True``: each rank's loader pulled only its own
  rows), the local array taken as this rank's block as it is. A sharded
  dim that does not divide its mesh extent raises ``MeshConfigError`` with
  the shapes, as in JAX.
* ``ShardFeeder`` — the learner's prefetch wrapper: a producer thread pulls
  the next host batch, places it with ``place_fn`` and banks up to
  ``depth`` placed batches; ``next()`` waits only when the host cannot keep
  up, and that wait is ``distar_feeder_wait_seconds``. On CUDA the placing
  runs on a side stream from pinned memory (``learner.prefetch.place_on``)
  and the consumer's stream waits on its event, as ``DevicePrefetcher``.
"""
from __future__ import annotations

import queue
import time
from typing import Callable

import numpy as np

from ..learner.prefetch import DevicePrefetcher, _SENTINEL
from ..obs import get_registry
from .mesh import MeshConfigError


def _extent(mesh, names) -> int:
    names = names if isinstance(names, tuple) else (names,)
    out = 1
    for n in names:
        out *= mesh.shape[n]
    return out


def _check_divisible(x, sharding) -> None:
    spec, mesh = getattr(sharding, "spec", None), getattr(sharding, "mesh", None)
    if spec is None or mesh is None:
        return
    shape = getattr(x, "shape", ())
    for dim, names in enumerate(spec):
        if names is None or dim >= len(shape):
            continue
        extent = _extent(mesh, names)
        if extent > 1 and shape[dim] % extent:
            raise MeshConfigError(
                f"array dim {dim} of size {shape[dim]} does not divide the "
                f"mesh axes {names if isinstance(names, tuple) else (names,)} (extent {extent}); "
                f"global shape {tuple(shape)} cannot shard as {sharding}"
            )


def assemble_global(x, sharding, local: bool = False):
    """This rank's block of the global host array ``x`` under ``sharding``
    (``local``: ``x`` already is this rank's block)."""
    x = np.asarray(x) if not hasattr(x, "dtype") else x
    if local:
        return x
    _check_divisible(x, sharding)
    mesh = sharding.mesh
    index = []
    for dim, names in enumerate(sharding.spec):
        if names is None:
            index.append(slice(None))
            continue
        names = names if isinstance(names, tuple) else (names,)
        i = 0
        for n in names:  # row-major over the named axes, as JAX splits
            i = i * mesh.shape[n] + mesh.coords[n]
        step = x.shape[dim] // _extent(mesh, names)
        index.append(slice(i * step, (i + 1) * step))
    return x[tuple(index)] if index else x


class ShardFeeder(DevicePrefetcher):
    """Wraps a host-batch iterator; yields placed batches in order, with
    the ``distar_feeder_*`` instrumentation. ``place_fn`` receives the raw
    host batch (pull and collate happen on the producer thread too) and
    returns the placed one; an error of either is raised by the ``next``
    that reaches it."""

    def __init__(self, dataloader, place_fn: Callable, depth: int = 2, token: str = "feeder",
                 device=None):
        if depth < 1:
            raise ValueError(f"ShardFeeder depth must be >= 1, got {depth}")
        self._depth = depth
        self.batches = 0
        self.total_wait_s = 0.0
        self.total_place_s = 0.0
        reg = get_registry()
        self._m_batches = reg.counter("distar_feeder_batches_total",
                                      "host batches placed onto the mesh", token=token)
        self._m_wait = reg.histogram(
            "distar_feeder_wait_seconds",
            "consumer-side starvation: wall-clock next() blocked on the feeder", token=token)
        self._m_place = reg.histogram("distar_feeder_place_seconds",
                                      "host pull + collate + device placement time per batch",
                                      token=token)
        self._m_occ = reg.gauge("distar_feeder_occupancy",
                                "placed-batch share of the double buffer (0..1)", token=token)
        super().__init__(dataloader, place_fn, depth=depth, device=device)

    def _loop(self) -> None:
        try:
            it = iter(self.source)
            while not self._stop.is_set():
                t0 = time.monotonic()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                item = self._place_one(batch)
                dt = time.monotonic() - t0
                self.total_place_s += dt
                self._m_place.observe(dt)
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # noqa: BLE001 - raised on the consumer's side
            self._err = e
        finally:
            self._q.put(_SENTINEL)

    def __next__(self):
        t0 = time.monotonic()
        item = super().__next__()
        waited = time.monotonic() - t0
        self.batches += 1
        self.total_wait_s += waited
        self._m_batches.inc()
        self._m_wait.observe(waited)
        self._m_occ.set(self._q.qsize() / self._depth)
        return item

    def occupancy(self) -> float:
        return self._q.qsize() / self._depth

    def stats(self) -> dict:
        """Host-side totals (the prefetch-overlap contract: mean wait well
        under the mean step time when the host keeps up)."""
        n = max(self.batches, 1)
        return {
            "batches": self.batches,
            "wait_s_mean": self.total_wait_s / n,
            "place_s_mean": self.total_place_s / n,
            "wait_s_total": self.total_wait_s,
        }

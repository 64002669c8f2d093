"""Host-to-device prefetch: the next batch is collated and copied while the
current step trains.

Counterpart of ``distar_tpu.learner.prefetch``; the learners wrap their
loader in its subclass ``parallel.ShardFeeder`` (the JAX learners' wrapper,
with the ``distar_feeder_*`` series). A producer thread pulls host
batches and places them, at most ``depth`` ahead. On CUDA the placing is
``place_on``: each array is copied into pinned host memory and sent with
``non_blocking=True`` on a side stream of the prefetcher's own, and an
event recorded after it; the consumer makes its current stream wait on
that event and marks every tensor as used there (``record_stream``), so
the caching allocator does not hand the side stream's memory out again
while the step still reads it. On the CPU ``place_on`` is the plain
``to_device``.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ..actor.inference import to_device


def place_on(tree, device: torch.device):
    """``tree`` (dicts, lists, tuples of numpy arrays) on ``device``: from
    pinned memory and without blocking on CUDA, ``to_device`` otherwise. A
    tensor already on ``device`` (an Anakin batch) stays where it is."""
    if device.type != "cuda":
        return to_device(tree, device)
    if isinstance(tree, dict):
        return {k: place_on(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(place_on(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device, non_blocking=True)
    host = torch.from_numpy(np.ascontiguousarray(tree)).pin_memory()
    return host.to(device, non_blocking=True)


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


class DevicePrefetcher:
    """Wraps a host-batch iterator and yields placed batches in order. An
    error of the source or of ``place_fn`` is raised by the ``next`` that
    reaches it; ``source`` is the wrapped iterator, for a caller that
    restarts on it after such an error. With ``device`` on CUDA the placing
    runs on a side stream (module docstring)."""

    def __init__(self, dataloader, place_fn: Callable, depth: int = 2,
                 device: Optional[torch.device] = None):
        if depth < 1:
            raise ValueError(f"depth must be at least 1, got {depth}")
        self.source = iter(dataloader)
        self._place = place_fn
        self._device = torch.device(device) if device is not None else None
        cuda = self._device is not None and self._device.type == "cuda"
        self._stream = torch.cuda.Stream(self._device) if cuda else None
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self.failed = False  # the source or place_fn raised; this prefetcher is spent
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True, name="device-prefetch")
        self._thread.start()

    def _place_one(self, batch):
        if self._stream is None:
            return self._place(batch), None
        with torch.cuda.stream(self._stream):
            placed = self._place(batch)
            event = torch.cuda.Event()
            event.record(self._stream)
        return placed, event

    def _loop(self) -> None:
        try:
            for batch in self.source:
                if self._stop.is_set():
                    return
                item = self._place_one(batch)
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

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self.failed:
            raise StopIteration
        item = self._q.get()
        if item is _SENTINEL:
            self.failed = self._err is not None
            self._q.put(_SENTINEL)  # every later next() ends too
            if self._err is not None:
                raise self._err
            raise StopIteration
        placed, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            for t in _tensors(placed):
                t.record_stream(stream)
        return placed

    def close(self) -> None:
        self._stop.set()
        try:  # drain so the producer unblocks
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        # a live producer leaves within 0.2 s of the flag; one blocked in
        # next(source) cannot be interrupted and dies with the process
        self._thread.join(timeout=0.5)


_SENTINEL = object()

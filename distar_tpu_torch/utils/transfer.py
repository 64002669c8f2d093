"""Moving nested dicts of arrays between the host and a device.

``to_device`` puts a tree of numpy arrays on a device (a tensor leaf moves
device to device, and stays as it is where it already lies); ``to_host`` brings
a tree of tensors back in ONE device -> host transfer (a flush's outputs,
a learner's batch, a weight publication).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_device(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device, non_blocking=True)
    return torch.from_numpy(np.ascontiguousarray(tree)).to(device, non_blocking=True)


def to_host(tree):
    """Copy a nested dict of device tensors to host numpy with one transfer:
    the leaves are packed into one byte buffer on the device (each padded
    to 8 bytes, so every host view is aligned), copied, and unpacked as
    views of the host copy."""
    chunks, spec = [], []

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
            return
        raw = t.contiguous().reshape(-1).view(torch.uint8)
        pad = -raw.numel() % 8
        chunks.append(raw)
        if pad:
            chunks.append(raw.new_zeros(pad))
        spec.append((path, t.dtype, tuple(t.shape), raw.numel() + pad))

    walk(tree, ())
    host = torch.cat(chunks).cpu().numpy()
    out: Dict = {}
    off = 0
    for path, dtype, shape, nbytes in spec:
        np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
        n = int(np.prod(shape, dtype=np.int64))
        arr = host[off:off + n * np_dtype.itemsize].view(np_dtype).reshape(shape)
        off += nbytes
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr
    return out

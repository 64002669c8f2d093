"""SL data: decoded-replay datasets on disk -> learner batches.

Counterpart of ``distar_tpu.learner.sl_dataloader``. A ``ReplayDataset``
is a directory of ``<name>.traj.zpkl`` files, each a zlib-compressed
pickle of one trajectory's list of step dicts (the bytes the JAX package
writes, so either package reads the other's datasets). ``SLDataloader``
keeps one slot a batch row: a slot walks its trajectory window by window
(``unroll_len`` steps), pads a short last window, and loads a trajectory
drawn from its seeded generator when it runs dry, flagging the row in
``new_episodes`` so the learner zeroes its carry.

Only open datasets this program or a trusted producer wrote: unpickling
runs code.
"""
from __future__ import annotations

import os
import pickle
import zlib
from typing import Dict, Iterator, List

import numpy as np

from ..lib import features as F
from .data import fake_sl_batch


class ReplayDataset:
    """A directory of decoded trajectories (zlib-pickled step lists)."""

    SUFFIX = ".traj.zpkl"

    def __init__(self, root: str):
        self.root = root
        self.paths = sorted(os.path.join(root, f) for f in os.listdir(root) if f.endswith(self.SUFFIX))
        if not self.paths:
            raise FileNotFoundError(f"no {self.SUFFIX} files under {root}")

    @classmethod
    def save(cls, root: str, name: str, steps: List[dict]) -> str:
        """Write one trajectory. Each step dict holds spatial_info,
        scalar_info, entity_info and entity_num (the feature schema),
        action_info, action_mask and selected_units_num."""
        os.makedirs(root, exist_ok=True)
        path = os.path.join(root, f"{name}{cls.SUFFIX}")
        with open(path, "wb") as f:
            f.write(zlib.compress(pickle.dumps(steps, protocol=5), level=1))
        return path

    def load(self, idx: int) -> List[dict]:
        with open(self.paths[idx % len(self.paths)], "rb") as f:
            return pickle.loads(zlib.decompress(f.read()))


class SLDataloader:
    """Batch slots streaming trajectory windows from a ``ReplayDataset``."""

    def __init__(self, dataset: ReplayDataset, batch_size: int, unroll_len: int, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.unroll_len = unroll_len
        self._rng = np.random.default_rng(seed)
        self._slots: List[List[dict]] = [[] for _ in range(batch_size)]
        self._fresh = [True] * batch_size

    def _refill(self, slot: int) -> None:
        idx = int(self._rng.integers(0, len(self.dataset.paths)))
        traj = self.dataset.load(idx)
        if not traj:
            raise RuntimeError(f"empty trajectory: {self.dataset.paths[idx]}")
        self._slots[slot] = list(traj)
        self._fresh[slot] = True

    @staticmethod
    def _pad_window(window: List[dict], length: int) -> List[dict]:
        """A short window (a short replay, a trajectory's tail) padded to
        ``length`` with copies of its last step whose every action mask is
        zero, so the padding adds to no loss term."""
        pad_src = dict(window[-1])
        pad_src["action_mask"] = {k: 0.0 for k in pad_src["action_mask"]}
        return window + [pad_src] * (length - len(window))

    def __iter__(self) -> Iterator[Dict]:
        return self

    def __next__(self) -> Dict:
        T = self.unroll_len
        windows, new_episodes = [], []
        for b in range(self.batch_size):
            if not self._slots[b]:
                self._refill(b)
            new_episodes.append(self._fresh[b])
            self._fresh[b] = False
            window = self._slots[b][:T]
            self._slots[b] = self._slots[b][T:]
            if len(window) < T:
                window = self._pad_window(window, T)
            windows.append(window)
        flat = [step for win in windows for step in win]  # [B*T], each row's window contiguous
        return {
            "spatial_info": F.batch_tree([s["spatial_info"] for s in flat]),
            "entity_info": F.batch_tree([s["entity_info"] for s in flat]),
            "scalar_info": F.batch_tree([s["scalar_info"] for s in flat]),
            "entity_num": np.stack([np.asarray(s["entity_num"]) for s in flat]),
            "action_info": F.batch_tree([s["action_info"] for s in flat]),
            "action_mask": F.batch_tree([s["action_mask"] for s in flat]),
            "selected_units_num": np.stack([np.asarray(s["selected_units_num"]) for s in flat]),
            "new_episodes": np.asarray(new_episodes, bool),
            "traj_lens": np.full((self.batch_size,), T, np.int64),
        }


def batch_steps(batch: Dict, n: int) -> List[dict]:
    """The ``n`` steps of a one-trajectory SL batch ([n, ...] rows) as the
    step dicts ``ReplayDataset.save`` takes."""
    def at(tree, t):  # keys sorted, as jax.tree.map rebuilds the JAX package's dicts
        if isinstance(tree, dict):
            return {k: at(tree[k], t) for k in sorted(tree)}
        return np.asarray(tree)[t]

    fields = ("spatial_info", "entity_info", "scalar_info", "entity_num", "action_info", "action_mask",
              "selected_units_num")
    # entity_num and selected_units_num as 0-d arrays, not numpy scalars, as
    # the JAX package writes them
    return [{k: np.asarray(batch[k][t]) if k in ("entity_num", "selected_units_num") else at(batch[k], t)
             for k in fields}
            for t in range(n)]


def make_fake_dataset(root: str, n_trajectories: int = 4, steps_per_traj: int = 16,
                      seed: int = 0) -> ReplayDataset:
    """A dataset of ``fake_sl_batch`` trajectories (the JAX package's test
    double for the replay decoder, the same draws from the same seed)."""
    rng = np.random.default_rng(seed)
    for i in range(n_trajectories):
        ReplayDataset.save(root, f"fake_{i:04d}",
                           batch_steps(fake_sl_batch(1, steps_per_traj, rng=rng), steps_per_traj))
    return ReplayDataset(root)

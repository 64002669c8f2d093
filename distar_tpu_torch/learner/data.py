"""SL batches: the schema, a fake dataloader and the entity cap.

Counterpart of the SL half of ``distar_tpu.learner.data``. An SL batch is a
host numpy tree of B trajectories x T steps laid out flat and batch-major
([B*T, ...]: trajectory b's steps are rows b*T .. b*T + T-1):

  spatial_info / entity_info / scalar_info   observation fields [B*T, ...]
  entity_num                                 [B*T]
  action_info[head]                          labels [B*T(, 64)]
  action_mask[head]                          [B*T] 1.0 where the head's loss counts
  selected_units_num                         [B*T] selected units incl. the end token
  new_episodes                               [B] trajectory restarted: zero its carry
  traj_lens                                  [B]
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from ..lib import actions as A
from ..lib import features as F


def fake_sl_batch(batch_size: int, unroll_len: int,
                  rng: Optional[np.random.Generator] = None) -> Dict:
    """A schema-complete random SL batch: zero observations with random
    entity counts (at least 8) and random labels in range."""
    rng = rng or np.random.default_rng(0)
    B, T, S = batch_size, unroll_len, F.MAX_SELECTED_UNITS_NUM
    n = B * T
    obs = F.batch_tree([F.fake_step_data(rng) for _ in range(n)])
    entity_num = np.maximum(obs["entity_num"], 8)
    sun = rng.integers(2, 7, (n,))
    su = np.zeros((n, S), np.int64)
    for i in range(n):
        # distinct units, then the end token: the pointer mask forbids picking
        # a unit twice, so a repeated label would sit on a -1e9 logit
        su[i, : sun[i] - 1] = rng.permutation(8)[: sun[i] - 1]
        su[i, sun[i] - 1] = entity_num[i]
    return {
        "spatial_info": obs["spatial_info"],
        "entity_info": obs["entity_info"],
        "scalar_info": obs["scalar_info"],
        "entity_num": entity_num,
        "action_info": {
            "action_type": rng.integers(0, A.NUM_ACTIONS, (n,)),
            "delay": rng.integers(0, F.MAX_DELAY + 1, (n,)),
            "queued": rng.integers(0, 2, (n,)),
            "selected_units": su,
            "target_unit": rng.integers(0, 8, (n,)),
            "target_location": rng.integers(0, F.SPATIAL_SIZE[0] * F.SPATIAL_SIZE[1], (n,)),
        },
        "action_mask": {k: np.ones((n,), np.float32) for k in F.ACTION_HEADS},
        "selected_units_num": sun,
        "new_episodes": np.zeros((B,), bool),
        "traj_lens": np.full((B,), T, np.int64),
    }


def random_sl_batch(batch_size: int, unroll_len: int, rng: np.random.Generator) -> Dict:
    """``fake_sl_batch``'s labels over random in-range observations
    (``features.random_step_data``, at least 8 entities a frame, since the
    labels pick among the first 8 units): parity checks use it because a
    zero observation hides layout faults."""
    batch = fake_sl_batch(batch_size, unroll_len, rng)
    n = batch_size * unroll_len
    obs = F.batch_tree([F.random_step_data(rng) for _ in range(n)])
    entity_num = np.maximum(obs["entity_num"], 8)
    su = batch["action_info"]["selected_units"]
    su[np.arange(n), batch["selected_units_num"] - 1] = entity_num  # the end token
    return dict(batch, spatial_info=obs["spatial_info"], entity_info=obs["entity_info"],
                scalar_info=obs["scalar_info"], entity_num=entity_num)


class FakeSLDataloader:
    """Infinite iterator of fake SL batches from one seeded generator."""

    def __init__(self, batch_size: int, unroll_len: int, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self._batch_size = batch_size
        self._unroll_len = unroll_len

    def __iter__(self) -> Iterator[Dict]:
        return self

    def __next__(self) -> Dict:
        return fake_sl_batch(self._batch_size, self._unroll_len, rng=self._rng)


def cap_entities(batch: Dict, n: int) -> Dict:
    """Slice a host SL batch's entity axis to its first ``n`` slots.

    Every model shape follows the input and padded rows are masked out of
    every reduction, so a step with entity_num <= n computes exactly what it
    computed uncapped, at less cost (the entity transformer and the pointer
    decode scale with the padded count). A step above the cap is truncated:
    entity_num clamps to n, end-token labels move to the new end slot, and a
    selected_units or target_unit label that pointed at a dropped entity
    zeroes that head's action_mask for the step instead of training on a
    wrong label.
    """
    entity_info = {k: v[:, :n] for k, v in batch["entity_info"].items()}
    old_num = np.asarray(batch["entity_num"])
    new_num = np.minimum(old_num, n)

    ai = dict(batch["action_info"])
    am = dict(batch["action_mask"])
    su = np.asarray(ai["selected_units"])
    was_end = su == old_num[..., None]
    dropped = (su >= new_num[..., None]) & ~was_end
    ai["selected_units"] = np.where(was_end | dropped, new_num[..., None], su)
    su_mask = np.asarray(am["selected_units"])
    am["selected_units"] = np.where(dropped.any(-1), 0.0, su_mask).astype(su_mask.dtype)

    tu = np.asarray(ai["target_unit"])
    tu_bad = tu >= new_num
    ai["target_unit"] = np.where(tu_bad, 0, tu)
    tu_mask = np.asarray(am["target_unit"])
    am["target_unit"] = np.where(tu_bad, 0.0, tu_mask).astype(tu_mask.dtype)

    return dict(batch, entity_info=entity_info, entity_num=new_num, action_info=ai,
                action_mask=am)

"""Learner batches: the SL and RL schemas, fake dataloaders, entity caps.

Counterpart of ``distar_tpu.learner.data``. An SL batch is a host numpy
tree of B trajectories x T steps laid out flat and batch-major ([B*T, ...]:
trajectory b's steps are rows b*T .. b*T + T-1):

  spatial_info / entity_info / scalar_info   observation fields [B*T, ...]
  entity_num                                 [B*T]
  action_info[head]                          labels [B*T(, 64)]
  action_mask[head]                          [B*T] 1.0 where the head's loss counts
  selected_units_num                         [B*T] selected units incl. the end token
  new_episodes                               [B] trajectory restarted: zero its carry
  traj_lens                                  [B]

An RL batch is time-major (the learner flattens the observations to rows
t*B + b):

  obs fields                [T+1, B, ...]   (T+1: the last step bootstraps)
  value_feature             [T+1, B, ...]   (with use_value_feature)
  hidden_state              tuple of (h, c), each [B, H]
  action_info[head]         [T, B(, S)]
  selected_units_num        [T, B]
  behaviour_logp[head]      [T, B(, S)]
  teacher_logit[head]       [T, B, ...]
  reward[field]             [T, B]
  step                      [T, B]
  done                      [T, B]  (1 from the terminal step onward)
  mask                      dict (see losses.rl_loss)
  model_last_iter           [B]
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from ..lib import actions as A
from ..lib import features as F

RL_REWARD_FIELDS = ("winloss", "build_order", "built_unit", "effect", "upgrade", "battle")


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


def fake_rl_batch(
    batch_size: int,
    unroll_len: int,
    rng: Optional[np.random.Generator] = None,
    hidden_size: int = 384,
    hidden_layers: int = 3,
    use_value_feature: bool = False,
) -> Dict:
    """A schema-complete random RL batch (host numpy), drawn from ``rng`` in
    the JAX package's order: zero observations with random entity counts (at
    least 8), teacher logits, random labels, behaviour log-probs, rewards,
    the value features (with ``use_value_feature``) and steps."""
    rng = rng or np.random.default_rng(0)
    T, B, S, N = unroll_len, batch_size, F.MAX_SELECTED_UNITS_NUM, F.MAX_ENTITY_NUM
    obs = F.batch_tree([F.batch_tree([F.fake_step_data(rng) for _ in range(B)])
                        for _ in range(T + 1)])
    entity_num = np.maximum(obs["entity_num"], 8)
    sun = rng.integers(2, 7, (T, B))

    # drawn before the labels, as the JAX package draws them
    teacher_logit = {k: rng.standard_normal((T, B) + shape).astype(np.float32)
                     for k, shape in F.LOGIT_SHAPES.items()}
    # distinct units, then the end token (== entity_num): the pointer mask
    # forbids picking a unit twice, so a repeated label would sit on a -1e9 logit
    su = np.zeros((T, B, S), np.int64)
    for t in range(T):
        for b in range(B):
            n = sun[t, b]
            su[t, b, : n - 1] = rng.permutation(8)[: n - 1]
            su[t, b, n - 1] = entity_num[t, b]
    actions = {
        "action_type": rng.integers(0, A.NUM_ACTIONS, (T, B)),
        "delay": rng.integers(0, F.MAX_DELAY + 1, (T, B)),
        "queued": rng.integers(0, 2, (T, B)),
        "selected_units": su,
        "target_unit": rng.integers(0, 8, (T, B)),
        "target_location": rng.integers(0, F.SPATIAL_SIZE[0] * F.SPATIAL_SIZE[1], (T, B)),
    }
    # the teacher near-deterministic on the label slots: random fake logits
    # on slots the learner masks (-1e9) would make the KL explode
    teacher_logit["selected_units"] = (40.0 * np.eye(N + 1, dtype=np.float32)[su] - 20.0).astype(np.float32)
    teacher_logit["target_unit"] = (
        40.0 * np.eye(N, dtype=np.float32)[actions["target_unit"]] - 20.0).astype(np.float32)
    behaviour_logp = {
        k: -np.abs(rng.standard_normal((T, B) + ((S,) if k == "selected_units" else ()))).astype(np.float32)
        for k in F.ACTION_HEADS
    }
    ones = np.ones((T, B), np.float32)
    masks = {
        "actions_mask": {k: ones.copy() for k in F.ACTION_HEADS},
        "selected_units_mask": np.arange(S)[None, None] < sun[..., None],
        "build_order_mask": ones.copy(),
        "built_unit_mask": ones.copy(),
        "effect_mask": ones.copy(),
        "cum_action_mask": ones.copy(),
        "step_mask": ones.copy(),
    }
    rewards = {f: rng.integers(-1, 2, (T, B)).astype(np.float32) for f in RL_REWARD_FIELDS}
    extra = {}
    if use_value_feature:
        extra["value_feature"] = F.batch_tree(
            [F.batch_tree([F.fake_value_feature(rng) for _ in range(B)]) for _ in range(T + 1)])
    zeros = np.zeros((B, hidden_size), np.float32)
    return {
        **extra,
        "spatial_info": obs["spatial_info"],
        "entity_info": obs["entity_info"],
        "scalar_info": obs["scalar_info"],
        "entity_num": entity_num,
        "hidden_state": tuple((zeros.copy(), zeros.copy()) for _ in range(hidden_layers)),
        "action_info": actions,
        "selected_units_num": sun,
        "behaviour_logp": behaviour_logp,
        "teacher_logit": teacher_logit,
        "reward": rewards,
        "step": rng.integers(0, 10000, (T, B)).astype(np.float32),
        "done": np.zeros((T, B), np.float32),
        "mask": masks,
        "model_last_iter": np.zeros((B,), np.float32),
    }


def random_rl_batch(batch_size: int, unroll_len: int, rng: np.random.Generator,
                    hidden_size: int = 384, hidden_layers: int = 3,
                    use_value_feature: bool = False) -> Dict:
    """``fake_rl_batch``'s labels over random in-range observations (and
    value features), at least 8 entities a frame: parity checks use it
    because a zero observation hides layout faults and makes every entity
    alike, so the attention backward over them is rounding noise."""
    T, B = unroll_len, batch_size
    batch = fake_rl_batch(B, T, rng, hidden_size, hidden_layers, use_value_feature)
    obs = F.batch_tree([F.batch_tree([F.random_step_data(rng) for _ in range(B)])
                        for _ in range(T + 1)])
    entity_num = np.maximum(obs["entity_num"], 8)
    su = batch["action_info"]["selected_units"]
    t, b = np.meshgrid(np.arange(T), np.arange(B), indexing="ij")
    su[t, b, batch["selected_units_num"] - 1] = entity_num[:-1]  # the end tokens
    batch["teacher_logit"]["selected_units"] = (
        40.0 * np.eye(F.MAX_ENTITY_NUM + 1, dtype=np.float32)[su] - 20.0).astype(np.float32)
    if use_value_feature:
        batch["value_feature"] = F.batch_tree(
            [F.batch_tree([F.random_value_feature(rng) for _ in range(B)]) for _ in range(T + 1)])
    return dict(batch, spatial_info=obs["spatial_info"], entity_info=obs["entity_info"],
                scalar_info=obs["scalar_info"], entity_num=entity_num)


class FakeRLDataloader:
    """Infinite iterator of fake RL batches from one seeded generator."""

    def __init__(self, batch_size: int, unroll_len: int, hidden_size: int = 384,
                 hidden_layers: int = 3, seed: int = 0, use_value_feature: bool = False):
        self._rng = np.random.default_rng(seed)
        self._kwargs = dict(batch_size=batch_size, unroll_len=unroll_len, hidden_size=hidden_size,
                            hidden_layers=hidden_layers, use_value_feature=use_value_feature)

    def __iter__(self) -> Iterator[Dict]:
        return self

    def __next__(self) -> Dict:
        return fake_rl_batch(rng=self._rng, **self._kwargs)


def cap_entities_rl(batch: Dict, n: int) -> Dict:
    """The RL layout's :func:`cap_entities` (obs [T+1, B, N, ...], actions
    and teacher logits [T, B, ...]).

    Exact for steps with entity_num <= n, as there. A step above the cap
    zeroes its selected_units and target_unit action masks entirely (the
    teacher's sliced distribution would renormalise over a truncated
    candidate set), clamps its end tokens to the new end slot and every
    out-of-range lane to it, and zeroes out-of-range target units.
    """
    entity_info = {k: v[:, :, :n] for k, v in batch["entity_info"].items()}
    old_num = np.asarray(batch["entity_num"])  # [T+1, B]
    new_num = np.minimum(old_num, n)
    act_num_old = old_num[:-1]  # the acted steps
    act_num_new = new_num[:-1]
    overflow = act_num_old > n  # [T, B]

    ai = dict(batch["action_info"])
    su = np.asarray(ai["selected_units"])  # [T, B, S]
    was_end = su == act_num_old[..., None]
    oob = (su >= act_num_new[..., None]) & ~was_end
    ai["selected_units"] = np.where(was_end | oob, act_num_new[..., None], su)
    tu = np.asarray(ai["target_unit"])  # [T, B]
    tu_bad = tu >= act_num_new
    ai["target_unit"] = np.where(tu_bad, 0, tu)

    mask = {k: (dict(v) if isinstance(v, dict) else v) for k, v in batch["mask"].items()}
    am = mask["actions_mask"]
    su_mask = np.asarray(am["selected_units"])
    am["selected_units"] = np.where(overflow, 0.0, su_mask).astype(su_mask.dtype)
    tu_mask = np.asarray(am["target_unit"])
    am["target_unit"] = np.where(overflow | tu_bad, 0.0, tu_mask).astype(tu_mask.dtype)

    def cap_logits(logits):
        out = dict(logits)
        out["selected_units"] = np.asarray(out["selected_units"])[..., : n + 1]
        out["target_unit"] = np.asarray(out["target_unit"])[..., :n]
        return out

    out = dict(batch, entity_info=entity_info, entity_num=new_num, action_info=ai, mask=mask,
               teacher_logit=cap_logits(batch["teacher_logit"]))
    if "successive_logit" in batch:  # DAPO's logits, the teacher's layout
        out["successive_logit"] = cap_logits(batch["successive_logit"])
    return out

"""RL dataloader: trajectory collation + adapter-fed batching.

Counterpart of ``distar_tpu.learner.rl_dataloader``: ``collate_trajectories``,
the adapter-fed ``RLDataLoader`` and the store-backed ``ReplayDataLoader``.
Role parity with the reference RLDataLoader (reference: distar/agent/default/
rl_training/rl_dataloader.py:45-167): worker pull-loops fetch trajectories
over the Adapter, `collate_trajectories` assembles the time-major learner
batch. Divergence by design: the reference pads entities per-batch to the
max entity count (:206-245); here every trajectory already carries the fixed
MAX_ENTITY_NUM padding (static shapes), so collation is pure stacking.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..comm import Adapter
from ..lib import features as F
from ..obs import finish_trace, get_registry, is_trace


class CollationError(ValueError):
    """A batch of trajectories cannot be collated (ragged lengths / empty
    batch). Carries the offending per-trajectory lengths so the fault is
    attributable to a producer without re-deriving anything — and unlike a
    bare ``assert``, survives ``python -O``."""

    def __init__(self, message: str, lengths: List[int]):
        super().__init__(f"{message} (per-trajectory lengths: {lengths})")
        self.lengths = list(lengths)


def collate_trajectories(trajs: List[list]) -> Dict:
    """[B] trajectories (each T steps + 1 bootstrap step) -> learner batch.

    Output layout matches ``learner.data.random_rl_batch`` (obs [T+1, B, ...],
    actions/logps/teacher/rewards [T, B, ...], hidden_state per layer [B, H]).
    Raises ``CollationError`` on an empty batch or ragged trajectory lengths.
    """
    lengths = [len(t) for t in trajs]
    if not trajs:
        raise CollationError("empty trajectory batch", lengths)
    T = lengths[0] - 1
    if T < 1:
        raise CollationError("trajectories need >= 1 step + bootstrap", lengths)
    if any(n != T + 1 for n in lengths):
        raise CollationError("trajectories must share T", lengths)
    steps = [t[:T] for t in trajs]

    def stack_obs(key):
        # [T+1, B, ...]: bootstrap step supplies index T
        return F.batch_tree(
            [
                F.batch_tree([traj[t][key] for traj in trajs])
                for t in range(T + 1)
            ]
        )

    def stack_tb(get):
        return F.batch_tree([F.batch_tree([get(traj[t]) for traj in trajs]) for t in range(T)])

    batch = {
        "spatial_info": stack_obs("spatial_info"),
        "entity_info": stack_obs("entity_info"),
        "scalar_info": stack_obs("scalar_info"),
        "entity_num": stack_obs("entity_num"),
        "hidden_state": tuple(
            (
                np.stack([np.asarray(traj[0]["hidden_state"][l][0]) for traj in trajs]),
                np.stack([np.asarray(traj[0]["hidden_state"][l][1]) for traj in trajs]),
            )
            for l in range(len(trajs[0][0]["hidden_state"]))
        ),
        "action_info": stack_tb(lambda s: s["action_info"]),
        "selected_units_num": stack_tb(lambda s: s["selected_units_num"]),
        "behaviour_logp": stack_tb(lambda s: s["behaviour_logp"]),
        "teacher_logit": stack_tb(lambda s: s["teacher_logit"]),
        "reward": stack_tb(lambda s: s["reward"]),
        "step": stack_tb(lambda s: s["step"]),
        "done": stack_tb(lambda s: s.get("done", 0.0)),
        "model_last_iter": np.asarray(
            [float(traj[0].get("model_last_iter", 0.0)) for traj in trajs], np.float32
        ),
    }
    if "value_feature" in trajs[0][0]:
        batch["value_feature"] = stack_obs("value_feature")
    sun = batch["selected_units_num"].astype(np.int64)
    masks = stack_tb(lambda s: s["mask"])
    masks["selected_units_mask"] = (
        np.arange(F.MAX_SELECTED_UNITS_NUM)[None, None, :] < sun[..., None]
    )
    batch["mask"] = masks
    return batch


class RLDataLoader:
    """Pulls trajectories for a player token over the Adapter and yields
    collated [T, B] batches."""

    def __init__(
        self,
        adapter: Adapter,
        player_id: str,
        batch_size: int,
        cache_size: int = 64,
        token_suffix: str = "traj",
    ):
        self._adapter = adapter
        self._token = f"{player_id}{token_suffix}"
        self._batch_size = batch_size
        self._cache_size = cache_size
        # the pull loop notifies this condition on every append, so __next__
        # sleeps in cond.wait instead of a 5 ms busy-poll (the timeout is a
        # liveness backstop, not the wake mechanism)
        self._cond = threading.Condition()
        # keep_trace: the loop leaves spans open so THIS consumer records the
        # terminal hop (cache entries are (traj, trace_ctx) tuples)
        self._cache = adapter.start_pull_loop(
            self._token, maxlen=cache_size, keep_trace=True, condition=self._cond
        )
        reg = get_registry()
        self._m_batches = reg.counter(
            "distar_dataloader_batches_total", "collated batches yielded", token=self._token
        )
        self._m_occupancy = reg.gauge(
            "distar_dataloader_occupancy", "pull-cache fill fraction", token=self._token
        )
        self._m_wait = reg.histogram(
            "distar_dataloader_wait_s",
            "wall-clock the learner starved waiting for trajectories, per batch",
            token=self._token,
        )

    @property
    def token(self) -> str:
        """The adapter token this loader consumes (telemetry/broker depth)."""
        return self._token

    def buffered(self) -> int:
        """Trajectories currently banked in the pull cache."""
        return len(self._cache)

    def occupancy(self) -> float:
        """Buffered-trajectory share of the pull cache (0..1): ~0 means the
        learner is actor-starved, ~1 means the actors outrun the learner
        (the saturation axis of the reference's staleness regime,
        rl_learner.py:90-101)."""
        return self.buffered() / max(self._cache_size, 1)

    def __iter__(self) -> Iterator[Dict]:
        return self

    def __next__(self) -> Dict:
        trajs: List[list] = []
        traces: List[Optional[dict]] = []
        waited_s = 0.0
        while len(trajs) < self._batch_size:
            if self._cache:
                traj, ctx = self._cache.popleft()
                trajs.append(traj)
                traces.append(ctx)
            else:
                # starvation: block on the pull loop's condition instead of
                # busy-polling; the timeout only bounds a missed notify
                t0 = time.monotonic()
                with self._cond:
                    self._cond.wait_for(lambda: bool(self._cache), timeout=0.5)
                waited_s += time.monotonic() - t0
        self._m_wait.observe(waited_s)
        # close out the actor-minted pipeline spans: the batch reaching the
        # learner is the terminal hop, and its age (actor env-step ->
        # learner consume) is the wall-clock half of staleness. Span ids and
        # ages ride the batch as host-side fields for the learner's log.
        span_ids, ages = [], []
        for traj, ctx in zip(trajs, traces):
            if isinstance(traj[0], dict):
                ctx = traj[0].pop("trace", ctx)  # same object when both exist
            if is_trace(ctx):
                ages.append(finish_trace(ctx, hop="learner_collate"))
                span_ids.append(ctx["span_id"])
        batch = collate_trajectories(trajs)
        if span_ids:
            batch["trace_span_ids"] = span_ids
            batch["trace_age_s"] = np.asarray(ages, np.float32)
        self._m_batches.inc()
        self._m_occupancy.set(self.occupancy())
        return batch


class ReplayDataLoader:
    """Store-backed sampling mode: batches come from a replay-store table
    (``replay.SampleClient``) instead of the point-to-point pull cache, then
    flow through the SAME ``collate_trajectories`` — the learner cannot tell
    which data plane fed it.

    What changes operationally: trajectories may be sampled more than once
    (the table's samples-per-insert ratio governs reuse), the last batch's
    per-item store metadata (seq/priority/sample_count/staleness) is kept on
    ``last_sample_info`` for priority updates and logging, and starvation
    blocks server-side in the store's rate limiter (the client retries
    rate-limit timeouts under its policy). Staleness/reuse histograms are
    recorded store-side (``distar_replay_sampled_*``).

    The client can be a single-store ``SampleClient``, the zero-copy
    ``LocalReplayClient`` (colocated fast path), or a
    ``ShardedSampleClient`` fanning in across a shard fleet — the loader is
    agnostic: all three speak the same ``sample``/``update_priorities``
    surface, and for the sharded one the per-item ``shard`` field on
    ``last_sample_info`` routes priority updates back to exactly the shard
    each item came from."""

    def __init__(self, sample_client, player_id: str, batch_size: int,
                 table: Optional[str] = None, sample_timeout_s: float = 30.0):
        self._client = sample_client
        self._table = table or player_id
        self._batch_size = batch_size
        self._sample_timeout_s = sample_timeout_s
        self.last_sample_info: List[dict] = []
        reg = get_registry()
        self._m_batches = reg.counter(
            "distar_dataloader_batches_total", "collated batches yielded",
            token=self._table,
        )
        self._m_wait = reg.histogram(
            "distar_dataloader_wait_s",
            "wall-clock the learner starved waiting for trajectories, per batch",
            token=self._table,
        )

    @property
    def token(self) -> str:
        """The replay table this loader samples (telemetry parity with the
        adapter loader's token)."""
        return self._table

    def __iter__(self) -> "ReplayDataLoader":
        return self

    def __next__(self) -> Dict:
        t0 = time.monotonic()
        items, info = self._client.sample(
            self._table, batch_size=self._batch_size,
            timeout_s=self._sample_timeout_s,
        )
        self._m_wait.observe(time.monotonic() - t0)
        span_ids, ages = [], []
        for traj in items:
            if traj and isinstance(traj[0], dict):
                ctx = traj[0].pop("trace", None)
                if is_trace(ctx):
                    ages.append(finish_trace(ctx, hop="learner_collate"))
                    span_ids.append(ctx["span_id"])
        batch = collate_trajectories(items)
        if span_ids:
            batch["trace_span_ids"] = span_ids
            batch["trace_age_s"] = np.asarray(ages, np.float32)
        self.last_sample_info = info
        self._m_batches.inc()
        return batch

    def update_priorities(self, updates: Dict[int, float]) -> int:
        """PER hook: push learner-side priorities (e.g. TD error magnitudes)
        back to the table; unknown seqs (already evicted) are ignored. On a
        sharded fleet the last batch's sample info routes each update to
        the shard that served the item (seqs are per-shard counters, so a
        broadcast could re-prioritize a stranger's seq)."""
        if getattr(self._client, "sharded", False):
            return self._client.update_priorities(
                self._table, updates, info=self.last_sample_info)
        return self._client.update_priorities(self._table, updates)

"""Distributed trajectory store: Reverb-style tables with prioritized
sampling, samples-per-insert rate control, and fsync'd disk spill so acked
inserts survive a store crash.

The decoupling layer between the actor fleet and the learner(s): actors
``InsertClient.insert`` trajectories into per-player tables, learners
``SampleClient.sample`` batches out, and the ``RateLimiter`` makes the
reuse ratio (and therefore staleness) a configured invariant instead of an
accident of queue sizes.

Counterpart of ``distar_tpu.replay``, exporting its ``__all__`` name for
name. See docs/data_plane.md for the shuttle-path vs store-path contract.
"""
from .client import DEFAULT_REPLAY_POLICY, InsertClient, SampleClient
from .errors import (
    InvalidBatchError,
    ItemCorruptError,
    RateLimitTimeout,
    ReplayError,
    StoreDrainingError,
    UnknownTableError,
    error_from_wire,
)
from .local import LocalReplayClient, is_inproc_addr, local_store, set_local_store
from .server import ReplayAdminServer, ReplayServer
from .sharding import (
    SHARD_TOKEN,
    HashRing,
    ShardMap,
    ShardedInsertClient,
    ShardedSampleClient,
    register_shard,
    stable_hash,
)
from .spill import SpillRing
from .store import (
    RateLimiter,
    ReplayStore,
    ReplayTable,
    SampledItem,
    SumTree,
    TableConfig,
)

__all__ = [
    "DEFAULT_REPLAY_POLICY",
    "InsertClient",
    "SampleClient",
    "InvalidBatchError",
    "ItemCorruptError",
    "RateLimitTimeout",
    "ReplayError",
    "StoreDrainingError",
    "UnknownTableError",
    "error_from_wire",
    "LocalReplayClient",
    "is_inproc_addr",
    "local_store",
    "set_local_store",
    "ReplayAdminServer",
    "ReplayServer",
    "SHARD_TOKEN",
    "HashRing",
    "ShardMap",
    "ShardedInsertClient",
    "ShardedSampleClient",
    "register_shard",
    "stable_hash",
    "SpillRing",
    "RateLimiter",
    "ReplayStore",
    "ReplayTable",
    "SampledItem",
    "SumTree",
    "TableConfig",
]

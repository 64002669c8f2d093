"""Zero-copy colocated fast path: the replay plane without the wire.

Counterpart of ``distar_tpu.replay.local``. In the Sebulba layout
(``rl_train --type all``) actor, store and learner share one process; a
store behind loopback TCP round-trips every trajectory through pickle ->
lz4 -> socket -> lz4 -> unpickle, twice (push and sample).
``LocalReplayClient`` removes the whole stack: it speaks
the exact Insert/SampleClient surface over a direct ``ReplayStore`` handle,
so ``push_trajectory`` hands the store THE object (no serialization — the
learner later collates the very arrays the actor produced) and ``sample``
hands them back. Rate limiting, eviction, spill durability and metrics are
untouched — they live in the store, not the transport.

Wiring is by address scheme so configs stay plain strings: an
``actor.replay.addr`` of ``"inproc"`` (or ``"local"``) resolves to the
process-registered store (``set_local_store``), which ``rl_train`` installs
under ``--replay --replay-fast-path``.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from ..comm.serializer import maybe_decode
from ..resilience import retry_call
from .client import DEFAULT_REPLAY_POLICY
from .store import ReplayStore

#: addr spellings that mean "the process-local store, no socket"
INPROC_ADDRS = ("inproc", "local")

_local_store: Optional[ReplayStore] = None
_local_lock = threading.Lock()


def set_local_store(store: Optional[ReplayStore]) -> None:
    """Install (or clear, with None) this process's colocated store."""
    global _local_store
    with _local_lock:
        _local_store = store


def local_store() -> ReplayStore:
    with _local_lock:
        store = _local_store
    if store is None:
        raise RuntimeError(
            "no in-process replay store registered: 'inproc' replay "
            "addresses need rl_train --replay --replay-fast-path (or an "
            "explicit set_local_store) in this process"
        )
    return store


def is_inproc_addr(addr: str) -> bool:
    return str(addr).strip().lower() in INPROC_ADDRS


class LocalReplayClient:
    """Insert+Sample client surface over a direct store handle. Sampled
    items are the inserted objects themselves (identity-preserved) except
    spill-recovered ones, which decode transparently.

    Pacing parity with the TCP clients: ``RateLimitTimeout`` is retryable,
    and the TCP clients re-offer it under ``DEFAULT_REPLAY_POLICY`` (120 s
    deadline budget) — so this client does too. Without that, a colocated
    learner that outpaces a still-warming actor would crash on the first
    30 s limiter block where the wire path would have ridden it out."""

    def __init__(self, store: Optional[ReplayStore] = None,
                 retry_policy=None):
        self._store = store if store is not None else local_store()
        self._policy = retry_policy or DEFAULT_REPLAY_POLICY

    # ------------------------------------------------------------ insert side
    def insert(self, table: str, item: Any, priority: float = 1.0,
               timeout_s: Optional[float] = None, key: Optional[str] = None) -> int:
        # no idem key: there is no wire to lose an ack on, so the in-process
        # call is exactly-once by construction
        return retry_call(
            self._store.insert, table, item,
            priority=priority, timeout_s=60.0 if timeout_s is None else timeout_s,
            op="replay_local:insert", policy=self._policy,
        )

    # ------------------------------------------------------------ sample side
    def sample(self, table: str, batch_size: int = 1,
               timeout_s: Optional[float] = None) -> Tuple[List[Any], List[dict]]:
        sampled = retry_call(
            self._store.sample, table,
            batch_size=batch_size,
            timeout_s=60.0 if timeout_s is None else timeout_s,
            op="replay_local:sample", policy=self._policy,
        )
        return [maybe_decode(s.data) for s in sampled], [s.info() for s in sampled]

    def update_priorities(self, table: str, updates: Dict[int, float],
                          info: Optional[List[dict]] = None) -> int:
        return self._store.update_priorities(table, updates)

    # ---------------------------------------------------------------- common
    def ping(self) -> bool:
        return True

    def stats(self) -> dict:
        return self._store.stats()

    def tables(self) -> List[str]:
        return self._store.tables()

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

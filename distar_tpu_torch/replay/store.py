"""Reverb-style trajectory tables: prioritized sampling + rate control.

Counterpart of ``distar_tpu.replay.store``: a table draws from
``random.Random(config.seed)`` with the same calls in the same order, so
the same inserts, priorities and seed sample the same sequence in both
packages.

The DI-star data plane is point-to-point push with consume-once semantics
(actor -> shuttle -> learner pull cache); the backpressure story is "the
deque is full". This module is the decoupling layer the Podracer/RLAX TPU
scaling recipes call for: a per-player ``ReplayTable`` holding trajectories
behind an explicit ``RateLimiter``, so actors and learners run at
independently-supervised speeds while the *ratio* between them — how often
each trajectory is trained on, and therefore how stale the average sample
is — is a configured invariant instead of an accident of queue sizes.

Samplers:
  * ``prioritized`` — sum-tree proportional sampling (with replacement) over
    ``priority ** priority_exponent``; per-item sample counts tracked.
  * ``uniform``     — degenerate prioritized case (every priority forced 1).
  * ``fifo``        — consume-once oldest-first pop, the legacy shuttle-path
    semantics expressed as a table (without replacement; items leave on
    sample).

Eviction: FIFO when ``max_size`` is hit, plus ``max_staleness_s`` sweeps
(items older than the bound will never be worth training on). Every item
departure — first sample for consume-once release, or eviction — fires the
``on_release`` hook the store uses to drop the item from the disk spill.

Rate control (``RateLimiter``): with ``spi = samples_per_insert``,
``min_size`` inserts are free, then the limiter keeps

    samples  ≈  spi * (inserts - min_size)      (within ± error_buffer)

by blocking samplers when actors fall behind and blocking inserters when
the learner does. ``error_buffer`` is in sample units and is clamped to at
least ``max(1, spi)`` so single-step progress is always possible. The
buffer also bounds the largest admissible sample batch
(``RateLimiter.max_sample_batch``): a batch the buffer can never admit
would park sampler AND inserter forever, so ``sample`` rejects it up front
with the non-retryable ``InvalidBatchError`` — size the buffer to at least
``max(1, spi) * batch_size`` (Reverb sizes its min/max_diff to the batch
the same way; the launcher defaults ``--replay-error-buffer`` accordingly).
"""
from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from ..obs import annotate_active, get_registry
from .errors import (
    InvalidBatchError,
    RateLimitTimeout,
    StoreDrainingError,
    UnknownTableError,
)

SAMPLERS = ("prioritized", "uniform", "fifo")


class SumTree:
    """Flat-array binary sum tree over ``capacity`` slots: O(log n) priority
    updates and prefix-sum descent for proportional sampling."""

    def __init__(self, capacity: int):
        assert capacity >= 1
        n = 1
        while n < capacity:
            n *= 2
        self._n = n
        self._tree = [0.0] * (2 * n)

    def set(self, slot: int, value: float) -> None:
        assert 0 <= slot < self._n and value >= 0.0
        i = slot + self._n
        self._tree[i] = value
        i //= 2
        while i >= 1:
            self._tree[i] = self._tree[2 * i] + self._tree[2 * i + 1]
            i //= 2

    def get(self, slot: int) -> float:
        return self._tree[slot + self._n]

    @property
    def total(self) -> float:
        return self._tree[1]

    def find(self, mass: float) -> int:
        """Slot whose cumulative-priority interval contains ``mass``
        (callers draw ``mass`` uniformly from [0, total))."""
        i = 1
        while i < self._n:
            left = 2 * i
            if mass < self._tree[left] or self._tree[left + 1] <= 0.0:
                i = left
            else:
                mass -= self._tree[left]
                i = left + 1
        return i - self._n


class RateLimiter:
    """Samples-per-insert gate shared by one table's inserters and samplers.

    Thread-safe; both sides block on one condition variable, and every
    commit wakes all waiters (an insert can unblock samplers and vice
    versa). Cumulative block time per side is the
    ``distar_replay_limiter_block_seconds_total`` counter — the single most
    diagnostic replay metric (it says *which* side of the fleet is slow).
    """

    def __init__(self, samples_per_insert: Optional[float] = 1.0,
                 min_size_to_sample: int = 1,
                 error_buffer: Optional[float] = None,
                 table: str = "", shard: str = ""):
        """``samples_per_insert=None`` disables ratio enforcement entirely
        (pure buffer semantics — the legacy pull-cache contract); only
        ``min_size_to_sample`` still gates sampling. ``shard`` labels the
        block-time series so colocated shard-fleet members (chaos drills,
        --replay-shards smoke runs) don't collapse into one series."""
        assert samples_per_insert is None or samples_per_insert > 0.0
        assert min_size_to_sample >= 1
        self.spi = None if samples_per_insert is None else float(samples_per_insert)
        self.min_size = int(min_size_to_sample)
        floor = max(1.0, self.spi or 1.0)
        self.error_buffer = max(floor, float(error_buffer if error_buffer is not None else floor))
        self._cv = threading.Condition()
        self._inserts = 0
        self._samples = 0
        self._block_s = {"insert": 0.0, "sample": 0.0}
        reg = get_registry()
        extra = {"shard": shard} if shard else {}
        self._c_block = {
            side: reg.counter(
                "distar_replay_limiter_block_seconds_total",
                "cumulative wall-clock the rate limiter blocked each side",
                table=table, side=side, **extra,
            )
            for side in ("insert", "sample")
        }

    # ----------------------------------------------------------- predicates
    def can_insert(self, n: int = 1) -> bool:
        if self.spi is None or self._inserts + n <= self.min_size:
            return True
        adj = self._inserts + n - self.min_size
        return self.spi * adj <= self._samples + self.error_buffer

    def can_sample(self, n: int = 1) -> bool:
        if self._inserts < self.min_size:
            return False
        if self.spi is None:
            return True
        adj = self._inserts - self.min_size
        return self._samples + n <= self.spi * adj + self.error_buffer

    def max_sample_batch(self) -> float:
        """Largest batch a sampler can EVER be admitted with: inserters can
        run at most ``floor(eb / spi)`` adjusted inserts ahead of a drained
        sampler before the ratio blocks them, at which point
        ``can_sample(n)`` needs ``n <= spi * floor(eb / spi) + eb``. A batch
        above this bound deadlocks both sides — the sampler waits for
        inserts the limiter will never allow, the inserter waits for samples
        that can never be drawn — so callers reject it with a config error
        instead of timing out forever."""
        if self.spi is None:
            return float("inf")
        return self.spi * math.floor(self.error_buffer / self.spi + 1e-9) + self.error_buffer

    # -------------------------------------------------------------- waiting
    def await_cond(self, predicate: Callable[[], bool], timeout_s: Optional[float],
                   side: str) -> None:
        """Block until ``predicate()`` holds (evaluated under the limiter's
        condition lock, re-checked on every commit). Raises
        ``RateLimitTimeout`` — retryable — when ``timeout_s`` elapses."""
        t0 = time.monotonic()
        with self._cv:
            ok = self._cv.wait_for(predicate, timeout=timeout_s)
        waited = time.monotonic() - t0
        if waited > 0.0005:
            self._block_s[side] += waited
            self._c_block[side].inc(waited)
            # attribute the flow-control wait to the request being served
            # (the replay server installs its span as this handler thread's
            # active trace) — the waterfall's blocked_s segment
            annotate_active("blocked_s", waited)
        if not ok:
            raise RateLimitTimeout(side, timeout_s or 0.0, self.state())

    def commit_insert(self, n: int = 1) -> None:
        with self._cv:
            self._inserts += n
            self._cv.notify_all()

    def commit_sample(self, n: int = 1) -> None:
        with self._cv:
            self._samples += n
            self._cv.notify_all()

    def notify(self) -> None:
        """Wake waiters after a table mutation the commit paths didn't see
        (eviction freeing size, shutdown)."""
        with self._cv:
            self._cv.notify_all()

    def release_pacing(self) -> None:
        """Drain mode: stop enforcing the samples-per-insert ratio (and drop
        the min-size gate to 1) so the resident tail can drain out to
        samplers even though inserts have stopped — a paced drain would
        otherwise park the last learners forever against a counter that will
        never advance."""
        with self._cv:
            self.spi = None
            self.min_size = 1
            self._cv.notify_all()

    def state(self) -> dict:
        return {
            "inserts": self._inserts,
            "samples": self._samples,
            "samples_per_insert": self.spi,
            "min_size_to_sample": self.min_size,
            "error_buffer": self.error_buffer,
            "can_insert": self.can_insert(),
            "can_sample": self.can_sample(),
            "block_insert_s": round(self._block_s["insert"], 3),
            "block_sample_s": round(self._block_s["sample"], 3),
        }


@dataclass
class _Item:
    seq: int
    data: Any
    priority: float
    ts: float
    sample_count: int = 0
    spill_key: Optional[str] = None


@dataclass
class SampledItem:
    """One sampled trajectory plus the metadata the learner's staleness /
    reuse telemetry needs (travels as the ``info`` half of a sample reply)."""

    data: Any
    seq: int
    priority: float
    sample_count: int
    staleness_s: float

    def info(self) -> dict:
        return {
            "seq": self.seq,
            "priority": self.priority,
            "sample_count": self.sample_count,
            "staleness_s": round(self.staleness_s, 4),
        }


@dataclass
class TableConfig:
    """Declarative per-table settings (the server builds tables from this;
    one config per player token)."""

    max_size: int = 1024
    sampler: str = "prioritized"
    priority_exponent: float = 1.0
    #: None disables the samples-per-insert ratio (pure buffer semantics)
    samples_per_insert: Optional[float] = 1.0
    min_size_to_sample: int = 1
    error_buffer: Optional[float] = None
    max_staleness_s: Optional[float] = None
    seed: int = 0

    def __post_init__(self):
        assert self.sampler in SAMPLERS, f"sampler {self.sampler!r} not in {SAMPLERS}"
        assert self.max_size >= 1
        if self.sampler == "fifo" and (self.samples_per_insert or 0) > 1.0:
            # consume-once removes items on sample: each insert can yield at
            # most one sample, so a reuse ratio > 1 deadlocks by construction
            # (sampler starved of items, inserter blocked on the ratio)
            raise ValueError(
                "fifo (consume-once) cannot satisfy samples_per_insert > 1; "
                "use the uniform or prioritized sampler for trajectory reuse"
            )


class ReplayTable:
    def __init__(self, name: str, config: Optional[TableConfig] = None,
                 on_release: Optional[Callable[[_Item, str], None]] = None,
                 shard: str = ""):
        import random

        self.name = name
        self.shard = shard
        self.config = config or TableConfig()
        cfg = self.config
        self._rng = random.Random(cfg.seed)
        self._lock = threading.RLock()
        self._items: Dict[int, _Item] = {}  # insertion-ordered (dict semantics)
        self._tree = SumTree(cfg.max_size)
        self._next_seq = 0
        self._on_release = on_release
        self.limiter = RateLimiter(
            samples_per_insert=cfg.samples_per_insert,
            min_size_to_sample=cfg.min_size_to_sample,
            error_buffer=cfg.error_buffer,
            table=name, shard=shard,
        )
        reg = get_registry()
        # shard label only when set: a single-store deployment keeps the
        # exact series names every dashboard/rule already matches on, while
        # a fleet gets one series per (table, shard) — the per-shard axis
        # the default rulebook evaluates over
        extra = {"shard": shard} if shard else {}
        self._c_inserts = reg.counter(
            "distar_replay_inserts_total", "trajectories inserted",
            table=name, **extra)
        self._c_samples = reg.counter(
            "distar_replay_samples_total", "trajectory samples served",
            table=name, **extra)
        self._c_evict = {
            reason: reg.counter(
                "distar_replay_evictions_total", "items evicted by policy",
                table=name, reason=reason, **extra,
            )
            for reason in ("size", "staleness")
        }
        self._g_size = reg.gauge(
            "distar_replay_table_size", "items resident in the table",
            table=name, **extra)
        self._g_occ = reg.gauge(
            "distar_replay_table_occupancy", "resident share of max_size (0..1)",
            table=name, **extra)
        self._h_staleness = reg.histogram(
            "distar_replay_sampled_staleness_seconds",
            "age of items at sampling time", table=name, **extra)
        self._h_reuse = reg.histogram(
            "distar_replay_sampled_reuse",
            "per-item sample count at sampling time", table=name, **extra)

    # ------------------------------------------------------------- internals
    def _slot(self, seq: int) -> int:
        return seq % self.config.max_size

    def _publish_size(self) -> None:
        n = len(self._items)
        self._g_size.set(n)
        self._g_occ.set(n / self.config.max_size)

    def _release(self, item: _Item, reason: str) -> None:
        if self._on_release is not None:
            try:
                self._on_release(item, reason)
            except Exception:  # a broken spill hook must not kill the table
                pass

    def _evict_oldest(self, reason: str) -> None:
        """Caller holds the lock."""
        seq, item = next(iter(self._items.items()))
        del self._items[seq]
        self._tree.set(self._slot(seq), 0.0)
        self._c_evict[reason].inc()
        self._release(item, reason)

    def _sweep_staleness(self, now: float) -> None:
        """Caller holds the lock; items are insertion-ordered so the sweep
        stops at the first young-enough item."""
        bound = self.config.max_staleness_s
        if bound is None:
            return
        while self._items:
            item = next(iter(self._items.values()))
            if now - item.ts <= bound:
                break
            self._evict_oldest("staleness")

    def _tree_value(self, priority: float) -> float:
        if self.config.sampler == "uniform":
            return 1.0
        return max(priority, 1e-9) ** self.config.priority_exponent

    # ------------------------------------------------------------------- api
    def insert(self, data: Any, priority: float = 1.0,
               timeout_s: Optional[float] = 60.0, spill_key: Optional[str] = None,
               restore: bool = False) -> int:
        """Insert one trajectory; blocks under the rate limiter, returns the
        item's table-unique ``seq``. ``restore=True`` is the spill-recovery
        path: it skips the limiter *wait* (recovery must never deadlock on a
        learner that isn't back yet) but still commits the insert count so
        post-restart pacing stays correct."""
        if not restore:
            self.limiter.await_cond(self.limiter.can_insert, timeout_s, "insert")
        with self._lock:
            self._sweep_staleness(time.time())
            if len(self._items) >= self.config.max_size:
                self._evict_oldest("size")
            seq = self._next_seq
            self._next_seq += 1
            item = _Item(seq=seq, data=data, priority=float(priority),
                         ts=time.time(), spill_key=spill_key)
            self._items[seq] = item
            self._tree.set(self._slot(seq), self._tree_value(item.priority))
            self._publish_size()
        self._c_inserts.inc()
        self.limiter.commit_insert()
        return seq

    def _available(self, n: int) -> bool:
        if self.config.sampler == "fifo":
            return len(self._items) >= n  # without replacement
        return len(self._items) >= 1  # with replacement: one item suffices

    def sample(self, batch_size: int = 1,
               timeout_s: Optional[float] = 60.0) -> List[SampledItem]:
        """Draw ``batch_size`` items; blocks under the rate limiter and on
        availability. Prioritized/uniform draw with replacement; fifo pops
        oldest-first (consume-once)."""
        assert batch_size >= 1
        limit = self.limiter.max_sample_batch()
        if batch_size > limit:
            raise InvalidBatchError(
                f"batch_size={batch_size} can never be admitted by table "
                f"{self.name!r}: samples_per_insert={self.limiter.spi:g} with "
                f"error_buffer={self.limiter.error_buffer:g} caps admissible "
                f"batches at {limit:g}; raise error_buffer to at least "
                f"max(1, samples_per_insert) * batch_size or shrink the batch"
            )
        self.limiter.await_cond(
            lambda: self.limiter.can_sample(batch_size) and self._available(batch_size),
            timeout_s, "sample",
        )
        now = time.time()
        out: List[SampledItem] = []
        with self._lock:
            self._sweep_staleness(now)
            if not self._available(batch_size):
                # a staleness sweep emptied the window between wait and lock:
                # surface as the same retryable pacing error
                raise RateLimitTimeout("sample", timeout_s or 0.0, self.limiter.state())
            if self.config.sampler == "fifo":
                for _ in range(batch_size):
                    seq, item = next(iter(self._items.items()))
                    del self._items[seq]
                    self._tree.set(self._slot(seq), 0.0)
                    item.sample_count += 1
                    out.append(SampledItem(item.data, seq, item.priority,
                                           item.sample_count, now - item.ts))
                    self._release(item, "consumed")
            else:
                seqs = list(self._items)
                for _ in range(batch_size):
                    total = self._tree.total
                    if total > 0.0:
                        slot = self._tree.find(self._rng.random() * total)
                        # map the slot back to the live seq occupying it
                        item = self._items.get(self._seq_for_slot(slot))
                    else:
                        item = None
                    if item is None:  # numeric edge: fall back to uniform
                        item = self._items[self._rng.choice(seqs)]
                    first_sample = item.sample_count == 0
                    item.sample_count += 1
                    out.append(SampledItem(item.data, item.seq, item.priority,
                                           item.sample_count, now - item.ts))
                    if first_sample:
                        self._release(item, "sampled")
            self._publish_size()
        for s in out:
            self._h_staleness.observe(s.staleness_s)
            self._h_reuse.observe(s.sample_count)
        self._c_samples.inc(len(out))
        self.limiter.commit_sample(len(out))
        return out

    def _seq_for_slot(self, slot: int) -> int:
        """Live seq occupying ``slot`` (ring layout: at most one candidate)."""
        base = self._next_seq - 1
        # candidates: the most recent seq congruent to slot mod max_size
        cand = base - ((base - slot) % self.config.max_size)
        return cand

    def update_priorities(self, updates: Dict[int, float]) -> int:
        """Re-prioritize live items (PER's learner-side TD-error refresh);
        unknown seqs are ignored. Returns how many were applied."""
        applied = 0
        with self._lock:
            for seq, priority in updates.items():
                item = self._items.get(int(seq))
                if item is None:
                    continue
                item.priority = float(priority)
                self._tree.set(self._slot(item.seq), self._tree_value(item.priority))
                applied += 1
        return applied

    def size(self) -> int:
        with self._lock:
            return len(self._items)

    def stats(self) -> dict:
        with self._lock:
            n = len(self._items)
            now = time.time()
            oldest = min((now - i.ts for i in self._items.values()), default=0.0)
            newest = max((now - i.ts for i in self._items.values()), default=0.0)
        return {
            "name": self.name,
            **({"shard": self.shard} if self.shard else {}),
            "size": n,
            "max_size": self.config.max_size,
            "occupancy": round(n / self.config.max_size, 4),
            "sampler": self.config.sampler,
            "oldest_item_s": round(newest, 3),
            "newest_item_s": round(oldest, 3),
            "limiter": self.limiter.state(),
        }


class ReplayStore:
    """Named-table container + the spill hookup (durability for acked
    inserts). ``table_factory`` auto-creates tables on first reference —
    per-player tables appear as the league mints players, no pre-declaration
    step."""

    #: bound on remembered insert idempotency keys (an LRU of the newest
    #: ones; far larger than any retry window's in-flight count)
    IDEM_CACHE = 8192

    def __init__(self, table_factory: Optional[Callable[[str], TableConfig]] = None,
                 spill: Optional[object] = None, shard_id: str = "",
                 recover_encoded: bool = False):
        self._factory = table_factory
        self._spill = spill
        self.shard_id = shard_id
        #: recover spilled items as pre-encoded ``Opaque`` payloads — skips
        #: the unpickle on recovery AND the recompress on every wire
        #: re-serve (the serving roles turn this on; default off so direct
        #: in-process consumers keep seeing plain objects)
        self._recover_encoded = recover_encoded
        self._tables: Dict[str, ReplayTable] = {}
        self._idem: Dict[str, int] = {}  # idem key -> acked seq (insertion-ordered)
        self._draining = False
        self._lock = threading.Lock()
        self._c_dedup = get_registry().counter(
            "distar_replay_insert_dedup_total",
            "retried inserts answered from the idempotency cache "
            "(ack lost after commit — without this they double-apply)",
            **({"shard": shard_id} if shard_id else {}),
        )

    # --------------------------------------------------------------- tables
    def create_table(self, name: str, config: Optional[TableConfig] = None) -> ReplayTable:
        with self._lock:
            if name in self._tables:
                return self._tables[name]
            table = ReplayTable(name, config=config, on_release=self._make_release(),
                                shard=self.shard_id)
            self._tables[name] = table
            return table

    def _make_release(self):
        spill = self._spill

        def release(item: _Item, reason: str) -> None:
            if spill is not None and item.spill_key is not None:
                spill.release(item.spill_key)

        return release

    def table(self, name: str) -> ReplayTable:
        with self._lock:
            table = self._tables.get(name)
        if table is not None:
            return table
        if self._factory is None:
            raise UnknownTableError(f"no table {name!r} (and no factory configured)")
        return self.create_table(name, self._factory(name))

    def tables(self) -> List[str]:
        with self._lock:
            return sorted(self._tables)

    # ------------------------------------------------------------------ ops
    def insert(self, table: str, item: Any, priority: float = 1.0,
               timeout_s: Optional[float] = 60.0,
               idem: Optional[str] = None) -> int:
        """Durable acked insert: the item lands on disk — fsync'd, CRC'd —
        and THEN in the table, before the seq is returned. The spill write
        must come first: the moment ``tbl.insert`` makes the item live, a
        concurrent sampler or size eviction can fire ``on_release`` ->
        ``spill.release(key)``, which must find the blob or it leaks as an
        orphan (recovered as a duplicate forever, eating the ring bound).
        A blob whose table insert then fails (rate-limit timeout) is
        released here — the caller was never acked. A crash between append
        and insert leaves an unacked blob that recovery re-inserts; the
        producer's retry makes that the documented at-least-once duplicate,
        never a loss.

        ``idem`` makes a client retry safe against the *ambiguous* failure
        (server committed, ack lost on the wire): a repeated key within the
        bounded cache window answers the original seq without re-applying —
        no duplicate item, no duplicate spill blob, no double limiter
        commit. The cache is process-lifetime only; a retry that crosses a
        store restart still lands as the documented at-least-once
        duplicate."""
        if self._draining:
            # graceful retirement: a retry of an ALREADY-acked insert is
            # still answered from the idem cache (the ack must hold across
            # the drain edge), but genuinely new work is refused typed so
            # routing moves it to a surviving shard
            if idem is not None:
                with self._lock:
                    cached = self._idem.get(idem)
                if cached is not None:
                    self._c_dedup.inc()
                    return cached
            raise StoreDrainingError(
                "store is draining; new inserts are refused (route to a "
                "surviving shard)")
        if idem is not None:
            with self._lock:
                cached = self._idem.get(idem)
            if cached is not None:
                self._c_dedup.inc()
                return cached
        tbl = self.table(table)
        spill_key = None
        if self._spill is not None:
            spill_key = self._spill.reserve_key(table)
            self._spill.append(spill_key, table, item, priority)
        try:
            seq = tbl.insert(item, priority=priority, timeout_s=timeout_s,
                             spill_key=spill_key)
        except Exception:
            if spill_key is not None:
                self._spill.release(spill_key)
            raise
        if idem is not None:
            with self._lock:
                self._idem[idem] = seq
                while len(self._idem) > self.IDEM_CACHE:
                    self._idem.pop(next(iter(self._idem)))
        return seq

    def sample(self, table: str, batch_size: int = 1,
               timeout_s: Optional[float] = 60.0) -> List[SampledItem]:
        return self.table(table).sample(batch_size=batch_size, timeout_s=timeout_s)

    def update_priorities(self, table: str, updates: Dict[int, float]) -> int:
        return self.table(table).update_priorities(updates)

    def recover(self) -> int:
        """Re-insert every spilled (acked-but-unsampled) trajectory; the
        crash-restart half of the durability contract. Returns the count."""
        if self._spill is None:
            return 0
        n = 0
        for rec in self._spill.recover(keep_encoded=self._recover_encoded):
            tbl = self.table(rec["table"])
            tbl.insert(rec["item"], priority=rec["priority"],
                       spill_key=rec["key"], restore=True)
            n += 1
        return n

    # ---------------------------------------------------------------- drain
    def begin_drain(self) -> dict:
        """Enter graceful retirement: refuse NEW inserts with the typed
        ``draining`` wire error (idem-cached retries of already-acked
        inserts still answer their seq) while samples keep being served, so
        the resident tail drains out to the learner fan-in instead of being
        shed wholesale. Idempotent; the serving process exits once
        ``resident_items()`` reaches zero (or its drain timeout lapses) and
        the spill has flushed."""
        if not self._draining:
            self._draining = True
            for name in self.tables():
                self.table(name).limiter.release_pacing()
            get_registry().counter(
                "distar_replay_drains_total",
                "graceful drains started on this store",
                **({"shard": self.shard_id} if self.shard_id else {}),
            ).inc()
        return {"draining": True, "resident": self.resident_items()}

    @property
    def draining(self) -> bool:
        return self._draining

    def resident_items(self) -> int:
        """Items still resident across every table — what a drain waits on."""
        return sum(self.table(name).stats().get("size", 0)
                   for name in self.tables())

    def stats(self) -> dict:
        out = {"tables": {name: self.table(name).stats() for name in self.tables()}}
        out["draining"] = self._draining
        if self.shard_id:
            out["shard"] = self.shard_id
        if self._spill is not None:
            out["spill"] = self._spill.stats()
        return out

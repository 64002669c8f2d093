"""Sharded replay fleet: consistent-hash routing + learner-side fan-in.

Counterpart of ``distar_tpu.replay.sharding``: ``stable_hash`` and
``HashRing`` (which the serving fleet's router also pins sessions with),
``ShardMap``, the sharded insert and sample clients and ``register_shard``.
A store tops out at a few thousand inserts and samples a second over
loopback; this module scales the data plane horizontally the
MindSpeed-RL distributed-dataflow way: N independent stores (each with its
own tables, rate limiter and spill), with ALL routing decided client-side
so the fleet needs no proxy tier.

Routing (``HashRing``): classic consistent hashing over ``vnode`` virtual
points per shard, keyed by a *stable* digest (md5 — NEVER ``hash()``, which
is salted per process). The shard identity is its ``host:port`` address, so
a restarted shard keeps its ring segment, and growing the fleet N -> N+1
remaps only ~1/(N+1) of the key space. Every insert routes by
``(table, trajectory key)``; a directed read/update for the same key lands
on the same shard by construction.

Fan-in (``ShardedSampleClient``): the learner samples whole batches from
one shard at a time, rotating round-robin (or weighted by resident items).
The samples-per-insert invariant is enforced *per shard* — each store's own
``RateLimiter`` paces the batches it serves against the inserts it
received — so a stalled/dead/rate-limited shard blocks only itself: the
rotation skips it (counted) and keeps the learner fed from the rest of the
fleet within the caller's timeout.

Discovery (``ShardMap``): a static comma-separated address list, or the
coordinator's register/lease path — shard processes register under the
``replay_shard`` token and the map is read back (non-destructively) via
the ``peers`` route, so lease-evicted stores drop out of new maps.
"""
from __future__ import annotations

import bisect
import hashlib
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..obs import get_registry
from ..resilience import CircuitOpenError, RetryableError, RetryPolicy
from .client import InsertClient, SampleClient
from .errors import (
    InvalidBatchError,
    RateLimitTimeout,
    ReplayError,
    StoreDrainingError,
    UnknownTableError,
)

#: coordinator token replay shards register under (bin/rl_train --type replay)
SHARD_TOKEN = "replay_shard"


def stable_hash(key: str) -> int:
    """64-bit digest that is identical across processes, machines and runs
    (the md5 prefix)."""
    return int.from_bytes(hashlib.md5(key.encode("utf-8")).digest()[:8], "big")


class HashRing:
    """Consistent-hash ring over named nodes with virtual points."""

    def __init__(self, nodes: Sequence[str], vnodes: int = 128):
        if not nodes:
            raise ValueError("hash ring needs at least one node")
        self.nodes = list(dict.fromkeys(nodes))  # order-preserving dedupe
        self.vnodes = int(vnodes)
        points: List[Tuple[int, str]] = [
            (stable_hash(f"{node}#{v}"), node) for node in self.nodes for v in range(self.vnodes)
        ]
        points.sort()
        self._hashes = [h for h, _ in points]
        self._owners = [n for _, n in points]

    def lookup(self, key: str) -> str:
        """The owning node of ``key``: the first ring point clockwise of the
        key's hash (wrapping past the top)."""
        i = bisect.bisect_right(self._hashes, stable_hash(key))
        if i == len(self._hashes):
            i = 0
        return self._owners[i]


class ShardMap:
    """Ordered shard address list + the ring built over it.

    The canonical key for routing is ``"<table>/<key>"`` so per-player
    tables spread independently (two players' trajectory #7 need not share
    a shard). Addresses are the shard identities: stable across restarts,
    so recovery lands recovered items exactly where routing looks for them.
    """

    def __init__(self, addrs: Sequence[str], vnodes: int = 128):
        self.addrs = list(dict.fromkeys(a.strip() for a in addrs if a.strip()))
        if not self.addrs:
            raise ValueError("shard map needs at least one 'host:port' address")
        self._ring = HashRing(self.addrs, vnodes=vnodes)

    def __len__(self) -> int:
        return len(self.addrs)

    def shard_for(self, table: str, key: str) -> str:
        """Deterministic owner address for an item key within a table."""
        return self._ring.lookup(f"{table}/{key}")

    @classmethod
    def parse(cls, spec: str, vnodes: int = 128) -> "ShardMap":
        """``"h1:p1,h2:p2,..."`` -> map (a single address is a 1-shard map)."""
        return cls(str(spec).split(","), vnodes=vnodes)

    @classmethod
    def discover(cls, coordinator_addr: Tuple[str, int], token: str = SHARD_TOKEN,
                 vnodes: int = 128) -> "ShardMap":
        """Read the live shard fleet from the coordinator's non-destructive
        ``peers`` route (lease-expired shards have already been evicted).
        Raises ``ValueError`` when no shard has registered yet."""
        from ..comm.discovery import discover_endpoints

        records = discover_endpoints(coordinator_addr, token)
        addrs = sorted({f"{r['ip']}:{r['port']}" for r in records})
        if not addrs:
            host, port = coordinator_addr
            raise ValueError(
                f"no {token!r} registrations at coordinator {host}:{port} "
                "(are the replay shards up, and started with --coordinator-addr?)"
            )
        return cls(addrs, vnodes=vnodes)


def _split_addr(addr: str) -> Tuple[str, int]:
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)


class _ShardedBase:
    """Shared plumbing: one lazily-dialed client per shard, each with its
    own retry policy + circuit breaker (per shard — one
    wedged store must not open the breaker for the healthy rest)."""

    _client_cls: Callable = None  # type: ignore[assignment]

    def __init__(self, shard_map: ShardMap, retry_policy: Optional[RetryPolicy] = None,
                 compress: bool = True, timeout_s: float = 60.0,
                 codec: str = "lz4", transport: str = "auto"):
        self.shard_map = shard_map
        self._retry_policy = retry_policy
        self._compress = compress
        self._codec = codec
        self._transport = transport
        self._timeout_s = timeout_s
        self._clients: Dict[str, object] = {}
        self._lock = threading.Lock()
        #: shards observed mid-drain (typed ``draining`` answers): routed
        #: around until a membership refresh drops them from the map
        self._draining: set = set()
        self._refresher = None

    # -------------------------------------------------------- live membership
    def set_shard_map(self, shard_map: ShardMap) -> None:
        """Install a freshly discovered map (live membership: joins appear,
        drained/lease-evicted shards disappear — the ≤1/(N+1) consistent-
        hash remap bounds how many keys move). Clients held against
        departed shards are closed; drain marks for addresses no longer in
        the map are pruned."""
        with self._lock:
            self.shard_map = shard_map
            self._draining &= set(shard_map.addrs)
            dead = [a for a in self._clients if a not in shard_map.addrs]
            closed = [self._clients.pop(a) for a in dead]
        for c in closed:
            try:
                c.close()
            except Exception:  # noqa: BLE001 - teardown best-effort
                pass

    def start_refresh(self, coordinator_addr: Tuple[str, int],
                      interval_s: float = 10.0,
                      token: str = SHARD_TOKEN) -> None:
        """Periodically re-discover the shard fleet from the coordinator
        (the shared ``comm.discovery`` refresh idiom) so this long-lived
        client sees scale-ups and drains without a restart. Empty reads are
        ignored (a restarting broker must not wipe a working map)."""
        from ..comm.discovery import start_refresh

        def apply(records):
            addrs = sorted({f"{r['ip']}:{r['port']}" for r in records})
            if addrs and addrs != self.shard_map.addrs:
                self.set_shard_map(ShardMap(addrs))

        if self._refresher is None:
            self._refresher = start_refresh(coordinator_addr, token, apply,
                                            interval_s=interval_s)

    def note_draining(self, addr: str) -> None:
        """Route around ``addr`` until the membership refresh retires it."""
        with self._lock:
            self._draining.add(addr)
        get_registry().counter(
            "distar_replay_drains_observed_total",
            "typed draining answers that moved routing off a retiring shard",
            shard=addr,
        ).inc()

    def client_for(self, addr: str):
        with self._lock:
            client = self._clients.get(addr)
            if client is None:
                host, port = _split_addr(addr)
                client = type(self)._client_cls(
                    host, port, timeout_s=self._timeout_s,
                    retry_policy=self._retry_policy, compress=self._compress,
                    codec=self._codec, transport=self._transport,
                )
                self._clients[addr] = client
            return client

    def transports(self) -> Dict[str, str]:
        """Active transport per dialed shard connection (shm for colocated
        shards, tcp for cross-host ones — mixed fleets are expected)."""
        with self._lock:
            return {addr: c.transport_active
                    for addr, c in self._clients.items()}

    def ping(self) -> bool:
        return all(self.client_for(a).ping() for a in self.shard_map.addrs)

    def tables(self) -> List[str]:
        names = set()
        for addr in self.shard_map.addrs:
            try:
                names.update(self.client_for(addr).tables())
            # analysis: allow(retryable-swallowed) — fan-in isolation contract (docs/data_plane.md): a dead shard hides its tables, not the fleet's; per-shard failures surface via breaker/fanin-skip counters on the data path
            except (ReplayError, ConnectionError, OSError, CircuitOpenError):
                continue
        return sorted(names)

    def fleet_stats(self) -> Dict[str, dict]:
        """Per-shard ``/replay/stats`` payloads keyed by shard address;
        unreachable shards report ``{"error": ...}`` instead of hiding."""
        out: Dict[str, dict] = {}
        for addr in self.shard_map.addrs:
            try:
                out[addr] = self.client_for(addr).stats()
            except Exception as e:  # noqa: BLE001 - digest must never raise
                out[addr] = {"error": repr(e)}
        return out

    def stats(self) -> dict:
        return {"shards": self.fleet_stats()}

    def close(self) -> None:
        if self._refresher is not None:
            self._refresher.stop_event.set()
            self._refresher = None
        with self._lock:
            clients, self._clients = list(self._clients.values()), {}
        for c in clients:
            c.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class ShardedInsertClient(_ShardedBase):
    """Actor-side writer over the fleet: every trajectory routes to the
    shard owning ``(table, key)`` on the ring. Keys default to a
    process-unique monotonic sequence so concurrent actors spread load
    without coordination; pass an explicit ``key`` to pin related items
    (e.g. one episode) to one shard."""

    _client_cls = InsertClient

    def __init__(self, shard_map: ShardMap, **kwargs):
        super().__init__(shard_map, **kwargs)
        self._seq = 0
        self._seq_lock = threading.Lock()
        self._key_base = f"{os.getpid():x}-{stable_hash(str(time.time())) & 0xFFFF:04x}"
        # counters are minted lazily: live membership means shards can join
        # after construction
        self._c_routed: Dict[str, object] = {}
        self._overlay_rings: Dict[tuple, HashRing] = {}

    def _routed_counter(self, addr: str):
        c = self._c_routed.get(addr)
        if c is None:
            c = self._c_routed[addr] = get_registry().counter(
                "distar_replay_shard_inserts_total",
                "inserts routed to each shard by the consistent-hash ring",
                shard=addr,
            )
        return c

    def next_key(self) -> str:
        with self._seq_lock:
            self._seq += 1
            return f"{self._key_base}-{self._seq}"

    def shard_for(self, table: str, key: str) -> str:
        """Owner for ``(table, key)`` under the CURRENT map, routed around
        shards observed mid-drain (a drained shard deregisters, so the next
        membership refresh makes the overlay permanent)."""
        m = self.shard_map
        with self._lock:
            draining = self._draining & set(m.addrs)
        if not draining or len(draining) >= len(m.addrs):
            return m.shard_for(table, key)
        cache_key = (tuple(m.addrs), frozenset(draining))
        ring = self._overlay_rings.get(cache_key)
        if ring is None:
            self._overlay_rings.clear()  # one live overlay at a time
            ring = self._overlay_rings[cache_key] = HashRing(
                [a for a in m.addrs if a not in draining])
        return ring.lookup(f"{table}/{key}")

    def insert(self, table: str, item, priority: float = 1.0,
               timeout_s: Optional[float] = None, key: Optional[str] = None) -> int:
        key = key if key is not None else self.next_key()
        # a shard answering the typed ``draining`` error is retiring: mark
        # it, re-route this key on the overlay ring (every future key skips
        # it too) and send again — at most once per fleet member
        for _ in range(max(len(self.shard_map), 1)):
            addr = self.shard_for(table, key)
            try:
                seq = self.client_for(addr).insert(
                    table, item, priority=priority, timeout_s=timeout_s)
            except StoreDrainingError:
                self.note_draining(addr)
                continue
            self._routed_counter(addr).inc()
            return seq
        raise StoreDrainingError(
            f"every shard in the {len(self.shard_map)}-member fleet is draining")


class ShardedSampleClient(_ShardedBase):
    """Learner-side fan-in: one whole batch per call from one shard,
    rotating round-robin (default) or weighted by resident items. A shard
    that is rate-limited, dead, or breaker-open is skipped — it blocks
    only itself — and the rotation keeps offering the rest of the fleet
    until the caller's ``timeout_s`` lapses. Per-shard spi holds because
    each store's own limiter admits (or blocks) the batches it serves."""

    _client_cls = SampleClient

    #: loaders key on this to hand per-item shard info back for routing
    sharded = True

    def __init__(self, shard_map: ShardMap, mode: str = "round_robin",
                 retry_policy: Optional[RetryPolicy] = None, **kwargs):
        assert mode in ("round_robin", "weighted"), mode
        # the inner client must fail FAST: rotation is the retry. The outer
        # loop re-offers a shard on later passes, which also redials through
        # a store restart within the caller's deadline.
        retry_policy = retry_policy or RetryPolicy(
            max_attempts=2, backoff_base_s=0.05, backoff_max_s=0.2, deadline_s=5.0)
        super().__init__(shard_map, retry_policy=retry_policy, **kwargs)
        self.mode = mode
        self._rr = 0
        self._weights: Dict[str, float] = {}
        self._weights_ts = 0.0
        # minted lazily: live membership means shards can join mid-run
        self._c_samples: Dict[str, object] = {}
        self._c_skips: Dict[str, object] = {}

    def _sample_counter(self, addr: str):
        c = self._c_samples.get(addr)
        if c is None:
            c = self._c_samples[addr] = get_registry().counter(
                "distar_replay_fanin_samples_total",
                "items served to the fan-in sampler, per shard", shard=addr)
        return c

    def _skip_counter(self, addr: str):
        c = self._c_skips.get(addr)
        if c is None:
            c = self._c_skips[addr] = get_registry().counter(
                "distar_replay_fanin_skips_total",
                "fan-in rotations that skipped a shard (pacing/fault/breaker)",
                shard=addr)
        return c

    # ----------------------------------------------------------- shard order
    def _refresh_weights(self, max_age_s: float = 5.0) -> None:
        now = time.monotonic()
        if now - self._weights_ts < max_age_s:
            return
        self._weights_ts = now
        for addr, st in self.fleet_stats().items():
            tables = st.get("tables") if isinstance(st, dict) else None
            self._weights[addr] = float(sum(
                t.get("size", 0) for t in (tables or {}).values())) if tables else 0.0

    def _order(self) -> List[str]:
        addrs = self.shard_map.addrs
        if self.mode == "weighted" and len(addrs) > 1:
            self._refresh_weights()
            start = self._rr
            self._rr += 1
            # fullest shards first; the rotating tiebreak keeps equal-weight
            # fleets fair instead of hammering the lexicographic winner
            return sorted(
                addrs,
                key=lambda a: (-self._weights.get(a, 0.0),
                               (addrs.index(a) - start) % len(addrs)),
            )
        start = self._rr
        self._rr += 1
        return [addrs[(start + i) % len(addrs)] for i in range(len(addrs))]

    # -------------------------------------------------------------------- api
    def sample(self, table: str, batch_size: int = 1,
               timeout_s: Optional[float] = None):
        deadline = time.monotonic() + (timeout_s if timeout_s is not None else 60.0)
        # short per-shard offers so one blocked store can't eat the budget;
        # a single-shard map degenerates to polling that store
        attempt_s = max(0.2, min(2.0, (timeout_s or 60.0) / (2 * len(self.shard_map))))
        unknown_tables = 0
        last_state: dict = {}
        while True:
            unknown_tables = 0
            for addr in self._order():
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise RateLimitTimeout("sample", timeout_s or 0.0, last_state)
                try:
                    items, info = self.client_for(addr).sample(
                        table, batch_size=batch_size,
                        timeout_s=min(attempt_s, remaining),
                    )
                except InvalidBatchError:
                    raise  # config error: waiting/rotating cannot fix it
                except RateLimitTimeout as e:
                    last_state = {"shard": addr, **(e.state or {})}
                    self._skip_counter(addr).inc()
                    continue
                except UnknownTableError:
                    unknown_tables += 1
                    self._skip_counter(addr).inc()
                    continue
                except (ReplayError, CircuitOpenError, RetryableError,
                        ConnectionError, OSError):
                    self._skip_counter(addr).inc()
                    continue
                for d in info:
                    d["shard"] = addr
                self._sample_counter(addr).inc(len(items))
                return items, info
            if unknown_tables == len(self.shard_map):
                raise UnknownTableError(
                    f"no shard in the fleet holds table {table!r}")
            if time.monotonic() >= deadline:
                raise RateLimitTimeout("sample", timeout_s or 0.0, last_state)

    def update_priorities(self, table: str, updates: Dict[int, float],
                          info: Optional[List[dict]] = None) -> int:
        """PER refresh across the fleet. With ``info`` (the sample-info dicts
        whose ``seq``/``shard`` pairs produced these updates) each update is
        routed to exactly its shard; without, the updates broadcast (unknown
        seqs are ignored server-side, so broadcast is correct but wasteful —
        and wrong only if two shards reuse a seq, which per-shard counters
        make likely: always pass info when you have it)."""
        by_shard: Dict[str, Dict[int, float]] = {}
        if info:
            shard_of = {int(d["seq"]): d.get("shard") for d in info if "seq" in d}
            for seq, pr in updates.items():
                addr = shard_of.get(int(seq))
                for target in ([addr] if addr else self.shard_map.addrs):
                    by_shard.setdefault(target, {})[int(seq)] = float(pr)
        else:
            for addr in self.shard_map.addrs:
                by_shard[addr] = {int(s): float(p) for s, p in updates.items()}
        applied = 0
        for addr, batch in by_shard.items():
            try:
                applied += self.client_for(addr).update_priorities(table, batch)
            # analysis: allow(retryable-swallowed) — priority updates are best-effort PER (docs/data_plane.md): a dead shard's items are gone anyway, and the applied count the caller gets back reflects the skip
            except (ReplayError, ConnectionError, OSError, CircuitOpenError):
                continue
        return applied


def register_shard(coordinator_addr: Tuple[str, int], host: str, port: int,
                   meta: Optional[dict] = None, lease_s: Optional[float] = None,
                   heartbeat_interval_s: Optional[float] = None,
                   stop_event: Optional[threading.Event] = None) -> threading.Thread:
    """Register one shard under ``SHARD_TOKEN`` and keep its lease alive
    from a daemon thread (re-registering when the broker says it lost us —
    the heartbeat contract). Returns the started thread."""
    from ..comm.discovery import register_endpoint

    return register_endpoint(
        coordinator_addr, SHARD_TOKEN, host, port, meta=meta, lease_s=lease_s,
        heartbeat_interval_s=heartbeat_interval_s, stop_event=stop_event,
    )

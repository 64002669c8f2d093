"""Coordinator high availability: write-ahead journal, warm standby, fencing.

Counterpart of ``distar_tpu.comm.ha``. The coordinator holds leases,
job-queue records, the arena ledger and the league's matchmaking state in
plain memory; this module makes the broker crash-safe and able to fail
over, so workers ride through the loss of the control plane without losing
accounting.

Three legs, one contract:

* **Write-ahead journal** (:class:`Journal`): every mutating coordinator
  route is appended as a CRC-framed record (``u32 len | u32 crc32 |
  pickle`` frames; snapshots through ``utils.storage``'s atomic
  tmp+fsync+rename) *before* the reply is sent; durable routes fsync first,
  heartbeat records are only flushed (losing one costs a re-register, never
  accounting). Periodic snapshots bound replay; a restarted coordinator
  reconstructs registrations (leases re-aged from record timestamps),
  queue contents, strikes, the ``ArenaStore`` and the ``LeagueService``
  exactly. The format is the JAX package's: the port reads a journal
  directory the JAX package wrote (records and snapshots hold plain types,
  but a snapshot's league and arena objects name ``distar_tpu`` classes,
  read as the port's through ``utils.pickles``); a snapshot the port writes
  names the port's classes, which the JAX package cannot read (ROADMAP
  Queue 3).

* **Warm standby** (:class:`HAState` in the ``standby`` role): a second
  coordinator process tails the primary's journal over a framed-TCP
  follower stream (``comm.serializer`` frames), applies each record to its
  own replica and its own journal, and acks the sequence number back; the
  primary's durable-route dispatch waits for that ack (semi-synchronous
  replication), so an acknowledged item is on the standby before the client
  sees the ack. Leadership is lease-based: the stream carries heartbeats,
  and ``takeover_grace_s`` without contact promotes the standby.

* **Epoch fencing**: one epoch counter, bumped on every leadership
  acquisition and journaled as a ``__lead__`` record, is stamped on every
  reply. Clients remember the highest epoch they have seen and discard
  lower-epoch answers typed (:class:`StaleEpochError`), so a deposed
  primary cannot split the fleet's view. A revived old primary probes its
  peers at boot, finds the higher epoch, and rejoins as a follower.

The client side lives in ``comm.coordinator.coordinator_request``: a comma
list of coordinator addresses, ``not_leader`` redirects and stale-epoch
rejection all ride the retry policy. After an ambiguous ack (the primary
died between send and reply) only **idempotent** routes are retried;
``ask`` and ``league_ask`` (draws) raise :class:`AmbiguousAckError`
instead of applying twice.

Route classification is the contract ``tools/lint_ha_routes.py`` checks:
every route of ``CoordinatorServer``'s ``routes`` is in
``JOURNALED_ROUTES`` or in the shrink-only ``EPHEMERAL_ROUTES`` allowlist.
"""
from __future__ import annotations

import glob
import os
import pickle
import queue
import socket
import struct
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..resilience import FatalError, RetryableError
from ..utils import pickles

# --------------------------------------------------------------------- routes
#: mutating routes that are journaled on the primary, replayed on restart
#: and streamed to standbys. "push" = register, "pull" = ask in this broker.
JOURNALED_ROUTES = frozenset({
    "register",      # producer "payload ready" records + discovery + canary
    "unregister",    # graceful drain departures
    "strike",        # dead-producer accounting (5 strikes purge)
    "heartbeat",     # lease refreshes (flush-only: loss => one re-register)
    "ask",           # queue POP — consuming a record must survive a restart
    "arena_report",  # arena ledger mutations (idempotent keys dedup replays)
    # league matchmaker (league/runtime/service.py): every mutating route
    # is a pure function of (state, seeded RNG, body, record ts), so the
    # replica replays to the exact roster/assignment/lineage/RNG cursor
    "league_register",    # learner roster + lease refresh (idempotent)
    "league_ask",         # matchmaking draw — advances RNG + assignment map
    "league_report",      # job completion + arena forward (key-dedup'd)
    "league_train_info",  # step accounting + snapshot minting (seq watermark)
})

#: explicitly-ephemeral allowlist (SHRINK-ONLY — lint_ha_routes.py): routes
#: that are read-only or whose state is lossy by design. Every entry needs a
#: reason; removing one is always safe, adding one is a reviewed decision.
EPHEMERAL_ROUTES = frozenset({
    "peers",       # read-only discovery listing
    "stats",       # read-only accounting
    "depth",       # read-only accounting
    "telemetry",   # TSDB ingest is best-effort by contract: shippers re-ship
                   # full snapshots every interval (and resync on failover)
    "arena_next",  # pure function of *reported* arena state — no state here
    "league_status",  # read-only matchmaking digest (explicitly non-mutating:
                      # even assignment expiry is deferred to journaled routes)
})

#: journaled routes whose ack additionally requires fsync + standby
#: replication (when a follower is attached) before the reply goes out
DURABLE_ROUTES = frozenset({
    "register", "unregister", "strike", "ask", "arena_report",
    # league mutations are all accounting: losing an acked one would orphan
    # an assignment, double-mint a snapshot or fork the RNG cursor
    "league_register", "league_ask", "league_report", "league_train_info",
})

#: routes safe to retry across a failover after an AMBIGUOUS ack (the reply
#: was lost; the primary may or may not have applied the request). register/
#: heartbeat/unregister/strike are naturally idempotent; arena_report dedups
#: on idempotent match keys. ``ask`` is a pop — retrying a possibly-applied
#: pop would consume a second record, so it is deliberately absent.
IDEMPOTENT_ROUTES = frozenset({
    "register", "unregister", "strike", "heartbeat", "arena_report",
    "peers", "stats", "depth", "telemetry", "arena_next",
    # league_register dedups on learner_id, league_report on match keys +
    # assignment pop, league_train_info on its per-player seq watermark.
    # ``league_ask`` is deliberately absent: like ``ask`` it is a draw —
    # retrying a possibly-applied ask would mint a second assignment.
    "league_register", "league_report", "league_train_info", "league_status",
})

LEAD_ROUTE = "__lead__"  # journal-internal leadership records


# --------------------------------------------------------------------- errors
class NotLeaderError(RetryableError):
    """The addressed coordinator is a standby; follow ``leader`` and retry."""

    def __init__(self, addr: str, leader: str = "", epoch: int = -1):
        super().__init__(f"{addr} is not the leader"
                         + (f" (leader hint: {leader})" if leader else ""))
        self.addr = addr
        self.leader = leader
        self.epoch = epoch


class StaleEpochError(RetryableError):
    """A reply carried an epoch older than one already seen — a deposed
    primary's answer, discarded typed (the no-split-brain guarantee)."""

    def __init__(self, addr: str, epoch: int, max_epoch: int):
        super().__init__(
            f"stale epoch {epoch} from {addr} (fleet is at {max_epoch})")
        self.addr = addr
        self.epoch = epoch
        self.max_epoch = max_epoch


class AmbiguousAckError(FatalError):
    """A non-idempotent request may or may not have been applied (the
    connection died between send and reply). Retrying could double-apply, so
    the ambiguity surfaces typed for the caller to resolve."""

    def __init__(self, route: str, addr: str, cause: Optional[BaseException] = None):
        super().__init__(
            f"coordinator:{route} @ {addr} died between send and reply; "
            "the request may have been applied — not retrying a "
            "non-idempotent route")
        self.route = route
        self.addr = addr
        self.cause = cause


class NotLeader(Exception):
    """Server-side control flow: raised by :meth:`HAState.dispatch` on a
    standby so the HTTP layer answers the typed ``not_leader`` envelope."""

    def __init__(self, leader: str = "", epoch: int = 0):
        super().__init__("not_leader")
        self.leader = leader
        self.epoch = epoch


class JournalCorruptError(RuntimeError):
    """A snapshot failed its CRC — the journal directory is damaged beyond
    the torn-tail case replay tolerates by construction."""


def _metrics():
    from ..obs import get_registry

    return get_registry()


# -------------------------------------------------------------------- journal
_FRAME = struct.Struct("<II")  # payload length, crc32(payload)


class Journal:
    """CRC-framed write-ahead log with periodic snapshots.

    Directory layout: ``wal.<seq16>.log`` append segments (a fresh segment
    per process start and per snapshot — torn tails are always the last
    record of a segment and are discarded as never-acked) and
    ``snap.<seq16>.bin`` full-state snapshots written via the storage
    layer's atomic tmp+fsync+rename idiom. Recovery = newest CRC-valid
    snapshot + replay of every later record; compaction keeps the newest
    two snapshots and only segments newer than the older one.
    """

    def __init__(self, root: str, snapshot_every: int = 512):
        self.root = root
        self.snapshot_every = max(1, int(snapshot_every))
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()
        self._fh = None
        self._seq = 0
        self._epoch = 0
        self._since_snapshot = 0
        self._subs: List["queue.Queue"] = []

    # ------------------------------------------------------------------ frames
    @staticmethod
    def _encode(record: dict) -> bytes:
        payload = pickle.dumps(record, protocol=5)
        return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload

    @staticmethod
    def _scan(path: str) -> List[dict]:
        """Every complete CRC-valid record in a segment; scanning stops at
        the first torn/corrupt frame (an unacked tail, never acked data)."""
        out: List[dict] = []
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return out
        off = 0
        while off + _FRAME.size <= len(data):
            n, crc = _FRAME.unpack_from(data, off)
            start, end = off + _FRAME.size, off + _FRAME.size + n
            if end > len(data):
                break  # torn tail
            payload = data[start:end]
            if zlib.crc32(payload) != crc:
                break  # bit rot / torn overwrite: stop, do not guess
            try:
                out.append(pickles.loads(payload))
            except Exception:  # undecodable record: same contract as bad CRC
                break
            off = end
        return out

    # ---------------------------------------------------------------- recovery
    def recover(self) -> Tuple[Optional[dict], List[dict]]:
        """``(snapshot_state_or_None, records_after_snapshot)``. Leaves the
        journal positioned to continue appending after the last record."""
        snaps = sorted(glob.glob(os.path.join(glob.escape(self.root), "snap.*.bin")))
        base: Optional[dict] = None
        base_seq = 0
        for path in reversed(snaps):
            try:
                raw = open(path, "rb").read()
                if len(raw) < 4:
                    continue
                (crc,) = struct.unpack("<I", raw[:4])
                if zlib.crc32(raw[4:]) != crc:
                    continue
                blob = pickles.loads(raw[4:])
                base, base_seq = blob, int(blob.get("seq", 0))
                break
            except Exception:
                continue
        if snaps and base is None:
            raise JournalCorruptError(
                f"no snapshot under {self.root} passed its CRC")
        records: List[dict] = []
        last = base_seq
        for seg in sorted(glob.glob(os.path.join(glob.escape(self.root), "wal.*.log"))):
            for rec in self._scan(seg):
                seq = int(rec.get("seq", 0))
                if seq <= last:
                    continue  # covered by the snapshot / duplicate
                records.append(rec)
                last = seq
        with self._lock:
            self._seq = last
            if base is not None:
                self._epoch = int(base.get("epoch", 0))
            for rec in records:
                if rec.get("route") == LEAD_ROUTE:
                    self._epoch = int(rec["body"].get("epoch", self._epoch))
        return base, records

    def _open_segment_locked(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
        path = os.path.join(self.root, f"wal.{self._seq + 1:016d}.log")
        self._fh = open(path, "ab")

    @property
    def seq(self) -> int:
        with self._lock:
            return self._seq

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def set_epoch(self, epoch: int) -> None:
        with self._lock:
            self._epoch = int(epoch)

    # ------------------------------------------------------------------ append
    def append(self, route: str, body: dict, ts: Optional[float] = None,
               durable: bool = True, epoch: Optional[int] = None) -> int:
        """Append one record; returns its sequence number. ``durable``
        fsyncs before returning (the record survives power loss before the
        caller acks); non-durable records are flushed to the OS only."""
        with self._lock:
            if self._fh is None:
                self._open_segment_locked()
            self._seq += 1
            if epoch is not None:
                self._epoch = int(epoch)
            rec = {"seq": self._seq, "ts": time.time() if ts is None else ts,
                   "route": route, "body": body}
            self._fh.write(self._encode(rec))
            self._fh.flush()
            if durable:
                os.fsync(self._fh.fileno())
            self._since_snapshot += 1
            # deliver under the lock: subscriber queues must observe records
            # in seq order even if appenders race
            for q in self._subs:
                try:
                    q.put_nowait(("rec", rec))
                except queue.Full:
                    # slow follower: mark the stream broken; it reconnects
                    # and receives a fresh snapshot instead of a silent gap
                    setattr(q, "overflowed", True)
        _metrics().counter(
            "distar_coordinator_ha_journal_records_total",
            "WAL records appended (primary writes + standby tail)",
        ).inc()
        return rec["seq"]

    def want_snapshot(self) -> bool:
        with self._lock:
            return self._since_snapshot >= self.snapshot_every

    # --------------------------------------------------------------- snapshots
    def snapshot(self, state: dict) -> str:
        """Write ``state`` (plus seq/epoch) atomically, rotate the append
        segment, and compact old segments/snapshots."""
        from ..utils import storage

        with self._lock:
            blob = dict(state)
            blob["seq"], blob["epoch"] = self._seq, self._epoch
            payload = pickle.dumps(blob, protocol=5)
            path = os.path.join(self.root, f"snap.{self._seq:016d}.bin")
            storage.write_bytes(
                path, struct.pack("<I", zlib.crc32(payload)) + payload)
            self._open_segment_locked()
            self._since_snapshot = 0
        self._compact()
        _metrics().counter(
            "distar_coordinator_ha_snapshots_total",
            "journal snapshots written (replay horizon resets)",
        ).inc()
        return path

    def _compact(self) -> None:
        snaps = sorted(glob.glob(os.path.join(glob.escape(self.root), "snap.*.bin")))
        for stale in snaps[:-2]:
            try:
                os.unlink(stale)
            except OSError:
                pass
        if len(snaps) < 2:
            return
        horizon = snaps[-2]  # keep segments newer than the older kept snap
        hseq = int(os.path.basename(horizon).split(".")[1])
        for seg in sorted(glob.glob(os.path.join(glob.escape(self.root), "wal.*.log"))):
            sseq = int(os.path.basename(seg).split(".")[1])
            # a segment starting at or before the horizon only holds records
            # the snapshot already covers IF a later segment exists (the
            # newest segment is always live — never reap the open file)
            if sseq <= hseq and seg != self._current_segment():
                try:
                    os.unlink(seg)
                except OSError:
                    pass

    def _current_segment(self) -> Optional[str]:
        with self._lock:
            return self._fh.name if self._fh is not None else None

    def reset(self, state: dict, seq: int, epoch: int) -> None:
        """Adopt a leader's snapshot wholesale (a follower joining): the
        local history is superseded — snapshot the received state and start
        a fresh segment after it. Divergent local tails (possible only past
        a fencing event) are deliberately discarded."""
        with self._lock:
            self._seq = int(seq)
            self._epoch = int(epoch)
            self._since_snapshot = 0
        self.snapshot(state)

    # ------------------------------------------------------------ subscriptions
    def subscribe(self, maxsize: int = 8192) -> "queue.Queue":
        q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        q.overflowed = False  # type: ignore[attr-defined]
        with self._lock:
            self._subs.append(q)
        return q

    def unsubscribe(self, q: "queue.Queue") -> None:
        with self._lock:
            if q in self._subs:
                self._subs.remove(q)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


# ------------------------------------------------------------------ ha status
def probe_ha_status(addr: str, timeout: float = 2.0) -> Optional[dict]:
    """``GET /coordinator/ha`` from ``addr`` ("host:port"); None when the
    peer is unreachable or does not speak HA."""
    import json
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(
                f"http://{addr}/coordinator/ha", timeout=timeout) as resp:
            return json.loads(resp.read())
    except (urllib.error.URLError, ConnectionError, TimeoutError, OSError,
            ValueError):
        return None


def apply_record(coordinator, rec: dict, arena_store=None,
                 league_service=None) -> None:
    """Apply one journaled record to a coordinator replica (restart replay
    and the standby tail share this one code path). Leases are re-aged from
    the record's wall timestamp, so an endpoint that stopped heartbeating
    long before the crash is evicted on the first sweep instead of getting
    a fresh TTL. League records replay through the hosted LeagueService
    with the record's clock, so lease/expiry decisions match the primary's."""
    route, body, ts = rec["route"], rec.get("body") or {}, float(rec.get("ts", 0.0))
    if route == LEAD_ROUTE:
        return
    if route.startswith("league_"):
        if league_service is None:
            from ..league.runtime import get_league_service

            league_service = get_league_service()
        method = {"league_register": "register_learner", "league_ask": "ask_job",
                  "league_report": "report",
                  "league_train_info": "train_info"}.get(route)
        if league_service is not None and method is not None:
            getattr(league_service, method)(body, now=ts)
        else:
            _metrics().counter(
                "distar_coordinator_ha_apply_skips_total",
                "journal records skipped on apply (no hosting store / "
                "unknown route)", route=route).inc()
        return
    if route == "register":
        coordinator.apply_register(
            body["token"], body["ip"], body["port"], body.get("meta"),
            lease_s=body.get("lease_s"), record_ts=ts)
    elif route == "heartbeat":
        coordinator.apply_heartbeat(
            body["ip"], body["port"], lease_s=body.get("lease_s"), record_ts=ts)
    elif route == "unregister":
        coordinator.unregister(body["ip"], body["port"])
    elif route == "strike":
        coordinator.strike(body["ip"], body["port"])
    elif route == "ask":
        coordinator.ask(body["token"])  # the pop re-executes; result discarded
    elif route == "arena_report":
        if arena_store is None:
            from ..arena import get_arena_store

            arena_store = get_arena_store()
        if arena_store is not None:
            arena_store.report_batch(body.get("matches", []))
        else:
            _metrics().counter(
                "distar_coordinator_ha_apply_skips_total",
                "journal records skipped on apply (no hosting store / "
                "unknown route)", route=route).inc()
    else:
        _metrics().counter(
            "distar_coordinator_ha_apply_skips_total",
            "journal records skipped on apply (no hosting store / "
            "unknown route)", route=route).inc()


class HAState:
    """Leadership + journaling + replication for one coordinator process.

    ``role="auto"`` probes ``peers`` at boot: a live primary with an epoch
    at least ours means we join as its standby; otherwise we lead (bumping
    the epoch past everything the journal has seen). The primary serves the
    follower feed (framed TCP) and journals every mutating route through
    :meth:`dispatch`; a standby answers every POST route with the typed
    ``not_leader`` envelope and promotes itself when the feed goes quiet
    for ``takeover_grace_s``.
    """

    def __init__(self, coordinator, journal_dir: str,
                 advertise: str = "",
                 feed_host: str = "127.0.0.1", feed_port: int = 0,
                 peers: Sequence[str] = (),
                 role: str = "auto",
                 takeover_grace_s: float = 3.0,
                 sync_timeout_s: float = 2.0,
                 snapshot_every: int = 512,
                 arena_store_fn: Optional[Callable] = None,
                 league_service_fn: Optional[Callable] = None):
        assert role in ("auto", "primary", "standby"), role
        self.coordinator = coordinator
        self.journal = Journal(journal_dir, snapshot_every=snapshot_every)
        self.advertise = advertise  # this process's HTTP addr, for hints
        self.peers = [p for p in peers if p]
        self.takeover_grace_s = float(takeover_grace_s)
        self.sync_timeout_s = float(sync_timeout_s)
        self._arena_store_fn = arena_store_fn
        self._league_service_fn = league_service_fn
        self.role = "booting"
        self.leader_hint = ""
        self._mutate_lock = threading.Lock()
        self._repl_cond = threading.Condition()
        self._follower_acked = 0
        self._followers = 0
        self._applied_seq = 0       # standby: last record applied
        self._applied_ts = 0.0      # standby: wall ts of that record
        self._leader_seq = 0        # standby: leader's latest seq (from hb)
        self._last_contact = time.monotonic()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._feed_listener: Optional[socket.socket] = None
        self.feed_host, self._feed_port_req = feed_host, feed_port
        self.feed_port = 0
        self._requested_role = role

    # ---------------------------------------------------------------- helpers
    def _arena_store(self):
        if self._arena_store_fn is not None:
            return self._arena_store_fn()
        from ..arena import get_arena_store

        return get_arena_store()

    def _league_service(self):
        if self._league_service_fn is not None:
            return self._league_service_fn()
        from ..league.runtime import get_league_service

        return get_league_service()

    @property
    def epoch(self) -> int:
        return self.journal.epoch

    def _state_blob(self) -> dict:
        store = self._arena_store()
        service = self._league_service()
        return {
            "coordinator": self.coordinator.state_snapshot(),
            "arena": store.state_blob() if store is not None else None,
            "league": service.state_blob() if service is not None else None,
        }

    def _restore_blob(self, blob: dict) -> None:
        self.coordinator.restore_state(blob.get("coordinator") or {})
        arena = blob.get("arena")
        store = self._arena_store()
        if arena is not None and store is not None:
            store.load_state(arena)
        league = blob.get("league")
        service = self._league_service()
        if league is not None and service is not None:
            service.load_state(league)

    # ------------------------------------------------------------------- boot
    def boot(self) -> "HAState":
        """Recover the local journal, pick a role, start threads."""
        base, records = self.journal.recover()
        if base is not None:
            self._restore_blob(base)
        for rec in records:
            apply_record(self.coordinator, rec, self._arena_store(),
                         self._league_service())
        self._start_feed_server()
        role = self._requested_role
        leader = ""
        if role == "auto":
            best_epoch, leader = -1, ""
            for peer in self.peers:
                st = probe_ha_status(peer)
                if st and st.get("role") == "primary" \
                        and int(st.get("epoch", -1)) >= self.journal.epoch \
                        and int(st.get("epoch", -1)) > best_epoch:
                    best_epoch, leader = int(st["epoch"]), peer
            role = "standby" if leader else "primary"
        elif role == "standby":
            leader = self.peers[0] if self.peers else ""
        if role == "primary":
            self._become_primary()
        else:
            self._become_standby(leader)
        t = threading.Thread(target=self._housekeeping, daemon=True,
                             name="coordinator-ha")
        t.start()
        self._threads.append(t)
        return self

    # -------------------------------------------------------------- leadership
    def _become_primary(self) -> None:
        epoch = self.journal.epoch + 1
        self.journal.append(LEAD_ROUTE, {"epoch": epoch, "addr": self.advertise},
                            durable=True, epoch=epoch)
        self.role = "primary"
        self.leader_hint = self.advertise
        _metrics().counter(
            "distar_coordinator_ha_leaderships_total",
            "leadership acquisitions (boot elections + standby promotions)",
        ).inc()
        self._publish_gauges()

    def _become_standby(self, leader: str) -> None:
        self.role = "standby"
        self.leader_hint = leader
        self._last_contact = time.monotonic()
        t = threading.Thread(target=self._tail_loop, daemon=True,
                             name="coordinator-ha-tail")
        t.start()
        self._threads.append(t)
        self._publish_gauges()

    def _publish_gauges(self) -> None:
        reg = _metrics()
        reg.gauge("distar_coordinator_ha_epoch",
                  "current leadership epoch of this coordinator").set(self.epoch)
        reg.gauge("distar_coordinator_ha_role",
                  "1 primary / 0 standby").set(1 if self.role == "primary" else 0)
        if self.role == "standby":
            lag = max(0, self._leader_seq - self._applied_seq)
            reg.gauge("distar_coordinator_ha_journal_lag_records",
                      "standby: records behind the primary's journal").set(lag)
            if self._applied_ts:
                reg.gauge(
                    "distar_coordinator_ha_journal_lag_seconds",
                    "standby: age of the newest applied journal record",
                ).set(max(0.0, time.time() - self._applied_ts))

    # ------------------------------------------------------------ HTTP dispatch
    def dispatch(self, name: str, body: dict, handler: Callable) -> object:
        """Route one POST through the HA contract: standbys answer
        ``not_leader`` typed; ephemeral routes pass straight through;
        journaled routes append (durable ones fsync + wait for standby
        replication) before the result is returned."""
        if self.role != "primary":
            raise NotLeader(leader=self.leader_hint, epoch=self.epoch)
        if name in EPHEMERAL_ROUTES or name not in JOURNALED_ROUTES:
            return handler(body)
        durable = name in DURABLE_ROUTES
        with self._mutate_lock:
            if name == "ask":
                # journal pops only when something was actually popped —
                # Adapter polls this route constantly on empty queues
                result = handler(body)
                seq = self.journal.append(name, body, durable=True) \
                    if result is not None else 0
            else:
                seq = self.journal.append(name, body, durable=durable)
                result = handler(body)
            if self.journal.want_snapshot():
                self.journal.snapshot(self._state_blob())
        if durable and seq:
            self._wait_replicated(seq)
        return result

    def _wait_replicated(self, seq: int) -> None:
        """Semi-synchronous replication: with a follower attached, a durable
        ack waits (bounded) until the standby confirmed the record — an
        acked item is on the standby before the client sees the ack. A slow
        or dying follower times out (counted) rather than stalling the
        fleet: availability wins, the journal still has the record."""
        with self._repl_cond:
            if self._followers == 0:
                return
            deadline = time.monotonic() + self.sync_timeout_s
            while self._follower_acked < seq:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    _metrics().counter(
                        "distar_coordinator_ha_sync_timeouts_total",
                        "durable acks that stopped waiting for a slow standby",
                    ).inc()
                    return
                self._repl_cond.wait(remaining)

    # ------------------------------------------------------------- feed server
    def _start_feed_server(self) -> None:
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind((self.feed_host, self._feed_port_req))
        ls.listen(8)
        self._feed_listener = ls
        self.feed_port = ls.getsockname()[1]

        def accept_loop():
            while not self._stop.is_set():
                try:
                    conn, _ = ls.accept()
                except OSError:
                    return  # listener closed
                t = threading.Thread(target=self._serve_follower,
                                     args=(conn,), daemon=True,
                                     name="coordinator-ha-feed")
                t.start()
                self._threads.append(t)

        t = threading.Thread(target=accept_loop, daemon=True,
                             name="coordinator-ha-accept")
        t.start()
        self._threads.append(t)

    def _serve_follower(self, conn: socket.socket) -> None:
        from . import serializer

        conn.settimeout(10.0)
        sub = None
        try:
            hello = serializer.recv_msg(conn)
            if not isinstance(hello, dict) or hello.get("op") != "tail":
                return
            # subscribe BEFORE snapshotting under the mutate lock: no record
            # can land between the snapshot and the stream's first item
            with self._mutate_lock:
                sub = self.journal.subscribe()
                blob = self._state_blob()
                seq, epoch = self.journal.seq, self.journal.epoch
            serializer.send_msg(conn, {"op": "snapshot", "seq": seq,
                                       "epoch": epoch, "state": blob})
            with self._repl_cond:
                self._followers += 1
                self._follower_acked = max(self._follower_acked, 0)
            send_lock = threading.Lock()
            stop_reader = threading.Event()

            def read_acks():
                while not stop_reader.is_set():
                    try:
                        msg = serializer.recv_msg(conn)
                    except socket.timeout:
                        continue  # idle follower: acks only flow with records
                    except (ConnectionError, OSError, ValueError):
                        return
                    if isinstance(msg, dict) and msg.get("op") == "ack":
                        with self._repl_cond:
                            self._follower_acked = max(
                                self._follower_acked, int(msg.get("seq", 0)))
                            self._repl_cond.notify_all()

            rt = threading.Thread(target=read_acks, daemon=True,
                                  name="coordinator-ha-acks")
            rt.start()
            try:
                while not self._stop.is_set():
                    if getattr(sub, "overflowed", False):
                        return  # follower too slow: force a resnapshot
                    try:
                        kind, rec = sub.get(timeout=0.5)
                    except queue.Empty:
                        with send_lock:
                            serializer.send_msg(
                                conn, {"op": "hb", "epoch": self.journal.epoch,
                                       "seq": self.journal.seq},
                                compress=False)
                        continue
                    with send_lock:
                        serializer.send_msg(conn, {"op": kind, "rec": rec},
                                            compress=False)
            finally:
                stop_reader.set()
        except (ConnectionError, OSError, ValueError):
            pass
        finally:
            if sub is not None:
                self.journal.unsubscribe(sub)
                with self._repl_cond:
                    self._followers = max(0, self._followers - 1)
                    self._repl_cond.notify_all()
            try:
                conn.close()
            except OSError:
                pass

    # ------------------------------------------------------------ standby tail
    def _leader_feed_addr(self) -> Optional[Tuple[str, int]]:
        st = probe_ha_status(self.leader_hint) if self.leader_hint else None
        if st and st.get("feed"):
            host, _, port = str(st["feed"]).rpartition(":")
            self.leader_hint = str(st.get("leader") or self.leader_hint)
            try:
                return host or "127.0.0.1", int(port)
            except ValueError:
                return None
        return None

    def _tail_loop(self) -> None:
        from . import serializer

        while not self._stop.is_set() and self.role == "standby":
            feed = self._leader_feed_addr()
            if feed is None:
                if self._grace_expired():
                    self._promote()
                    return
                self._stop.wait(0.25)
                continue
            try:
                conn = socket.create_connection(feed, timeout=3.0)
            except OSError:
                if self._grace_expired():
                    self._promote()
                    return
                self._stop.wait(0.25)
                continue
            conn.settimeout(3.0)
            try:
                serializer.send_msg(conn, {"op": "tail",
                                           "from_seq": self.journal.seq},
                                    compress=False)
                while not self._stop.is_set():
                    try:
                        msg = serializer.recv_msg(conn)
                    except socket.timeout:
                        if self._grace_expired():
                            self._promote()
                            return
                        continue
                    self._last_contact = time.monotonic()
                    op = msg.get("op") if isinstance(msg, dict) else None
                    if op == "snapshot":
                        with self._mutate_lock:
                            self._restore_blob(msg.get("state") or {})
                            self.journal.reset(msg.get("state") or {},
                                               int(msg.get("seq", 0)),
                                               int(msg.get("epoch", 0)))
                            self._applied_seq = int(msg.get("seq", 0))
                            self._leader_seq = self._applied_seq
                    elif op == "rec":
                        rec = msg.get("rec") or {}
                        with self._mutate_lock:
                            self.journal.append(
                                rec.get("route", "?"), rec.get("body") or {},
                                ts=rec.get("ts"),
                                durable=rec.get("route") in DURABLE_ROUTES)
                            apply_record(self.coordinator, rec,
                                         self._arena_store(),
                                         self._league_service())
                            self._applied_seq = int(rec.get("seq", 0))
                            self._applied_ts = float(rec.get("ts", 0.0))
                            self._leader_seq = max(self._leader_seq,
                                                   self._applied_seq)
                        serializer.send_msg(
                            conn, {"op": "ack", "seq": self._applied_seq},
                            compress=False)
                    elif op == "hb":
                        self._leader_seq = int(msg.get("seq", self._leader_seq))
                        self.journal.set_epoch(
                            max(self.journal.epoch, int(msg.get("epoch", 0))))
                    self._publish_gauges()
            except (ConnectionError, OSError, ValueError):
                pass
            finally:
                try:
                    conn.close()
                except OSError:
                    pass
            # stream died: the grace clock (last contact) decides takeover
            if self._grace_expired():
                self._promote()
                return
            self._stop.wait(0.25)

    def _grace_expired(self) -> bool:
        return time.monotonic() - self._last_contact > self.takeover_grace_s

    def _promote(self) -> None:
        if self._stop.is_set() or self.role == "primary":
            return
        # one last check: another peer may already lead at a higher epoch
        for peer in self.peers:
            st = probe_ha_status(peer, timeout=1.0)
            if st and st.get("role") == "primary" \
                    and int(st.get("epoch", -1)) > self.journal.epoch:
                self.leader_hint = peer
                self._last_contact = time.monotonic()
                t = threading.Thread(target=self._tail_loop, daemon=True,
                                     name="coordinator-ha-tail")
                t.start()
                self._threads.append(t)
                return
        _metrics().counter(
            "distar_coordinator_ha_takeovers_total",
            "standby promotions after the leadership lease went quiet",
        ).inc()
        self._become_primary()

    # ------------------------------------------------------------ housekeeping
    def _housekeeping(self) -> None:
        interval = max(0.5, self.takeover_grace_s / 2.0)
        while not self._stop.wait(interval):
            self._publish_gauges()
            if self.role != "primary":
                continue
            for peer in self.peers:
                st = probe_ha_status(peer, timeout=1.0)
                if st and st.get("role") == "primary" \
                        and int(st.get("epoch", -1)) > self.journal.epoch:
                    # deposed: a newer leadership exists — rejoin as its
                    # follower instead of split-braining (clients already
                    # fence our stale-epoch answers)
                    _metrics().counter(
                        "distar_coordinator_ha_demotions_total",
                        "primaries that found a newer epoch and demoted",
                    ).inc()
                    self._become_standby(peer)
                    break

    # ----------------------------------------------------------------- status
    def status(self) -> dict:
        self._publish_gauges()
        return {
            "role": self.role,
            "epoch": self.epoch,
            "seq": self.journal.seq,
            "feed": f"{self.feed_host}:{self.feed_port}",
            "leader": self.leader_hint,
            "advertise": self.advertise,
            "peers": list(self.peers),
            "journal_lag_records": (max(0, self._leader_seq - self._applied_seq)
                                    if self.role == "standby" else 0),
            "journal_lag_seconds": (max(0.0, time.time() - self._applied_ts)
                                    if self.role == "standby" and self._applied_ts
                                    else 0.0),
            "followers": self._followers,
        }

    def final_snapshot(self) -> None:
        """Journal a parting snapshot (clean shutdown path)."""
        if self.role == "primary":
            self.journal.snapshot(self._state_blob())

    def stop(self) -> None:
        self._stop.set()
        if self._feed_listener is not None:
            try:
                self._feed_listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._feed_listener.close()
            except OSError:
                pass
            self._feed_listener = None
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []
        self.journal.close()


# ---------------------------------------------------------- client-side state
def parse_addrs(spec) -> Tuple[Tuple[str, int], ...]:
    """``"h1:p1,h2:p2"`` (or a list of such, or (host, port) tuples) ->
    canonical ((host, port), ...). A single coordinator is the 1-tuple."""
    if isinstance(spec, (tuple, list)) and len(spec) == 2 \
            and isinstance(spec[1], int):
        return ((str(spec[0]) or "127.0.0.1", int(spec[1])),)
    items: List[str] = []
    if isinstance(spec, str):
        items = [s.strip() for s in spec.split(",") if s.strip()]
    else:
        for entry in spec or ():
            if isinstance(entry, (tuple, list)):
                items.append(f"{entry[0]}:{entry[1]}")
            else:
                items.append(str(entry))
    out: List[Tuple[str, int]] = []
    for item in items:
        host, _, port = item.rpartition(":")
        out.append((host or "127.0.0.1", int(port)))
    if not out:
        raise ValueError(f"no coordinator addrs in {spec!r}")
    return tuple(out)


def format_addrs(addrs: Sequence[Tuple[str, int]]) -> str:
    return ",".join(f"{h}:{p}" for h, p in addrs)


class FailoverTargets:
    """Shared per-address-set client state: which coordinator is believed
    primary, and the highest epoch ever seen from the set (the fence)."""

    def __init__(self, addrs: Tuple[Tuple[str, int], ...]):
        self.addrs = addrs
        self._lock = threading.Lock()
        self._active = 0
        self.max_epoch = -1

    def active(self) -> Tuple[str, int]:
        with self._lock:
            return self.addrs[self._active]

    def note_epoch(self, epoch: int) -> None:
        with self._lock:
            self.max_epoch = max(self.max_epoch, int(epoch))

    def is_stale(self, epoch: int) -> bool:
        with self._lock:
            return int(epoch) < self.max_epoch

    def rotate(self, failed: Tuple[str, int]) -> Tuple[str, int]:
        """Advance past ``failed`` (no-op if another thread already did)."""
        moved = False
        with self._lock:
            if len(self.addrs) > 1 and self.addrs[self._active] == failed:
                self._active = (self._active + 1) % len(self.addrs)
                moved = True
            current = self.addrs[self._active]
        if moved:
            _metrics().counter(
                "distar_coordinator_ha_client_failovers_total",
                "client-side coordinator target rotations",
            ).inc()
            _notify_failover(self)
        return current

    def follow(self, leader: str, current: Tuple[str, int]) -> None:
        """Adopt a ``not_leader`` redirect's hint when it names a configured
        addr; otherwise just rotate off the standby we asked."""
        target = None
        if leader:
            try:
                target = parse_addrs(leader)[0]
            except (ValueError, IndexError):
                target = None
        with self._lock:
            if target in self.addrs:
                if self.addrs[self._active] != target:
                    self._active = self.addrs.index(target)
                    moved = True
                else:
                    moved = False
            else:
                moved = False
        if moved:
            _notify_failover(self)
        elif target is None or target not in self.addrs:
            self.rotate(current)


_TARGETS: Dict[Tuple[Tuple[str, int], ...], FailoverTargets] = {}
_TARGETS_LOCK = threading.Lock()
_FAILOVER_LISTENERS: List[Callable] = []


def targets_for(addrs: Tuple[Tuple[str, int], ...]) -> FailoverTargets:
    with _TARGETS_LOCK:
        st = _TARGETS.get(addrs)
        if st is None:
            st = _TARGETS[addrs] = FailoverTargets(addrs)
        return st


def reset_targets() -> None:
    """Forget all client failover state (tests)."""
    with _TARGETS_LOCK:
        _TARGETS.clear()


def add_failover_listener(fn: Callable) -> None:
    """``fn(targets)`` runs after any client-side target rotation — how the
    telemetry shipper learns to resync its full snapshot to a new primary
    immediately instead of a ship interval later."""
    with _TARGETS_LOCK:
        _FAILOVER_LISTENERS.append(fn)


def remove_failover_listener(fn: Callable) -> None:
    with _TARGETS_LOCK:
        if fn in _FAILOVER_LISTENERS:
            _FAILOVER_LISTENERS.remove(fn)


def _notify_failover(targets: FailoverTargets) -> None:
    with _TARGETS_LOCK:
        listeners = list(_FAILOVER_LISTENERS)
    for fn in listeners:
        try:
            fn(targets)
        except Exception:  # noqa: BLE001 - observers must not break RPCs
            pass


def is_ambiguous(err: BaseException) -> bool:
    """Could the request have been applied even though the call failed?
    A refused/unresolvable connection never carried the request; anything
    else (timeout, reset, truncated reply) may have."""
    seen = set()
    stack = [err]
    while stack:
        e = stack.pop()
        if id(e) in seen or e is None:
            continue
        seen.add(id(e))
        if isinstance(e, (ConnectionRefusedError, socket.gaierror)):
            return False
        for attr in ("cause", "reason", "__cause__", "__context__"):
            nxt = getattr(e, attr, None)
            if isinstance(nxt, BaseException):
                stack.append(nxt)
    return True

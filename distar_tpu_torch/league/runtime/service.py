"""Coordinator-hosted league service: the matchmaking control plane.

Counterpart of ``distar_tpu.league.runtime.service``. The coordinator's
write-ahead journal (``comm/ha.py``) journals its mutating routes and
replays them through ``comm.ha.apply_record`` with each record's clock;
the replay-safety below is what that relies on.

The seed :class:`~distar_tpu_torch.league.league.League` is transport-agnostic
and deterministic given its RNG — but it draws from the *module-level*
``random`` (and ``np.random`` inside ``ExploiterPlayer.is_reset``), which
makes its decisions impossible to replay from a journal. This service is
the journal-safe wrapper the HA coordinator hosts (comm/ha.py anticipated
it by name: "a future route (the league's matchmaker)"): every mutating
entry point is a pure function of (state, seeded RNG, request body, record
timestamp), so replaying the coordinator's WAL reconstructs the league —
roster, snapshot lineage, assignment map, RNG cursor — exactly.

What it owns, and what it deliberately does not:

* **Roster** — learners register under a league player id (MP*/EP*/ME*…),
  and a player whose learners all stopped heartbeating is *frozen*:
  derived from journaled ``last_seen`` timestamps, never stored, so a
  SIGKILL'd learner's players stay in the league (matchable as opponents)
  without a tombstone route. A supervised restart re-registers and thaws.
* **Matchmaking** — ``ask_job`` draws the branch (sp/pfsp/vs_main/eval)
  from the player class's configured probabilities with the service RNG,
  then picks the opponent. PFSP weights are NOT re-grown from league win
  counters: they come from the arena's live payoff matrix
  (:meth:`~distar_tpu_torch.arena.store.ArenaStore.pfsp_preview`, the
  Wilson-CI ledger) so matchmaking sharpens as real results arrive.
* **Assignments** — every job carries a ``job_id``; outstanding
  assignments expire after ``job_ttl_s`` (pruned lazily *inside journaled
  routes* using the record timestamp, so replay prunes identically). A
  learner killed mid-job therefore leaves no orphaned assignment, and its
  acked reports are already in the arena ledger (idempotent keys).
* **Snapshot minting** — historical players are minted from
  ``CheckpointManager`` generations: a learner reports the generation
  path it just recorded and the service snapshots its player to exactly
  that file. Minting is idempotent on (player_id, generation_path):
  duplicate triggers (retries, ambiguous acks) return the existing
  snapshot. Reset decisions (exploiter re-spawns) use the service RNG.
* **Not owned**: win/loss accounting (the arena store's job — one ledger,
  one dedup) and the match transport (learners report through
  ``league_report`` which forwards to the co-hosted store in-process).
"""
from __future__ import annotations

import pickle
import random
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from ..league import League
from ..player import (
    ActivePlayer,
    AdaptiveEvolutionaryExploiterPlayer,
    ExploiterPlayer,
    MainExploiterPlayer,
    MainPlayer,
)

#: the four dispatch branches the runtime distinguishes (metrics label set)
BRANCHES = ("sp", "pfsp", "vs_main", "eval")


def _metrics():
    from ...obs import get_registry

    return get_registry()


class LeagueService:
    """Journal-replayable league control plane (hosted by the coordinator).

    Every mutating method takes the wire ``body`` plus an optional ``now``:
    live dispatch leaves ``now`` unset (wall clock), journal replay passes
    the record's timestamp — the only clock the service ever reads, so a
    cold replay reconstructs lease ages and assignment expiry decisions.
    """

    def __init__(self, cfg: Optional[dict] = None, seed: int = 0,
                 lease_s: float = 30.0, job_ttl_s: float = 180.0,
                 league: Optional[League] = None):
        self.league = league if league is not None else League(cfg)
        self.lease_s = float(lease_s)
        self.job_ttl_s = float(job_ttl_s)
        self._seed = int(seed)
        self._rng = random.Random(self._seed)
        self._lock = threading.RLock()
        # learner_id -> {player_id, ip, port, registered_ts, last_seen}
        self.learners: Dict[str, dict] = {}
        # job_id -> {player_ids, branch, learner_id, actor, issued_ts}
        self.assignments: Dict[str, dict] = {}
        # "{player_id}|{generation_path}" -> minted snapshot id
        self._minted: "OrderedDict[str, str]" = OrderedDict()
        # per-player last-applied train_info seq (idempotency watermark)
        self._train_seq: Dict[str, int] = {}
        # match keys already folded into league payoffs (mirrors the arena
        # dedup so a replayed report can't double-count the league view)
        self._seen: "OrderedDict[str, None]" = OrderedDict()
        self._seen_cap = 100_000
        self._job_seq = 0
        self.jobs_by_branch: Dict[str, int] = {b: 0 for b in BRANCHES}
        self.orphans_total = 0
        self.reassignments_total = 0
        # let League.save_resume/load_resume carry the runtime state too
        # (satellite: a cold coordinator replay reconstructs the league)
        self.league.attach_runtime(self._runtime_state, self._load_runtime_state)

    # ------------------------------------------------------------------ clock
    @staticmethod
    def _now(now: Optional[float]) -> float:
        return time.time() if now is None else float(now)

    # ---------------------------------------------------------------- learner
    def register_learner(self, body: dict, now: Optional[float] = None) -> dict:
        """Register (or heartbeat — re-registering refreshes the lease) one
        learner process under its league player. Idempotent by learner_id."""
        ts = self._now(now)
        learner_id = str(body.get("learner_id") or body.get("player_id") or "")
        player_id = str(body.get("player_id") or "")
        with self._lock:
            player = self.league.active_players.get(player_id)
            if player is None:
                return {"registered": False, "error": f"unknown player {player_id}"}
            entry = self.learners.get(learner_id)
            if entry is None:
                entry = self.learners[learner_id] = {
                    "player_id": player_id,
                    "ip": str(body.get("ip", "")),
                    "port": int(body.get("port", 0)),
                    "registered_ts": ts,
                }
                self.league.register_learner(
                    player_id, ip=entry["ip"], port=entry["port"],
                    rank=int(body.get("rank", 0)),
                    world_size=int(body.get("world_size", 1)))
            entry["player_id"] = player_id
            entry["last_seen"] = ts
            reply = {
                "registered": True,
                "checkpoint_path": player.checkpoint_path,
                "teacher_checkpoint_path": player.teacher_checkpoint_path,
                "lease_s": self.lease_s,
                # last-applied train_info watermark: a restarted learner
                # resumes its seq numbering past it instead of replaying
                # into the duplicate filter
                "train_seq": self._train_seq.get(player_id, -1),
            }
        self._publish_metrics(ts)
        return reply

    def _frozen_players_locked(self, ts: float) -> List[str]:
        """Players whose every registered learner stopped heartbeating —
        derived, never stored: freezing survives replay for free and a
        supervised restart thaws by re-registering."""
        by_player: Dict[str, List[float]] = {}
        for entry in self.learners.values():
            by_player.setdefault(entry["player_id"], []).append(entry["last_seen"])
        return sorted(
            pid for pid, seen in by_player.items()
            if all(ts - s > self.lease_s for s in seen)
        )

    # ------------------------------------------------------------ matchmaking
    def pfsp_weights(self, home: str, candidates: List[str]) -> List[float]:
        """Opponent weights for ``home`` over ``candidates`` — the arena
        store's variance-PFSP row, bit-identical to
        ``ArenaStore._pfsp_preview_locked([home]+candidates)[home]``
        (the agreement the determinism tests pin). Uniform fallback when no
        arena store is hosted or the row degenerates."""
        from ...arena import get_arena_store

        if not candidates:
            return []
        store = get_arena_store()
        if store is not None:
            row = store.pfsp_preview([home] + list(candidates)).get(home, {})
            weights = [float(row.get(c, 0.0)) for c in candidates]
            if sum(weights) > 0:
                return weights
        return [1.0 / len(candidates)] * len(candidates)

    def _pick_pfsp(self, home_id: str, candidates: List[str]):
        keys = sorted(c for c in candidates if c != home_id)
        if not keys:
            return None
        weights = self.pfsp_weights(home_id, keys)
        return self.league.historical_players[
            self._rng.choices(keys, weights=weights, k=1)[0]]

    def _main_id_for(self, player_id: str) -> Optional[str]:
        """ME<suffix> pairs with MP<suffix>; fall back to the first main."""
        actives = self.league.active_players
        candidate = f"MP{player_id[2:]}"
        if candidate in actives:
            return candidate
        mains = sorted(pid for pid in actives if pid.startswith("MP"))
        return mains[0] if mains else None

    def _choose_opponent(self, player: ActivePlayer, branch: str):
        """(effective_branch, opponent Player) — deterministic given the
        service RNG and the current roster/ledger. Falls back down the
        branch ladder (vs_main -> pfsp -> sp mirror) instead of raising so
        a journaled ask can always be replayed."""
        league = self.league
        hist = league.historical_players
        pid = player.player_id
        if branch == "vs_main" and isinstance(
                player, (MainExploiterPlayer, AdaptiveEvolutionaryExploiterPlayer)):
            main_id = self._main_id_for(pid)
            if main_id is not None:
                return "vs_main", league.active_players[main_id]
            branch = "pfsp"
        if branch == "eval":
            keys = sorted(hist.keys())
            if keys:
                return "eval", hist[self._rng.choice(keys)]
            branch = "pfsp"
        if branch == "sp" and isinstance(player, MainPlayer):
            mains = sorted(
                mid for mid, p in league.active_players.items()
                if isinstance(p, MainPlayer))
            opp_id = self._rng.choice(mains) if mains else pid
            return "sp", league.active_players.get(opp_id, player)
        # pfsp (and every fallback): class-appropriate historical pool
        if isinstance(player, (MainExploiterPlayer,
                               AdaptiveEvolutionaryExploiterPlayer)):
            main_id = self._main_id_for(pid)
            pool = [hid for hid, p in hist.items() if p.parent_id == main_id]
            opp = self._pick_pfsp(pid, pool or list(hist.keys()))
        else:
            pool = [hid for hid, p in hist.items() if p.pipeline != "bot"]
            opp = self._pick_pfsp(pid, pool or list(hist.keys()))
        if opp is not None:
            return "pfsp", opp
        return "sp", player  # empty league: mirror-match bootstrap

    def ask_job(self, body: dict, now: Optional[float] = None) -> Optional[dict]:
        """PFSP matchmaking for one actor/learner ask. Returns the job dict
        (league ``_job_template`` layout + ``job_id``) or None for an
        unknown player — never raises, so the journaled record is always
        replayable."""
        ts = self._now(now)
        player_id = str(body.get("player_id") or "")
        with self._lock:
            self._prune_assignments_locked(ts)
            player = self.league.active_players.get(player_id)
            if player is None:
                return None
            probs = dict(self.league.cfg.branch_probs.get(
                type(player).__name__, {"pfsp": 1.0}))
            drawn = self._rng.choices(
                list(probs.keys()), weights=list(probs.values()), k=1)[0]
            branch, opponent = self._choose_opponent(player, drawn)
            job = self.league._job_template([player, opponent], branch)
            if branch == "vs_main":
                # the main is a frozen opponent: no teacher, no data
                for idx, p in enumerate((player, opponent)):
                    if isinstance(p, MainPlayer):
                        job["teacher_player_ids"][idx] = "none"
                        job["teacher_checkpoint_paths"][idx] = "none"
                job["send_data_players"] = [player_id]
            elif branch == "eval":
                job["teacher_player_ids"] = ["none", "none"]
                job["teacher_checkpoint_paths"] = ["none", "none"]
                job["send_data_players"] = []
            job["env_info"]["map_name"] = self._rng.choices(
                list(self.league.cfg.map_names),
                weights=list(self.league.cfg.map_id_weights), k=1)[0]
            self._job_seq += 1
            job_id = f"J{self._job_seq}"
            job["job_id"] = job_id
            self.assignments[job_id] = {
                "player_ids": list(job["player_ids"]),
                "branch": branch,
                "learner_id": str(body.get("learner_id", "")),
                "actor": str(body.get("actor", "")),
                "issued_ts": ts,
            }
            self.jobs_by_branch[branch] = self.jobs_by_branch.get(branch, 0) + 1
        _metrics().counter(
            "distar_league_jobs_dispatched_total",
            "league jobs handed to actors, by matchmaking branch",
            branch=branch).inc()
        self._publish_metrics(ts)
        return job

    def _prune_assignments_locked(self, ts: float) -> None:
        """Expire assignments older than ``job_ttl_s``. Runs only inside
        journaled routes with the record clock, so live and replay expire
        the same set — the no-orphaned-jobs invariant the drill checks."""
        dead = [jid for jid, a in self.assignments.items()
                if ts - a["issued_ts"] > self.job_ttl_s]
        for jid in dead:
            del self.assignments[jid]
        if dead:
            self.orphans_total += len(dead)
            _metrics().counter(
                "distar_league_orphaned_jobs_total",
                "job assignments expired without a report (dead actor)",
            ).inc(len(dead))

    # -------------------------------------------------------------- reporting
    def report(self, body: dict, now: Optional[float] = None) -> dict:
        """Complete one assignment and ingest its match records.

        The records are arena-format (idempotent ``key`` per episode) and
        are forwarded to the co-hosted ArenaStore in-process — one ledger,
        one dedup, and because the forward happens inside this journaled
        route, WAL replay re-ingests through the same path (the store's
        keys turn replays into exact dedups)."""
        from ...arena import get_arena_store

        ts = self._now(now)
        matches = list(body.get("matches") or [])
        job_id = str(body.get("job_id", ""))
        store = get_arena_store()
        arena = store.report_batch(matches) if store is not None \
            else {"applied": 0, "duplicates": 0}
        with self._lock:
            self._prune_assignments_locked(ts)
            completed = self.assignments.pop(job_id, None) is not None
            learner_id = str(body.get("learner_id", ""))
            if learner_id in self.learners:
                self.learners[learner_id]["last_seen"] = ts
            for rec in matches:
                key = str(rec.get("key", ""))
                if not key or key in self._seen:
                    continue
                self._seen[key] = None
                while len(self._seen) > self._seen_cap:
                    self._seen.popitem(last=False)
                self._ingest_league_payoff_locked(rec)
        self._publish_metrics(ts)
        return {"completed": completed, **arena}

    def _ingest_league_payoff_locked(self, rec: dict) -> None:
        """Mirror one match into the league-side payoff records (the
        is_trained_enough/vs_main-threshold inputs) — dedup'd by the same
        idempotent keys the arena uses."""
        home, away = str(rec.get("home", "")), str(rec.get("away", ""))
        winner = str(rec.get("winner", "draw"))
        stats = {"game_steps": float(rec.get("game_steps", 0.0)),
                 "game_iters": 0, "game_duration": float(rec.get("duration_s", 0.0))}
        wr_home = {"home": 1.0, "away": 0.0}.get(winner, 0.5)
        players = self.league.all_players
        if home in players and home != away:
            players[home].payoff.update(away, {"winrate": wr_home, **stats})
            players[home].total_game_count += 1
        if away in players and home != away:
            players[away].payoff.update(home, {"winrate": 1.0 - wr_home, **stats})
            players[away].total_game_count += 1

    # ---------------------------------------------------------------- minting
    def train_info(self, body: dict, now: Optional[float] = None) -> dict:
        """Learner progress ingest + snapshot minting + reset decision.

        Idempotent two ways: a per-player ``seq`` watermark makes the step
        accounting replay-safe under ambiguous-ack retries, and minting
        dedups on (player_id, generation_path) — the same checkpoint
        generation can never become two historical players."""
        ts = self._now(now)
        player_id = str(body.get("player_id") or "")
        with self._lock:
            self._prune_assignments_locked(ts)
            player = self.league.active_players.get(player_id)
            if player is None:
                return {"ok": False, "error": f"unknown player {player_id}"}
            seq = body.get("seq")
            if seq is not None:
                seq = int(seq)
                if seq <= self._train_seq.get(player_id, -1):
                    return {"ok": True, "duplicate": True}
                self._train_seq[player_id] = seq
            player.total_agent_step += int(body.get("train_steps", 0))
            if body.get("checkpoint_path"):
                player.checkpoint_path = str(body["checkpoint_path"])
            learner_id = str(body.get("learner_id", ""))
            if learner_id in self.learners:
                self.learners[learner_id]["last_seen"] = ts
            reply: dict = {"ok": True, "minted": False}
            gen = str(body.get("generation_path") or "")
            if gen:
                mint_key = f"{player_id}|{gen}"
                snap_id = self._minted.get(mint_key)
                if snap_id is not None:
                    reply["snapshot_id"] = snap_id
                else:
                    snap = player.snapshot()
                    snap.checkpoint_path = gen  # mint from the recorded
                    # CheckpointManager generation, not the name heuristic
                    self.league.historical_players[snap.player_id] = snap
                    self._minted[mint_key] = snap.player_id
                    reply.update(minted=True, snapshot_id=snap.player_id)
                    _metrics().counter(
                        "distar_league_snapshot_mints_total",
                        "historical players minted from checkpoint generations",
                    ).inc()
                    if self._should_reset(player):
                        reset_path = player.teacher_checkpoint_path
                        if reset_path and reset_path != "none":
                            player.reset_payoff()
                            player.checkpoint_path = reset_path
                            reply["reset_checkpoint_path"] = reset_path
        self._publish_metrics(ts)
        return reply

    def _should_reset(self, player: ActivePlayer) -> bool:
        """Deterministic re-spawn policy (the player classes' own is_reset
        draws from np.random/module random — unusable under WAL replay):
        main exploiters always restart after a snapshot, exploiters with
        the configured probability from the service RNG, mains never."""
        if isinstance(player, (MainExploiterPlayer,
                               AdaptiveEvolutionaryExploiterPlayer)):
            return True
        if isinstance(player, ExploiterPlayer):
            return self._rng.random() < ExploiterPlayer.reset_prob
        return False

    # ------------------------------------------------------------ reassignment
    def note_reassignment(self, n: int = 1) -> None:
        with self._lock:
            self.reassignments_total += int(n)
        _metrics().counter(
            "distar_league_reassignments_total",
            "elastic actor moves between learners (payoff-driven)",
        ).inc(int(n))

    # ----------------------------------------------------------------- status
    def status(self, body: Optional[dict] = None, now: Optional[float] = None) -> dict:
        """Read-only digest (``GET /league/status`` / ``opsctl league``).
        Ephemeral route: must not mutate — expiry here would diverge the
        replica from the journal."""
        ts = self._now(now)
        with self._lock:
            frozen = self._frozen_players_locked(ts)
            learners = {
                lid: {**e, "age_s": max(0.0, ts - e["last_seen"]),
                      "fresh": ts - e["last_seen"] <= self.lease_s}
                for lid, e in self.learners.items()
            }
            active = sum(1 for e in learners.values() if e["fresh"])
            snap = {
                "active_learners": active,
                "registered_learners": len(self.learners),
                "frozen_players": frozen,
                "learners": learners,
                "active_players": sorted(self.league.active_players),
                "historical_players": sorted(self.league.historical_players),
                "assignments_pending": len(self.assignments),
                "assignments": {
                    jid: dict(a) for jid, a in self.assignments.items()},
                "jobs_by_branch": dict(self.jobs_by_branch),
                "snapshot_mints": len(self._minted),
                "minted": dict(self._minted),
                "orphaned_jobs": self.orphans_total,
                "reassignments": self.reassignments_total,
                "lease_s": self.lease_s,
                "job_ttl_s": self.job_ttl_s,
            }
        self._publish_metrics(ts)
        return snap

    def _publish_metrics(self, ts: float) -> None:
        reg = _metrics()
        with self._lock:
            fresh = sum(1 for e in self.learners.values()
                        if ts - e["last_seen"] <= self.lease_s)
            frozen = len(self._frozen_players_locked(ts))
            pending = len(self.assignments)
        reg.gauge("distar_league_active_learners",
                  "learners with a fresh lease (registered and heartbeating)",
                  ).set(fresh)
        reg.gauge("distar_league_frozen_players",
                  "league players whose every learner lease lapsed",
                  ).set(frozen)
        reg.gauge("distar_league_assignments_pending",
                  "dispatched jobs awaiting a result report").set(pending)

    # ------------------------------------------------------------- durability
    def _runtime_state(self) -> dict:
        """The runtime leg (roster, assignment map, mint lineage, RNG
        cursor) — embedded in both ``state_blob`` and, via the attached
        hooks, ``League.save_resume``."""
        return {
            "seed": self._seed,
            "rng": self._rng.getstate(),
            "learners": {k: dict(v) for k, v in self.learners.items()},
            "assignments": {k: dict(v) for k, v in self.assignments.items()},
            "minted": list(self._minted.items()),
            "train_seq": dict(self._train_seq),
            "seen": list(self._seen.keys()),
            "job_seq": self._job_seq,
            "jobs_by_branch": dict(self.jobs_by_branch),
            "orphans_total": self.orphans_total,
            "reassignments_total": self.reassignments_total,
        }

    def _load_runtime_state(self, data: dict) -> None:
        self._seed = int(data.get("seed", self._seed))
        self._rng.setstate(data["rng"])
        self.learners = {k: dict(v) for k, v in data["learners"].items()}
        self.assignments = {k: dict(v) for k, v in data["assignments"].items()}
        self._minted = OrderedDict(data["minted"])
        self._train_seq = dict(data["train_seq"])
        self._seen = OrderedDict((k, None) for k in data.get("seen", []))
        self._job_seq = int(data["job_seq"])
        self.jobs_by_branch = dict(data["jobs_by_branch"])
        self.orphans_total = int(data["orphans_total"])
        self.reassignments_total = int(data["reassignments_total"])

    def state_blob(self) -> dict:
        """Detached full state — the HA snapshot payload (third leg next to
        the coordinator and arena blobs). Pickle round-trip detaches live
        player objects so later matches can't mutate a handed-out snapshot."""
        with self._lock:
            blob = {
                "league": {
                    "active_players": self.league.active_players,
                    "historical_players": self.league.historical_players,
                    "elo": self.league.elo,
                    "trueskill": self.league.trueskill,
                    "learners": {k: list(v)
                                 for k, v in self.league._learners.items()},
                },
                "runtime": self._runtime_state(),
            }
            return pickle.loads(pickle.dumps(blob))

    def load_state(self, data: dict) -> None:
        with self._lock:
            lg = data["league"]
            self.league.active_players = lg["active_players"]
            self.league.historical_players = lg["historical_players"]
            self.league.elo = lg["elo"]
            self.league.trueskill = lg["trueskill"]
            self.league._learners = {k: list(v)
                                     for k, v in lg.get("learners", {}).items()}
            self._load_runtime_state(data["runtime"])

    def state_digest(self) -> dict:
        """Timestamp-free structural digest for replica comparison (the
        chaos drill's equality check): wall-clock skew between a live
        dispatch and its journal record is real but meaningless; roster,
        lineage, assignments, counters and the RNG cursor must be exact."""
        with self._lock:
            return {
                "active_players": {
                    pid: {"ckpt": p.checkpoint_path,
                          "step": p.total_agent_step,
                          "snapshots": p.snapshot_times}
                    for pid, p in sorted(self.league.active_players.items())},
                "historical_players": {
                    pid: {"ckpt": p.checkpoint_path, "parent": p.parent_id}
                    for pid, p in sorted(self.league.historical_players.items())},
                "learners": sorted(
                    (lid, e["player_id"]) for lid, e in self.learners.items()),
                "assignments": sorted(
                    (jid, a["branch"], tuple(a["player_ids"]))
                    for jid, a in self.assignments.items()),
                "minted": sorted(self._minted.items()),
                "train_seq": dict(sorted(self._train_seq.items())),
                "job_seq": self._job_seq,
                "jobs_by_branch": dict(sorted(self.jobs_by_branch.items())),
                "orphans_total": self.orphans_total,
                "rng": hash(self._rng.getstate()),
            }


# --------------------------------------------------------------- process-global
_SERVICE: Optional[LeagueService] = None
_SERVICE_LOCK = threading.Lock()


def set_league_service(service: Optional[LeagueService]) -> None:
    global _SERVICE
    with _SERVICE_LOCK:
        _SERVICE = service


def get_league_service() -> Optional[LeagueService]:
    with _SERVICE_LOCK:
        return _SERVICE

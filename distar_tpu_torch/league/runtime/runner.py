"""League runtime launchers: N concurrent learners under one matchmaker.

Counterpart of ``distar_tpu.league.runtime.runner``. Two halves, matching
the two processes of a league deployment:

* :class:`LeagueLearnerLoop` — the per-process training loop a
  ``rl_train --type league-learner`` hosts. One league player, one
  independent learner (own device, own ``CheckpointManager`` role-key
  lineage), one fused Anakin rollout with the **away seat** carrying the
  opponent the matchmaker picked. Per round: ask a job, resolve the
  opponent model from the job's checkpoint path, train, report the
  finished episodes under idempotent match keys, record a checkpoint
  generation, and stream train-info (which is where historical snapshots
  get minted server-side).
* :class:`LeagueRunner` — the ``rl_train --type league-run`` parent: hosts
  the coordinator (LeagueService + ArenaStore) in process, spawns one
  learner subprocess per active player, and summarises the economy
  (payoff matrix, mints, jobs-by-branch) on exit.

Departures from the JAX package: the opponent slot holds a model, not a
parameter tree (ROADMAP Queue 3 item 18); the coordinator's HA journal
(``journal_dir``) and the actor-slot fleets (``build_actor_fleets``) raise
naming their ROADMAP Queue 1 items, 11 and 10.

Model publication rides the existing serving surface: a
:class:`LeaguePublisher` pushes every new checkpoint generation into the
per-player gateway behind a ``GatewayMux`` — the wire ``player`` field the
mux already routes by is exactly the league player id, so actors pinned to
a player always sample against that player's latest generation.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence

#: default league roster for a small self-play economy: one main agent and
#: two exploiter classes (the three-learner quickstart in docs/league.md)
DEFAULT_PLAYERS = ("MP0", "EP0", "ME0")

_FLEET_ITEM = ("actor-slot fleets need fleet/supervisor.py, which is not ported yet "
               "(ROADMAP Queue 1 item 10)")
_HA_ITEM = ("the league-run journal needs the coordinator's HA (comm/ha.py), which is not "
            "ported yet (ROADMAP Queue 1 item 11)")


def league_cfg(player_ids: Sequence[str],
               teacher_path: str = "none") -> dict:
    """A League config whose roster is exactly ``player_ids``, cold-started
    (empty checkpoint paths — learners publish real generations as they
    train). The default historical seed players are disabled: history grows
    only from minted snapshots, so the payoff matrix is all real matches."""
    ids = list(player_ids)
    n = len(ids)
    return {"league": {
        "use_historical_players": False,
        "save_initial_snapshot": True,
        "active_players": {
            "player_id": ids,
            "checkpoint_path": [""] * n,
            "pipeline": ["default"] * n,
            "frac_id": [1] * n,
            "z_path": ["3map.json"] * n,
            "z_prob": [0.0] * n,
            "teacher_id": ["none"] * n,
            "teacher_path": [teacher_path] * n,
            "one_phase_step": [1e9] * n,
            "chosen_weight": [1.0] * n,
        },
    }}


class LeaguePublisher:
    """Per-player model publication through the ``GatewayMux`` player field.

    Every published generation loads into the named player's own
    ``ModelRegistry`` and activates (the gateway's zero-downtime hot swap);
    an unknown player is a no-op — a league can mint players faster than
    the serving fleet reconfigures, and publication must never stall the
    training loop for it."""

    def __init__(self, mux) -> None:
        self.mux = mux
        self.published: Dict[str, str] = {}  # player_id -> last version

    def publish(self, player_id: str, version: str,
                checkpoint_path: str) -> bool:
        from ...serve.errors import UnknownPlayerError

        try:
            gateway = self.mux.resolve(player_id)
        except (KeyError, UnknownPlayerError):
            return False
        gateway.registry.load(version, source=checkpoint_path, activate=True)
        self.published[player_id] = version
        return True


class LeagueLearnerLoop:
    """One league learner: matchmade self-play rounds over a fused rollout.

    ``remote`` is a :class:`~..remote.RemoteLeagueService`; ``learner`` a
    constructed RLLearner whose dataloader is ``loader`` (an
    ``AnakinDataLoader`` over an ``opponent_seat=True`` runner, its
    ``opponent_provider`` wired to :meth:`opponent_model`). The loop owns
    the opponent slot: each job re-resolves it from the job's away-seat
    checkpoint path (the learner's own live model for true self-play, a
    port ``Model`` loaded once per job for a frozen snapshot or main, None
    for unpublished players: the loader's frozen copy of the initial
    policy).
    """

    def __init__(self, player_id: str, remote, learner, loader,
                 rounds: int = 2, iters_per_round: int = 1,
                 eval_windows: int = 3, publisher=None,
                 learner_id: str = ""):
        self.player_id = player_id
        self.remote = remote
        self.learner = learner
        self.loader = loader
        self.rounds = int(rounds)
        self.iters_per_round = int(iters_per_round)
        self.eval_windows = int(eval_windows)
        self.publisher = publisher
        self.learner_id = learner_id or f"{player_id}@{os.getpid()}"
        self._opp_resolver = None  # () -> the away seat's model, or None
        self._opp_lock = threading.Lock()
        self.jobs_done = 0
        self.mints = 0

    # ---------------------------------------------------------- opponent slot
    def opponent_model(self):
        """The away seat's model — the loader's ``opponent_provider``.
        None (before the first job / for never-published opponents) lets
        the loader fall back to its frozen copy of the initial policy. The
        slot holds a resolver, called every window: live self-play's reads
        the learner's model then."""
        with self._opp_lock:
            resolver = self._opp_resolver
        return resolver() if resolver is not None else None

    def _live_model(self):
        return getattr(self.learner, "model", None)

    def _resolve_opponent(self, job: dict) -> str:
        away = str(job["player_ids"][1])
        path = str(job["checkpoint_paths"][1] or "")
        resolver = None
        if away == self.player_id:
            # live self-play: read the learner's model at every rollout
            # window, so the away seat follows its updates
            resolver = self._live_model
        elif path and os.path.exists(path):
            from ...model.convert import frozen_model

            frozen = frozen_model(self.learner.model.cfg, path, self.learner.device)  # once a job
            resolver = lambda: frozen  # noqa: E731
        with self._opp_lock:
            self._opp_resolver = resolver
        return away

    # ---------------------------------------------------------------- matches
    def _matches_for(self, job: dict, away: str) -> List[dict]:
        results = self.loader.drain_results()
        return [{
            "key": f"{job['job_id']}e{i}",
            "home": self.player_id,
            "away": away,
            "round": 0,
            "winner": r["winner"],
            "game_steps": float(r["steps"]),
            "duration_s": 0.0,
        } for i, r in enumerate(results)]

    # ------------------------------------------------------------------- run
    def run_round(self, seq: int) -> dict:
        """One matchmade round: ask -> train (or eval-rollout) -> report ->
        checkpoint generation -> train-info. Returns a round summary."""
        job = self.remote.ask_job(self.player_id, learner_id=self.learner_id)
        if not job:
            return {"job": None}
        away = self._resolve_opponent(job)
        branch = job.get("branch", "")
        if branch == "eval":
            # evaluation matches: rollout windows only, no optimizer steps
            # (the job's send_data_players is empty by construction)
            for _ in range(self.eval_windows):
                next(self.loader)
        else:
            target = self.learner.last_iter.val + self.iters_per_round
            self.learner.run(max_iterations=target)
        matches = self._matches_for(job, away)
        # short rounds can end mid-episode: roll a few extra windows so the
        # round reports real outcomes and the payoff matrix fills from
        # actual matches
        for _ in range(self.eval_windows):
            if matches:
                break
            next(self.loader)
            matches = self._matches_for(job, away)
        self.remote.report(job["job_id"], matches, learner_id=self.learner_id)
        self.jobs_done += 1

        path = os.path.join(
            self.learner.save_dir, "checkpoints",
            f"{self.player_id}_iteration_{self.learner.last_iter.val}.ckpt")
        self.learner.save(path, sync=True)
        gens = self.learner.checkpoint_manager.generations()
        gen_path = gens[0]["path"] if gens else path
        reply = self.remote.train_info(
            self.player_id, seq=seq,
            train_steps=self.iters_per_round if branch != "eval" else 0,
            checkpoint_path=gen_path, generation_path=gen_path,
            learner_id=self.learner_id)
        if reply.get("minted"):
            self.mints += 1
        if self.publisher is not None:
            self.publisher.publish(self.player_id, f"gen{seq}", gen_path)
        reset = str(reply.get("reset_checkpoint_path") or "")
        if reset and os.path.exists(reset):
            # exploiter re-spawn: the service snapshotted us and rolled the
            # lineage back to the teacher checkpoint
            self.learner.restore(reset)
        return {"job": job["job_id"], "branch": branch, "away": away,
                "matches": len(matches), "minted": bool(reply.get("minted"))}

    def run(self) -> dict:
        reply = self.remote.register_learner(
            self.player_id, learner_id=self.learner_id)
        if not reply.get("registered"):
            raise RuntimeError(f"league rejected {self.player_id}: {reply}")
        ckpt = str(reply.get("checkpoint_path") or "")
        if ckpt and os.path.exists(ckpt):
            self.learner.restore(ckpt)
        # continue the train-info numbering past the service's watermark so
        # a supervised restart doesn't replay into the duplicate filter
        base = int(reply.get("train_seq", -1)) + 1
        summaries = []
        for i in range(1, self.rounds + 1):
            out = self.run_round(base + i - 1)
            summaries.append(out)
            # analysis: allow(no-print) — per-round progress on the league-learner subprocess's stdout, read by the league-run parent and operators tailing the child
            print(f"league-learner {self.player_id}: round {i}/{self.rounds}"
                  f" {out}", flush=True)
        return {"player_id": self.player_id, "rounds": summaries,
                "jobs": self.jobs_done, "mints": self.mints,
                "iters": self.learner.last_iter.val}


# --------------------------------------------------------------------- fleet
def league_actor_cmd(player_id: str, coordinator: str = ""):
    """Member command for a league actor-slot fleet (``kind="actor"``).

    The smoke/capacity member: prints the standard ready line and holds
    a seat until drained (stdin close / terminate). A real distributed
    deployment swaps this build_cmd for ``rl_train --type actor`` with the
    player's plane address."""
    code = (
        "import sys\n"
        "print('LEAGUE-ACTOR 127.0.0.1 0 player=%s', flush=True)\n"
        "sys.stdin.read()\n" % player_id
    )

    def build(index: int) -> List[str]:
        return [sys.executable, "-u", "-c", code]

    return build


def build_actor_fleets(player_ids: Sequence[str], actors_per_player: int = 1,
                       coordinator: str = "", min_actors: int = 1):
    """The JAX package's actor-slot fleets under a ``FleetSupervisor``: the
    supervisor is ROADMAP Queue 1 item 10, so this raises."""
    raise NotImplementedError(_FLEET_ITEM)


# -------------------------------------------------------------------- runner
class LeagueRunner:
    """The league-run parent process: coordinator + matchmaker + N learners.

    Hosts the :class:`~.service.LeagueService` (and an ``ArenaStore``)
    inside a ``CoordinatorServer``. Learner subprocesses are spawned
    through ``python -m distar_tpu_torch.bin.rl_train --type
    league-learner`` (one per active player, each its own process on the
    card) and awaited; ``run()`` returns the final digest and prints it.
    ``journal_dir`` (the JAX package's HA journal) and
    ``actors_per_player`` above 0 raise naming ROADMAP Queue 1 items 11 and
    10.
    """

    def __init__(self, player_ids: Sequence[str] = DEFAULT_PLAYERS,
                 save_path: str = "", journal_dir: str = "",
                 arena_store_path: str = "", seed: int = 0,
                 lease_s: float = 30.0, job_ttl_s: float = 180.0,
                 learner_argv_extra: Optional[List[str]] = None,
                 rounds: int = 2, iters_per_round: int = 1,
                 actors_per_player: int = 0, reassign: bool = False,
                 env: Optional[dict] = None):
        if journal_dir:
            raise NotImplementedError(f"LeagueRunner(journal_dir=...): {_HA_ITEM}")
        if int(actors_per_player) > 0:
            raise NotImplementedError(f"LeagueRunner(actors_per_player > 0): {_FLEET_ITEM}")
        self.player_ids = list(player_ids)
        self.save_path = save_path
        self.arena_store_path = arena_store_path
        self.seed = int(seed)
        self.lease_s = float(lease_s)
        self.job_ttl_s = float(job_ttl_s)
        self.learner_argv_extra = list(learner_argv_extra or [])
        self.rounds = int(rounds)
        self.iters_per_round = int(iters_per_round)
        self.env = dict(env) if env else None
        self.server = None
        self.store = None
        self.service = None
        self.procs: Dict[str, subprocess.Popen] = {}
        self.learner_s: Dict[str, float] = {}  # spawn to exit, per player

    # ----------------------------------------------------------- control plane
    def start_control_plane(self, port: int = 0) -> str:
        """Coordinator + ArenaStore + LeagueService. Returns the address
        learners connect to."""
        from ...arena import ArenaStore, set_arena_store
        from ...comm import Coordinator, CoordinatorServer
        from .service import LeagueService, set_league_service

        self.store = ArenaStore(path=self.arena_store_path or None)
        if self.arena_store_path:
            self.store.maybe_load()
        set_arena_store(self.store)
        self.service = LeagueService(
            league_cfg(self.player_ids), seed=self.seed,
            lease_s=self.lease_s, job_ttl_s=self.job_ttl_s)
        set_league_service(self.service)
        self.server = CoordinatorServer(coordinator=Coordinator(), port=port)
        self.server.start()
        addr = f"127.0.0.1:{self.server.port}"
        # analysis: allow(no-print) — launcher stdout: the address line operators read to reach the control plane
        print(f"league-run control plane on {addr} (journal=off)", flush=True)
        return addr

    # --------------------------------------------------------------- learners
    def _learner_cmd(self, player_id: str, addr: str) -> List[str]:
        return [
            sys.executable, "-u", "-m", "distar_tpu_torch.bin.rl_train",
            "--type", "league-learner",
            "--player-id", player_id,
            "--coordinator-addr", addr,
            "--league-rounds", str(self.rounds),
            "--league-iters-per-round", str(self.iters_per_round),
            *(["--save-path", self.save_path] if self.save_path else []),
            *self.learner_argv_extra,
        ]

    def _learner_env(self) -> dict:
        """The learners' environment (``env``, else this process's) with
        each learner's intra-op threads set to its share of the host's
        cores where ``OMP_NUM_THREADS`` is not given: N learner processes
        of a thread per core each would load every core N times over."""
        env = dict(self.env if self.env is not None else os.environ)
        if "OMP_NUM_THREADS" not in env:
            cores = len(os.sched_getaffinity(0))
            env["OMP_NUM_THREADS"] = str(max(1, cores // max(1, len(self.player_ids))))
        return env

    def spawn_learners(self, addr: str) -> None:
        self._t_spawn = {}
        env = self._learner_env()
        for pid in self.player_ids:
            self._t_spawn[pid] = time.monotonic()
            self.procs[pid] = subprocess.Popen(self._learner_cmd(pid, addr), env=env)
            # analysis: allow(no-print) — launcher stdout: pid lines operators use to target kills
            print(f"league-run: spawned learner {pid} "
                  f"(pid {self.procs[pid].pid})", flush=True)

    def wait_learners(self, timeout_s: float = 1800.0) -> Dict[str, int]:
        """Each learner's exit code (-9 past ``timeout_s``, then killed);
        ``learner_s`` gets each one's seconds from spawn to exit."""
        deadline = time.monotonic() + timeout_s
        codes: Dict[str, int] = {}
        pending = dict(self.procs)
        while pending:
            for pid, proc in list(pending.items()):
                rc = proc.poll()
                if rc is not None:
                    codes[pid] = rc
                    self.learner_s[pid] = time.monotonic() - self._t_spawn[pid]
                    del pending[pid]
            if pending and time.monotonic() > deadline:
                for pid, proc in pending.items():
                    proc.kill()
                    proc.wait()
                    codes[pid] = -9
                break
            time.sleep(0.05)
        return {pid: codes[pid] for pid in self.procs}

    # -------------------------------------------------------------------- run
    def run(self, port: int = 0, timeout_s: float = 1800.0) -> dict:
        addr = self.start_control_plane(port=port)
        try:
            self.spawn_learners(addr)
            codes = self.wait_learners(timeout_s=timeout_s)
            status = self.service.status()
            payoff = self.store.payoff_snapshot()
            off_diag = sum(
                1 for cell in payoff.get("cells", [])
                if cell.get("a") != cell.get("b")
                and cell.get("games", 0) > 0)
            digest = {
                "learner_rc": codes,
                "jobs_by_branch": status["jobs_by_branch"],
                "snapshot_mints": status["snapshot_mints"],
                "historical_players": status["historical_players"],
                "assignments_pending": status["assignments_pending"],
                "orphaned_jobs": status["orphaned_jobs"],
                "off_diagonal_pairs": off_diag,
                "matches_total": self.store.matches_total,
                "reassign_moves": {},
            }
            ok = (all(c == 0 for c in codes.values())
                  and status["snapshot_mints"] >= 1
                  and off_diag >= 1)
            digest["ok"] = ok
            # analysis: allow(no-print) — the machine-parseable verdict line the acceptance harness greps for
            print("LEAGUE-RUN-DONE " + json.dumps(digest), flush=True)
            return digest
        finally:
            self.shutdown()

    def shutdown(self) -> None:
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if self.arena_store_path and self.store is not None:
            self.store.save()
        if self.server is not None:
            self.server.stop()
            self.server = None
        from ...arena import set_arena_store
        from .service import set_league_service

        set_arena_store(None)
        set_league_service(None)

"""League manager: player registry, matchmaking, payoff/ELO bookkeeping,
snapshot/reset decisions, resume.

Counterpart of ``distar_tpu.league.league``. ``load_resume`` also reads a
resume file the JAX package wrote (``utils.pickles``).

Role parity with the reference League (reference: distar/ctools/worker/
league/league.py:30-556): learners register and stream train-info (driving
snapshot/reset decisions, :259-297); actors ask for jobs (PFSP matchmaking,
:394-486) and send results (payoff + ELO ingestion, :313-384). The HTTP
surface lives in api.py; this class is transport-agnostic and fully
deterministic given its RNG, so league logic is unit-testable without any
game (the simulation tests the reference lacks).
"""
from __future__ import annotations

import itertools
import os
import pickle
import random
import threading
import time
from typing import Dict, List, Optional

from ..utils import Config, deep_merge_dicts
from .elo import ELORating
from .trueskill import TrueSkill
from .player import (
    ActivePlayer,
    HistoricalPlayer,
    MainPlayer,
    Player,
    active_player_type,
)

LEAGUE_DEFAULTS = Config(
    {
        "league": {
            "use_historical_players": True,
            "vs_bot": False,
            "pfsp_train_bot": False,
            "save_initial_snapshot": True,
            "bot_probs": [0, 0, 0, 0.2, 0.2, 0.3, 0.3],
            "branch_probs": {
                "MainPlayer": {"sp": 0.5, "pfsp": 0.5},
                "ExploiterPlayer": {"pfsp": 1.0},
                "MainExploiterPlayer": {"vs_main": 0.3, "pfsp": 0.5, "eval": 0.2},
                "ExpertPlayer": {"pfsp": 1.0},
                "ExpertExploiterPlayer": {"pfsp": 1.0},
                "AdaptiveEvolutionaryExploiterPlayer": {"vs_main": 0.5, "pfsp": 0.5},
            },
            "map_names": ["KairosJunction"],
            "map_id_weights": [1],
            "stat_decay": 0.995,
            "stat_warm_up_size": 1000,
            "payoff_min_win_rate_games": 1000,
            "print_freq": 100,
            "save_resume_freq_s": 3600,
            "active_players": {
                "player_id": ["MP0"],
                "checkpoint_path": ["pretrain.ckpt"],
                "pipeline": ["default"],
                "frac_id": [1],
                "z_path": ["3map.json"],
                "z_prob": [0.0],
                "teacher_id": ["teacher"],
                "teacher_path": ["pretrain.ckpt"],
                "one_phase_step": [1e9],
                "chosen_weight": [1.0],
            },
            "historical_players": {
                "player_id": ["HP0"],
                "checkpoint_path": ["pretrain.ckpt"],
                "pipeline": ["default"],
                "frac_id": [1],
                "z_path": ["3map.json"],
                "z_prob": [0.0],
            },
        }
    }
)


class League:
    def __init__(self, cfg: Optional[dict] = None, logger=None):
        whole = deep_merge_dicts(LEAGUE_DEFAULTS, cfg or {})
        self.cfg = whole.league
        self.logger = logger
        self.active_players: Dict[str, ActivePlayer] = {}
        self.historical_players: Dict[str, HistoricalPlayer] = {}
        self.elo = ELORating()
        self.trueskill = TrueSkill()
        self._lock = threading.RLock()
        self._learners: Dict[str, List[dict]] = {}
        # runtime attachment (league/runtime/service.py): when a
        # LeagueService hosts this league, its roster/assignment/mint state
        # rides save_resume/load_resume so one journal carries everything
        self._runtime_state_fn = None
        self._runtime_load_fn = None
        if self.cfg.get("resume_path") and os.path.isfile(self.cfg.resume_path):
            self.load_resume(self.cfg.resume_path)
        else:
            self._init_players()

    # ------------------------------------------------------------------ init
    def _log(self, msg: str) -> None:
        if self.logger is not None:
            self.logger.info(msg)

    def _init_players(self) -> None:
        ap = self.cfg.active_players
        n = len(ap.player_id)

        def col(name, default):
            vals = ap.get(name)
            return vals if vals is not None else [default] * n

        for i in range(n):
            self.add_active_player(
                player_id=ap.player_id[i],
                checkpoint_path=ap.checkpoint_path[i],
                pipeline=col("pipeline", "default")[i],
                frac_id=col("frac_id", 1)[i],
                z_path=col("z_path", "3map.json")[i],
                z_prob=col("z_prob", 0.0)[i],
                teacher_id=col("teacher_id", "none")[i],
                teacher_path=col("teacher_path", "none")[i],
                one_phase_step=col("one_phase_step", 1e9)[i],
                chosen_weight=col("chosen_weight", 1.0)[i],
            )
        if self.cfg.save_initial_snapshot:
            # seed history with a snapshot of every active player so
            # parent-matched pfsp branches (ME/AE) have opponents from the
            # start (reference league.py:162-189)
            for player in list(self.active_players.values()):
                snap = player.snapshot()
                self.historical_players[snap.player_id] = snap
        if self.cfg.use_historical_players:
            hp = self.cfg.historical_players
            ids = hp.get("player_id") or [f"HP{i}" for i in range(len(hp.checkpoint_path))]
            for i, pid in enumerate(ids):
                self.historical_players[pid] = HistoricalPlayer(
                    hp.checkpoint_path[i],
                    pid,
                    pipeline=hp.pipeline[i],
                    frac_id=hp.frac_id[i],
                    z_path=hp.z_path[i],
                    z_prob=hp.get("z_prob", [0.0] * len(ids))[i],
                    decay=self.cfg.stat_decay,
                    warm_up_size=self.cfg.stat_warm_up_size,
                    min_win_rate_games=self.cfg.payoff_min_win_rate_games,
                )

    def add_active_player(self, player_id: str, checkpoint_path: str, pipeline="default",
                          frac_id=1, z_path="3map.json", z_prob=0.0, teacher_id="none",
                          teacher_path="none", one_phase_step=1e9, chosen_weight=1.0) -> None:
        cls = active_player_type(player_id)
        if cls is None:
            raise ValueError(
                f"unknown active player type for id {player_id} "
                f"(expected prefix MP/ME/EP/EX/AE/XP)"
            )
        self.active_players[player_id] = cls(
            checkpoint_path,
            player_id,
            pipeline=pipeline,
            frac_id=frac_id,
            z_path=z_path,
            z_prob=z_prob,
            teacher_id=teacher_id,
            teacher_checkpoint_path=teacher_path,
            decay=self.cfg.stat_decay,
            warm_up_size=self.cfg.stat_warm_up_size,
            min_win_rate_games=self.cfg.payoff_min_win_rate_games,
            one_phase_step=int(float(one_phase_step)),
            chosen_weight=chosen_weight,
        )

    def remove_player(self, player_id: str) -> bool:
        with self._lock:
            return (
                self.active_players.pop(player_id, None) is not None
                or self.historical_players.pop(player_id, None) is not None
            )

    @property
    def all_players(self) -> Dict[str, Player]:
        return {**self.active_players, **self.historical_players}

    # --------------------------------------------------------------- learner
    def register_learner(self, player_id: str, ip: str = "", port: int = 0, rank: int = 0,
                         world_size: int = 1) -> dict:
        with self._lock:
            player = self.active_players[player_id]
            self._learners.setdefault(player_id, []).append(
                {"ip": ip, "port": port, "rank": rank, "world_size": world_size}
            )
            return {"checkpoint_path": player.checkpoint_path}

    def learner_send_train_info(self, player_id: str, train_steps: int,
                                checkpoint_path: Optional[str] = None) -> dict:
        """Ingest learner progress; decide snapshot and/or live reset
        (reference league.py:259-297). Returns {} or
        {'reset_checkpoint_path': path} which the learner applies in place."""
        with self._lock:
            player = self.active_players[player_id]
            player.total_agent_step += int(train_steps)
            if checkpoint_path:
                player.checkpoint_path = checkpoint_path
            reply: dict = {}
            if player.is_trained_enough(
                self.historical_players, self.active_players, self.cfg.pfsp_train_bot
            ):
                snap = player.snapshot()
                self.historical_players[snap.player_id] = snap
                self._log(f"snapshot: {snap.player_id} @ step {player.total_agent_step}")
                if player.is_reset():
                    reset_path = player.reset_checkpoint(
                        self.active_players, self.historical_players, snap.player_id
                    )
                    player.reset_payoff()
                    player.checkpoint_path = reset_path
                    reply["reset_checkpoint_path"] = reset_path
                    self._log(f"reset {player_id} -> {reset_path}")
            return reply

    # ----------------------------------------------------------------- actor
    def choose_active_player(self) -> ActivePlayer:
        ids = list(self.active_players.keys())
        weights = [self.active_players[i].chosen_weight for i in ids]
        return self.active_players[random.choices(ids, weights=weights, k=1)[0]]

    def actor_ask_for_job(self, request: Optional[dict] = None) -> dict:
        request = request or {"job_type": "train"}
        job_type = request.get("job_type", "train")
        with self._lock:
            if job_type == "eval":
                job = self._eval_job()
            elif self.cfg.vs_bot:
                job = self._vs_bot_job(self.choose_active_player())
            else:
                job = self._train_job(self.choose_active_player())
            job["env_info"]["map_name"] = random.choices(
                list(self.cfg.map_names), weights=list(self.cfg.map_id_weights), k=1
            )[0]
            return job

    def _job_template(self, players: List[Player], branch: str) -> dict:
        return {
            "branch": branch,
            "player_ids": [p.player_id for p in players],
            "side_ids": list(range(len(players))),
            "pipelines": [p.pipeline for p in players],
            "checkpoint_paths": [p.checkpoint_path for p in players],
            "successive_ids": [
                p.player_id if isinstance(p, MainPlayer) else "none" for p in players
            ],
            "z_path": [p.z_path for p in players],
            "z_prob": [p.z_prob for p in players],
            "teacher_player_ids": [p.teacher_id for p in players],
            "teacher_checkpoint_paths": [p.teacher_checkpoint_path for p in players],
            "send_data_players": sorted(
                {p.player_id for p in players if isinstance(p, ActivePlayer)}
            ),
            "update_players": sorted(
                {p.player_id for p in players if isinstance(p, ActivePlayer)}
            ),
            "frac_ids": [p.frac_id for p in players],
            "env_info": {
                "player_ids": [p.player_id for p in players],
                "side_id": list(range(len(players))),
            },
        }

    def _train_job(self, player: ActivePlayer) -> dict:
        branch, home, away = player.get_branch_opponent(
            self.historical_players, self.active_players, self.cfg.branch_probs,
            self.cfg.pfsp_train_bot,
        )
        players = list(itertools.chain.from_iterable(zip(home, away)))
        job = self._job_template(players, branch)
        if branch == "vs_main":
            # the main player is frozen opponent here: no teacher, no data
            for idx, p in enumerate(players):
                if isinstance(p, MainPlayer):
                    job["teacher_player_ids"][idx] = "none"
                    job["teacher_checkpoint_paths"][idx] = "none"
            job["send_data_players"] = sorted(
                {
                    p.player_id
                    for p in players
                    if isinstance(p, ActivePlayer) and not isinstance(p, MainPlayer)
                }
            )
        elif "eval" in branch:
            job["teacher_player_ids"] = ["none"] * len(players)
            job["teacher_checkpoint_paths"] = ["none"] * len(players)
            job["send_data_players"] = []
        return job

    def _vs_bot_job(self, player: ActivePlayer) -> dict:
        bot_probs = list(self.cfg.bot_probs)
        bot_level = random.choices(range(len(bot_probs)), weights=bot_probs, k=1)[0]
        job = self._job_template([player], "train_bot")
        job["bot_id"] = f"bot{bot_level}"
        job["env_info"]["player_ids"] = [player.player_id, f"bot{bot_level}"]
        job["env_info"]["side_id"] = [0, 1]
        return job

    def _eval_job(self) -> dict:
        """Ladder pairing: prefer pairs with fewer recorded games than
        ladder_min_games so the payoff/rating matrix fills evenly
        (reference _get_ladder_job_info, league.py:486+)."""
        hist = list(self.historical_players.values())
        if len(hist) < 2:
            pair = hist * 2
        else:
            min_games = int(self.cfg.get("ladder_min_games", 100))
            # .get-based reads: indexing the nested defaultdicts would
            # materialise zero entries for every pair on every eval job
            games = self.elo.games
            under = [
                (a, b)
                for a in hist
                for b in hist
                if a.player_id != b.player_id
                and games.get(a.player_id, {}).get(b.player_id, 0) < min_games
            ]
            pair = list(random.choice(under)) if under else random.sample(hist, 2)
        job = self._job_template(pair, "ladder")
        job["send_data_players"] = []
        job["update_players"] = []
        return job

    def actor_send_result(self, result: dict) -> bool:
        """Ingest one finished game. ``result`` layout (per reference
        _send_result_loop): game_steps/game_iters/game_duration, plus per
        side-id dicts {'player_id', 'opponent_id', 'winloss' in {-1,0,1}}."""
        game_stats = {
            "game_steps": result.get("game_steps", 0),
            "game_iters": result.get("game_iters", 0),
            "game_duration": result.get("game_duration", 0.0),
        }
        sides = {k: v for k, v in result.items() if isinstance(v, dict) and "player_id" in v}
        with self._lock:
            for side in sides.values():
                pid, opp = side["player_id"], side["opponent_id"]
                if pid not in self.all_players:
                    continue
                player = self.all_players[pid]
                if pid != opp:
                    player.payoff.update(
                        opp,
                        {"winrate": (1 + side["winloss"]) / 2, **game_stats},
                    )
                player.total_game_count += 1
                race = side.get("race", "unknown")
                if isinstance(player, ActivePlayer) and race != "unknown":
                    stats = {**side, "game_steps": game_stats["game_steps"]}
                    player.dist_stat.update_from_result(race, stats)
                    player.cum_stat.update_from_result(race, stats)
                    player.unit_num_stat.update_from_result(race, stats)
            first = sides.get("0") or next(iter(sides.values()), None)
            if first is not None and first["player_id"] != first["opponent_id"]:
                wl = int(first["winloss"])
                self.elo.update(first["player_id"], first["opponent_id"], wl)
                if wl > 0:
                    self.trueskill.update(first["player_id"], first["opponent_id"])
                elif wl < 0:
                    self.trueskill.update(first["opponent_id"], first["player_id"])
                else:
                    self.trueskill.update(first["player_id"], first["opponent_id"], draw=True)
        return True

    # ---------------------------------------------------------------- resume
    def attach_runtime(self, state_fn, load_fn) -> None:
        """Hook a league-runtime service into resume journaling: its state
        (learner roster, assignment map, snapshot lineage, RNG cursor) is
        embedded in ``save_resume`` blobs and handed back on load."""
        self._runtime_state_fn = state_fn
        self._runtime_load_fn = load_fn

    def save_resume(self, path: str) -> str:
        """Journal the full league state (players, payoff, ratings) to
        ``path``. Atomic via the storage layer (tmp+fsync+rename): a
        coordinator killed mid-journal leaves the previous journal intact —
        the durability contract the autosave loop depends on."""
        from ..utils import storage

        with self._lock:
            blob = pickle.dumps(
                {
                    "active_players": self.active_players,
                    "historical_players": self.historical_players,
                    "elo": self.elo,
                    "trueskill": self.trueskill,
                    "learners": {k: list(v) for k, v in self._learners.items()},
                    "runtime": (
                        self._runtime_state_fn()
                        if self._runtime_state_fn is not None else None
                    ),
                }
            )
        storage.write_bytes(path, blob)
        return path

    def load_resume(self, path: str) -> None:
        """Adopt the resume file at ``path``, the port's or the JAX package's."""
        from ..utils import pickles, storage

        data = pickles.loads(storage.read_bytes(path))
        self.active_players = data["active_players"]
        self.historical_players = data["historical_players"]
        self.elo = data["elo"]
        self.trueskill = data.get("trueskill", TrueSkill())
        self._learners = {k: list(v) for k, v in (data.get("learners") or {}).items()}
        runtime = data.get("runtime")
        if runtime is not None and self._runtime_load_fn is not None:
            self._runtime_load_fn(runtime)
        # backfill attributes absent from older resume pickles (unpickling
        # skips __init__)
        from .stat_meters import CumStat, DistStat, UnitNumStat

        for player in self.active_players.values():
            if not hasattr(player, "dist_stat"):
                player.dist_stat = DistStat(player.decay, player.warm_up_size)
                player.cum_stat = CumStat(player.decay, player.warm_up_size)
                player.unit_num_stat = UnitNumStat(player.decay, player.warm_up_size)
        self._log(f"league resumed from {path}")

    # -------------------------------------------------------------- autosave
    def start_autosave(self, path: str, interval_s: Optional[float] = None) -> str:
        """Periodic ``save_resume`` journaling on a daemon thread — the
        coordinator-durability leg of the fault-tolerance layer: a broker
        restart with ``load_resume(path)`` picks the league up where the
        last journal left it instead of resetting all payoff/ELO state.
        Cadence defaults to ``league.save_resume_freq_s``. Returns ``path``."""
        interval_s = float(
            self.cfg.get("save_resume_freq_s", 3600) if interval_s is None else interval_s
        )
        assert interval_s > 0
        self.stop_autosave()
        self._autosave_stop = threading.Event()

        def run():
            from ..obs import get_registry

            saves = get_registry().counter(
                "distar_league_autosaves_total", "league resume journals written"
            )
            while not self._autosave_stop.wait(interval_s):
                try:
                    self.save_resume(path)
                    saves.inc()
                except Exception as e:  # journaling must never kill matchmaking
                    self._log(f"league autosave failed: {e!r}")

        self._autosave_thread = threading.Thread(
            target=run, daemon=True, name="league-autosave"
        )
        self._autosave_thread.start()
        return path

    def stop_autosave(self) -> None:
        stop = getattr(self, "_autosave_stop", None)
        thread = getattr(self, "_autosave_thread", None)
        if stop is not None:
            stop.set()
        if thread is not None:
            thread.join(timeout=10.0)
            self._autosave_thread = None

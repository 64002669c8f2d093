"""Actor: job lifecycle + lockstep env fleet with batched device inference.

Counterpart of ``distar_tpu.actor.actor``. Its weights are port
``state_dict``s of a policy-only model (``use_value_network = False``): a
learner's publication, a flax-layout numpy tree, loads through
``model.convert.policy_params_from_flax``; without one the actor draws its
own seeded weights with ``model.init_params``. Its engines run on CUDA
unless ``device`` says otherwise (``resolve_device``). With
``actor.replay.enabled`` trajectories go to a replay store (one
``InsertClient``, a consistent-hash shard fleet, or the colocated
``inproc`` store) instead of, or with ``mirror`` beside, the adapter.

Role parity with the reference Actor (reference: distar/actor/actor.py:23-353
and actor_comm.py): ask the league for a job, drive env<->agent loops, ship
trajectories to the learner over the Adapter, pull fresh weights
periodically, report results.

Divergence from the reference (a design choice): the reference forks one
process per env and funnels inference through shared-memory slots
(actor.py:301-319, agent.py:715-739). Here the env fleet steps in lockstep
inside one process and every slot's observation joins ONE fixed-shape
batch, so a single batched forward amortises the launches. WHERE that batch runs is the rollout
plane's choice (rollout_plane.PolicyClient, the Sebulba split): a private
per-actor BatchedInference (``inline``, default), this host's shared
gateway+engine (``local``), or a remote bin/serve gateway (``remote``).
SC2-process concurrency (the real env's slow step) belongs to the env
layer's own worker pool behind the same interface.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..comm import Adapter
from ..envs import BaseEnv, MockEnv
from ..league import League
from ..model import Model, default_model_config, init_params
from ..model.convert import policy_params_from_flax
from ..obs import get_registry, start_trace
from ..utils import Config, deep_merge_dicts
from .agent import Agent, sample_fake_z
from .inference import resolve_device
from .rollout_plane import RolloutPlane

ACTOR_DEFAULTS = Config(
    {
        "actor": {
            "env_num": 2,
            "traj_len": 16,
            "episodes_per_job": 1,
            "model_update_interval_s": 10.0,
            "seed": 0,
            # directories searched for the job's z_path libraries
            "z_dirs": ["", "data/z_libraries"],
            "fake_reward_prob": 1.0,
            # pad-to-bucket entity cap for inference obs (agents slice in
            # pre_process; matches the learner-side learner.max_entities)
            "max_entities": None,
            # replay-store push target (config-switched; default off so the
            # point-to-point shuttle path is untouched). ``addr`` is
            # "host:port" of a ReplayServer, a comma-separated shard list
            # (trajectories route by consistent hash), or "inproc" for the
            # zero-copy colocated store; ``mirror`` additionally keeps the
            # adapter push; ``priority`` seeds the table priority of fresh
            # trajectories; ``compress`` is this side's wire-compression
            # preference (negotiated per connection); ``transport`` picks
            # the data-plane leg (auto negotiates shm rings with colocated
            # stores, tcp forces the socket).
            "replay": {
                "enabled": False,
                "addr": "",
                "mirror": False,
                "priority": 1.0,
                "timeout_s": 60.0,
                "compress": True,
                "transport": "auto",
            },
            # rollout inference plane (docs/serving.md, Sebulba split):
            # ``inline`` is a per-actor BatchedInference; ``local``
            # shares ONE in-process gateway+engine per player across every
            # job on this host; ``remote`` rides the framed-TCP data plane
            # of a bin/serve.py gateway at ``addr``. ``slots`` sizes the
            # shared local engine (0 = this job's env_num).
            "plane": {
                "backend": "inline",
                "addr": "",
                "slots": 0,
                "max_delay_s": 0.005,
                "timeout_s": 30.0,
                # remote-backend transport: auto negotiates shm rings per
                # gateway connection when colocated (docs/data_plane.md)
                "transport": "auto",
            },
        }
    }
)


class Actor:
    def __init__(
        self,
        cfg: Optional[dict] = None,
        league: Optional[League] = None,
        adapter: Optional[Adapter] = None,
        model_cfg: Optional[dict] = None,
        env_fn: Optional[Callable[[], BaseEnv]] = None,
        init_params: Optional[dict] = None,
        player_params: Optional[Dict[str, dict]] = None,
        device=None,
    ):
        """``init_params`` and ``player_params`` are ``state_dict``s of the
        policy-only model."""
        whole = deep_merge_dicts(ACTOR_DEFAULTS, cfg or {})
        self.cfg = whole.actor
        self._replay_client = None  # lazily dialed from cfg.actor.replay
        rcfg = self._replay_cfg()
        if rcfg.get("enabled", False) and rcfg.get("addr", ""):
            # fail fast on a malformed address here, at config time, not
            # mid-episode at the first push
            self._replay_target()
        self.device = resolve_device(device)
        self.league = league
        self.adapter = adapter
        self.model_cfg = deep_merge_dicts(default_model_config(), model_cfg or {})
        self.model_cfg.use_value_network = False
        # the parameter names and shapes a publication must fit (no storage)
        with torch.device("meta"):
            self._shape_model = Model(self.model_cfg)
        self._env_fn = env_fn or (lambda: MockEnv(seed=self.cfg.seed))
        self._init_params = init_params
        self._player_params = dict(player_params or {})
        self._rng = np.random.default_rng(self.cfg.seed)
        # ONE plane per actor, surviving across jobs: shared engines (and
        # their compilations) persist; inline stays per-job by construction.
        # Unsized shared engines default to BOTH sides of a job reserving
        # env_num sessions each (a self-play job puts two clients of the
        # SAME player on one gateway; exact-capacity admission would
        # otherwise fail the second side's reserve at job start)
        pcfg = dict(self.cfg.get("plane", {}) or {})
        if not pcfg.get("slots"):
            pcfg["slots"] = 2 * self.cfg.env_num
        self.plane = RolloutPlane(model_cfg=self.model_cfg, device=self.device, **pcfg)
        self.results: List[dict] = []
        # highest learner iteration ever received per player — survives
        # across jobs (the per-job _model_iters resets), for freshness
        # monitoring/telemetry
        self.model_iter_highwater: Dict[str, int] = {}

    # ---------------------------------------------------------------- params
    def _initial_params(self):
        """Seeded initial weights (``model.init_params`` with
        ``actor.seed``), drawn once."""
        if self._init_params is None:
            model = Model(self.model_cfg)
            init_params(model, self.cfg.seed)
            self._init_params = model.state_dict()
        return self._init_params

    def _params_from_publication(self, data: dict):
        """A learner's publication (``{"params": flax-layout numpy tree,
        ...}``, value towers included) as this actor's ``state_dict``."""
        return policy_params_from_flax(data["params"], self._shape_model)

    def _load_player_params(self, player_id: str):
        """Fresh weights from the learner when published, else initial."""
        if player_id in self._player_params:
            return self._player_params[player_id]
        if self.adapter is not None:
            data = self._pull_latest_model(player_id)
            if data is not None:
                self._note_model_iter(player_id, data.get("iter", 0))
                return self._params_from_publication(data)
        return self._initial_params()

    def _note_model_iter(self, player_id: str, it: int) -> None:
        self._model_iters[player_id] = it
        self.model_iter_highwater[player_id] = max(
            self.model_iter_highwater.get(player_id, 0), it
        )
        get_registry().gauge(
            "distar_actor_model_iter", "freshest learner iteration received",
            player=player_id,
        ).set(self.model_iter_highwater[player_id])

    def _sample_z(
        self,
        side: int,
        job: dict,
        born_location: Optional[int] = None,
        map_name: Optional[str] = None,
    ) -> dict:
        """Target strategy for one side: the job's z_path library keyed by
        map/matchup/born-location (reference agent.py:176-243), synthetic
        fallback when no library resolves (e.g. before gen_z has produced
        one). With a ``born_location`` (known once the episode's first obs
        arrives) the exact library key is used; otherwise a random one."""
        z_paths = job.get("z_path", [])
        path = z_paths[side] if side < len(z_paths) else ""
        lib = None
        if path and path != "none":
            if not hasattr(self, "_z_libs"):
                self._z_libs = {}
            if path not in self._z_libs:
                from ..lib.z_library import ZLibrary

                resolved = None
                pkg_z_dir = os.path.join(
                    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "data", "z_libraries",
                )
                for d in list(self.cfg.get("z_dirs", [""])) + [pkg_z_dir]:
                    cand = os.path.join(d, path) if d else path
                    if os.path.exists(cand):
                        resolved = cand
                        break
                try:
                    self._z_libs[path] = ZLibrary(resolved) if resolved else None
                except Exception as e:
                    logging.warning(f"actor: failed to load z library {path}: {e!r}")
                    self._z_libs[path] = None
            lib = self._z_libs[path]
        if lib is not None:
            from ..league.player import FRAC_ID

            frac_ids = job.get("frac_ids", [1, 1])

            def race_of(s):
                frac = frac_ids[s] if s < len(frac_ids) else 1
                return FRAC_ID.get(frac, ["zerg"])[0]

            race, opp_race = race_of(side), race_of(1 - side)
            # library keys follow the decoder's matchup convention: own race
            # for mirrors, race+opponent otherwise (gen_z, decode_z)
            mix_race = race if race == opp_race else race + opp_race
            fr_prob = float(self.cfg.get("fake_reward_prob", 1.0))
            resolved_map = map_name or job.get("env_info", {}).get("map_name", "")
            if born_location is not None:
                try:
                    return lib.sample(resolved_map, mix_race, int(born_location), fr_prob)
                except (KeyError, TypeError, IndexError):
                    pass  # library has no entries for this exact spawn
            target = lib.sample_any(
                resolved_map, mix_race=mix_race, fake_reward_prob=fr_prob,
            )
            if target is not None:
                return target
        return sample_fake_z(self._rng)

    def _load_teacher_params(self, side: int, job: dict, own_params):
        """Frozen teacher weights for the human-prior KL (reference
        actor_comm.py:114-118: teacher = separate SL checkpoint with value
        nets stripped). Falls back to a frozen snapshot of the player's own
        initial weights — logged loudly, since a self-teacher makes the
        kl/action_type_kl terms near-vacuous."""
        tids = job.get("teacher_player_ids", [])
        tpaths = job.get("teacher_checkpoint_paths", [])
        tid = tids[side] if side < len(tids) else "none"
        tpath = str(tpaths[side]) if side < len(tpaths) else "none"
        if tid != "none" and tpath not in ("none", "") and os.path.exists(tpath):
            try:
                from ..utils.checkpoint import load_params

                return policy_params_from_flax(load_params(tpath), self._shape_model)
            except Exception as e:
                logging.warning(
                    f"actor: failed to load teacher checkpoint {tpath} for side {side}: {e!r}"
                )
        logging.warning(
            f"actor: no teacher checkpoint for side {side} "
            f"(teacher_id={tid!r}, path={tpath!r}); freezing the player's initial "
            "weights as teacher — KL terms will be weak until a real SL teacher is wired"
        )
        return own_params

    def _pull_latest_model(self, player_id: str):
        """Drain the FIFO plane to the freshest publication (non-blocking).
        reset_flag ORs across everything drained — exactly one publication
        carries it and it must not be lost to a newer one."""
        if self.adapter is None:  # adapterless actor (play/eval/tests): no
            return None           # publication plane to drain
        latest, reset_seen = None, False
        while True:
            data = self.adapter.pull(f"{player_id}model", block=False)
            if data is None:
                if latest is not None and reset_seen:
                    latest = dict(latest, reset_flag=True)
                return latest
            reset_seen = reset_seen or bool(data.get("reset_flag", False))
            if latest is None or data.get("iter", 0) >= latest.get("iter", 0):
                latest = data

    def _refresh_models(self, job, player_ids, clients, params) -> bool:
        """Periodic weight hot-reload for update_players (the
        freshness-critical path, reference actor_comm.py:172-216: actors pull
        every ~10s; a learner-sent reset_flag additionally restarts
        episodes). On the gateway backends the refresh is ONE registry
        hot-swap per (player, iteration) on the plane — deduped, applied at
        a flush boundary, shared by every client — instead of per-actor
        param installs. Returns True when a reset was requested."""
        reset = False
        for side in list(clients):
            player = player_ids[side]
            if player not in job.get("update_players", []):
                continue
            data = self._pull_latest_model(player)
            if data is not None and data.get("iter", -1) > self._model_iters.get(player, -1):
                new_params = self._params_from_publication(data)
                params[player] = new_params
                clients[side].refresh(new_params, data.get("iter", 0))
                self._note_model_iter(player, data.get("iter", 0))
                reset = reset or bool(data.get("reset_flag", False))
        return reset

    # ------------------------------------------------------------------- run
    def run_job(
        self, episodes: Optional[int] = None, job: Optional[dict] = None
    ) -> List[dict]:
        """Ask for one job and play it out; returns per-episode results.

        An explicit ``job`` dict overrides asking the league — play/eval use
        this to pin matchups (reference job_type eval_test, play.py)."""
        episodes = episodes or self.cfg.episodes_per_job
        if job is None:
            job = (
                self.league.actor_ask_for_job({"job_type": "train"})
                if self.league is not None
                else {
                    "player_ids": ["MP0", "HP0"],
                    "send_data_players": ["MP0"],
                    "update_players": ["MP0"],
                    "teacher_player_ids": ["T", "none"],
                    "branch": "standalone",
                    "env_info": {"map_name": "mock"},
                }
            )
        self._model_iters: Dict[str, int] = {}
        player_ids = job["player_ids"][:2]
        n_env = self.cfg.env_num
        # each env steps in its own worker thread (real SC2 steps are slow
        # and high-variance); inference batches over the ready set
        from .env_pool import RESET, EnvWorkerPool
        from .. import plugins

        pool = EnvWorkerPool([self._env_fn] * n_env)

        # model-free sides act without the batched inference: no slot, no
        # teacher, no trajectories. That's scripted built-ins
        # ('scripted.random') AND custom plugin pipelines, which own their
        # inference (plugins.py; role of the reference's importable agent
        # pipelines, distar/agent/import_helper.py + pysc2/agents/)
        pipelines = job.get("pipelines", [])

        def _pipeline(side: int) -> str:
            return pipelines[side] if side < len(pipelines) else "default"

        modelfree_sides = {
            side for side in range(len(player_ids))
            if plugins.is_model_free(_pipeline(side))
        }

        # slots: (env, side); one PolicyClient per model-driven side. The
        # plane decides where the model actually lives: a private
        # BatchedInference (inline), this host's shared gateway (local), or
        # a remote bin/serve gateway (remote) — LSTM carries, teacher state
        # and weight refresh all follow the backend (docs/serving.md)
        params = {
            pid: self._load_player_params(pid)
            for side, pid in enumerate(player_ids)
            if side not in modelfree_sides
        }
        teacher_params = {
            side: self._load_teacher_params(side, job, params[pid])
            for side, pid in enumerate(player_ids)
            if side not in modelfree_sides
        }
        clients = {
            side: self.plane.client_for(
                pid, num_slots=n_env, params=params[pid],
                teacher_params=teacher_params[side], seed=side,
            )
            for side, pid in enumerate(player_ids)
            if side not in modelfree_sides
        }
        from ..league.player import FRAC_ID as _FRAC_ID

        _frac_ids = job.get("frac_ids", [])

        def _side_race(side: int) -> str:
            frac = _frac_ids[side] if side < len(_frac_ids) else 1
            return _FRAC_ID.get(frac, ["zerg"])[0]

        agents = {
            (e, side): (
                plugins.build_agent(
                    _pipeline(side), pid,
                    seed=self.cfg.seed + e * 2 + side, race=_side_race(side),
                )
                if side in modelfree_sides
                else Agent(
                    pid,
                    z=self._sample_z(side, job),
                    traj_len=self.cfg.traj_len,
                    seed=self.cfg.seed + e * 2 + side,
                    max_entities=self.cfg.get("max_entities"),
                )
            )
            for e in range(n_env)
            for side, pid in enumerate(player_ids)
        }
        for (e, side), ag in agents.items():
            ag.model_last_iter = self._model_iters.get(ag.player_id, 0)
            ag.collect_trajectories = (
                side not in modelfree_sides
                and ag.player_id in job.get("send_data_players", [])
            )
        sides = list(range(len(player_ids)))
        hidden_backup = {
            (e, side): clients[side].hidden_for_slot(e)
            for e in range(n_env)
            for side in sides
            if side in clients
        }

        def reset_slot(e: int) -> None:
            """Restart env slot e: fresh episode, fresh Z, zeroed policy and
            teacher LSTM carries (shared by episode-end and league-reset).
            On the gateway backends the zeroing happens server-side — a
            session reset. The fresh obs arrives asynchronously via the
            pool."""
            for side in sides:
                if side in modelfree_sides:
                    agents[(e, side)].reset()
                    continue
                agents[(e, side)].reset(z=self._sample_z(side, job))
                clients[side].reset_slot(e)
                hidden_backup[(e, side)] = clients[side].hidden_for_slot(e)
            pool.reset(e)

        def handle_episode_end(e: int, next_obs, rewards, info) -> None:
            """Close out every side's pending action with the terminal
            reward, report the result, restart the slot."""
            nonlocal episodes_done
            for side in sides:
                ag = agents[(e, side)]
                if ag._output is not None and (e, side) in pending_teacher:
                    traj = ag.collect_data(
                        next_obs.get(side), rewards[side], True,
                        pending_teacher.pop((e, side)),
                        hidden_backup[(e, side)],
                    )
                    self._maybe_push(job, ag, traj, clients, hidden_backup, e, side)
            episodes_done += 1
            result = {
                "game_steps": info.get("game_loop", 0),
                "game_iters": 0,
                "game_duration": 0.0,
            }
            from ..league.player import FRAC_ID

            frac_ids = job.get("frac_ids", [1, 1])
            for side in sides:
                ag = agents[(e, side)]
                frac = frac_ids[side] if side < len(frac_ids) else 1
                opponent = (
                    player_ids[1 - side] if 1 - side < len(player_ids) else
                    job.get("opponent_id", "bot")
                )
                result[str(side)] = {
                    "player_id": player_ids[side],
                    "opponent_id": opponent,
                    "winloss": int(rewards[side]),
                    "race": FRAC_ID.get(frac, ["zerg"])[0],
                    **ag.episode_stats(),
                }
            results.append(result)
            if self.league is not None:
                from ..resilience import CommError

                try:
                    self.league.actor_send_result(result)
                except CommError as e:
                    # result delivery already retried inside RemoteLeague;
                    # losing one matchmaking sample must not kill the job
                    # loop mid-episode — log and keep rolling
                    logging.warning(f"actor: result delivery dropped: {e}")
                    get_registry().counter(
                        "distar_actor_result_send_failures_total",
                        "league result deliveries dropped after retries",
                    ).inc()
            reset_slot(e)

        for e in range(n_env):
            pool.reset(e)
        # neutral schema-complete filler for slots that haven't produced an
        # observation yet (inactive batch positions are never consumed)
        from ..lib import features as F

        filler = F.fake_step_data(rng=self._rng)
        cap = self.cfg.get("max_entities")
        if cap:
            # capped lanes batch at the bucket shape: the filler must match
            filler["entity_info"] = {
                k: v[:cap] for k, v in filler["entity_info"].items()
            }
            filler["entity_num"] = np.minimum(np.asarray(filler["entity_num"]), cap)
        obs: Dict[int, dict] = {}
        episodes_done, results = 0, []
        last_model_refresh = time.time()
        pending_teacher: Dict = {}
        last_prepared: Dict = {}
        try:
            while episodes_done < episodes:
                if time.time() - last_model_refresh > self.cfg.model_update_interval_s:
                    last_model_refresh = time.time()
                    refreshed = self._refresh_models(job, player_ids, clients, params)
                    for ag in agents.values():
                        ag.model_last_iter = self._model_iters.get(ag.player_id, 0)
                    if refreshed:
                        # league-triggered reset: restart every episode with
                        # the fresh checkpoint (reference actor.py:321-323);
                        # in-flight steps are dropped by the epoch tags
                        pending_teacher.clear()
                        obs.clear()
                        for e in range(n_env):
                            reset_slot(e)
                # collect whatever envs finished stepping (>=1, with a cap so
                # the model-refresh clock keeps ticking)
                for e, kind, payload in pool.ready(timeout=1.0):
                    if kind == RESET:
                        obs[e] = payload
                        # the first obs reveals the spawn: re-key Z to the
                        # exact map/matchup/born-location library entry
                        # (reference agent.reset, agent.py:176-243)
                        for side in sides:
                            gi = (payload.get(side) or {}).get("game_info", {})
                            born = gi.get("born_location")
                            if born is not None:
                                agents[(e, side)].reset(z=self._sample_z(
                                    side, job, born_location=born,
                                    map_name=gi.get("map_name"),
                                ))
                    else:
                        next_obs, rewards, done, info = payload
                        if done:
                            handle_episode_end(e, next_obs, rewards, info)
                        else:
                            obs[e] = next_obs
                if not obs:
                    continue

                # obs[e] holds only the sides DUE this cycle (variable
                # per-agent delays, SC2Env contract); a fresh obs first
                # closes out that agent's previous action (collect-on-
                # receipt, the reference's per-env loop order), then the
                # agent acts on it. Non-ready slots ride the batch as
                # inactive filler (hidden state preserved).
                env_actions: Dict[int, dict] = {e: {} for e in range(n_env)}
                for side, pid in enumerate(player_ids):
                    if side in modelfree_sides:
                        for e in range(n_env):
                            if e in obs and side in obs[e]:
                                env_actions[e][side] = agents[(e, side)].step(obs[e][side])
                        continue
                    prepared, active = [], []
                    for e in range(n_env):
                        if e in obs and side in obs[e]:
                            ag = agents[(e, side)]
                            if ag._output is not None and (e, side) in pending_teacher:
                                traj = ag.collect_data(
                                    obs[e][side], 0.0, False,
                                    pending_teacher.pop((e, side)),
                                    hidden_backup[(e, side)],
                                )
                                self._maybe_push(job, ag, traj, clients, hidden_backup, e, side)
                            prepared.append(ag.pre_process(obs[e][side]))
                            last_prepared[(e, side)] = prepared[-1]
                            active.append(True)
                        else:
                            prepared.append(last_prepared.get((e, side), filler))
                            active.append(False)
                    if not any(active):
                        # no lane of this side is due: skip both forwards
                        # (hidden state untouched for inactive lanes anyway)
                        continue
                    outs = clients[side].sample(prepared, active)
                    # teacher logits at act time with the FROZEN teacher
                    # weights, stored until the next obs arrives (on the
                    # gateway backends these rode the SAME flush as the
                    # policy forward — no second round-trip)
                    t_logits = clients[side].teacher_logits(prepared, outs, active)
                    for e in range(n_env):
                        if active[e]:
                            act = agents[(e, side)].post_process(outs[e])
                            act["selected_units_num"] = outs[e]["selected_units_num"]
                            env_actions[e][side] = act
                            pending_teacher[(e, side)] = t_logits[e]

                # hand the acted-on envs back to their workers
                for e in list(obs.keys()):
                    if env_actions[e]:
                        pool.submit(e, env_actions[e])
                        del obs[e]
        finally:
            pool.close()
            for c in clients.values():
                c.close()  # frees the job's sessions on shared gateways
        self.results.extend(results)
        return results

    # ----------------------------------------------------------- replay push
    def _replay_cfg(self):
        return self.cfg.get("replay", {}) or {}

    def _replay_target(self):
        """Validated target spec from ``cfg.actor.replay.addr``: the string
        ``"inproc"`` (colocated store), or a list of ``(host, port)`` pairs
        (one = single store, several = consistent-hash shard fleet). Raises
        a clear config error instead of a bare ``int()`` ValueError."""
        from ..replay import is_inproc_addr

        addr = str(self._replay_cfg().get("addr", ""))
        if is_inproc_addr(addr):
            return addr
        targets = []
        for part in addr.split(","):
            part = part.strip()
            if not part:
                continue
            host, _, port = part.rpartition(":")
            try:
                targets.append((host or "127.0.0.1", int(port)))
            except ValueError:
                raise ValueError(
                    f"actor.replay.addr must be 'host:port' (optionally "
                    f"comma-separated for a shard fleet) or 'inproc', "
                    f"got {addr!r}"
                ) from None
        if not targets:
            raise ValueError(
                f"actor.replay.addr must name at least one 'host:port', "
                f"got {addr!r}"
            )
        return targets

    def _get_replay_client(self):
        """Dial the replay plane once per actor (clients reconnect + retry
        internally; docs/data_plane.md store path): the in-process store
        handle for ``inproc`` (zero serialization), one ``InsertClient``
        for a single store, or a ``ShardedInsertClient`` routing across
        the fleet by consistent hash."""
        if self._replay_client is None:
            target = self._replay_target()
            compress = bool(self._replay_cfg().get("compress", True))
            transport = str(self._replay_cfg().get("transport", "auto"))
            if isinstance(target, str):  # inproc fast path
                from ..replay import LocalReplayClient

                self._replay_client = LocalReplayClient()
            elif len(target) == 1:
                from ..replay import InsertClient

                self._replay_client = InsertClient(*target[0], compress=compress,
                                                   transport=transport)
            else:
                from ..replay import ShardMap, ShardedInsertClient

                self._replay_client = ShardedInsertClient(
                    ShardMap([f"{h}:{p}" for h, p in target]), compress=compress,
                    transport=transport)
        return self._replay_client

    def push_trajectory(self, player_id: str, traj) -> None:
        """Ship one finished trajectory to the configured data plane(s):
        the replay store when ``actor.replay.enabled``, the legacy shuttle
        path otherwise (or additionally, with ``replay.mirror``)."""
        rcfg = self._replay_cfg()
        use_replay = bool(rcfg.get("enabled", False)) and rcfg.get("addr", "")
        if use_replay:
            try:
                # inside the try: client construction failing (config rot
                # after init) must count as a dropped push, not kill the
                # job loop mid-episode
                client = self._get_replay_client()
                client.insert(
                    player_id, traj,
                    priority=float(rcfg.get("priority", 1.0)),
                    timeout_s=float(rcfg.get("timeout_s", 60.0)),
                )
                get_registry().counter(
                    "distar_actor_replay_pushed_total",
                    "trajectories acked by the replay store", player=player_id,
                ).inc()
            except Exception as err:
                # the client already retried under its policy/breaker; a
                # store outage past that budget must not kill the job loop
                # mid-episode (the trajectory is lost, counted, and the
                # episode keeps rolling — exactly the legacy drop semantics)
                logging.warning(f"actor: replay push dropped: {err!r}")
                get_registry().counter(
                    "distar_actor_replay_push_failures_total",
                    "replay-store inserts dropped after retries",
                    player=player_id,
                ).inc()
            if not rcfg.get("mirror", False):
                return
        if self.adapter is not None:
            # mint the pipeline span here, where the trajectory is born: the
            # context rides the payload through shuttle/adapter into the
            # learner, and the span id is ALSO stamped into the trajectory
            # itself so the learner can attribute per-trajectory staleness
            trace = start_trace("trajectory", player=player_id)
            traj[0]["trace"] = trace
            get_registry().counter(
                "distar_actor_traj_pushed_total", "trajectories shipped to the learner",
                player=player_id,
            ).inc()
            self.adapter.push(
                f"{player_id}traj", traj, timeout_ms=120_000, trace=trace
            )

    def _maybe_push(self, job, ag, traj, clients, hidden_backup, e, side) -> None:
        if traj is None:
            return
        # next trajectory starts from the CURRENT carry (before this cycle's
        # forward) — read back from wherever the plane keeps it
        hidden_backup[(e, side)] = clients[side].hidden_for_slot(e)
        if ag.player_id in job["send_data_players"]:
            self.push_trajectory(ag.player_id, traj)

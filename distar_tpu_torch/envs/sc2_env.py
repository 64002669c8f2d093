"""SC2 environment orchestration over abstract game controllers.

Counterpart of ``distar_tpu.envs.sc2_env``.

Role parity with the reference SC2Env (reference: distar/envs/env.py:96-455):
per-agent variable ``skip_steps`` delays (the AlphaStar delay-action model —
each agent names the game loop of its next observation, the env advances to
the earliest one, :333-375), simulated inference-latency noise
(`random_delay_weights`, :350-354), win/loss extraction from player_result
(:411-424), per-agent {obs, opponent_obs, action_result} returns (:443-455),
and episode-length cutoffs.

The controller is abstract (`GameController`): the reference's
RemoteController (websocket+protobuf to the SC2 binary,
pysc2/lib/remote_controller.py) slots in unchanged once the proto package is
available; `FakeController` (dummy protos) makes the whole orchestration
testable without the game — the reference's mock_sc2_env strategy applied
one layer lower.
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional, Protocol, Sequence

import numpy as np

from .env import BaseEnv
from .features import ProtoFeatures

# sc_pb.Result: Victory=1, Defeat=2, Tie=3, Undecided=4
POSSIBLE_RESULTS = {1: 1, 2: -1, 3: 0, 4: 0}
MAX_STEP_COUNT = 524_000  # SC2 hard limit 2^19, minus margin (reference :427)


class GameController(Protocol):
    """Subset of the reference RemoteController the env drives."""

    status_ended: bool

    def step(self, loops: int) -> None: ...

    def acts(self, raw_cmds: List[dict]): ...  # returns result-like or None

    def observe(self, target_game_loop: int = 0): ...  # raw proto obs


class SC2Env(BaseEnv):
    def __init__(
        self,
        controllers: Sequence[GameController],
        features: Sequence[ProtoFeatures],
        episode_length: int = 100_000,
        random_delay_weights: Optional[Sequence[float]] = None,
        realtime: bool = False,
        both_obs: bool = True,
        seed: int = 0,
        human_indices: Optional[Sequence[int]] = None,
        save_replay_episodes: int = 0,
        replay_saver=None,
    ):
        assert len(controllers) == len(features)
        self._controllers = list(controllers)
        self._features = list(features)
        self.num_agents = len(controllers)
        self._episode_length = min(episode_length, MAX_STEP_COUNT)
        self._random_delay_weights = list(random_delay_weights or [])
        self._realtime = realtime
        # a human plays through their own full-screen client: the env never
        # observes or acts their controller (reference env.py:315-316,384-385)
        self._human = set(human_indices or [])
        self._both_obs = both_obs and self.num_agents == 2 and not self._human
        self._save_replay_episodes = save_replay_episodes
        self._replay_saver = replay_saver
        self._rng = random.Random(seed)
        self._episode_steps = 0
        self._episode_count = 0
        self._next_obs_step = [0] * self.num_agents
        self._action_result: List[List[int]] = [[1] for _ in range(self.num_agents)]
        self._last_tags: List[list] = [[] for _ in range(self.num_agents)]
        self._raw_obs: List = [None] * self.num_agents
        self._born_locations: List = [None] * self.num_agents
        self._done = True

    # ------------------------------------------------------------------ api
    def reset(self) -> Dict[int, dict]:
        self._episode_steps = 0
        self._episode_count += 1
        self._next_obs_step = [
            MAX_STEP_COUNT + 1 if i in self._human else 0
            for i in range(self.num_agents)
        ]
        self._action_result = [[1] for _ in range(self.num_agents)]
        self._raw_obs = [None] * self.num_agents
        self._born_locations: List = [None] * self.num_agents
        self._done = False
        # restart the underlying game (reference restarts via the
        # controller's restart_game / create+join, env.py:298-330)
        for c in self._controllers:
            if hasattr(c, "reset"):
                c.reset()
        obs, _, _, _ = self._observe(0)
        return obs

    def step(self, actions: Dict[int, dict]):
        assert not self._done, "step() after episode end; call reset()"
        # issue raw commands + register each agent's requested delay
        for idx, action in actions.items():
            delay = max(int(np.asarray(action["delay"]).reshape(-1)[0]), 1)
            self._next_obs_step[idx] = self._episode_steps + delay
            cmd = self._features[idx].transform_action(
                action, self._last_tags[idx],
                selected_units_num=action.get("selected_units_num"),
            )
            c = self._controllers[idx]
            if not c.status_ended:
                result = c.acts([cmd])
                if result is not None:
                    self._action_result[idx] = (
                        list(result) if isinstance(result, (list, tuple)) else [result]
                    )

        # simulated inference/network latency for short delays (reference
        # :350-354, fires only when EVERY acting agent requested a short
        # delay): the game runs on while the "agents think"
        if not self._realtime and self._random_delay_weights and actions:
            max_delay = max(
                self._next_obs_step[i] - self._episode_steps for i in actions
            )
            if max_delay < 4:
                lag = self._rng.choices(
                    range(len(self._random_delay_weights)),
                    weights=self._random_delay_weights,
                )[0]
                self._advance(lag)
                self._episode_steps += lag

        target = min(self._next_obs_step)
        step_mul = max(target - self._episode_steps, 0)
        self._advance(step_mul)
        # dueness is judged inside _observe against the ACTUAL game loop —
        # a latency lag may have overshot some agents' schedules
        return self._observe(max(target, self._episode_steps))

    def close(self) -> None:
        for c in self._controllers:
            if hasattr(c, "close"):
                c.close()

    # ------------------------------------------------------------- internals
    def _advance(self, loops: int) -> None:
        # realtime games advance on SC2's own clock — no step requests
        # (upstream pysc2 sc2_env gates exactly this way); observe() blocks
        # until the target game loop instead
        if loops <= 0 or self._realtime:
            return
        for c in self._controllers:
            if not c.status_ended:
                c.step(loops)

    def _observe(self, target_game_loop: int):
        # observe only the agents that are due (or every non-human agent in
        # both-obs critic mode) — the reference's selective parallel observe
        # (env.py:377-390); a human's controller is never queried
        due = [
            i for i in range(self.num_agents)
            if self._next_obs_step[i] <= target_game_loop and i not in self._human
        ]
        query = [
            i for i in range(self.num_agents)
            if i not in self._human and (self._both_obs or i in due)
        ] or due
        for i in query:
            self._raw_obs[i] = self._controllers[i].observe(
                target_game_loop=target_game_loop
            )
        game_loop = int(self._raw_obs[query[0]].observation.game_loop)
        self._episode_steps = game_loop
        due = [
            i for i in range(self.num_agents)
            if self._next_obs_step[i] <= game_loop and i not in self._human
        ]

        outcome = [0] * self.num_agents
        episode_complete = any(
            getattr(o, "player_result", None) for o in self._raw_obs if o is not None
        )
        if episode_complete:
            for i, o in enumerate(self._raw_obs):
                if o is None:
                    continue
                pid = o.observation.player_common.player_id
                for result in o.player_result:
                    if result.player_id == pid:
                        outcome[i] = POSSIBLE_RESULTS.get(result.result, 0)
                    elif self.num_agents == 2:
                        outcome[1 - i] = POSSIBLE_RESULTS.get(result.result, 0)
        if game_loop >= self._episode_length:
            episode_complete = True
        self._done = episode_complete
        if episode_complete:
            self._maybe_save_replay(outcome)

        obs: Dict[int, dict] = {}
        if episode_complete:
            indices = [i for i in range(self.num_agents) if i not in self._human]
        else:
            indices = due
        for i in indices:
            # a non-due agent's cached obs may be stale (or absent) — e.g.
            # the terminal frame, or a realtime overshoot making an
            # unqueried agent due; serve it the current frame
            cached = self._raw_obs[i]
            if cached is None or int(cached.observation.game_loop) < game_loop:
                self._raw_obs[i] = self._controllers[i].observe(
                    target_game_loop=target_game_loop
                )
            opponent = self._raw_obs[1 - i] if self._both_obs else None
            f_obs = self._features[i].transform_obs(
                self._raw_obs[i], opponent_obs=opponent
            )
            f_obs["action_result"] = self._action_result[i]
            self._last_tags[i] = f_obs["game_info"]["tags"]
            # born locations key the Z-library sampling (reference
            # agent.py:183-187 reads them off the first observation)
            if self._born_locations[i] is None:
                try:
                    self._born_locations[i] = self._features[i].born_locations(
                        self._raw_obs[i]
                    )
                except Exception:
                    self._born_locations[i] = (0, 0)
            f_obs["game_info"]["born_location"] = self._born_locations[i][0]
            f_obs["game_info"]["away_born_location"] = self._born_locations[i][1]
            obs[i] = f_obs
        rewards = {i: float(outcome[i]) for i in range(self.num_agents)}
        info = {"game_loop": game_loop, "outcome": outcome}
        return obs, rewards, episode_complete, info

    def _maybe_save_replay(self, outcome) -> None:
        """Save the finished game's replay every N episodes (reference
        env.py:435-438)."""
        if (
            self._replay_saver is None
            or self._save_replay_episodes <= 0
            or self._episode_count % self._save_replay_episodes != 0
        ):
            return
        try:
            self._replay_saver(f"outcome_{outcome}")
        except Exception:  # replay saving must never kill training
            import logging

            logging.exception("save_replay failed")


class FakeController:
    """Dummy-proto controller: advances a loop counter, serves synthetic
    observations, ends with a victory/defeat pair after ``end_at`` loops."""

    def __init__(self, player_id: int = 1, end_at: int = 1000, n_units: int = 8,
                 map_y: int = 120, map_x: int = 120, seed: int = 0,
                 winner_player: int = 1):
        from .dummy_obs import build_dummy_obs, make_unit
        from ..lib import actions as ACT

        self._build = build_dummy_obs
        self._make_unit = make_unit
        self._unit_type = ACT.UNIT_TYPES[10]
        self.player_id = player_id
        self._end_at = end_at
        self._n_units = n_units
        self._map = (map_y, map_x)
        self._rng = np.random.default_rng(seed)
        self._winner = winner_player
        self.game_loop = 0
        self.status_ended = False
        self.acts_log: List[list] = []

    def reset(self) -> None:
        """Restart the fake game (role of restart_game in the real client)."""
        self.game_loop = 0
        self.status_ended = False

    def step(self, loops: int) -> None:
        self.game_loop += loops

    def acts(self, raw_cmds: List[dict]):
        self.acts_log.append(raw_cmds)
        return [1]

    def observe(self, target_game_loop: int = 0):
        if target_game_loop > self.game_loop:
            self.game_loop = target_game_loop
        units = [
            self._make_unit(100 + i, self._unit_type, x=5 + i, y=10)
            for i in range(self._n_units)
        ]
        obs = self._build(
            units=units, game_loop=self.game_loop, player_id=self.player_id,
            map_y=self._map[0], map_x=self._map[1], rng=self._rng,
        )
        if self.game_loop >= self._end_at:
            self.status_ended = True
            from types import SimpleNamespace as NS

            obs.player_result = [
                NS(player_id=1, result=1 if self._winner == 1 else 2),
                NS(player_id=2, result=1 if self._winner == 2 else 2),
            ]
        else:
            obs.player_result = []
        return obs

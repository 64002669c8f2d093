"""A host-side ``BaseEnv`` over the micro-battle world.

Counterpart of ``distar_tpu.envs.jaxenv.host``. ``JaxMicroBattleEnv`` makes
the world a drop-in for the actor stack (``rl_train --env jaxenv`` without
``--anakin``): the reset/step surface, per-agent observation dicts, and the
keys the agent's reward machinery reads (``game_loop``, ``action_result``,
``battle_score``) match MockEnv. One lane runs on ``device`` (CUDA unless
the caller asks for the CPU) and every observation crosses to the host as
numpy in the contract's dtypes: the slow path the Anakin loop replaces,
kept for the actor and for parity tests.

``episode_digest`` is the determinism witness: a sha256 over every
observation byte, reward and done flag of a fully scripted episode, in the
JAX package's order, so a scenario both worlds play gives both the same
digest.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ...utils.transfer import to_host
from ..env import BaseEnv
from .core import WINNER_DRAW, EnvConfig, reset, step
from .obs import observe
from .scenario import Scenario, ScenarioConfig, ScenarioGenerator, make_generator

_ACTION_KEYS = ("action_type", "delay", "queued", "selected_units", "target_unit", "target_location")


def _host_obs(dev_obs: dict) -> dict:
    """Lane 0 of a device observation as host numpy, contract dtypes, in
    one device -> host copy (read-only use: the leaves are views of it)."""
    def lane0(tree):
        if isinstance(tree, dict):
            return {k: lane0(v) for k, v in tree.items()}
        return tree[0]
    return to_host(lane0(dev_obs))


class JaxMicroBattleEnv(BaseEnv):
    """Two-agent BaseEnv over one micro-battle scenario an episode.

    Each ``reset`` draws the next scenario from the env's generator (seeded
    with ``seed``, on ``device``), or replays a pinned ``scenario`` (a batch
    of one lane). Team 0 is agent 0 (home).
    """

    num_agents = 2

    def __init__(self, env_cfg: EnvConfig = EnvConfig(),
                 scenario_cfg: Optional[ScenarioConfig] = None,
                 seed: int = 0, scenario: Optional[Scenario] = None, device=None):
        from ...actor.inference import resolve_device  # the actor package imports envs

        self.cfg = env_cfg
        self.device = resolve_device(device)
        self.gen = ScenarioGenerator(
            scenario_cfg if scenario_cfg is not None
            else ScenarioConfig(units_per_squad=env_cfg.units_per_squad))
        self._generator = make_generator(seed, self.device)
        self._pinned = None if scenario is None else Scenario(*(x.to(self.device) for x in scenario))
        self._state = None
        self._entity_num = {0: 1, 1: 1}

    # --------------------------------------------------------------- BaseEnv
    def _obs_pair(self) -> Dict[int, dict]:
        out = {}
        t = int(self._state.t[0])
        dmg = self._state.dmg_dealt[0].tolist()
        for team in (0, 1):
            o = _host_obs(observe(self.cfg, self._state, team))
            o["game_loop"] = t * self.cfg.loops_per_step
            o["action_result"] = [1]
            o["battle_score"] = float(dmg[team])
            o["opponent_battle_score"] = float(dmg[1 - team])
            # the end token of the next action's pointer rows is this
            # observation's entity_num; kept so step() can recover sun
            self._entity_num[team] = int(o["entity_num"])
            out[team] = o
        return out

    def reset(self) -> Dict[int, dict]:
        scn = self._pinned if self._pinned is not None else self.gen.generate(self._generator)
        self._state = reset(self.cfg, scn)
        return self._obs_pair()

    def _dev_action(self, a: dict) -> dict:
        return {k: torch.as_tensor(np.asarray(a[k], np.int64).reshape((1,) + np.shape(a[k])),
                                   device=self.device) for k in _ACTION_KEYS}

    def _sun(self, a: dict, obs_entity_num: int) -> torch.Tensor:
        """selected_units_num, which host actors do not ship: the position
        of the end token (== entity_num) in the pointer rows."""
        if "selected_units_num" in a:
            n = int(np.asarray(a["selected_units_num"]))
        else:
            su = np.asarray(a["selected_units"]).reshape(-1)
            hits = np.flatnonzero(su == obs_entity_num)
            n = int(hits[0]) + 1 if hits.size else su.shape[0]
        return torch.full((1,), n, dtype=torch.int64, device=self.device)

    def step(self, actions: Dict[int, dict]) -> Tuple[Dict[int, dict], Dict[int, float], bool, dict]:
        if self._state is None:
            raise RuntimeError("step() before reset()")
        if 0 not in actions:
            raise ValueError("agent 0 action required (home team)")
        kw = {}
        if 1 in actions:
            kw["action_away"] = self._dev_action(actions[1])
            kw["selected_units_num_away"] = self._sun(actions[1], self._entity_num[1])
        self._state, rew, done, winner = step(self.cfg, self._state, self._dev_action(actions[0]),
                                              self._sun(actions[0], self._entity_num[0]), **kw)
        obs = self._obs_pair()
        winloss, battle = rew["winloss"][0].tolist(), rew["battle"][0].tolist()
        done = bool(done[0])
        info: dict = {"game_loop": obs[0]["game_loop"], "battle_reward": {0: battle[0], 1: battle[1]}}
        if done:
            w = int(winner[0])
            info["winner"] = -1 if w == WINNER_DRAW else w
        return obs, {0: winloss[0], 1: winloss[1]}, done, info


def episode_digest(seed: int = 0,
                   scenario_cfg: Optional[ScenarioConfig] = None,
                   env_cfg: Optional[EnvConfig] = None,
                   max_steps: int = 64, scenario: Optional[Scenario] = None,
                   device=None) -> dict:
    """Deterministic fingerprint of one fully scripted episode: the home
    team passes no_op (its units auto-acquire), the away team plays the
    scripted controller. Returns the sha256 over the episode, its steps and
    winner; ``scenario`` pins the battle (else the env draws it from
    ``seed``)."""
    from ...lib import features as F

    env_cfg = env_cfg or EnvConfig(units_per_squad=4)
    scenario_cfg = scenario_cfg or ScenarioConfig(
        units_per_squad=env_cfg.units_per_squad,
        max_units=env_cfg.units_per_squad, episode_len=max_steps)
    env = JaxMicroBattleEnv(env_cfg, scenario_cfg, seed=seed, scenario=scenario, device=device)
    obs = env.reset()
    no_op = {
        "action_type": np.asarray(0, np.int64),
        "delay": np.asarray(1, np.int64),
        "queued": np.asarray(0, np.int64),
        "selected_units": np.zeros(F.MAX_SELECTED_UNITS_NUM, np.int64),
        "target_unit": np.asarray(0, np.int64),
        "target_location": np.asarray(0, np.int64),
        "selected_units_num": np.asarray(1, np.int64),
    }
    h = hashlib.sha256()

    def eat(o):
        # the JAX package's leaf order: sorted dict keys, depth first
        for section in ("entity_info", "entity_num", "scalar_info", "spatial_info"):
            leaves = o[section] if section != "entity_num" else {"": o[section]}
            for k in sorted(leaves):
                h.update(np.ascontiguousarray(np.asarray(leaves[k])).tobytes())

    eat(obs[0])
    steps, winner = 0, None
    for _ in range(max_steps):
        obs, rewards, done, info = env.step({0: no_op})
        steps += 1
        eat(obs[0])
        h.update(np.asarray([rewards[0], rewards[1]], np.float64).tobytes())
        h.update(b"\x01" if done else b"\x00")
        if done:
            winner = info.get("winner")
            break
    return {"sha256": h.hexdigest(), "steps": steps, "winner": winner}

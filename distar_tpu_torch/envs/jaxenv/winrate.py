"""Head-to-head win rates over fixed micro-battle scenario sets.

Counterpart of ``distar_tpu.envs.jaxenv.winrate``: ``FleetRollout.compare()``'s
win-rate leg. ``head_to_head`` runs policy A (home) against policy B (away)
on a batch of scenarios, every lane stepping to the timeout (finished lanes
freeze), and reduces the final winner codes to a win-rate summary. The
scenario set is a batch the caller gives (a fixed eval suite) or one drawn
from ``seed``, so an A/B is reproducible and both orderings can be averaged
to cancel the home/away asymmetry.

Policies are ``(obs_batch, carry, generator) -> (action_info,
selected_units_num, carry)`` with an ``init_carry(batch, device)`` hook;
``model_policy`` wraps the port's ``Model.sample_action`` (LSTM carry
threaded, Gumbel draws from the generator), and the scripted
``attack_nearest_policy`` and ``idle_policy`` are the mock engines of the
canary's compare() test.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from ...lib import features as F
from ...obs import get_registry
from .core import WINNER_AWAY, WINNER_HOME, EnvConfig, micro_legal_mask, reset, step
from .obs import observe
from .scenario import Scenario, ScenarioConfig, ScenarioGenerator, make_generator, table

ATTACK_UNIT = 3  # contract action_type: Attack_unit
_MICRO_LEGAL = micro_legal_mask()


class ScriptedPolicy:
    """A stateless policy from a function (obs_batch, generator) -> (action, sun)."""

    def __init__(self, fn: Callable):
        self._fn = fn

    def init_carry(self, batch: int, device=None):
        return None

    def __call__(self, obs, carry, generator=None):
        action, sun = self._fn(obs, generator)
        return action, sun, carry


def _attack_nearest(obs, generator=None):
    """Select every own unit and focus fire on the enemy slot nearest the
    squad's centroid (the packed observation puts own alive units first,
    enemies after; entity x/y are the rounded pixel positions)."""
    alliance = obs["entity_info"]["alliance"]          # [B, 512]
    B, dev = alliance.shape[0], alliance.device
    S = F.MAX_SELECTED_UNITS_NUM
    entity_num = obs["entity_num"].long()               # [B]
    slot_ok = torch.arange(F.MAX_ENTITY_NUM, device=dev) < entity_num[:, None]
    own = (alliance == 1) & slot_ok
    enemy = (alliance == 4) & slot_ok
    n_own = own.sum(1)                                  # [B]
    lane = torch.arange(S, device=dev)[None]            # [1, S]
    su = torch.where(lane < n_own[:, None], lane,
                     torch.where(lane == n_own[:, None], entity_num[:, None], 0))
    sun = torch.clamp_max(n_own + 1, S)
    ex = obs["entity_info"]["x"].float()
    ey = obs["entity_info"]["y"].float()
    cnt = torch.clamp_min(n_own, 1)
    cx = torch.where(own, ex, 0.0).sum(1) / cnt
    cy = torch.where(own, ey, 0.0).sum(1) / cnt
    d2 = (ex - cx[:, None]) * (ex - cx[:, None]) + (ey - cy[:, None]) * (ey - cy[:, None])
    target = torch.argmin(torch.where(enemy, d2, torch.inf), dim=1)
    # argmin over an all-inf row gives 0; fall back to the first enemy slot
    target = torch.where(enemy.any(1), target, torch.clamp_max(n_own, F.MAX_ENTITY_NUM - 1))
    zeros = torch.zeros(B, dtype=torch.int64, device=dev)
    action = {
        "action_type": torch.full((B,), ATTACK_UNIT, dtype=torch.int64, device=dev),
        "delay": torch.ones(B, dtype=torch.int64, device=dev),
        "queued": zeros,
        "selected_units": su,
        "target_unit": target,
        "target_location": zeros,
    }
    return action, sun


def _idle(obs, generator=None):
    entity_num = obs["entity_num"]
    B, dev = entity_num.shape[0], entity_num.device
    zeros = torch.zeros(B, dtype=torch.int64, device=dev)
    action = {
        "action_type": zeros,
        "delay": torch.ones(B, dtype=torch.int64, device=dev),
        "queued": zeros,
        "selected_units": torch.zeros(B, F.MAX_SELECTED_UNITS_NUM, dtype=torch.int64, device=dev),
        "target_unit": zeros,
        "target_location": zeros,
    }
    return action, torch.ones(B, dtype=torch.int64, device=dev)


def attack_nearest_policy() -> ScriptedPolicy:
    return ScriptedPolicy(_attack_nearest)


def idle_policy() -> ScriptedPolicy:
    return ScriptedPolicy(_idle)


class ModelPolicy:
    """``Model.sample_action`` with its own LSTM carry; ``restrict_micro``
    confines action_type to the micro-battle vocabulary."""

    def __init__(self, model, restrict_micro: bool = True):
        self.model = model
        lstm = model.cfg["encoder"]["core_lstm"]
        self._hidden_size = int(lstm["hidden_size"])
        self._hidden_layers = int(lstm["num_layers"])
        self.restrict_micro = restrict_micro

    def init_carry(self, batch: int, device=None):
        z = torch.zeros(batch, self._hidden_size, device=device)
        return tuple((z, z) for _ in range(self._hidden_layers))

    def __call__(self, obs, carry, generator=None, noise=None):
        """``noise`` (one Gumbel draw per head) stands in for the generator."""
        legal = table(_MICRO_LEGAL, obs["entity_num"].device) if self.restrict_micro else None
        out = self.model.sample_action(obs["spatial_info"], obs["entity_info"], obs["scalar_info"],
                                       obs["entity_num"], carry, noise=noise, generator=generator,
                                       legal_mask=legal)
        return out["action_info"], out["selected_units_num"], out["hidden_state"]


def model_policy(model, restrict_micro: bool = True) -> ModelPolicy:
    return ModelPolicy(model, restrict_micro=restrict_micro)


def head_to_head(policy_a, policy_b,
                 episodes: int = 16, seed: int = 0,
                 scenarios: Optional[Scenario] = None,
                 env_cfg: EnvConfig = EnvConfig(),
                 scenario_cfg: Optional[ScenarioConfig] = None,
                 device=None) -> dict:
    """Policy A (home) against policy B (away) over a fixed scenario set.

    Returns ``{win_rate, wins, losses, draws, episodes}``, ``win_rate``
    counting a draw as half a win for A, and what a payoff ledger takes:
    ``matches`` (one ``{winner, draw, game_steps}`` record per episode, in
    lane order), ``mean_game_steps`` and ``duration_s`` (the wall time of
    the batch). ``scenarios`` pins the set (the league's fixed eval suite);
    otherwise ``episodes`` scenarios are drawn from ``seed`` on ``device``
    (CUDA unless the caller asks for the CPU). Both policies draw from one
    generator seeded with ``seed``, A before B each step."""
    from ...actor.inference import resolve_device  # the actor package imports envs

    scenario_cfg = (scenario_cfg if scenario_cfg is not None
                    else ScenarioConfig(units_per_squad=env_cfg.units_per_squad))
    if scenario_cfg.units_per_squad != env_cfg.units_per_squad:
        raise ValueError("scenario_cfg.units_per_squad must match env_cfg")
    t0 = time.monotonic()
    if scenarios is None:
        generator = make_generator(seed, resolve_device(device))
        scenarios = ScenarioGenerator(scenario_cfg).batch(episodes, generator)
    else:
        generator = make_generator(seed, scenarios.pos_home.device)
    B, dev = scenarios.batch_size, scenarios.pos_home.device
    with torch.no_grad():
        states = reset(env_cfg, scenarios)
        ca, cb = policy_a.init_carry(B, dev), policy_b.init_carry(B, dev)
        for _ in range(int(scenario_cfg.episode_len)):
            act_a, sun_a, ca = policy_a(observe(env_cfg, states, 0), ca, generator)
            act_b, sun_b, cb = policy_b(observe(env_cfg, states, 1), cb, generator)
            states, _, _, _ = step(env_cfg, states, act_a, sun_a, act_b, sun_b)
    # lanes freeze after done, so t is each lane's terminal step
    winner, game_steps = states.winner.tolist(), states.t.tolist()
    duration_s = time.monotonic() - t0
    wins = sum(w == WINNER_HOME for w in winner)
    losses = sum(w == WINNER_AWAY for w in winner)
    draws = B - wins - losses
    win_rate = (wins + 0.5 * draws) / max(B, 1)
    names = {WINNER_HOME: "home", WINNER_AWAY: "away"}
    matches = [{"winner": names.get(w, "draw"), "draw": names.get(w, "draw") == "draw", "game_steps": s}
               for w, s in zip(winner, game_steps)]
    get_registry().gauge(
        "distar_env_head2head_win_rate",
        "home-side win rate of the last jaxenv head-to-head evaluation",
    ).set(win_rate)
    return {"win_rate": win_rate, "wins": wins, "losses": losses,
            "draws": draws, "episodes": B, "matches": matches,
            "mean_game_steps": sum(game_steps) / B if B else 0.0,
            "duration_s": duration_s}

"""Micro-battle dynamics in PyTorch: reset and step over fixed-shape unit
tensors, for a batch of lanes at once.

Counterpart of ``distar_tpu.envs.jaxenv.core``. Two squads of units
(positions, health, cooldowns) fight on the contract's spatial rectangle.
Commands arrive in the real Features action layout — action_type indexes
the 327-action vocabulary, selected_units are pointer slots into the
observation's entity list, target_unit is an entity slot, target_location
a flat spatial index — and are decoded on the device through semantic
lookup tables built once from the action contract. Reward is the damage
differential (``battle``) plus a terminal win bonus (``winloss``).

Every leaf carries a leading lane axis [B]; the functions are written
batched (no vmap), make no host copy and read nothing back, so a whole
rollout window stays on the device. They give the JAX package's states,
rewards and winners on the same scenarios and actions, bit for bit
(tests/test_torch_jaxenv.py): where XLA's CPU backend fuses a multiply-add
or takes a constant's reciprocal, so does the port (``fma``, ``norm2``).
Damage taken is summed per target with a one-hot product where JAX
scatter-adds; both are exact, every damage and health value being a whole
number.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...lib import actions as ACT
from ...lib import features as F
from .scenario import (
    CATALOG_COOLDOWN,
    CATALOG_DAMAGE,
    CATALOG_HEALTH,
    CATALOG_RANGE,
    CATALOG_SPEED,
    CELL,
    GRID_W,
    MAP_H,
    MAP_W,
    Scenario,
    table,
)

# ------------------------------------------------------------ semantic LUTs
# Order kinds a unit can hold between steps.
KIND_STOP, KIND_MOVE, KIND_ATTACK_MOVE, KIND_ATTACK_UNIT = 0, 1, 2, 3

# action_type -> command semantics, from the action contract's per-head
# flags: unit-targeted actions attack the target, location actions move
# (attack-move for an Attack variant), bare selected-units actions stop.
_SEM_NONE, _SEM_MOVE, _SEM_ATTACK_MOVE, _SEM_ATTACK_UNIT, _SEM_STOP = 0, 1, 2, 3, 4


def _build_action_semantics() -> np.ndarray:
    sem = np.zeros(ACT.NUM_ACTIONS, np.int32)
    for i, a in enumerate(ACT.ACTIONS):
        if a["target_unit"]:
            sem[i] = _SEM_ATTACK_UNIT
        elif a["target_location"]:
            sem[i] = _SEM_ATTACK_MOVE if "Attack" in a["name"] else _SEM_MOVE
        elif a["selected_units"]:
            sem[i] = _SEM_STOP
    return sem


ACTION_SEMANTIC = _build_action_semantics()
_SEM_TO_KIND = np.array(
    [KIND_STOP, KIND_MOVE, KIND_ATTACK_MOVE, KIND_ATTACK_UNIT, KIND_STOP], np.int32)
_SELECTED_UNITS_MASK = np.ascontiguousarray(ACT.SELECTED_UNITS_MASK)

# The micro-battle action subset (the policy's optional legal mask): no_op,
# Attack_pt, Attack_unit, HoldPosition, Move_pt, Move_unit, Smart_pt,
# Smart_unit, Stop. Every other action decodes to one of these semantics.
MICRO_ACTION_TYPES = (0, 2, 3, 156, 197, 198, 265, 266, 267)


def micro_legal_mask() -> np.ndarray:
    mask = np.zeros(ACT.NUM_ACTIONS, bool)
    mask[list(MICRO_ACTION_TYPES)] = True
    return mask


# Winner codes (EnvState.winner)
WINNER_NONE, WINNER_HOME, WINNER_AWAY, WINNER_DRAW = -1, 0, 1, 2

_MAP_HI = np.array([MAP_W - 0.5, MAP_H - 0.5], np.float32)


@dataclass(frozen=True)
class EnvConfig:
    """Static dynamics knobs."""

    units_per_squad: int = 8
    loops_per_step: int = 22      # game loops one env step represents
    damage_norm: float = 200.0    # battle reward = damage diff / this
    timeout_margin: float = 0.05  # health-fraction lead needed to win a timeout
    hit_slack: float = 1.0        # px of target-radius slack on weapon range

    @property
    def num_units(self) -> int:
        return 2 * self.units_per_squad


class EnvState(NamedTuple):
    """Complete battle state of B lanes (N = 2 * U units a lane; the first
    U slots are home, the rest away)."""

    scenario: Scenario
    pos: torch.Tensor            # f32 [B, N, 2] (x, y)
    health: torch.Tensor         # f32 [B, N]
    max_health: torch.Tensor     # f32 [B, N]
    cooldown: torch.Tensor       # f32 [B, N] steps until the weapon is ready
    alive: torch.Tensor          # bool [B, N]
    order_kind: torch.Tensor     # i32 [B, N] KIND_*
    order_pos: torch.Tensor      # f32 [B, N, 2]
    order_target: torch.Tensor   # i32 [B, N] unit index, -1 = none
    t: torch.Tensor              # i32 [B] env steps taken
    done: torch.Tensor           # bool [B]
    winner: torch.Tensor         # i32 [B] WINNER_*
    last_action: torch.Tensor    # i32 [B, 2, 3] per team (action_type, delay, queued)
    last_selected: torch.Tensor  # bool [B, 2, N] units in each team's last selection
    last_targeted: torch.Tensor  # bool [B, 2, N] unit each team last targeted
    dmg_dealt: torch.Tensor      # f32 [B, 2] cumulative damage by team
    kills: torch.Tensor          # f32 [B, 2] cumulative kills by team

    @property
    def device(self) -> torch.device:
        return self.pos.device


def team_vector(cfg: EnvConfig, device) -> torch.Tensor:
    """i32 [N]: 0 for home slots, 1 for away slots."""
    U = cfg.units_per_squad
    return (torch.arange(2 * U, device=device) >= U).to(torch.int32)


def reset(cfg: EnvConfig, scenario: Scenario) -> EnvState:
    U, N = cfg.units_per_squad, cfg.num_units
    B = scenario.batch_size
    dev = scenario.pos_home.device
    types = torch.cat([scenario.type_home, scenario.type_away], 1).long()
    slot = torch.arange(U, device=dev)
    alive = torch.cat([slot < scenario.n_home[:, None], slot < scenario.n_away[:, None]], 1)
    pos = torch.cat([scenario.pos_home, scenario.pos_away], 1).float()
    # masked like health, so never-spawned pad slots add nothing to the
    # timeout's health-fraction denominator
    health = table(CATALOG_HEALTH, dev)[types] * alive
    i32 = torch.int32
    return EnvState(
        scenario=scenario,
        pos=pos,
        health=health,
        max_health=health.clone(),
        cooldown=torch.zeros(B, N, device=dev),
        alive=alive,
        order_kind=torch.zeros(B, N, dtype=i32, device=dev),
        order_pos=pos.clone(),
        order_target=torch.full((B, N), -1, dtype=i32, device=dev),
        t=torch.zeros(B, dtype=i32, device=dev),
        done=torch.zeros(B, dtype=torch.bool, device=dev),
        winner=torch.full((B,), WINNER_NONE, dtype=i32, device=dev),
        last_action=torch.zeros(B, 2, 3, dtype=i32, device=dev),
        last_selected=torch.zeros(B, 2, N, dtype=torch.bool, device=dev),
        last_targeted=torch.zeros(B, 2, N, dtype=torch.bool, device=dev),
        dmg_dealt=torch.zeros(B, 2, device=dev),
        kills=torch.zeros(B, 2, device=dev),
    )


def unit_types(cfg: EnvConfig, state: EnvState) -> torch.Tensor:
    """i64 [B, N] catalog row per unit slot."""
    return torch.cat([state.scenario.type_home, state.scenario.type_away], 1).long()


def pack_perm(cfg: EnvConfig, state: EnvState, team: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Entity packing for ``team``'s observation: a permutation [B, N]
    placing the team's own alive units first, then alive enemies, then dead
    slots (valid entities in the first entity_num rows), and the alive
    count [B]. ``step`` decodes pointer actions through the same
    permutation, so the entity slots the model emits land on these units."""
    own = team_vector(cfg, state.device) == team
    alive = state.alive
    rank = torch.where(alive & own, 0, torch.where(alive & ~own, 1, 2))
    perm = torch.argsort(rank, dim=1, stable=True)
    return perm, alive.sum(1)


def _lane(x, B: int, dev, shape=()) -> torch.Tensor:
    """An action field as an int64 tensor [B, *shape] on ``dev``."""
    return torch.as_tensor(x, device=dev).reshape((B,) + shape).long()


def _decode_team_action(cfg: EnvConfig, state: EnvState, team: int,
                        action: dict, selected_units_num) -> EnvState:
    """Apply one team's contract-layout action to its units' orders."""
    N = cfg.num_units
    B = state.t.shape[0]
    dev = state.device
    at = _lane(action["action_type"], B, dev).clamp(0, ACT.NUM_ACTIONS - 1)
    sem = table(ACTION_SEMANTIC, dev)[at].long()
    has_sel = table(_SELECTED_UNITS_MASK, dev)[at]
    perm, entity_num = pack_perm(cfg, state, team)

    # selected-units pointer: entity slots -> unit ids; the end-token lane
    # (and any junk after it) excluded through selected_units_num
    S = F.MAX_SELECTED_UNITS_NUM
    su = _lane(action["selected_units"], B, dev, (S,))
    sun = _lane(selected_units_num, B, dev)
    lane_ok = ((torch.arange(S, device=dev) < (sun - 1)[:, None]) & (su >= 0)
               & (su < entity_num[:, None]) & (su < N))
    sel_unit_ids = perm.gather(1, su.clamp(0, N - 1))
    # a max over repeated slots: a count above zero
    sel = torch.zeros(B, N, dtype=torch.int32, device=dev).scatter_add_(
        1, sel_unit_ids, lane_ok.to(torch.int32)) > 0
    own = team_vector(cfg, dev) == team
    sel = sel & own & state.alive

    # target unit: an entity slot in the same packed view
    tslot = _lane(action["target_unit"], B, dev)
    t_ok = (tslot >= 0) & (tslot < entity_num) & (tslot < N)
    target_id = perm.gather(1, tslot.clamp(0, N - 1)[:, None])[:, 0]

    # target location: flat index over the (y, x) spatial rectangle
    loc = _lane(action["target_location"], B, dev).clamp(0, MAP_H * MAP_W - 1)
    tpos = torch.stack([(loc % MAP_W).float(), (loc // MAP_W).float()], -1)

    attack_unit = sem == _SEM_ATTACK_UNIT
    valid = has_sel & (sem != _SEM_NONE) & torch.where(attack_unit, t_ok, True)
    upd = sel & valid[:, None]
    new_kind = table(_SEM_TO_KIND, dev)[sem]
    order_kind = torch.where(upd, new_kind[:, None], state.order_kind)
    order_pos = torch.where(upd[..., None], tpos[:, None, :], state.order_pos)
    order_target = torch.where(
        upd, torch.where(attack_unit, target_id, -1).to(torch.int32)[:, None], state.order_target)

    zero = torch.zeros_like(at)
    last_action = state.last_action.clone()
    last_action[:, team] = torch.stack([
        at, _lane(action["delay"], B, dev) if "delay" in action else zero,
        _lane(action["queued"], B, dev) if "queued" in action else zero], -1).to(torch.int32)
    targeted = torch.zeros(B, N, dtype=torch.bool, device=dev).scatter_(
        1, target_id[:, None], (valid & attack_unit & upd.any(1))[:, None])
    last_selected = state.last_selected.clone()
    last_selected[:, team] = sel
    last_targeted = state.last_targeted.clone()
    last_targeted[:, team] = targeted
    return state._replace(order_kind=order_kind, order_pos=order_pos, order_target=order_target,
                          last_action=last_action, last_selected=last_selected,
                          last_targeted=last_targeted)


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once, as a fused multiply-add (the product
    is exact in float64; the sum's double rounding is innocuous)."""
    c = c.double() if isinstance(c, torch.Tensor) else c
    b = b.double() if isinstance(b, torch.Tensor) else b
    return torch.add(torch.mul(a.double(), b), c).float()


def norm2(v: torch.Tensor) -> torch.Tensor:
    """The Euclidean norm of [..., 2] vectors as XLA's CPU backend computes
    ``jnp.linalg.norm(v, axis=-1)``: sqrt(fma(y, y, x * x)), the square root
    correctly rounded (taken in float64: torch's float32 sqrt on the CPU is
    not always)."""
    x, y = v[..., 0], v[..., 1]
    return torch.sqrt(fma(y, y, torch.mul(x, x)).double()).float()


def _distances(pos: torch.Tensor) -> torch.Tensor:
    """[B, N, N] Euclidean distances between units."""
    return norm2(pos[:, :, None, :] - pos[:, None, :, :])


def _scripted_orders(cfg: EnvConfig, state: EnvState, team: int) -> EnvState:
    """The built-in opponent: every unit of ``team`` attack-moves at the
    nearest living enemy (a chase-and-shoot baseline, no randomness)."""
    own = team_vector(cfg, state.device) == team
    enemy_alive = state.alive & ~own
    d = torch.where(enemy_alive[:, None, :], _distances(state.pos), torch.inf)
    nearest = torch.argmin(d, dim=2)
    upd = own & state.alive & enemy_alive.any(1)[:, None]
    nearest_pos = state.pos.gather(1, nearest[..., None].expand(-1, -1, 2))
    return state._replace(
        order_kind=torch.where(upd, KIND_ATTACK_MOVE, state.order_kind),
        order_pos=torch.where(upd[..., None], nearest_pos, state.order_pos),
        order_target=torch.where(upd, -1, state.order_target),
    )


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, ...] at per-unit indices idx [B, N] along the unit axis."""
    if x.dim() == 2:
        return x.gather(1, idx)
    return x.gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))


def step(cfg: EnvConfig, state: EnvState,
         action_home: dict, selected_units_num_home,
         action_away: Optional[dict] = None, selected_units_num_away=None):
    """One simultaneous tick of every lane. ``action_away=None`` plays the
    scripted opponent. Returns ``(state, reward, done, winner)`` where
    ``reward`` is ``{"battle": f32 [B, 2], "winloss": f32 [B, 2]}`` (home,
    away). Once a lane is done its state freezes and further steps are
    zero-reward no-ops (window padding, masked out by the Anakin loop)."""
    prev = state
    prev_done = state.done
    dev = state.device
    team_of = team_vector(cfg, dev)
    U, N = cfg.units_per_squad, cfg.num_units
    types = unit_types(cfg, state)

    state = _decode_team_action(cfg, state, 0, action_home, selected_units_num_home)
    if action_away is None:
        state = _scripted_orders(cfg, state, 1)
    else:
        state = _decode_team_action(cfg, state, 1, action_away, selected_units_num_away)

    rng_ = table(CATALOG_RANGE, dev)[types] + cfg.hit_slack
    dmg_ = table(CATALOG_DAMAGE, dev)[types]
    spd_ = table(CATALOG_SPEED, dev)[types]
    cd_ = table(CATALOG_COOLDOWN, dev)[types]
    pos, alive, kind = state.pos, state.alive, state.order_kind

    # --- target resolution
    d = _distances(pos)
    enemy = team_of[:, None] != team_of[None, :]
    d_cand = torch.where(enemy[None] & alive[:, None, :], d, torch.inf)
    nearest_d = d_cand.amin(2)
    nearest = torch.argmin(d_cand, dim=2)  # the first of equal distances, as jnp.argmin
    ot = state.order_target.long().clamp(0, N - 1)
    explicit_ok = (kind == KIND_ATTACK_UNIT) & (state.order_target >= 0) & alive.gather(1, ot)
    # stop/hold and attack-move auto-acquire in range; a plain move does
    # not shoot. An explicit attack whose target is still out of range also
    # auto-acquires: chasers return fire on the way in.
    explicit_near = explicit_ok & (d.gather(2, ot[..., None])[..., 0] <= rng_)
    auto = (kind == KIND_STOP) | (kind == KIND_ATTACK_MOVE) | (explicit_ok & ~explicit_near)
    auto_ok = auto & torch.isfinite(nearest_d)
    target = torch.where(explicit_near, ot, torch.where(auto_ok, nearest, -1))
    t_idx = target.clamp(0, N - 1)
    t_dist = d.gather(2, t_idx[..., None])[..., 0]
    engaged = (target >= 0) & (t_dist <= rng_)
    shoot = alive & engaged & (state.cooldown <= 0.0)

    # damage taken per unit: the shots aimed at it summed (whole numbers,
    # exact in any order)
    hits = t_idx[:, :, None] == torch.arange(N, device=dev)  # [B, shooter, target]
    dmg_in = (hits * torch.where(shoot, dmg_, 0.0)[:, :, None]).sum(1)
    cooldown = torch.where(shoot, cd_, torch.clamp_min(state.cooldown - 1.0, 0.0))

    # --- movement (attackers in range hold; everyone else follows orders)
    chase = explicit_ok & ~engaged
    dest = torch.where(
        chase[..., None], _take(pos, t_idx),
        torch.where(((kind == KIND_MOVE) | (kind == KIND_ATTACK_MOVE))[..., None],
                    state.order_pos, pos))
    dvec = dest - pos
    dist = norm2(dvec)
    stepv = dvec / torch.clamp_min(dist, 1e-6)[..., None] * torch.minimum(spd_, dist)[..., None]
    moving = alive & ~engaged & (dist > 1e-3)
    newpos = pos + torch.where(moving[..., None], stepv, 0.0)
    newpos = torch.minimum(newpos.clamp_min(0.5), table(_MAP_HI, dev))

    terrain = state.scenario.terrain.reshape(state.scenario.terrain.shape[0], -1)

    def passable(p):
        cell = torch.div(p, CELL, rounding_mode="floor").long()
        return terrain.gather(1, cell[..., 1] * GRID_W + cell[..., 0])

    # wall slide: when the full step lands in a blocked cell, fall back to
    # the x-only then the y-only component, so units skirt walls
    slide_x = torch.stack([newpos[..., 0], pos[..., 1]], -1)
    slide_y = torch.stack([pos[..., 0], newpos[..., 1]], -1)
    cand = torch.where(passable(newpos)[..., None], newpos,
                       torch.where(passable(slide_x)[..., None], slide_x,
                                   torch.where(passable(slide_y)[..., None], slide_y, pos)))
    pos = torch.where(moving[..., None], cand, pos)

    # --- health and outcome
    health = torch.clamp_min(state.health - dmg_in, 0.0)
    alive2 = alive & (health > 0.0)
    died = alive & ~alive2
    dealt = torch.where(shoot, torch.minimum(dmg_, state.health.gather(1, t_idx)), 0.0)
    home_slot, away_slot = team_of == 0, team_of == 1
    dealt_home = (dealt * home_slot).sum(1)
    dealt_away = (dealt * away_slot).sum(1)
    kills_home = (died & away_slot).sum(1).float()
    kills_away = (died & home_slot).sum(1).float()

    t2 = state.t + 1
    home_alive = alive2[:, :U].any(1)
    away_alive = alive2[:, U:].any(1)
    timeout = t2 >= state.scenario.episode_len
    end = ~home_alive | ~away_alive | timeout
    hfrac = health[:, :U].sum(1) / torch.clamp_min(state.max_health[:, :U].sum(1), 1e-6)
    afrac = health[:, U:].sum(1) / torch.clamp_min(state.max_health[:, U:].sum(1), 1e-6)
    timeout_winner = torch.where(
        hfrac > afrac + cfg.timeout_margin, WINNER_HOME,
        torch.where(afrac > hfrac + cfg.timeout_margin, WINNER_AWAY, WINNER_DRAW))
    winner = torch.where(
        ~end, WINNER_NONE,
        torch.where(home_alive & ~away_alive, WINNER_HOME,
                    torch.where(away_alive & ~home_alive, WINNER_AWAY,
                                torch.where(~home_alive & ~away_alive, WINNER_DRAW,
                                            timeout_winner)))).to(torch.int32)

    # XLA compiles the division by a constant as a product by its reciprocal
    battle_home = (dealt_home - dealt_away) * (1.0 / cfg.damage_norm)
    winloss_home = torch.where(end & (winner == WINNER_HOME), 1.0,
                               torch.where(end & (winner == WINNER_AWAY), -1.0, 0.0))

    new_state = state._replace(
        pos=pos, health=health, cooldown=cooldown, alive=alive2,
        t=t2, done=state.done | end, winner=winner,
        dmg_dealt=state.dmg_dealt + torch.stack([dealt_home, dealt_away], -1),
        kills=state.kills + torch.stack([kills_home, kills_away], -1),
    )
    # freeze after done: padded steps replay the terminal state, zero reward
    new_state = lane_where(prev_done, prev, new_state)
    live = 1.0 - prev_done.float()
    reward = {
        "battle": torch.stack([battle_home, -battle_home], -1) * live[:, None],
        "winloss": torch.stack([winloss_home, -winloss_home], -1) * live[:, None],
    }
    return new_state, reward, new_state.done, new_state.winner


def lane_where(cond: torch.Tensor, a, b):
    """Lane-wise select over a state (or any NamedTuple of tensors): lane i
    of every leaf from ``a`` where ``cond[i]``, else from ``b``."""
    if isinstance(a, tuple):
        return type(a)(*(lane_where(cond, x, y) for x, y in zip(a, b)))
    return torch.where(cond.reshape((-1,) + (1,) * (b.dim() - 1)), a, b)

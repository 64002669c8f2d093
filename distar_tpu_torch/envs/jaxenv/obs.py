"""The Features observation of a batch of lanes, built on the device.

Counterpart of ``distar_tpu.envs.jaxenv.obs``. ``observe(cfg, state,
team)`` gives exactly the schema in ``lib.features`` with a leading lane
axis: SPATIAL_INFO planes [B, 152, 160] (effect_* as coordinate lists),
SCALAR_INFO fields, ENTITY_INFO vectors padded to MAX_ENTITY_NUM, in the
contract's dtypes, from tensor operations only, so it runs inside an
Anakin window. ``entity_num`` is the contract's int64 (the JAX package's
device copy is int32: JAX runs without x64 there).

Entity packing (own alive units first, then enemies) comes from
``core.pack_perm``, the permutation ``core.step`` decodes pointer actions
through, so the model's entity slots always name these rows.
"""
from __future__ import annotations

import numpy as np
import torch

from ...lib import actions as ACT
from ...lib import features as F
from .core import EnvConfig, EnvState, fma, pack_perm, team_vector, unit_types
from .scenario import CATALOG_DENSE_TYPES, CELL, GRID_H, GRID_W, MAP_H, MAP_W, table

# SC2 player_relative plane codes
_PR_SELF, _PR_ENEMY = 1, 4
_RACE_ZERG = 2

_TORCH_DTYPE = {np.dtype(k): v for k, v in (
    (np.uint8, torch.uint8), (np.int8, torch.int8), (np.int16, torch.int16),
    (np.int32, torch.int32), (np.int64, torch.int64), (np.float16, torch.float16),
    (np.float32, torch.float32), (np.bool_, torch.bool))}


def torch_dtype(dt) -> torch.dtype:
    return _TORCH_DTYPE[np.dtype(dt)]


# The f32 log1p that XLA's CPU backend compiles jnp.log1p into: a Cephes
# polynomial for log(1 + x), a rational function below sqrt(2) - 1, with
# its multiply-adds fused (FMA). Reproduced op for op, each fused
# multiply-add as one rounding of the exact float64 result, so the
# observation's agent_statistics come out bit-equal to the JAX package's
# (torch.log1p rounds about one whole number in 100 the other way).
# Coefficients in evaluation order.
_LOG_A = (0.07037683576345444, -0.11514610052108765, 0.11676998436450958)
_LOG_B = (-0.12420140951871872, 0.14249323308467865, -0.16668057441711426)
_LOG_C = (0.2000071406364441, -0.24999994039535522, 0.3333333134651184)
_LOG1P_P = (4.527000055531971e-05, 0.4985410273075104, 6.578732490539551, 29.91191864013672,
            60.949668884277344, 57.11296463012695, 20.039552688598633)
_LOG1P_Q = (1.0, 15.062909126281738, 83.04756927490234, 221.7624053955078, 309.0987243652344,
            216.42788696289062, 60.11865997314453)
_FLT_MIN = 1.1754943508222875e-38
_SQRT_HALF = 0.7071067690849304
_SMALL = 0.4142135679721832


def _poly(x: torch.Tensor, coeffs) -> torch.Tensor:
    """Horner's rule from the first coefficient, one FMA a step."""
    acc = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        acc = fma(acc, x, c)
    return acc


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """float32 log1p(x), bit-equal to XLA's CPU lowering of ``jnp.log1p``
    (XLA flushes subnormal inputs to zero; this does not)."""
    y = torch.add(x, 1.0)
    bits = torch.where(y > _FLT_MIN, y, _FLT_MIN).view(torch.int32)
    m = torch.bitwise_or(torch.bitwise_and(bits, 0x7FFFFF), 0x3F000000).view(torch.float32)
    e = torch.add(torch.sub(torch.bitwise_right_shift(bits, 23), 127).float(), 1.0)
    low = m < _SQRT_HALF
    xx = torch.add(torch.add(m, -1.0), torch.where(low, m, 0.0))
    e = torch.sub(e, torch.where(low, 1.0, 0.0))
    z = torch.mul(xx, xx)
    z3 = torch.mul(z, xx)
    a, b, c = (fma(fma(xx, k[0], k[1]), xx, k[2]) for k in (_LOG_A, _LOG_B, _LOG_C))
    p = fma(fma(fma(a, z3, b), z3, c), z3, torch.mul(e, -0.00021219444170128554))
    r = fma(e, 0.693359375, torch.add(fma(z, -0.5, xx), p))
    large = torch.where(y == 0.0, -torch.inf, torch.where((y < 0.0) | torch.isnan(y), torch.nan, r))
    large = torch.where(y == torch.inf, torch.inf, large)
    x2 = torch.mul(x, x)
    ratio = torch.div(_poly(x, _LOG1P_P), _poly(x, _LOG1P_Q))
    small = torch.add(x, torch.add(torch.mul(x2, -0.5), torch.mul(torch.mul(x, x2), ratio)))
    return torch.where(torch.abs(x) < _SMALL, small, large)


def observe(cfg: EnvConfig, state: EnvState, team: int = 0) -> dict:
    """One team's schema-complete observation of every lane (device tensors)."""
    N = cfg.num_units
    B = state.t.shape[0]
    dev = state.device
    own = team_vector(cfg, dev) == team
    perm, entity_num = pack_perm(cfg, state, team)
    slot_mask = torch.arange(N, device=dev) < entity_num[:, None]

    dense = table(CATALOG_DENSE_TYPES, dev)[unit_types(cfg, state)]
    px = torch.round(state.pos[..., 0]).clamp(0, MAP_W - 1)
    py = torch.round(state.pos[..., 1]).clamp(0, MAP_H - 1)

    def entities(unit_vals, dtype):
        """[B, N] per-unit values -> the packed, zero-padded [B, 512] vector."""
        vals = torch.where(slot_mask, unit_vals.gather(1, perm), 0)
        out = torch.zeros(B, F.MAX_ENTITY_NUM, dtype=torch_dtype(dtype), device=dev)
        out[:, :N] = vals.to(out.dtype)
        return out

    ordered = (state.order_kind != 0).to(torch.int32)
    entity_info = {k: torch.zeros(B, F.MAX_ENTITY_NUM, dtype=torch_dtype(dt), device=dev)
                   for k, dt in F.ENTITY_INFO.items()}
    entity_info.update(
        unit_type=entities(dense, np.int16),
        alliance=entities(torch.where(own, _PR_SELF, _PR_ENEMY).expand(B, N), np.uint8),
        x=entities(px, np.uint8),
        y=entities(py, np.uint8),
        health_ratio=entities(state.health / torch.clamp_min(state.max_health, 1e-6), np.float16),
        build_progress=entities(torch.ones(B, N, device=dev), np.float16),
        display_type=entities(torch.ones(B, N, dtype=torch.int32, device=dev), np.uint8),
        weapon_cooldown=entities(torch.ceil(state.cooldown).clamp(0, 255), np.uint8),
        is_active=entities(ordered, np.uint8),
        order_length=entities(ordered, np.uint8),
        last_selected_units=entities(state.last_selected[:, team].to(torch.int32), np.int8),
        last_targeted_unit=entities(state.last_targeted[:, team].to(torch.int32), np.int8),
    )

    # --- spatial planes
    terrain8 = (state.scenario.terrain[:, :, None, :, None]
                .expand(B, GRID_H, CELL, GRID_W, CELL).reshape(B, MAP_H, MAP_W).to(torch.uint8))
    cell = py.long() * MAP_W + px.long()
    pr_val = torch.where(state.alive, torch.where(own, _PR_SELF, _PR_ENEMY), 0).to(torch.int32)
    # the largest code a pixel gets (dead units give 0, the empty value)
    player_relative = torch.zeros(B, MAP_H * MAP_W, dtype=torch.int32, device=dev).scatter_reduce_(
        1, cell, pr_val, "amax").to(torch.uint8).view(B, MAP_H, MAP_W)
    zeros = torch.zeros(B, MAP_H, MAP_W, dtype=torch.uint8, device=dev)
    spatial_info = {
        "height_map": terrain8 * 64,
        "visibility_map": torch.full((B, MAP_H, MAP_W), 2, dtype=torch.uint8, device=dev),
        "creep": zeros,
        "player_relative": player_relative,
        "alerts": zeros.clone(),
        "pathable": terrain8,
        "buildable": terrain8.clone(),
    }
    for k, dt in F.SPATIAL_INFO.items():
        if k.startswith("effect_"):
            spatial_info[k] = torch.zeros(B, F.EFFECT_LENGTH, dtype=torch_dtype(dt), device=dev)

    # --- scalar stats
    own_alive = state.alive & own
    enemy_alive = state.alive & ~own
    own_counts = torch.zeros(B, ACT.NUM_UNIT_TYPES, dtype=torch.int32, device=dev).scatter_add_(
        1, dense, own_alive.to(torch.int32))
    enemy_counts = torch.zeros(B, ACT.NUM_UNIT_TYPES, dtype=torch.int32, device=dev).scatter_add_(
        1, dense, enemy_alive.to(torch.int32))
    stats = torch.stack([
        own_alive.sum(1).float(),
        (state.health * own).sum(1),
        enemy_alive.sum(1).float(),
        state.dmg_dealt[:, team],
        state.dmg_dealt[:, 1 - team],
        state.kills[:, team],
        state.kills[:, 1 - team],
        state.t.float(),
        (state.max_health * own).sum(1),
        (state.max_health * ~own).sum(1),
    ], -1)
    scalar_info = {k: torch.zeros((B,) + tuple(shape), dtype=torch_dtype(dt), device=dev)
                   for k, (dt, shape) in F.SCALAR_INFO.items()}
    last = state.last_action[:, team]
    scalar_info.update(
        home_race=torch.full((B,), _RACE_ZERG, dtype=torch.uint8, device=dev),
        away_race=torch.full((B,), _RACE_ZERG, dtype=torch.uint8, device=dev),
        time=(state.t * cfg.loops_per_step).float(),
        unit_counts_bow=own_counts.clamp(0, 255).to(torch.uint8),
        agent_statistics=xla_log1p(torch.clamp_min(stats, 0.0)),
        last_action_type=last[:, 0].to(torch.int16),
        last_delay=last[:, 1].to(torch.int16),
        last_queued=last[:, 2].to(torch.int16),
        unit_type_bool=(own_counts > 0).to(torch.uint8),
        enemy_unit_type_bool=(enemy_counts > 0).to(torch.uint8),
    )
    return {
        "spatial_info": spatial_info,
        "scalar_info": scalar_info,
        "entity_info": entity_info,
        "entity_num": torch.clamp_min(entity_num, 1),
    }

"""Scenario parameters and the procedural generator, in PyTorch.

Counterpart of ``distar_tpu.envs.jaxenv.scenario``. A ``Scenario`` is
everything that varies between micro-battle episodes (unit composition,
squad sizes, terrain mask, spawn geometry) as a NamedTuple of fixed-shape
tensors with a leading lane axis, so a batch of B scenarios is one
``ScenarioGenerator.batch(B, generator)`` call on the generator's device.

The draws come from a ``torch.Generator`` where the JAX package splits a
threefry key: the distributions, ranges, clips and the carving of
passable discs around both spawns are the JAX package's, but a seed gives
other scenarios than there (ROADMAP Queue 3). ``Scenario.from_numpy``
takes scenarios made elsewhere, such as the JAX package's, so both worlds
can play the same battles.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ...lib import actions as ACT
from ...lib import features as F

# The world is the contract's spatial rectangle: positions are float
# (x, y), x in [0, 160) and y in [0, 152); the terrain grid has one cell
# per CELL x CELL pixel block and upsamples exactly to SPATIAL_SIZE.
MAP_H, MAP_W = F.SPATIAL_SIZE  # (y=152, x=160)
CELL = 8
GRID_H, GRID_W = MAP_H // CELL, MAP_W // CELL  # (19, 20)

# The unit catalog: real SC2 unit types (raw game ids in the contract's
# 260-type vocabulary) with micro-battle combat stats, one row per type.
CATALOG_RAW_TYPES = np.array([48, 105, 110, 74], dtype=np.int64)  # marine, zergling, roach, stalker
CATALOG_DENSE_TYPES = np.array([ACT.UNIT_TYPES.index(int(t)) for t in CATALOG_RAW_TYPES], np.int64)
CATALOG_HEALTH = np.array([45.0, 35.0, 145.0, 160.0], dtype=np.float32)
CATALOG_DAMAGE = np.array([6.0, 5.0, 16.0, 13.0], dtype=np.float32)
CATALOG_RANGE = np.array([12.0, 3.0, 10.0, 14.0], dtype=np.float32)  # px
CATALOG_SPEED = np.array([2.0, 3.0, 1.5, 2.0], dtype=np.float32)     # px/step
CATALOG_COOLDOWN = np.array([2.0, 1.0, 3.0, 3.0], dtype=np.float32)  # steps between shots
NUM_CATALOG_TYPES = len(CATALOG_RAW_TYPES)


class Scenario(NamedTuple):
    """A batch of episode parameters, every leaf [B, ...] on one device."""

    n_home: torch.Tensor       # int32 [B] live home units (<= units_per_squad)
    n_away: torch.Tensor       # int32 [B]
    type_home: torch.Tensor    # int32 [B, U] catalog row per slot
    type_away: torch.Tensor    # int32 [B, U]
    pos_home: torch.Tensor     # float32 [B, U, 2] spawn (x, y)
    pos_away: torch.Tensor     # float32 [B, U, 2]
    terrain: torch.Tensor      # bool [B, GRID_H, GRID_W], True = passable
    episode_len: torch.Tensor  # int32 [B] env steps until timeout

    @classmethod
    def from_numpy(cls, tree, device=None) -> "Scenario":
        """A scenario batch from arrays with the same field names (a dict,
        a NamedTuple such as the JAX package's ``Scenario``, whose ``key``
        is dropped), each with a leading lane axis."""
        get = tree.get if isinstance(tree, dict) else (lambda k: getattr(tree, k))
        dtypes = {"pos_home": torch.float32, "pos_away": torch.float32, "terrain": torch.bool}
        return cls(**{k: torch.from_numpy(np.array(get(k))).to(device=device, dtype=dtypes.get(k, torch.int32))
                      for k in cls._fields})

    @property
    def batch_size(self) -> int:
        return int(self.n_home.shape[0])


@dataclass(frozen=True)
class ScenarioConfig:
    """Static knobs of the procedural distribution."""

    units_per_squad: int = 8      # U: the padded squad width
    min_units: int = 2
    max_units: int = 8            # inclusive; clamped to units_per_squad
    episode_len: int = 64
    blocked_frac: float = 0.12    # fraction of terrain cells impassable
    spawn_spread: float = 12.0    # px of per-unit jitter around the spawn center
    spawn_margin: float = 20.0    # px the spawn centers keep from map edges
    mirror_spawns: bool = True    # away spawn = point mirror of home spawn
    mirror_types: bool = False    # away squad = home's composition and size
    #   (composition-fair episodes: win-rate A/Bs measure the policy, not
    #   the catalog matchup lottery)

    def __post_init__(self):
        if not (1 <= self.min_units <= self.max_units <= self.units_per_squad):
            raise ValueError(
                f"need 1 <= min_units <= max_units <= units_per_squad, got "
                f"{self.min_units}/{self.max_units}/{self.units_per_squad}")


def _uniform(shape, lo, hi, generator, device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=generator, device=device)


class ScenarioGenerator:
    """(n, generator) -> a Scenario batch, drawn on the generator's device.

    ``batch`` draws squad sizes, catalog compositions, a blob terrain mask
    and mirrored spawn clusters for n lanes at once; ``generate`` is one
    lane (a batch of 1), the host env's episode.
    """

    def __init__(self, cfg: ScenarioConfig = ScenarioConfig()):
        self.cfg = cfg

    def batch(self, n: int, generator: torch.Generator) -> Scenario:
        cfg = self.cfg
        U = cfg.units_per_squad
        dev = generator.device
        i32 = torch.int32
        n_home = torch.randint(cfg.min_units, cfg.max_units + 1, (n,), generator=generator, device=dev, dtype=i32)
        n_away = torch.randint(cfg.min_units, cfg.max_units + 1, (n,), generator=generator, device=dev, dtype=i32)
        type_home = torch.randint(0, NUM_CATALOG_TYPES, (n, U), generator=generator, device=dev, dtype=i32)
        type_away = torch.randint(0, NUM_CATALOG_TYPES, (n, U), generator=generator, device=dev, dtype=i32)
        if cfg.mirror_types:
            n_away, type_away = n_home.clone(), type_home.clone()

        # spawn geometry: the home center in the left band, the away one
        # mirrored (or drawn in the right band)
        m = cfg.spawn_margin
        cx = _uniform((n,), m, MAP_W / 3.0, generator, dev)
        cy = _uniform((n,), m, MAP_H - m, generator, dev)
        home_center = torch.stack([cx, cy], -1)
        if cfg.mirror_spawns:
            away_center = torch.stack([MAP_W - cx, MAP_H - cy], -1)
        else:
            away_center = torch.stack([_uniform((n,), 2.0 * MAP_W / 3.0, MAP_W - m, generator, dev),
                                       _uniform((n,), m, MAP_H - m, generator, dev)], -1)
        s = cfg.spawn_spread
        pos_home = home_center[:, None] + _uniform((n, U, 2), -s, s, generator, dev)
        pos_away = away_center[:, None] + _uniform((n, U, 2), -s, s, generator, dev)
        bound = table(_BOUND, dev)
        pos_home = torch.minimum(pos_home.clamp_min(1.0), bound)
        pos_away = torch.minimum(pos_away.clamp_min(1.0), bound)

        # blob terrain: iid blocked cells, then passable discs around both
        # spawn clusters so no unit starts inside a wall
        passable = torch.rand((n, GRID_H, GRID_W), generator=generator, device=dev) >= cfg.blocked_frac
        cell_center = table(_CELL_CENTER, dev)
        carve_r = cfg.spawn_spread + 1.5 * CELL
        for center in (home_center, away_center):
            diff = cell_center[None] - center[:, None, None]
            d = torch.sqrt(diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1])
            passable = passable | (d <= carve_r)
        return Scenario(
            n_home=n_home, n_away=n_away, type_home=type_home, type_away=type_away,
            pos_home=pos_home, pos_away=pos_away, terrain=passable,
            episode_len=torch.full((n,), cfg.episode_len, dtype=i32, device=dev))

    def generate(self, generator: torch.Generator) -> Scenario:
        return self.batch(1, generator)


def make_generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    return torch.Generator(device=torch.device(device)).manual_seed(int(seed))


_TABLES = {}


def _device_key(device) -> str:
    """``device`` with a CUDA index filled in: "cuda" and "cuda:0" (a
    generator's or a tensor's device) name one cache entry."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def table(array: np.ndarray, device) -> torch.Tensor:
    """A module constant as a tensor on ``device``, copied there once: the
    env's lookup tables live on the device, so a step makes no host copy."""
    key = (id(array), _device_key(device))
    if key not in _TABLES:
        _TABLES[key] = torch.from_numpy(np.ascontiguousarray(array)).to(device)
    return _TABLES[key]


_BOUND = np.array([MAP_W - 1.0, MAP_H - 1.0], np.float32)
_gy, _gx = np.mgrid[0:GRID_H, 0:GRID_W]
_CELL_CENTER = np.stack([_gx * CELL + CELL / 2.0, _gy * CELL + CELL / 2.0],
                        axis=-1).astype(np.float32)  # (x, y) of each cell center, px

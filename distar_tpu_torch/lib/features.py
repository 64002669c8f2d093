"""Feature-space contract: observation/action schemas and fixed shapes.

The same schema as ``distar_tpu.lib.features``: entity arrays are padded to
``MAX_ENTITY_NUM`` and selected units to ``MAX_SELECTED_UNITS_NUM``, so every
batched forward sees one shape. Observations are host numpy trees; the
inference layer moves them to the device.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .actions import (
    NUM_ACTIONS,
    NUM_BEGINNING_ORDER_ACTIONS,
    NUM_BUFFS,
    NUM_CUMULATIVE_STAT_ACTIONS,
    NUM_UNIT_MIX_ABILITIES,
    NUM_UNIT_TYPES,
    NUM_UPGRADES,
    QUEUE_ACTION_EMBEDDING_DIM,
)

SPATIAL_SIZE = (152, 160)  # (y, x)
BUFF_LENGTH = 3
UPGRADE_LENGTH = 20
MAX_DELAY = 127
BEGINNING_ORDER_LENGTH = 20
MAX_SELECTED_UNITS_NUM = 64
MAX_ENTITY_NUM = 512
EFFECT_LENGTH = 100

# Spatial planes: name -> dtype. 'effect_*' planes arrive as flat-index
# coordinate lists of length EFFECT_LENGTH and are scattered on device.
SPATIAL_INFO = {
    "height_map": np.uint8,
    "visibility_map": np.uint8,
    "creep": np.uint8,
    "player_relative": np.uint8,
    "alerts": np.uint8,
    "pathable": np.uint8,
    "buildable": np.uint8,
    "effect_PsiStorm": np.int16,
    "effect_NukeDot": np.int16,
    "effect_LiberatorDefenderZone": np.int16,
    "effect_BlindingCloud": np.int16,
    "effect_CorrosiveBile": np.int16,
    "effect_LurkerSpines": np.int16,
}

# Scalar features: name -> (dtype, shape)
SCALAR_INFO = {
    "home_race": (np.uint8, ()),
    "away_race": (np.uint8, ()),
    "upgrades": (np.int16, (NUM_UPGRADES,)),
    "time": (np.float32, ()),
    "unit_counts_bow": (np.uint8, (NUM_UNIT_TYPES,)),
    "agent_statistics": (np.float32, (10,)),
    "cumulative_stat": (np.uint8, (NUM_CUMULATIVE_STAT_ACTIONS,)),
    "beginning_order": (np.int16, (BEGINNING_ORDER_LENGTH,)),
    "last_queued": (np.int16, ()),
    "last_delay": (np.int16, ()),
    "last_action_type": (np.int16, ()),
    "bo_location": (np.int16, (BEGINNING_ORDER_LENGTH,)),
    "unit_order_type": (np.uint8, (NUM_UNIT_MIX_ABILITIES,)),
    "unit_type_bool": (np.uint8, (NUM_UNIT_TYPES,)),
    "enemy_unit_type_bool": (np.uint8, (NUM_UNIT_TYPES,)),
}

# Per-entity features (each a [MAX_ENTITY_NUM] vector): name -> dtype
ENTITY_INFO = {
    "unit_type": np.int16,
    "alliance": np.uint8,
    "cargo_space_taken": np.uint8,
    "build_progress": np.float16,
    "health_ratio": np.float16,
    "shield_ratio": np.float16,
    "energy_ratio": np.float16,
    "display_type": np.uint8,
    "x": np.uint8,
    "y": np.uint8,
    "cloak": np.uint8,
    "is_blip": np.uint8,
    "is_powered": np.uint8,
    "mineral_contents": np.float16,
    "vespene_contents": np.float16,
    "cargo_space_max": np.uint8,
    "assigned_harvesters": np.uint8,
    "weapon_cooldown": np.uint8,
    "order_length": np.uint8,
    "order_id_0": np.int16,
    "order_id_1": np.int16,
    "is_hallucination": np.uint8,
    "buff_id_0": np.uint8,
    "buff_id_1": np.uint8,
    "addon_unit_type": np.uint8,
    "is_active": np.uint8,
    "order_progress_0": np.float16,
    "order_progress_1": np.float16,
    "order_id_2": np.int16,
    "order_id_3": np.int16,
    "is_in_cargo": np.uint8,
    "attack_upgrade_level": np.uint8,
    "armor_upgrade_level": np.uint8,
    "shield_upgrade_level": np.uint8,
    "last_selected_units": np.int8,
    "last_targeted_unit": np.int8,
}

ACTION_HEADS = ("action_type", "delay", "queued", "selected_units", "target_unit", "target_location")

# Per-head logit widths; selected_units has MAX_ENTITY_NUM+1 classes (the +1
# is the end-flag token).
LOGIT_SHAPES = {
    "action_type": (NUM_ACTIONS,),
    "delay": (MAX_DELAY + 1,),
    "queued": (2,),
    "selected_units": (MAX_SELECTED_UNITS_NUM, MAX_ENTITY_NUM + 1),
    "target_unit": (MAX_ENTITY_NUM,),
    "target_location": (SPATIAL_SIZE[0] * SPATIAL_SIZE[1],),
}

ACTION_SHAPES = {
    "action_type": (),
    "delay": (),
    "queued": (),
    "selected_units": (MAX_SELECTED_UNITS_NUM,),
    "target_unit": (),
    "target_location": (),
}


def fake_step_data(rng: Optional[np.random.Generator] = None, size=SPATIAL_SIZE) -> Dict:
    """A schema-complete single observation (no batch dim): zeros everywhere
    except ``entity_num`` (the inference template and warm-up input)."""
    rng = rng or np.random.default_rng(0)
    spatial = {
        k: np.zeros((EFFECT_LENGTH,) if k.startswith("effect_") else size, dtype)
        for k, dtype in SPATIAL_INFO.items()
    }
    return {
        "spatial_info": spatial,
        "scalar_info": {k: np.zeros(shape, dtype) for k, (dtype, shape) in SCALAR_INFO.items()},
        "entity_info": {k: np.zeros((MAX_ENTITY_NUM,), dtype) for k, dtype in ENTITY_INFO.items()},
        "entity_num": np.asarray(rng.integers(1, MAX_ENTITY_NUM), dtype=np.int64),
    }


# exclusive upper bounds for drawing in-range categorical fields
_SPATIAL_CLASSES = {
    "height_map": 256, "visibility_map": 4, "creep": 2, "player_relative": 5,
    "alerts": 2, "pathable": 2, "buildable": 2,
}
_SCALAR_CLASSES = {
    "home_race": 5, "away_race": 5, "upgrades": 2, "unit_counts_bow": 16,
    "cumulative_stat": 2, "beginning_order": NUM_BEGINNING_ORDER_ACTIONS,
    "last_queued": 2, "last_delay": MAX_DELAY + 1, "last_action_type": NUM_ACTIONS,
    "unit_order_type": 2, "unit_type_bool": 2, "enemy_unit_type_bool": 2,
}
_ENTITY_CLASSES = {
    "unit_type": NUM_UNIT_TYPES, "alliance": 5, "cargo_space_taken": 9, "display_type": 5,
    "x": SPATIAL_SIZE[1], "y": SPATIAL_SIZE[0], "cloak": 5, "is_blip": 2, "is_powered": 2,
    "cargo_space_max": 9, "assigned_harvesters": 24, "weapon_cooldown": 32,
    "order_length": 9, "order_id_0": NUM_ACTIONS, "order_id_1": QUEUE_ACTION_EMBEDDING_DIM,
    "is_hallucination": 2, "buff_id_0": NUM_BUFFS, "buff_id_1": NUM_BUFFS, "addon_unit_type": 9,
    "is_active": 2, "order_id_2": QUEUE_ACTION_EMBEDDING_DIM,
    "order_id_3": QUEUE_ACTION_EMBEDDING_DIM, "is_in_cargo": 2, "attack_upgrade_level": 4,
    "armor_upgrade_level": 4, "shield_upgrade_level": 4, "last_selected_units": 2,
    "last_targeted_unit": 2,
}


def random_step_data(rng: np.random.Generator, size=SPATIAL_SIZE) -> Dict:
    """A schema-complete observation with every field drawn in range: maps,
    effect lists, scalars, entity fields and coordinates. Parity checks use
    it because zero-filled observations hide layout bugs (an NHWC/NCHW
    flatten mix-up is invisible on a constant map)."""
    H, W = size
    spatial = {}
    for k, dtype in SPATIAL_INFO.items():
        if k.startswith("effect_"):
            spatial[k] = rng.integers(0, H * W, (EFFECT_LENGTH,)).astype(dtype)
        else:
            spatial[k] = rng.integers(0, _SPATIAL_CLASSES[k], size).astype(dtype)
    scalar = {}
    for k, (dtype, shape) in SCALAR_INFO.items():
        if k == "time":
            scalar[k] = np.asarray(rng.uniform(0, 20000), dtype)
        elif k == "agent_statistics":
            scalar[k] = rng.uniform(0, 1, shape).astype(dtype)
        elif k == "bo_location":
            scalar[k] = rng.integers(0, H * W, shape).astype(dtype)
        else:
            scalar[k] = np.asarray(rng.integers(0, _SCALAR_CLASSES[k], shape), dtype)
    entity = {}
    for k, dtype in ENTITY_INFO.items():
        if np.issubdtype(dtype, np.floating):
            entity[k] = rng.uniform(0, 1, (MAX_ENTITY_NUM,)).astype(dtype)
        else:
            entity[k] = rng.integers(0, _ENTITY_CLASSES[k], (MAX_ENTITY_NUM,)).astype(dtype)
    return {
        "spatial_info": spatial,
        "scalar_info": scalar,
        "entity_info": entity,
        "entity_num": np.asarray(rng.integers(1, MAX_ENTITY_NUM + 1), dtype=np.int64),
    }


# Centralized-critic feature schema (the RL learner's value encoder, with
# ``use_value_feature``): opponent statistics, both sides' unit scatter
# inputs and the opponent's build order. name -> (dtype, shape); a shape
# names its dims, "SPATIAL" is the map.
VALUE_FEATURE_INFO = {
    "enemy_unit_counts_bow": (np.uint8, ("NUM_UNIT_TYPES",)),
    "enemy_unit_type_bool": (np.uint8, ("NUM_UNIT_TYPES",)),
    "enemy_agent_statistics": (np.float32, (10,)),
    "enemy_upgrades": (np.int16, ("NUM_UPGRADES",)),
    "enemy_cumulative_stat": (np.uint8, ("NUM_CUMULATIVE_STAT_ACTIONS",)),
    "unit_alliance": (np.uint8, ("MAX_ENTITY_NUM",)),
    "unit_type": (np.int16, ("MAX_ENTITY_NUM",)),
    "unit_x": (np.uint8, ("MAX_ENTITY_NUM",)),
    "unit_y": (np.uint8, ("MAX_ENTITY_NUM",)),
    "total_unit_count": (np.int64, ()),
    "own_units_spatial": (np.uint8, "SPATIAL"),
    "enemy_units_spatial": (np.uint8, "SPATIAL"),
    "beginning_order": (np.int16, (BEGINNING_ORDER_LENGTH,)),
    "bo_location": (np.int16, (BEGINNING_ORDER_LENGTH,)),
}


def fake_value_feature(rng: Optional[np.random.Generator] = None) -> Dict[str, np.ndarray]:
    """A schema-complete value feature (no batch dim): zeros except
    ``total_unit_count``, one draw from ``rng``."""
    rng = rng or np.random.default_rng(0)
    dims = {
        "NUM_UNIT_TYPES": NUM_UNIT_TYPES,
        "NUM_UPGRADES": NUM_UPGRADES,
        "NUM_CUMULATIVE_STAT_ACTIONS": NUM_CUMULATIVE_STAT_ACTIONS,
        "MAX_ENTITY_NUM": MAX_ENTITY_NUM,
    }
    out = {}
    for k, (dtype, shape) in VALUE_FEATURE_INFO.items():
        if shape == "SPATIAL":
            out[k] = np.zeros(SPATIAL_SIZE, dtype)
        else:
            out[k] = np.zeros(tuple(dims.get(s, s) for s in shape), dtype)
    out["total_unit_count"] = np.asarray(int(rng.integers(1, MAX_ENTITY_NUM)), np.int64)
    return out


def random_value_feature(rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """A value feature with every field drawn in range (``fake_value_feature``
    is zeros, which hide layout faults)."""
    H, W = SPATIAL_SIZE
    bounds = {"enemy_unit_counts_bow": 16, "enemy_unit_type_bool": 2, "enemy_upgrades": 2,
              "enemy_cumulative_stat": 2, "unit_alliance": 2, "unit_type": NUM_UNIT_TYPES,
              "unit_x": W, "unit_y": H, "own_units_spatial": 2, "enemy_units_spatial": 2,
              "beginning_order": NUM_BEGINNING_ORDER_ACTIONS, "bo_location": H * W}
    out = {}
    for k, v in fake_value_feature(rng).items():
        if k == "enemy_agent_statistics":
            out[k] = rng.uniform(0, 1, v.shape).astype(v.dtype)
        elif k == "total_unit_count":
            out[k] = np.asarray(rng.integers(1, MAX_ENTITY_NUM + 1), v.dtype)
        else:
            out[k] = rng.integers(0, bounds[k], v.shape).astype(v.dtype)
    return out


def batch_tree(trees, stack=np.stack):
    """Stack a list of nested dict/tuple/array structures along axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: batch_tree([t[k] for t in trees], stack) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(batch_tree([t[i] for t in trees], stack) for i in range(len(first)))
    return stack([np.asarray(t) for t in trees])

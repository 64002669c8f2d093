"""Action-space contract: the 327-action table and every derived lookup.

Counterpart of ``distar_tpu.lib.actions``. The raw table and id
vocabularies live in ``distar_tpu_torch/data/game_contract.json`` (a copy of
the JAX package's contract file). This module derives the tables the
policy, the agent's pseudo-rewards and the SC2 feature transforms read
(``envs/features.py``: the id reorder arrays, the ability remaps, the
queue-action ids, the replay-decode ability families), as numpy arrays.

Every action is a dict with keys:
  func_id, general_ability_id, goal, name, queued, selected_units,
  target_location, target_unit, and optionally game_id.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

_DATA_PATH = os.path.join(os.path.dirname(__file__), "..", "data", "game_contract.json")

with open(_DATA_PATH) as _f:
    _CONTRACT = json.load(_f)

ACTIONS: List[dict] = _CONTRACT["actions"]
UNIT_TYPES: List[int] = _CONTRACT["unit_types"]
BUFFS: List[int] = _CONTRACT["buffs"]
UPGRADES: List[int] = _CONTRACT["upgrades"]
ADDON: List[int] = _CONTRACT["addon"]
ABILITIES: List[int] = _CONTRACT["abilities"]
UNIT_SPECIFIC_ABILITIES: List[int] = _CONTRACT["unit_specific_abilities"]
UNIT_GENERAL_ABILITIES: List[int] = _CONTRACT["unit_general_abilities"]
UNIT_MIX_ABILITIES: List[int] = _CONTRACT["unit_mix_abilities"]
ORDER_ACTIONS: List[int] = _CONTRACT["order_actions"]

NUM_ACTIONS = len(ACTIONS)  # 327
NUM_UNIT_TYPES = len(UNIT_TYPES)  # 260
NUM_BUFFS = len(BUFFS)  # 50
NUM_UPGRADES = len(UPGRADES)  # 90
NUM_ADDON = len(ADDON)  # 9
NUM_UNIT_MIX_ABILITIES = len(UNIT_MIX_ABILITIES)  # 269
NUM_ORDER_ACTIONS = len(ORDER_ACTIONS) + 1


def reorder_lookup_array(ids: List[int]) -> np.ndarray:
    """Game-id -> dense-index LUT; -1 marks ids outside the vocabulary."""
    arr = np.full(max(ids) + 1, -1, dtype=np.int64)
    for index, item in enumerate(ids):
        arr[item] = index
    return arr


UNIT_TYPES_REORDER_ARRAY = reorder_lookup_array(UNIT_TYPES)
BUFFS_REORDER_ARRAY = reorder_lookup_array(BUFFS)
UPGRADES_REORDER_ARRAY = reorder_lookup_array(UPGRADES)
ADDON_REORDER_ARRAY = reorder_lookup_array(ADDON)
ABILITIES_REORDER_ARRAY = reorder_lookup_array(ABILITIES)

ORDER_ACTIONS_REORDER_ARRAY = np.zeros(573 + 1, dtype=np.int64)
for _idx, _v in enumerate(ORDER_ACTIONS):
    ORDER_ACTIONS_REORDER_ARRAY[_v] = _idx + 1

# --- ability remapping: specific ability id -> mixed-vocabulary index -------
# An ability maps to its general ability when one exists, else to itself;
# index is its position in UNIT_MIX_ABILITIES. Index 0 is the no-op.
_MIX_INDEX: Dict[int, int] = {a: i for i, a in enumerate(UNIT_MIX_ABILITIES)}

UNIT_ABILITY_REORDER = np.full(max(UNIT_MIX_ABILITIES) + 1, -1, dtype=np.int64)
ABILITY_TO_GABILITY: Dict[int, int] = {}
for _i, _spec in enumerate(UNIT_SPECIFIC_ABILITIES):
    _gen = UNIT_GENERAL_ABILITIES[_i]
    _target = _spec if _gen == 0 else _gen
    ABILITY_TO_GABILITY[_spec] = _target
    UNIT_ABILITY_REORDER[_spec] = _MIX_INDEX[_target]
UNIT_ABILITY_REORDER[0] = 0

FUNC_ID_TO_ACTION_TYPE: Dict[int, int] = {a["func_id"]: i for i, a in enumerate(ACTIONS)}

# --- queue actions: Train_*/Research* general abilities get a dense id ------
GABILITY_TO_QUEUE_ACTION: Dict[int, int] = {}
QUEUE_ACTIONS: List[int] = []
_count = 1  # 0 is the no-op slot
for _idx, _a in enumerate(ACTIONS):
    if "Train_" in _a["name"] or "Research" in _a["name"]:
        GABILITY_TO_QUEUE_ACTION[_a["general_ability_id"]] = _count
        QUEUE_ACTIONS.append(_idx)
        _count += 1
    else:
        GABILITY_TO_QUEUE_ACTION[_a["general_ability_id"]] = 0

ABILITY_TO_QUEUE_ACTION = np.full(max(ABILITY_TO_GABILITY) + 1, -1, dtype=np.int64)
ABILITY_TO_QUEUE_ACTION[0] = 0
for _aid, _gid in ABILITY_TO_GABILITY.items():
    ABILITY_TO_QUEUE_ACTION[_aid] = GABILITY_TO_QUEUE_ACTION.get(_gid, 0)

NUM_QUEUE_ACTIONS = len(QUEUE_ACTIONS)  # 109 as derived; see note below
# The reference's model yaml pins the order_id_{1,2,3} embedding width to 49
# (actor_critic_default_config.yaml:6) even though its derivation yields 109
# queue actions; inputs are clamped into the table at runtime
# (entity_encoder.py:72). We reproduce that contract: embeddings are 49 wide,
# lookups clamp.
QUEUE_ACTION_EMBEDDING_DIM = 49

# --- strategy-statistic action subsets --------------------------------------
# Supply/worker/creep actions are excluded from build-order targets; static
# defense and a few others additionally from cumulative targets
# (reference: actions.py:374-387).
EXCLUDE_ACTIONS = [
    "Build_Pylon_pt", "Train_Overlord_quick", "Build_SupplyDepot_pt",
    "Train_Drone_quick", "Train_SCV_quick", "Train_Probe_quick",
    "Build_CreepTumor_pt", "",
]
CUM_EXCLUDE_ACTIONS = [
    "Build_SpineCrawler_pt", "Build_SporeCrawler_pt", "Build_PhotonCannon_pt",
    "Build_ShieldBattery_pt", "Build_Bunker_pt", "Morph_Overseer_quick",
    "Build_MissileTurret_pt",
]

BEGINNING_ORDER_ACTIONS: List[int] = [0]
CUMULATIVE_STAT_ACTIONS: List[int] = [0]
for _idx, _a in enumerate(ACTIONS):
    if _a["goal"] in ("unit", "build", "research") and _a["name"] not in EXCLUDE_ACTIONS:
        BEGINNING_ORDER_ACTIONS.append(_idx)
        if _a["name"] not in CUM_EXCLUDE_ACTIONS:
            CUMULATIVE_STAT_ACTIONS.append(_idx)

NUM_BEGINNING_ORDER_ACTIONS = len(BEGINNING_ORDER_ACTIONS)  # 174
NUM_CUMULATIVE_STAT_ACTIONS = len(CUMULATIVE_STAT_ACTIONS)  # 167

BEGINNING_ORDER_REORDER_ARRAY = reorder_lookup_array(BEGINNING_ORDER_ACTIONS)
CUMULATIVE_STAT_REORDER_ARRAY = reorder_lookup_array(CUMULATIVE_STAT_ACTIONS)

# --- per-head availability masks over action types --------------------------
SELECTED_UNITS_MASK = np.array([a["selected_units"] for a in ACTIONS], dtype=bool)
TARGET_UNIT_MASK = np.array([a["target_unit"] for a in ACTIONS], dtype=bool)
TARGET_LOCATION_MASK = np.array([a["target_location"] for a in ACTIONS], dtype=bool)
QUEUED_MASK = np.array([a["queued"] for a in ACTIONS], dtype=bool)

UNIT_BUILD_ACTIONS = [a["func_id"] for a in ACTIONS if a["goal"] == "build"]
UNIT_TRAIN_ACTIONS = [a["func_id"] for a in ACTIONS if a["goal"] == "unit"]

GENERAL_ABILITY_IDS = [a["general_ability_id"] for a in ACTIONS]
UNIT_ABILITY_TO_ACTION: Dict[int, int] = {}
for _idx, _ab in enumerate(UNIT_MIX_ABILITIES):
    if _ab in GENERAL_ABILITY_IDS:
        UNIT_ABILITY_TO_ACTION[_idx] = GENERAL_ABILITY_IDS.index(_ab)

# --- replay-decode ability canonicalisation (reference features.py:862-871) -
# cancel-slot and unload-unit ability families collapse onto their general
# actions; Dance/Cheer are dropped.
CANCEL_SLOT_ABILITIES = {313, 1039, 305, 307, 309, 1832, 1834, 3672}
UNLOAD_UNIT_ABILITIES = {410, 415, 397, 1440, 2373, 1409, 914, 3670}
FRIVOLOUS_ABILITIES = {6, 7}  # Dance, Cheer
CANCEL_SLOT_TARGET = 3671  # Cancel_Last/cancel_quick general
UNLOAD_ALL_TARGET = 3664


def action_kind(a: dict) -> str:
    """Which raw-command form an action takes: 'unit' (targets a unit), 'pt'
    (targets a location), 'autocast', or 'quick' (no target) — the cmd_type
    disambiguation of reference reverse_raw_action (:875-878)."""
    if a["target_unit"]:
        return "unit"
    if a["target_location"]:
        return "pt"
    if a["name"].endswith("_autocast"):
        return "autocast"
    return "quick"


# (general_ability_id, kind) -> action index; verified collision-free
GAB_KIND_TO_ACTION: Dict[tuple, int] = {}
for _idx, _a in enumerate(ACTIONS):
    if _a["general_ability_id"] is not None:
        GAB_KIND_TO_ACTION.setdefault((_a["general_ability_id"], action_kind(_a)), _idx)

# game unit-type / upgrade id -> cumulative-stat slot (-1 when untracked)
UNIT_TO_CUM: Dict[int, int] = {}
UPGRADE_TO_CUM: Dict[int, int] = {}
for _idx, _a in enumerate(ACTIONS):
    if "game_id" in _a and _idx in CUMULATIVE_STAT_ACTIONS:
        _slot = CUMULATIVE_STAT_ACTIONS.index(_idx)
        if _a["goal"] in ("unit", "build"):
            UNIT_TO_CUM[_a["game_id"]] = _slot
        elif _a["goal"] == "research":
            UPGRADE_TO_CUM[_a["game_id"]] = _slot

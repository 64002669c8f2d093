"""Action-space contract: the 327-action table and the derived tables the
policy reads.

The raw table and id vocabularies live in ``distar_tpu_torch/data/
game_contract.json`` (a copy of the JAX package's contract file). Only the
tables the serving path needs are derived here: the vocabulary counts that
size the embeddings and ``SELECTED_UNITS_MASK``, which says whether an
action type selects units at all.
"""
from __future__ import annotations

import json
import os
from typing import List

import numpy as np

_DATA_PATH = os.path.join(os.path.dirname(__file__), "..", "data", "game_contract.json")

with open(_DATA_PATH) as _f:
    _CONTRACT = json.load(_f)

ACTIONS: List[dict] = _CONTRACT["actions"]
UNIT_TYPES: List[int] = _CONTRACT["unit_types"]
BUFFS: List[int] = _CONTRACT["buffs"]
UPGRADES: List[int] = _CONTRACT["upgrades"]
ADDON: List[int] = _CONTRACT["addon"]
UNIT_MIX_ABILITIES: List[int] = _CONTRACT["unit_mix_abilities"]

NUM_ACTIONS = len(ACTIONS)  # 327
NUM_UNIT_TYPES = len(UNIT_TYPES)  # 260
NUM_BUFFS = len(BUFFS)  # 50
NUM_UPGRADES = len(UPGRADES)  # 90
NUM_ADDON = len(ADDON)  # 9
NUM_UNIT_MIX_ABILITIES = len(UNIT_MIX_ABILITIES)  # 269

# The reference's model yaml pins the order_id_{1,2,3} embedding width to 49
# even though its derivation yields 109 queue actions; lookups clamp.
QUEUE_ACTION_EMBEDDING_DIM = 49

# Supply/worker/creep actions are excluded from build-order targets; static
# defense and a few others additionally from cumulative targets.
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

# whether each action type selects units (gates the pointer decode)
SELECTED_UNITS_MASK = np.array([a["selected_units"] for a in ACTIONS], dtype=bool)

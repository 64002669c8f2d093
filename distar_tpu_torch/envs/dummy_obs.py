"""Synthetic raw-observation builders (duck-typed protos).

Counterpart of ``distar_tpu.envs.dummy_obs``.

Role parity with the reference's proto fixtures (reference: distar/pysc2/
tests/dummy_observation.py:15-50 — "build a dummy ResponseObservation ...
passed to features.transform_obs"): SimpleNamespace trees with the same
attribute surface as s2clientprotocol messages, so ProtoFeatures runs and is
tested without the game or even the proto package.
"""
from __future__ import annotations

from types import SimpleNamespace as NS
from typing import List, Optional, Sequence

import numpy as np


def pos(x, y):
    return NS(x=x, y=y)


def make_unit(
    tag: int,
    unit_type: int,
    alliance: int = 1,
    x: float = 10.0,
    y: float = 20.0,
    health: float = 50.0,
    health_max: float = 100.0,
    orders: Sequence[int] = (),
    buff_ids: Sequence[int] = (),
    passengers: Sequence = (),
    **kwargs,
):
    defaults = dict(
        cargo_space_taken=0, build_progress=1.0, shield_max=0.0, energy_max=0.0,
        display_type=1, owner=1 if alliance == 1 else 2, cloak=3, is_blip=False,
        is_powered=True, mineral_contents=0, vespene_contents=0, cargo_space_max=0,
        assigned_harvesters=0, weapon_cooldown=0, is_hallucination=False,
        add_on_tag=0, is_active=True, attack_upgrade_level=0, armor_upgrade_level=0,
        shield_upgrade_level=0, shield=0.0, energy=0.0,
    )
    defaults.update(kwargs)
    return NS(
        tag=tag, unit_type=unit_type, alliance=alliance, pos=pos(x, y),
        health=health, health_max=health_max,
        orders=[NS(ability_id=a, progress=0.5) for a in orders],
        buff_ids=list(buff_ids), passengers=list(passengers), **defaults,
    )


def make_passenger(tag: int, unit_type: int, health: float = 30.0):
    return NS(tag=tag, unit_type=unit_type, health=health, health_max=50.0,
              shield=0.0, shield_max=0.0, energy=0.0, energy_max=0.0)


def _packed_plane(arr: np.ndarray, bits: int):
    if bits == 1:
        data = np.packbits(arr.astype(bool).reshape(-1)).tobytes()
    else:
        data = arr.astype({8: np.uint8, 16: np.uint16, 32: np.int32}[bits]).tobytes()
    return NS(size=NS(y=arr.shape[0], x=arr.shape[1]), bits_per_pixel=bits, data=data)


def make_minimap(map_y: int = 120, map_x: int = 120, rng: Optional[np.random.Generator] = None):
    rng = rng or np.random.default_rng(0)
    layers = {
        "height_map": _packed_plane(rng.integers(0, 255, (map_y, map_x)), 8),
        "visibility_map": _packed_plane(rng.integers(0, 4, (map_y, map_x)), 8),
        "creep": _packed_plane(rng.integers(0, 2, (map_y, map_x)), 1),
        "player_relative": _packed_plane(rng.integers(0, 5, (map_y, map_x)), 8),
        "alerts": _packed_plane(rng.integers(0, 2, (map_y, map_x)), 1),
        "pathable": _packed_plane(rng.integers(0, 2, (map_y, map_x)), 1),
        "buildable": _packed_plane(rng.integers(0, 2, (map_y, map_x)), 1),
    }
    return NS(**layers)


def build_dummy_obs(
    units: Optional[List] = None,
    game_loop: int = 100,
    player_id: int = 1,
    upgrade_ids: Sequence[int] = (),
    effects: Sequence = (),
    map_y: int = 120,
    map_x: int = 120,
    minerals: int = 500,
    killed_minerals: float = 0.0,
    killed_vespene: float = 0.0,
    action_results: Sequence[int] = (1,),
    rng: Optional[np.random.Generator] = None,
):
    cat = NS(none=0.0, army=killed_minerals, economy=0.0, technology=0.0, upgrade=0.0)
    catv = NS(none=0.0, army=killed_vespene, economy=0.0, technology=0.0, upgrade=0.0)
    return NS(
        observation=NS(
            game_loop=game_loop,
            raw_data=NS(
                units=units or [],
                effects=list(effects),
                player=NS(upgrade_ids=list(upgrade_ids)),
            ),
            player_common=NS(
                player_id=player_id, minerals=minerals, vespene=100, food_used=20,
                food_cap=30, food_army=10, food_workers=10, idle_worker_count=1,
                army_count=5, warp_gate_count=0, larva_count=3,
            ),
            feature_layer_data=NS(minimap_renders=make_minimap(map_y, map_x, rng)),
            score=NS(score_details=NS(killed_minerals=cat, killed_vespene=catv)),
        ),
        action_errors=[NS(result=r) for r in action_results],
    )


def build_dummy_game_info(map_y: int = 120, map_x: int = 120, map_name: str = "DummyMap"):
    return NS(
        start_raw=NS(map_size=NS(x=map_x, y=map_y), start_locations=[pos(20, 30)]),
        map_name=map_name,
        player_info=[
            NS(player_id=1, race_requested=2, type=1),
            NS(player_id=2, race_requested=2, type=1),
        ],
    )


def make_effect(effect_id: int, positions: Sequence, owner: int = 2):
    return NS(effect_id=effect_id, owner=owner, pos=[pos(x, y) for x, y in positions])


def make_raw_action(ability_id: int, unit_tags: Sequence[int] = (),
                    target_unit_tag: Optional[int] = None,
                    target_pos=None, queue_command: bool = False):
    uc = NS(ability_id=ability_id, unit_tags=list(unit_tags), queue_command=queue_command)
    if target_unit_tag is not None:
        uc.target_unit_tag = target_unit_tag
    if target_pos is not None:
        uc.target_world_space_pos = pos(*target_pos)
    return NS(unit_command=uc)


def make_autocast_action(ability_id: int, unit_tags: Sequence[int] = ()):
    return NS(toggle_autocast=NS(ability_id=ability_id, unit_tags=list(unit_tags)))


def build_parity_fixtures():
    """Deterministic proto fixtures shared by the obs-transform golden
    parity harness: tools/record_reference_obs_golden.py replays them
    through the REFERENCE Features.transform_obs / reverse_raw_action
    (reference features.py:463,854) on torch, tests/test_obs_golden_parity.py
    replays them through envs/features.ProtoFeatures — both sides see
    byte-identical inputs, so every output field is a cross-check.

    All ids are drawn from the extracted game-contract tables so every LUT
    lookup is in-vocabulary on both sides (out-of-vocabulary handling
    deliberately differs: the reference keeps -1 sentinels, we clamp to the
    no-op — envs/features.py _lut).
    """
    from ..lib import actions as ACT

    def valid(lut, n, skip=0):
        idxs = np.nonzero(np.asarray(lut) > 0)[0][skip:skip + n]
        assert len(idxs) == n, "contract table too small for fixtures"
        return [int(i) for i in idxs]

    unit_ab = valid(ACT.UNIT_ABILITY_REORDER, 2, skip=4)
    queue_ab = valid(ACT.ABILITY_TO_QUEUE_ACTION, 3)
    buff_ids = valid(ACT.BUFFS_REORDER_ARRAY, 2)
    addon_type = valid(ACT.ADDON_REORDER_ARRAY, 1, skip=2)[0]
    upgrade_ids = valid(ACT.UPGRADES_REORDER_ARRAY, 2, skip=3)

    def pick_ability(kind):
        """Smallest concrete ability whose canonical (gability, kind) decodes
        to an action with a selection (and a queued head, so the queued
        value round-trips on both sides)."""
        for a, g in sorted(ACT.ABILITY_TO_GABILITY.items()):
            idx = ACT.GAB_KIND_TO_ACTION.get((g, kind))
            if idx is None:
                continue
            spec = ACT.ACTIONS[idx]
            if spec["selected_units"] and (kind == "autocast" or spec["queued"]):
                return a
        raise AssertionError(f"no fixture ability for kind {kind}")

    quick_ab = pick_ability("quick")
    pt_ab = pick_ability("pt")
    unit_ab_cmd = pick_ability("unit")
    autocast_ab = pick_ability("autocast")

    map_y, map_x = 120, 112  # non-square: catches x/y transpositions
    game_info = NS(
        start_raw=NS(
            map_size=NS(x=map_x, y=map_y),
            start_locations=[pos(90.5, 100.5)],
        ),
        map_name="ParityMap",
        player_info=[
            NS(player_id=1, race_requested=2, type=1),
            NS(player_id=2, race_requested=3, type=1),
        ],
    )
    # exactly ONE base structure: the reference derives the born location
    # from it and asserts uniqueness (reference features.py:384-393)
    hatch = make_unit(101, 86, x=30.5, y=40.5, health=1450.0, health_max=1500.0,
                      energy=25.0, energy_max=200.0)
    first_obs = build_dummy_obs(
        units=[hatch], game_loop=0, map_y=map_y, map_x=map_x,
        rng=np.random.default_rng(11),
    )

    units = [
        hatch,
        make_unit(102, 104, x=31.2, y=44.9, health=40.0, health_max=40.0,
                  orders=[unit_ab[0]], weapon_cooldown=0.5,
                  assigned_harvesters=2),
        make_unit(103, 126, x=35.0, y=41.0, health=150.0, health_max=175.0,
                  energy=30.0, energy_max=200.0,
                  orders=[unit_ab[1], queue_ab[0], queue_ab[1], queue_ab[2]],
                  buff_ids=buff_ids),
        make_unit(104, 106, x=50.7, y=60.1, health=180.0, health_max=200.0,
                  cargo_space_max=8, cargo_space_taken=2,
                  passengers=[make_passenger(201, 105), make_passenger(202, 105)]),
        make_unit(105, 105, x=36.0, y=42.0, build_progress=0.55, health=20.0,
                  health_max=35.0),
        make_unit(106, 48, alliance=4, x=80.4, y=90.8, health=35.0,
                  health_max=45.0, display_type=2, owner=2,
                  attack_upgrade_level=1),
        make_unit(107, 74, alliance=4, x=82.0, y=95.0, health=80.0,
                  health_max=80.0, shield=60.0, shield_max=80.0, owner=2,
                  cloak=1, is_hallucination=True),
        make_unit(108, 21, alliance=4, x=100.0, y=30.0, health=900.0,
                  health_max=1000.0, owner=2, add_on_tag=109),
        make_unit(109, addon_type, alliance=4, x=102.0, y=30.0, health=400.0,
                  health_max=400.0, owner=2),
        make_unit(110, 341, alliance=3, x=25.0, y=35.0, health=0.0,
                  health_max=0.0, owner=16, mineral_contents=900,
                  is_active=False),
    ]
    effects = [
        make_effect(1, [(40.0, 50.0), (41.0, 50.0)], owner=2),   # PsiStorm
        make_effect(9, [(60.0, 70.0)], owner=1),                 # skipped: own Liberator zone
        make_effect(9, [(61.0, 71.0)], owner=2),                 # kept
        make_effect(12, [(62.0, 72.0)], owner=1),                # skipped: own LurkerSpines
    ]
    obs = build_dummy_obs(
        units=units, game_loop=4521, upgrade_ids=upgrade_ids, effects=effects,
        map_y=map_y, map_x=map_x, minerals=754, killed_minerals=600.0,
        killed_vespene=200.0, action_results=(2, 3),
        rng=np.random.default_rng(12),
    )
    opp_units = [
        make_unit(301, 59, x=90.5, y=100.5, health=1300.0, health_max=1500.0),
        make_unit(302, 48, x=91.0, y=99.0, health=45.0, health_max=45.0),
        make_unit(303, 48, x=92.5, y=98.0, health=30.0, health_max=45.0),
        make_unit(304, 105, alliance=4, x=30.0, y=40.0, health=35.0,
                  health_max=35.0, owner=1),  # OUR unit seen by the opponent
    ]
    opponent_obs = build_dummy_obs(
        units=opp_units, game_loop=4521, upgrade_ids=upgrade_ids[:1],
        map_y=map_y, map_x=map_x, minerals=310, killed_minerals=150.0,
        killed_vespene=75.0, player_id=2, rng=np.random.default_rng(13),
    )

    actions = [
        ("quick", make_raw_action(quick_ab, [102], queue_command=True)),
        ("pt", make_raw_action(pt_ab, [102, 103], target_pos=(37.6, 55.2))),
        ("unit", make_raw_action(unit_ab_cmd, [103, 105], target_unit_tag=106)),
        ("bad_target", make_raw_action(unit_ab_cmd, [103], target_unit_tag=999999)),
        ("cancel_slot", make_raw_action(305, [101])),
        ("unload", make_raw_action(410, [104])),
        ("frivolous", make_raw_action(6, [102])),
        ("autocast", make_autocast_action(autocast_ab, [103])),
        ("no_units", make_raw_action(quick_ab, [])),
    ]
    return {
        "game_info": game_info,
        "first_obs": first_obs,
        "obs": obs,
        "opponent_obs": opponent_obs,
        "actions": actions,
        "z_stream": build_z_stream(),
    }


def build_z_stream():
    """Decoded-action stream for the Z-extraction parity check (reference
    get_z, features.py:419-460 vs envs/features.extract_z): exercises the
    zergling-spam cap, the spine-crawler proximity filter (one build near
    our born location — dropped — and one near the enemy's — kept),
    cumulative-stat marking, the BO-only CUM_EXCLUDE family (build order
    advances, no cum bit), and BO-length truncation. Locations are flat
    spatial indices (y*160+x)."""
    from ..lib import actions as ACT

    def flat(x, y):
        return y * 160 + x

    zergling = 322  # Train_Zergling_quick on both tables
    spine = 54      # Build_SpineCrawler_pt
    assert zergling in ACT.BEGINNING_ORDER_ACTIONS
    assert spine in ACT.BEGINNING_ORDER_ACTIONS
    bo = [a for a in ACT.BEGINNING_ORDER_ACTIONS[1:]
          if a not in (zergling, spine)]
    # the cumulative set is a strict subset of the BO set (lib/actions.py
    # derivation), so the disjoint case to pin is BO-but-NOT-cum: static
    # defense & co. must enter the build order without setting a cum bit
    bo_not_cum = [a for a in ACT.BEGINNING_ORDER_ACTIONS[1:]
                  if a not in ACT.CUMULATIVE_STAT_ACTIONS and a != spine]
    assert bo_not_cum, "contract tables lost the CUM_EXCLUDE family"

    stream = []

    def add(action_type, location=0):
        stream.append({"action_info": {
            "action_type": action_type, "target_location": location,
        }})

    # ordinary build-order prefix
    for i, a in enumerate(bo[:6]):
        add(a, flat(30 + i, 40))
    # zergling spam: 12 trains, cap keeps 8 in the BO
    for i in range(12):
        add(zergling, flat(50, 60))
    # spine near OUR base (born location ~ (30, 79-ish)): filtered out
    add(spine, flat(31, 80))
    # spine near the ENEMY's start: kept
    add(spine, flat(90, 19))
    # BO-only actions (CUM_EXCLUDE family): BO slot advances, no cum bit
    for a in bo_not_cum[:3]:
        add(a, flat(70, 70))
    # overflow the 20-slot BO window
    for i, a in enumerate(bo[6:24]):
        add(a, flat(10 + i, 12))
    return stream

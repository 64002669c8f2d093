"""Proto-facing feature transforms: raw SC2 observations -> the fixed-shape
feature contract, and agent actions <-> raw game actions.

Counterpart of ``distar_tpu.envs.features``.

Role parity with the reference Features (reference: distar/agent/default/lib/
features.py:165-951): minimap feature-layer bit-unpacking (:282-304), per-unit
38-field rows incl. cargo passengers (:504-589), id-space remaps via the
reorder LUTs (:594-614), ratio/log normalisations (:619-648), bag-of-words
vectors (:664-676), the y-axis flip (:630), opponent-derived value features
(:691-765), transform_action (:770+) and reverse_raw_action (:854-951), and
compute_battle_score (:352-361).

Everything is duck-typed against s2clientprotocol attribute access (protobuf
objects and SimpleNamespace fixtures both satisfy it), so the transform logic
is fully testable without the game: `dummy_obs.build_dummy_obs` plays the
role of the reference's dummy_observation proto builders
(pysc2/tests/dummy_observation.py).

TPU-first divergence: entity arrays leave here already padded to
MAX_ENTITY_NUM (the reference pads per-batch in its dataloader) so every
consumer sees one static shape.
"""
from __future__ import annotations

import enum
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..lib import actions as ACT
from ..lib import features as F


class Effects(enum.IntEnum):
    none = 0
    PsiStorm = 1
    GuardianShield = 2
    TemporalFieldGrowing = 3
    TemporalField = 4
    ThermalLance = 5
    ScannerSweep = 6
    NukeDot = 7
    LiberatorDefenderZoneSetup = 8
    LiberatorDefenderZone = 9
    BlindingCloud = 10
    CorrosiveBile = 11
    LurkerSpines = 12


SCORE_CATEGORIES = ("none", "army", "economy", "technology", "upgrade")

MINIMAP_LAYERS = (
    "height_map", "visibility_map", "creep", "player_relative", "alerts",
    "pathable", "buildable",
)

_BIT_DTYPES = {1: np.uint8, 8: np.uint8, 16: np.uint16, 32: np.int32}


def unpack_feature_layer(plane) -> Optional[np.ndarray]:
    """Decode one bit-packed feature-layer image (reference :290-304)."""
    sy, sx = int(plane.size.y), int(plane.size.x)
    if (sy, sx) == (0, 0):
        return None
    data = np.frombuffer(plane.data, dtype=_BIT_DTYPES[plane.bits_per_pixel])
    if plane.bits_per_pixel == 1:
        data = np.unpackbits(data)
        if data.shape[0] != sx * sy:
            data = data[: sx * sy]
    return data.reshape(sy, sx)


def compute_battle_score(obs) -> float:
    """killed minerals + 1.5 * killed vespene, summed over score categories."""
    if obs is None:
        return 0.0
    details = obs.observation.score.score_details
    killed_mineral = sum(getattr(details.killed_minerals, s) for s in SCORE_CATEGORIES)
    killed_vespene = sum(getattr(details.killed_vespene, s) for s in SCORE_CATEGORIES)
    return float(killed_mineral + 1.5 * killed_vespene)


def _pad_to(arr: np.ndarray, n: int, value=0) -> np.ndarray:
    if arr.shape[0] >= n:
        return arr[:n]
    pad = [(0, n - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad, constant_values=value)


def _lut(lut: np.ndarray, ids) -> np.ndarray:
    """Reorder LUT lookup with out-of-range ids mapped to 0 (the reference
    prints an error for -1 entries and the encoders clamp; 0 is the no-op)."""
    ids = np.asarray(ids, dtype=np.int64)
    clipped = np.clip(ids, 0, len(lut) - 1)
    out = lut[clipped]
    return np.where((ids >= 0) & (ids < len(lut)) & (out >= 0), out, 0)


def extract_z(
    action_infos: Sequence[Dict],
    home_born_location: Optional[int] = None,
    away_born_location: Optional[int] = None,
    filter_spine: bool = True,
    bo_zergling_num: int = 8,
):
    """Strategy-statistics ("Z") extraction from a decoded action stream
    (reference get_z, features.py:419-460): beginning-order indices +
    locations (zergling spam capped at ``bo_zergling_num``, spine crawlers
    nearer our base than the enemy's dropped) and the dense cumulative-stat
    vector.

    Returns (beginning_order[20], cumulative_stat[dense], bo_len,
    bo_location[20]).
    """
    sx = F.SPATIAL_SIZE[1]
    own = (home_born_location % sx, home_born_location // sx) if home_born_location is not None else None
    away = (away_born_location % sx, away_born_location // sx) if away_born_location is not None else None

    zergling_count = 0
    beginning_order: List[int] = []
    bo_location: List[int] = []
    cumulative_stat = np.zeros(ACT.NUM_CUMULATIVE_STAT_ACTIONS, np.int8)
    for step in action_infos:
        action_type = int(np.asarray(step["action_info"]["action_type"]).reshape(-1)[0])
        if action_type == 322:  # Train_Zergling_quick
            zergling_count += 1
            if zergling_count > bo_zergling_num:
                continue
        if action_type in ACT.BEGINNING_ORDER_ACTIONS:
            location = int(np.asarray(step["action_info"]["target_location"]).reshape(-1)[0])
            if filter_spine and action_type == 54 and own and away:  # Build_SpineCrawler_pt
                x, y = location % sx, location // sx
                own_d = (own[0] - x) ** 2 + (own[1] - y) ** 2
                away_d = (away[0] - x) ** 2 + (away[1] - y) ** 2
                if own_d < away_d:
                    continue
            beginning_order.append(ACT.BEGINNING_ORDER_ACTIONS.index(action_type))
            bo_location.append(location)
        if action_type in ACT.CUMULATIVE_STAT_ACTIONS:
            cumulative_stat[ACT.CUMULATIVE_STAT_ACTIONS.index(action_type)] = 1

    bo_len = len(beginning_order)
    L = F.BEGINNING_ORDER_LENGTH
    beginning_order = (beginning_order + [0] * L)[:L]
    bo_location = (bo_location + [0] * L)[:L]
    return (
        np.asarray(beginning_order, np.int16),
        cumulative_stat,
        bo_len,
        np.asarray(bo_location, np.int16),
    )


class ProtoFeatures:
    """Per-game feature transformer bound to game_info (map size, races)."""

    def __init__(self, game_info, cfg: Optional[dict] = None):
        self.map_size = game_info.start_raw.map_size  # .x, .y
        self.map_name = getattr(game_info, "map_name", "unknown")
        self.start_locations = [
            (float(p.x), float(p.y))
            for p in getattr(game_info.start_raw, "start_locations", [])
        ]
        # 3 = observer type in sc_pb; duck-typed: anything with player_id +
        # race_requested and type != observer
        self.requested_races = {
            info.player_id: info.race_requested
            for info in game_info.player_info
            if getattr(info, "type", 1) != 3
        }

    def flat_location(self, x: float, y: float) -> int:
        """World (x, y) -> flat spatial index after the y flip."""
        xi = min(int(x), int(self.map_size.x) - 1)
        yi = min(int(self.map_size.y - y), int(self.map_size.y) - 1)
        return max(yi, 0) * F.SPATIAL_SIZE[1] + max(xi, 0)

    def born_locations(self, first_obs) -> (int, int):
        """(home, away) flat born locations from the initial observation:
        home = our first base structure, away = the farthest start location
        (reference Features keeps home/away_born_location for the Z spine
        filter, features.py:431-446)."""
        home_xy = None
        for u in first_obs.observation.raw_data.units:
            if u.alliance == 1 and u.unit_type in (59, 18, 86):  # nexus/cc/hatchery
                home_xy = (u.pos.x, u.pos.y)
                break
        if home_xy is None:
            return 0, 0
        away_xy = None
        best = -1.0
        for sx, sy in self.start_locations:
            d = (sx - home_xy[0]) ** 2 + (sy - home_xy[1]) ** 2
            if d > best:
                best, away_xy = d, (sx, sy)
        home = self.flat_location(*home_xy)
        away = self.flat_location(*away_xy) if away_xy else home
        return home, away

    # ------------------------------------------------------------------ obs
    def transform_obs(self, obs, padding_spatial: bool = True, opponent_obs=None) -> Dict:
        raw = obs.observation.raw_data
        spatial_info: Dict[str, np.ndarray] = {}

        # minimap planes, padded bottom/right to the fixed contract size
        for name in MINIMAP_LAYERS:
            plane = getattr(obs.observation.feature_layer_data.minimap_renders, name)
            d = unpack_feature_layer(plane)
            if d is None:
                d = np.zeros(F.SPATIAL_SIZE, np.uint8)
            if padding_spatial:
                d = np.pad(
                    d,
                    ((0, F.SPATIAL_SIZE[0] - d.shape[0]), (0, F.SPATIAL_SIZE[1] - d.shape[1])),
                )
            spatial_info[name] = d.astype(F.SPATIAL_INFO[name])

        # effect coordinate lists (flat indices, y flipped); enemy-owned
        # Liberator zones / lurker spines only (reference :479-485)
        effect_lists: Dict[str, List[int]] = {
            k: [] for k in F.SPATIAL_INFO if k.startswith("effect_")
        }
        for e in raw.effects:
            name = Effects(e.effect_id).name
            key = f"effect_{name}"
            if key not in effect_lists:
                continue
            if name in ("LiberatorDefenderZone", "LurkerSpines") and e.owner == 1:
                continue
            for p in e.pos:
                loc = int(p.x) + int(self.map_size.y - p.y) * F.SPATIAL_SIZE[1]
                effect_lists[key].append(loc)
        for k, lst in effect_lists.items():
            spatial_info[k] = _pad_to(
                np.asarray(lst[: F.EFFECT_LENGTH], np.int16), F.EFFECT_LENGTH
            )

        # ------------------------------------------------------------ units
        tag_types = {u.tag: u.unit_type for u in raw.units}
        tags: List[int] = []
        rows: List[List[float]] = []
        for u in raw.units:
            orders = list(u.orders)
            tags.append(u.tag)
            rows.append([
                u.unit_type, u.alliance, u.cargo_space_taken, u.build_progress,
                u.health_max, u.shield_max, u.energy_max, u.display_type, u.owner,
                u.pos.x, u.pos.y, u.cloak, u.is_blip, u.is_powered,
                u.mineral_contents, u.vespene_contents, u.cargo_space_max,
                u.assigned_harvesters, u.weapon_cooldown, len(orders),
                orders[0].ability_id if len(orders) > 0 else 0,
                orders[1].ability_id if len(orders) > 1 else 0,
                u.is_hallucination,
                u.buff_ids[0] if len(u.buff_ids) >= 1 else 0,
                u.buff_ids[1] if len(u.buff_ids) >= 2 else 0,
                tag_types.get(u.add_on_tag, 0) if u.add_on_tag else 0,
                u.is_active,
                orders[0].progress if len(orders) >= 1 else 0,
                orders[1].progress if len(orders) >= 2 else 0,
                orders[2].ability_id if len(orders) > 2 else 0,
                orders[3].ability_id if len(orders) > 3 else 0,
                0,  # is_in_cargo
                u.attack_upgrade_level, u.armor_upgrade_level, u.shield_upgrade_level,
                u.health, u.shield, u.energy,
            ])
            # cargo passengers become pseudo-entities at the carrier's position
            for v in u.passengers:
                tags.append(v.tag)
                rows.append([
                    v.unit_type, u.alliance, 0, 0, v.health_max, v.shield_max,
                    v.energy_max, 0, u.owner, u.pos.x, u.pos.y,
                    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                    1,  # is_in_cargo
                    0, 0, 0, v.health, v.shield, v.energy,
                ])
        rows = rows[: F.MAX_ENTITY_NUM]
        tags = tags[: F.MAX_ENTITY_NUM]
        entity_num = len(rows)
        r = np.asarray(rows, np.float32) if rows else np.zeros((0, 38), np.float32)

        col = {
            name: i
            for i, name in enumerate([
                "unit_type", "alliance", "cargo_space_taken", "build_progress",
                "health_max", "shield_max", "energy_max", "display_type", "owner",
                "x", "y", "cloak", "is_blip", "is_powered", "mineral_contents",
                "vespene_contents", "cargo_space_max", "assigned_harvesters",
                "weapon_cooldown", "order_length", "order_id_0", "order_id_1",
                "is_hallucination", "buff_id_0", "buff_id_1", "addon_unit_type",
                "is_active", "order_progress_0", "order_progress_1", "order_id_2",
                "order_id_3", "is_in_cargo", "attack_upgrade_level",
                "armor_upgrade_level", "shield_upgrade_level", "health", "shield",
                "energy",
            ])
        }

        def c(name):
            return r[:, col[name]] if entity_num else np.zeros((0,), np.float32)

        entity_info: Dict[str, np.ndarray] = {}
        for k, dtype in F.ENTITY_INFO.items():
            if k.startswith("last_"):
                v = np.zeros((entity_num,), np.int64)
            elif k == "unit_type":
                v = _lut(ACT.UNIT_TYPES_REORDER_ARRAY, c(k))
            elif k == "order_id_0":
                v = _lut(ACT.UNIT_ABILITY_REORDER, c(k))
            elif k in ("order_id_1", "order_id_2", "order_id_3"):
                v = _lut(ACT.ABILITY_TO_QUEUE_ACTION, c(k))
            elif k in ("buff_id_0", "buff_id_1"):
                v = _lut(ACT.BUFFS_REORDER_ARRAY, c(k))
            elif k == "addon_unit_type":
                v = _lut(ACT.ADDON_REORDER_ARRAY, c(k))
            elif k in ("cargo_space_taken", "cargo_space_max"):
                v = np.clip(c(k), 0, 8)
            elif k == "health_ratio":
                v = c("health") / (c("health_max") + 1e-6)
            elif k == "shield_ratio":
                v = c("shield") / (c("shield_max") + 1e-6)
            elif k == "energy_ratio":
                v = c("energy") / (c("energy_max") + 1e-6)
            elif k == "mineral_contents":
                v = c(k) / 1800.0
            elif k == "vespene_contents":
                v = c(k) / 2500.0
            elif k == "y":
                v = self.map_size.y - c(k)
            else:
                v = c(k)
            entity_info[k] = _pad_to(np.asarray(v), F.MAX_ENTITY_NUM).astype(dtype)

        # ---------------------------------------------------------- scalars
        player = obs.observation.player_common
        scalar_info: Dict[str, np.ndarray] = {}
        scalar_info["time"] = np.asarray(obs.observation.game_loop, np.float32)
        stats = np.asarray(
            [
                player.minerals, player.vespene, player.food_used, player.food_cap,
                player.food_army, player.food_workers, player.idle_worker_count,
                player.army_count, player.warp_gate_count, player.larva_count,
            ],
            np.float32,
        )
        scalar_info["agent_statistics"] = np.log1p(stats)
        scalar_info["home_race"] = np.asarray(
            self.requested_races[player.player_id], np.uint8
        )
        away = [r_ for pid, r_ in self.requested_races.items() if pid != player.player_id]
        scalar_info["away_race"] = np.asarray(away[0] if away else 0, np.uint8)

        upgrades = np.zeros(ACT.NUM_UPGRADES, np.uint8)
        up_idx = _lut(ACT.UPGRADES_REORDER_ARRAY, list(raw.player.upgrade_ids)[: F.UPGRADE_LENGTH])
        upgrades[up_idx.astype(np.int64)] = 1
        scalar_info["upgrades"] = upgrades

        own = entity_info["alliance"][:entity_num] == 1
        own_types = entity_info["unit_type"][:entity_num][own].astype(np.int64)
        bow = np.zeros(ACT.NUM_UNIT_TYPES, np.int64)
        np.add.at(bow, own_types, 1)
        scalar_info["unit_counts_bow"] = np.clip(bow, 0, 255).astype(np.uint8)
        scalar_info["unit_type_bool"] = (bow > 0).astype(np.uint8)

        order_bool = np.zeros(ACT.NUM_UNIT_MIX_ABILITIES, np.uint8)
        own_orders = entity_info["order_id_0"][:entity_num][own].astype(np.int64)
        order_bool[own_orders] = 1
        scalar_info["unit_order_type"] = order_bool

        enemy = entity_info["alliance"][:entity_num] == 4
        enemy_types = entity_info["unit_type"][:entity_num][enemy].astype(np.int64)
        enemy_bool = np.zeros(ACT.NUM_UNIT_TYPES, np.uint8)
        enemy_bool[enemy_types] = 1
        scalar_info["enemy_unit_type_bool"] = enemy_bool

        # Z-conditioning fields are the AGENT's responsibility (pre_process);
        # zero here to keep the schema complete
        scalar_info["cumulative_stat"] = np.zeros(ACT.NUM_CUMULATIVE_STAT_ACTIONS, np.uint8)
        scalar_info["beginning_order"] = np.zeros(F.BEGINNING_ORDER_LENGTH, np.int16)
        scalar_info["bo_location"] = np.zeros(F.BEGINNING_ORDER_LENGTH, np.int16)
        scalar_info["last_queued"] = np.asarray(0, np.int16)
        scalar_info["last_delay"] = np.asarray(0, np.int16)
        scalar_info["last_action_type"] = np.asarray(0, np.int16)

        action_result = [o.result for o in obs.action_errors] or [1]
        battle_score = compute_battle_score(obs)
        opponent_battle_score = compute_battle_score(opponent_obs)
        ret = {
            "spatial_info": spatial_info,
            "scalar_info": scalar_info,
            "entity_info": entity_info,
            "entity_num": np.asarray(entity_num, np.int64),
            "game_info": {
                "map_name": self.map_name,
                "game_loop": int(obs.observation.game_loop),
                "tags": tags,
            },
            # top-level copies are the agent-facing contract (MockEnv shares it)
            "action_result": action_result,
            "battle_score": battle_score,
            "opponent_battle_score": opponent_battle_score,
        }

        if opponent_obs is not None:
            ret["value_feature"] = self._value_feature(ret, opponent_obs)
        return ret

    def _value_feature(self, ret: Dict, opponent_obs) -> Dict:
        """Opponent-derived centralized-critic features (reference :691-765)."""
        raw = opponent_obs.observation.raw_data
        entity_info = ret["entity_info"]
        n = int(ret["entity_num"])
        own_mask = entity_info["alliance"][:n] == 1

        enemy_x, enemy_y, enemy_types = [], [], []
        for u in raw.units:
            if u.alliance == 1:  # the OPPONENT's own units
                enemy_x.append(u.pos.x)
                enemy_y.append(self.map_size.y - u.pos.y)
                enemy_types.append(u.unit_type)
        enemy_types = _lut(ACT.UNIT_TYPES_REORDER_ARRAY, enemy_types).astype(np.int64)
        bow = np.zeros(ACT.NUM_UNIT_TYPES, np.int64)
        np.add.at(bow, enemy_types, 1)

        unit_type = np.concatenate(
            [enemy_types, entity_info["unit_type"][:n][own_mask].astype(np.int64)]
        )
        unit_x = np.concatenate([np.asarray(enemy_x), entity_info["x"][:n][own_mask]])
        unit_y = np.concatenate([np.asarray(enemy_y), entity_info["y"][:n][own_mask]])
        alliance = np.concatenate(
            [np.ones(len(enemy_types)), np.zeros(own_mask.sum())]
        )
        total = len(unit_y)

        player = opponent_obs.observation.player_common
        stats = np.asarray(
            [
                player.minerals, player.vespene, player.food_used, player.food_cap,
                player.food_army, player.food_workers, player.idle_worker_count,
                player.army_count, player.warp_gate_count, player.larva_count,
            ],
            np.float32,
        )
        upgrades = np.zeros(ACT.NUM_UPGRADES, np.uint8)
        up = _lut(ACT.UPGRADES_REORDER_ARRAY, list(raw.player.upgrade_ids)[: F.UPGRADE_LENGTH])
        upgrades[up.astype(np.int64)] = 1

        opp_rel = unpack_feature_layer(
            opponent_obs.observation.feature_layer_data.minimap_renders.player_relative
        )
        if opp_rel is None:
            opp_rel = np.zeros(F.SPATIAL_SIZE, np.uint8)
        opp_rel = np.pad(
            opp_rel,
            ((0, F.SPATIAL_SIZE[0] - opp_rel.shape[0]), (0, F.SPATIAL_SIZE[1] - opp_rel.shape[1])),
        )
        return {
            "unit_type": _pad_to(unit_type, F.MAX_ENTITY_NUM).astype(np.int16),
            "enemy_unit_counts_bow": np.clip(bow, 0, 255).astype(np.uint8),
            "enemy_unit_type_bool": (bow > 0).astype(np.uint8),
            "unit_x": _pad_to(unit_x, F.MAX_ENTITY_NUM).astype(np.uint8),
            "unit_y": _pad_to(unit_y, F.MAX_ENTITY_NUM).astype(np.uint8),
            "unit_alliance": _pad_to(alliance, F.MAX_ENTITY_NUM).astype(np.uint8),
            "total_unit_count": np.asarray(total, np.int64),
            "enemy_agent_statistics": np.log1p(stats),
            "enemy_upgrades": upgrades.astype(np.int16),
            "enemy_cumulative_stat": np.zeros(ACT.NUM_CUMULATIVE_STAT_ACTIONS, np.uint8),
            "own_units_spatial": (ret["spatial_info"]["player_relative"] == 1).astype(np.uint8),
            "enemy_units_spatial": (opp_rel == 1).astype(np.uint8),
            "beginning_order": np.zeros(F.BEGINNING_ORDER_LENGTH, np.int16),
            "bo_location": np.zeros(F.BEGINNING_ORDER_LENGTH, np.int16),
        }

    # --------------------------------------------------------------- action
    def transform_action(
        self, action: Dict, tags: Sequence[int], selected_units_num=None
    ) -> Dict:
        """Agent action dict -> raw-command dict the env/client executes
        (reference transform_action :770-850; emitting a plain dict keeps
        this independent of sc_pb — the client binding wraps it).

        ``selected_units_num`` (from the sampler output) bounds the selection;
        without it the scan stops at the end token — steps beyond it carry
        sampler garbage that must not become unit commands."""
        action_type = int(np.asarray(action["action_type"]).reshape(-1)[0])
        spec = ACT.ACTIONS[action_type]
        cmd: Dict = {
            "func_id": spec["func_id"],
            "ability_id": spec["general_ability_id"] or 0,
            "queue_command": bool(int(np.asarray(action["queued"]).reshape(-1)[0]))
            if spec["queued"]
            else False,
            "unit_tags": [],
        }
        if spec["selected_units"]:
            sel = np.asarray(action["selected_units"]).reshape(-1)
            n_tags = len(tags)
            if selected_units_num is not None:
                sel = sel[: int(np.asarray(selected_units_num).reshape(-1)[0])]
            else:
                end = np.nonzero(sel == n_tags)[0]
                if end.size:
                    sel = sel[: int(end[0]) + 1]
            seen = set()
            unit_tags = []
            for i in sel:
                i = int(i)
                if 0 <= i < n_tags and i not in seen:
                    seen.add(i)
                    unit_tags.append(int(tags[i]))
            cmd["unit_tags"] = unit_tags
        if spec["target_unit"]:
            tu = int(np.asarray(action["target_unit"]).reshape(-1)[0])
            if 0 <= tu < len(tags):
                cmd["target_unit_tag"] = int(tags[tu])
        if spec["target_location"]:
            loc = int(np.asarray(action["target_location"]).reshape(-1)[0])
            x = loc % F.SPATIAL_SIZE[1]
            y = loc // F.SPATIAL_SIZE[1]
            cmd["target_world_space_pos"] = (float(x), float(self.map_size.y - y))
        return cmd

    def _ability_to_action(self, ability_id: int, kind: str) -> Optional[int]:
        """Canonicalise an ability id and disambiguate pt/unit/quick/autocast
        variants (reference transfer_action_type :862-880)."""
        if ability_id in ACT.FRIVOLOUS_ABILITIES:
            return None
        if ability_id in ACT.UNLOAD_UNIT_ABILITIES:
            ability_id = ACT.UNLOAD_ALL_TARGET
        elif ability_id in ACT.CANCEL_SLOT_ABILITIES:
            ability_id = ACT.CANCEL_SLOT_TARGET
        gab = ACT.ABILITY_TO_GABILITY.get(ability_id, ability_id)
        return ACT.GAB_KIND_TO_ACTION.get((gab, kind))

    @staticmethod
    def _proto_field(msg, name):
        """Submessage presence: real protos need HasField (unset oneof
        members read as defaults); duck-typed fixtures use None/absence."""
        if hasattr(msg, "HasField"):
            try:
                return getattr(msg, name) if msg.HasField(name) else None
            except ValueError:
                return None
        return getattr(msg, name, None)

    def reverse_raw_action(self, raw_action, tags: Sequence[int]) -> Dict:
        """Replay raw action -> model action dict + per-head mask (reference
        reverse_raw_action :854-951): ability canonicalised (cancel/unload
        remaps) and disambiguated by command kind — unit_command as
        unit/pt/quick, toggle_autocast as autocast (reference :912-922) —
        selected tags mapped to entity indices with the end-flag appended,
        location clamped into the map after the y flip. Invalid/unknown
        actions come back as masked no_ops (invalid=True)."""
        uc = self._proto_field(raw_action, "unit_command")
        ac = self._proto_field(raw_action, "toggle_autocast")
        tag_index = {t: i for i, t in enumerate(tags)}
        entity_num = len(tags)
        S = F.MAX_SELECTED_UNITS_NUM
        invalid = False

        target_unit = 0
        location = 0
        queued = 0
        if ac is not None:
            kind = "autocast"
            ability_id = ac.ability_id
            unit_tags = ac.unit_tags
            action_type = self._ability_to_action(ability_id, kind)
        elif uc is not None:
            ability_id = uc.ability_id
            unit_tags = uc.unit_tags
            queued = int(getattr(uc, "queue_command", False) or 0)
            pos = self._proto_field(uc, "target_world_space_pos")
            target_tag = self._proto_field(uc, "target_unit_tag")
            if target_tag is not None:
                kind = "unit"
                if target_tag in tag_index:
                    target_unit = tag_index[target_tag]
                else:
                    invalid = True
            elif pos is not None:
                kind = "pt"
                x = int(pos.x) if hasattr(pos, "x") else int(pos[0])
                y = int(pos.y) if hasattr(pos, "y") else int(pos[1])
                x = min(x, int(self.map_size.x) - 1)
                y = min(int(self.map_size.y) - y, int(self.map_size.y) - 1)
                location = max(y, 0) * F.SPATIAL_SIZE[1] + max(x, 0)
            else:
                kind = "quick"
            action_type = self._ability_to_action(ability_id, kind)
            if action_type is None and kind == "quick":
                action_type = self._ability_to_action(ability_id, "autocast")
        else:
            unit_tags = []
            action_type = None
        if action_type is None:
            action_type = 0
            invalid = True
        spec = ACT.ACTIONS[action_type]

        selected = np.zeros(S, np.int64)
        sun = 0
        # tags matched against THIS obs (the reference collects only tags it
        # can resolve, :888-894) — kept for every unit-carrying command, not
        # just spec'd selections, and NOT capped (:930-931 caps the tensor)
        matched = [(tag_index[t], t) for t in unit_tags if t in tag_index]
        selected_tags: List[int] = [t for _, t in matched]
        if spec["selected_units"]:
            if matched:
                idxs = [i for i, _ in matched][: S - 1]
                selected[: len(idxs)] = idxs
                selected[len(idxs)] = entity_num  # end flag (reference :931)
                sun = len(idxs) + 1
            else:
                invalid = True
        action = {
            "action_type": np.asarray(action_type, np.int64),
            "delay": np.asarray(0, np.int64),
            "queued": np.asarray(queued, np.int64),
            "selected_units": selected,
            "target_unit": np.asarray(target_unit, np.int64),
            "target_location": np.asarray(location, np.int64),
        }
        head_valid = 0.0 if invalid else 1.0
        mask = {
            "action_type": head_valid,
            "delay": head_valid,
            # autocast commands carry no queue bit on the wire — the
            # reference leaves queued unset there (mask 0, :887 vs :915)
            "queued": head_valid * float(spec["queued"]) * (0.0 if ac is not None else 1.0),
            "selected_units": head_valid * float(spec["selected_units"]),
            "target_unit": head_valid * float(spec["target_unit"]),
            "target_location": head_valid * float(spec["target_location"]),
        }
        return {
            "action": action,
            "selected_units_num": np.asarray(sun, np.int64),
            "mask": mask,
            "invalid": invalid,
            # raw tags behind the selection, for last-action augmentation
            # (the decoder's last_selected_units; works for autocast too)
            "selected_tags": selected_tags,
            "target_tag": (
                int(tags[target_unit]) if (kind == "unit" and not invalid) else None
            ) if uc is not None and ac is None else None,
        }

"""Two-pass SC2 replay decoder -> SL training trajectories.

Counterpart of ``distar_tpu.envs.replay_decoder``.

Role parity with the reference ReplayDecoder (reference: distar/agent/
default/replay_decoder.py:37-435):

  pass 1 (:236-278)  start the replay with a 1x1 minimap (actions need no
                     spatial data), step at 50-loop strides, harvest the raw
                     action stream (camera moves dropped), running the
                     keyboard-spam ``FilterActions`` dedup (:70-214) to build
                     the *filtered* stream used for Z extraction;
  pass 2 (:281-330+) restart with the full map-sized minimap, observe
                     BEFORE each action, step its recorded delay, emit
                     (obs, action) pairs via ProtoFeatures.transform_obs +
                     reverse_raw_action with last-action augmentation and
                     the missed-tag fixup (:44-60);
  version routing (:361-400)  a replay's base_build picks the binary via
                     run_configs.version_for_build (BUILD2VERSION); the
                     client relaunches on version change or every 10 replays.

Output steps follow the frozen ReplayDataset contract
(learner/sl_dataloader.py): feature-schema obs + action_info + action_mask +
selected_units_num, with the replay's Z written into every step's
scalar_info.

The client is injectable: production uses StarcraftProcess via run_configs;
tests connect to fake_sc2.FakeSC2Server through the same RemoteController.
"""
from __future__ import annotations

import logging
import random
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..lib import actions as ACT
from ..lib import features as F
from ..obs import get_registry
from .features import ProtoFeatures, extract_z

RESULT_DICT = {1: "W", 2: "L", 3: "D", 4: "U"}
RACE_DICT = {1: "terran", 2: "zerg", 3: "protoss", 4: "random"}
# crawler/uprooted/burrowed variants whose tags vanish mid-morph
# (reference get_tags :62-67)
MORPHING_UNIT_TYPES = {
    665, 666, 341, 1961, 483, 884, 885, 796, 797, 146, 147, 608, 880, 344, 881, 342,
}


def get_tags(obs) -> Dict[int, List[float]]:
    tags = {}
    for u in obs.observation.raw_data.units:
        if u.unit_type in MORPHING_UNIT_TYPES:
            tags[u.tag] = [u.pos.x, u.pos.y]
    return tags


def find_missed_tag(obs, action, saved_tags):
    """Remap a target tag that morphed away to the unit now standing at its
    recorded position (reference :44-60)."""
    ar = action.action_raw
    if ar.HasField("unit_command") and ar.unit_command.HasField("target_unit_tag"):
        target_tag = ar.unit_command.target_unit_tag
        live = {u.tag for u in obs.observation.raw_data.units}
        if target_tag not in live and target_tag in saved_tags:
            x, y = saved_tags[target_tag]
            for u in obs.observation.raw_data.units:
                if u.pos.x == x and u.pos.y == y:
                    action.action_raw.unit_command.target_unit_tag = u.tag
                    break
    return action


class FilterActions:
    """De-duplicate keyboard-spam action bursts (reference :70-214): runs of
    the same train/research/morph/bile ability within <=4 loops collapse to
    the number of effects actually observed between observations."""

    def __init__(self, flag: bool = False):
        def gids(pred):
            return {
                a["general_ability_id"] for a in ACT.ACTIONS if pred(a["name"]) and a["general_ability_id"]
            }

        zerg_morphs = {
            "Train_Baneling_quick", "Train_Corruptor_quick", "Train_Drone_quick",
            "Train_Hydralisk_quick", "Train_Infestor_quick", "Train_Mutalisk_quick",
            "Train_Overlord_quick", "Train_Roach_quick", "Train_SwarmHost_quick",
            "Train_Ultralisk_quick", "Train_Zergling_quick",
        }
        self.morph_abilities = gids(lambda n: n in zerg_morphs or "Morph" in n)
        self.train_abilities = gids(lambda n: "Train" in n and n not in zerg_morphs)
        self.research_abilities = gids(lambda n: "Research" in n)
        self.corrosivebile = {2338}
        self.target_abilities = (
            self.train_abilities | self.research_abilities
            | self.corrosivebile | self.morph_abilities
        )
        self.max_loop = 4
        self.filter_flag = flag

    @staticmethod
    def gen_ability_id(action):
        ar = action.action_raw
        if ar.HasField("unit_command"):
            return ar.unit_command.ability_id
        if ar.HasField("toggle_autocast"):
            return ar.toggle_autocast.ability_id
        return None

    @staticmethod
    def gen_unit_tags(action):
        ar = action.action_raw
        if ar.HasField("unit_command"):
            return ar.unit_command.unit_tags
        if ar.HasField("toggle_autocast"):
            return ar.toggle_autocast.unit_tags
        return []

    def _count_real(self, actions, a_id, pre_obs, post_obs) -> Optional[int]:
        """How many of this burst's commands visibly took effect; None keeps
        the burst unfiltered."""
        unit_tags = self.gen_unit_tags(actions[0])
        if a_id in self.morph_abilities:
            pre = {u.tag: u.unit_type for u in pre_obs.units}
            post = {u.tag: u.unit_type for u in post_obs.units}
            count = 0
            for t in unit_tags:
                if t not in pre or t not in post:
                    count += 1
                elif pre[t] != post[t]:
                    count += 1
            return count
        if a_id in self.corrosivebile:
            pre = {u.tag: u.unit_type for u in pre_obs.units}
            count = 0
            for t in unit_tags:
                if t not in pre or pre[t] == 688:  # Ravager
                    count += 1
            return count
        if a_id in self.train_abilities:
            pre = {u.tag: len(u.orders) for u in pre_obs.units}
            post = {u.tag: len(u.orders) for u in post_obs.units}
            pre_len = post_len = 0
            for t in unit_tags:
                if t not in pre or t not in post:
                    return None  # tag vanished: keep everything
                pre_len += pre[t]
                post_len += post[t]
            return post_len - pre_len
        return None

    def filter(self, actions, a_id, last_last_ob, last_ob, ob):
        if a_id not in self.target_abilities or len(actions) == 1:
            return actions
        if a_id in self.research_abilities:
            return [actions[0]]  # research can't repeat
        if actions[0].game_loop >= last_ob.observation.game_loop:
            pre_obs = last_ob.observation.raw_data
        else:
            pre_obs = last_last_ob.observation.raw_data
        count = self._count_real(actions, a_id, pre_obs, ob.observation.raw_data)
        if count is None:
            return actions
        count = min(count, len(actions))
        # spread the kept commands across the burst, always keeping the last
        new_actions = []
        for i in range(count):
            index = -1 if i == count - 1 else (len(actions) // count) * i
            new_actions.append(actions[index])
        return new_actions

    def run(self, last_last_ob, last_ob, ob, cached_actions):
        """Consume completed same-ability bursts from ``cached_actions``;
        returns (still_cached, filtered_out_now)."""
        if not self.filter_flag or ob.observation.game_loop > 8000:  # ~6 min
            return [], cached_actions
        if not cached_actions:
            return [], []
        out = []
        burst = []
        for idx, a in enumerate(cached_actions[:-1]):
            burst.append(a)
            a_id = self.gen_ability_id(a)
            next_id = self.gen_ability_id(cached_actions[idx + 1])
            gap = cached_actions[idx + 1].game_loop - a.game_loop
            if a_id != next_id or gap > self.max_loop:
                out += self.filter(burst, a_id, last_last_ob, last_ob, ob)
                burst = []
        return burst + [cached_actions[-1]], out


class ReplayDecoder:
    """Decode one replay-player into an SL trajectory (step-dict list)."""

    def __init__(
        self,
        cfg: Optional[dict] = None,
        controller_provider: Optional[Callable[[Optional[str]], object]] = None,
        stride: int = 50,
    ):
        cfg = cfg or {}
        self._stride = stride
        self._parse_race = cfg.get("parse_race", "ZTP")
        self._minimum_action_length = cfg.get("minimum_action_length", 128)
        self._filter = FilterActions(cfg.get("filter_action", False))
        self._relaunch_every = cfg.get("relaunch_every_replays", 10)
        # external endpoints (an SC2 we didn't launch) must not be killed by
        # RequestQuit, and gain nothing from periodic relaunch
        self._external = bool(cfg.get("external_endpoint", False))
        if self._external:
            self._relaunch_every = 10 ** 9
        self._provider = controller_provider or _SC2ProcessProvider()
        self._controller = None
        self._version: Optional[str] = None
        self._decoded_since_launch = 0

    # ---------------------------------------------------------------- client
    def _ensure_client(self, version: Optional[str]) -> None:
        relaunch = (
            self._controller is None
            or (version is not None and version != self._version)
            or self._decoded_since_launch >= self._relaunch_every
        )
        if not relaunch:
            return
        self.close()
        self._controller = self._provider(version)
        self._version = version
        self._decoded_since_launch = 0

    def close(self) -> None:
        if self._controller is not None:
            try:
                if self._external:
                    self._controller.close()  # drop the socket, leave SC2 up
                else:
                    self._controller.quit()
            except Exception:
                pass
            self._controller = None
        closer = getattr(self._provider, "close", None)
        if closer:
            closer()

    # ------------------------------------------------------------------- run
    def run(self, replay_path: str, player_index: int) -> Optional[List[dict]]:
        """Decode ``replay_path`` from ``player_index``'s (0/1) perspective;
        None for computer players / off-race / too-short replays / errors
        (reference run :361-412)."""
        try:
            start_time = time.time()
            info = self._replay_info(replay_path)
            if info is None:
                return None
            if info["player_type"][player_index] == 2:  # Computer
                return None
            if info["race"][player_index][0].upper() not in self._parse_race.upper():
                return None
            self._ensure_client(info["version"])
            self._decoded_since_launch += 1
            data = self._parse_replay(replay_path, player_index, info)
            if data is None or len(data) < self._minimum_action_length:
                return None
            elapsed = time.time() - start_time
            reg = get_registry()
            reg.counter("distar_replay_decoded_total", "replays decoded").inc()
            reg.counter(
                "distar_replay_decoded_steps_total", "training steps emitted"
            ).inc(len(data))
            reg.histogram(
                "distar_replay_decode_seconds", "wall time per decoded replay"
            ).observe(elapsed)
            if elapsed > 0:
                reg.gauge(
                    "distar_replay_decode_steps_per_s", "decode throughput (last replay)"
                ).set(len(data) / elapsed)
            logging.info(
                "decoded %s player %d: %d steps in %.1fs",
                replay_path, player_index, len(data), elapsed,
            )
            return data
        except Exception as e:
            get_registry().counter(
                "distar_replay_decode_errors_total", "replay decode failures"
            ).inc()
            logging.error("parse replay error %r\n%s", e, traceback.format_exc())
            self.close()
            self._version = None
            return None

    def _replay_info(self, replay_path: str) -> Optional[dict]:
        """Replay metadata + version routing. The version is routed from the
        replay's own MPQ header (``sc2.replay_header`` — same source the
        reference reads via mpyq, replay_decoder.py:366-377) so the FIRST
        client launch is already the right binary; the running client then
        serves the player/race/map metadata."""
        from .sc2.run_configs import VERSIONS, version_for_build

        base_build = None
        try:
            from .sc2.replay_header import parse_replay_header

            base_build = parse_replay_header(replay_path)["base_build"]
        except Exception as e:
            # unreadable OR structurally-unexpected header (e.g. field 1 not a
            # struct raises AttributeError inside parse_replay_header): any
            # failure here must fall through to client-served replay_info, not
            # fail the whole replay decode
            # unreadable header: fall back to asking whatever client is up
            # (any version serves replay_info)
            logging.warning("replay header parse failed for %s: %r", replay_path, e)
        if base_build is not None:
            self._ensure_client(version_for_build(base_build).game_version)
        else:
            self._ensure_client(self._version)
        info = self._controller.replay_info(replay_path=replay_path)
        version = version_for_build(base_build if base_build is not None else info.base_build).game_version
        if version not in VERSIONS:
            logging.warning("no game version for build %s; using current", info.base_build)
            version = self._version
        from .sc2.maps import LOCALIZED_BNET_NAME_TO_NAME_LUT

        return {
            "race": [RACE_DICT.get(p.player_info.race_actual, "random") for p in info.player_info],
            "result": [RESULT_DICT.get(p.player_result.result, "U") for p in info.player_info],
            "player_type": [p.player_info.type for p in info.player_info],
            "mmr": [p.player_mmr for p in info.player_info],
            "map_name": LOCALIZED_BNET_NAME_TO_NAME_LUT.get(info.map_name, info.map_name),
            "game_steps": info.game_duration_loops,
            "version": version,
        }

    # ----------------------------------------------------------------- parse
    def _start_replay(self, replay_path: str, player: int, minimap_xy) -> None:
        from .sc2.proto import sc_pb

        interface = sc_pb.InterfaceOptions(
            raw=True, score=False, raw_crop_to_playable_area=True,
        )
        interface.feature_layer.width = 1
        interface.feature_layer.resolution.x = 1
        interface.feature_layer.resolution.y = 1
        interface.feature_layer.minimap_resolution.x = minimap_xy[0]
        interface.feature_layer.minimap_resolution.y = minimap_xy[1]
        interface.feature_layer.crop_to_playable_area = True
        self._controller.start_replay(
            sc_pb.RequestStartReplay(
                replay_path=replay_path, options=interface, observed_player_id=player,
            )
        )

    def _harvest(self, replay_path: str, player: int, game_loops: int):
        """Pass 1: action stream at ``stride``-loop strides with the spam
        filter running alongside (reference :236-278). Returns
        (player_actions, filtered_actions, first_ob)."""
        self._start_replay(replay_path, player, (1, 1))
        # game_info is only legal while in_game/in_replay: fetch it now, the
        # harvest may run the replay to Status.ended
        game_info = self._controller.game_info()
        cur_loop = 0
        player_actions: List = []
        filtered_actions: List = []
        cached: List = []
        first_ob = last_last_ob = last_ob = self._controller.observe()
        while cur_loop < game_loops:
            next_loop = min(game_loops, cur_loop + self._stride)
            self._controller.step(next_loop - cur_loop)
            cur_loop = next_loop
            ob = self._controller.observe()
            for a in ob.actions:
                if a.HasField("action_raw") and not a.action_raw.HasField("camera_move"):
                    cached.append(a)
                    player_actions.append(a)
            cached, fresh = self._filter.run(last_last_ob, last_ob, ob, cached)
            last_last_ob, last_ob = last_ob, ob
            filtered_actions += fresh
            if len(ob.player_result):
                filtered_actions += cached
                break
        return player_actions, filtered_actions, first_ob, game_info

    def decode_z(self, replay_path: str, player_index: int) -> Optional[dict]:
        """Z-only decode (pass 1 alone): one episode summary for
        lib.z_library.build_z_library (role of the reference gen_z
        _parse_replay, distar/bin/gen_z.py:240-300)."""
        try:
            info = self._replay_info(replay_path)
            if info is None or info["player_type"][player_index] == 2:
                return None
            if info["race"][player_index][0].upper() not in self._parse_race.upper():
                return None
            self._ensure_client(info["version"])
            self._decoded_since_launch += 1
            player = player_index + 1
            actions, filtered, first_ob, game_info = self._harvest(
                replay_path, player, info["game_steps"]
            )
            if not actions:
                return None
            feature = ProtoFeatures(game_info)
            home_loc, away_loc = feature.born_locations(first_ob)
            race = info["race"][player_index]
            opp_race = info["race"][1 - player_index] if len(info["race"]) > 1 else race
            mix_race = race if race == opp_race else race + opp_race
            filtered_infos = _z_action_infos(feature, filtered)
            bo, cum, _, bo_loc = extract_z(filtered_infos, home_loc, away_loc)
            return {
                "map_name": info["map_name"],
                "mix_race": mix_race,
                "born_location": home_loc,
                "winloss": 1 if info["result"][player_index] == "W" else -1,
                "beginning_order": bo.tolist(),
                "bo_location": bo_loc.tolist(),
                "cumulative_stat": cum.tolist(),
                "game_loop": int(actions[-1].game_loop),
                "mmr": info["mmr"][player_index],
            }
        except Exception as e:
            logging.error("decode_z error %r\n%s", e, traceback.format_exc())
            self.close()
            self._version = None
            return None

    def _parse_replay(self, replay_path: str, player_index: int, info: dict) -> Optional[List[dict]]:
        player = player_index + 1
        player_actions, filtered_actions, _, _ = self._harvest(
            replay_path, player, info["game_steps"]
        )
        if not player_actions:
            return None

        # ---------------- pass 2: (obs, action) pairs (full minimap, :281-330)
        try:
            from .sc2.maps import get_map_size

            map_size = tuple(get_map_size(info["map_name"]))  # (x, y)
        except KeyError:
            # unknown map: the feature contract's full (x, y) = (160, 152)
            map_size = (F.SPATIAL_SIZE[1], F.SPATIAL_SIZE[0])
        self._start_replay(replay_path, player, map_size)
        raw_ob = self._controller.observe()
        saved_tags = get_tags(raw_ob)
        game_info = self._controller.game_info()
        feature = ProtoFeatures(game_info)
        home_loc, away_loc = feature.born_locations(raw_ob)

        last_selected_tags: Optional[Sequence[int]] = None
        last_target_tag: Optional[int] = None
        last_delay = np.asarray(0, np.int16)
        last_action_type = np.asarray(0, np.int16)
        last_queued = np.asarray(0, np.int16)
        enemy_unit_type_bool = np.zeros(ACT.NUM_UNIT_TYPES, np.uint8)

        self._controller.step(max(player_actions[0].game_loop - 2, 0))
        traj_data: List[dict] = []
        for idx, action in enumerate(player_actions):
            if idx == len(player_actions) - 1:
                delay = random.randint(0, F.MAX_DELAY)
            else:
                delay = player_actions[idx + 1].game_loop - action.game_loop
            raw_ob = self._controller.observe()
            if len(raw_ob.player_result):
                break
            if delay > 0:
                self._controller.step(delay)
            # accumulate morphing-unit positions as they appear (crawlers
            # etc. don't exist at game start)
            saved_tags.update(get_tags(raw_ob))
            action = find_missed_tag(raw_ob, action, saved_tags)

            step_data = feature.transform_obs(raw_ob)
            entity_num = int(step_data["entity_num"])
            tags = step_data["game_info"]["tags"]
            tag_index = {t: i for i, t in enumerate(tags)}
            last_selected_units = np.zeros(F.MAX_ENTITY_NUM, np.int8)
            last_targeted_unit = np.zeros(F.MAX_ENTITY_NUM, np.int8)
            for t in last_selected_tags or []:
                if t in tag_index:
                    last_selected_units[tag_index[t]] = 1
            if last_target_tag is not None and last_target_tag in tag_index:
                last_targeted_unit[tag_index[last_target_tag]] = 1
            step_data["entity_info"]["last_selected_units"] = last_selected_units
            step_data["entity_info"]["last_targeted_unit"] = last_targeted_unit
            step_data["scalar_info"]["last_delay"] = last_delay
            step_data["scalar_info"]["last_action_type"] = last_action_type
            step_data["scalar_info"]["last_queued"] = last_queued
            # enemy composition accumulates across fog (reference :318-319)
            enemy_unit_type_bool = (
                enemy_unit_type_bool | step_data["scalar_info"]["enemy_unit_type_bool"]
            ).astype(np.uint8)
            step_data["scalar_info"]["enemy_unit_type_bool"] = enemy_unit_type_bool

            rev = feature.reverse_raw_action(action.action_raw, tags)
            if rev["invalid"]:
                continue
            act_info = rev["action"]
            act_info["delay"] = np.asarray(min(delay, F.MAX_DELAY - 1), np.int64)
            last_action_type = act_info["action_type"].astype(np.int16)
            last_delay = act_info["delay"].astype(np.int16)
            last_queued = act_info["queued"].astype(np.int16)
            last_selected_tags = rev["selected_tags"]
            last_target_tag = rev["target_tag"]
            step_data.pop("game_info")
            step_data.pop("value_feature", None)
            step_data.update(
                {
                    "action_info": act_info,
                    "action_mask": rev["mask"],
                    "selected_units_num": rev["selected_units_num"],
                }
            )
            traj_data.append(step_data)

        # ---------------- Z targets from the FILTERED stream (:341-351)
        filtered_infos = _z_action_infos(feature, filtered_actions)
        beginning_order, cumulative_stat, _, bo_location = extract_z(
            filtered_infos, home_loc, away_loc
        )
        for step_data in traj_data:
            step_data["scalar_info"]["beginning_order"] = beginning_order
            step_data["scalar_info"]["cumulative_stat"] = cumulative_stat.astype(np.uint8)
            step_data["scalar_info"]["bo_location"] = bo_location
        return traj_data


def _z_action_infos(feature: ProtoFeatures, actions) -> List[dict]:
    """Action stream -> action_info dicts for extract_z. Out-of-set abilities
    decode to action_type 0 == BEGINNING_ORDER_ACTIONS[0]; letting them
    through would misalign beginning_order/bo_location in the Z targets
    (unresolvable selections are fine here — Z only reads type+location)."""
    infos = []
    for a in actions:
        rev = feature.reverse_raw_action(a.action_raw, [])
        if int(np.asarray(rev["action"]["action_type"])) == 0:
            continue
        infos.append({"action_info": rev["action"]})
    return infos


class _SC2ProcessProvider:
    """Production controller provider: one StarcraftProcess per version,
    launch retries x10 (reference _restart :414-427)."""

    def __init__(self):
        self._proc = None

    def __call__(self, version: Optional[str]):
        from .sc2 import run_configs

        self.close()
        last = None
        for attempt in range(10):
            try:
                run_config = run_configs.get(version=version)
                self._proc = run_config.start(want_rgb=False)
                return self._proc.controller
            except Exception as e:
                last = e
                logging.error("start sc2 failed (%r), retry %d", e, attempt)
                self.close()
        raise RuntimeError(f"could not launch SC2 for version {version}: {last!r}")

    def close(self) -> None:
        if self._proc is not None:
            try:
                self._proc.close()
            except Exception:
                pass
            self._proc = None

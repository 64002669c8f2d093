"""Map registry: size table, localized-name LUT, data access, auto-install.

Counterpart of ``distar_tpu.envs.sc2.maps``.

Role parity with the reference map infrastructure (reference: distar/envs/
map_info.py:8-278 — MAPS size/name table + LOCALIZED_BNET_NAME_TO_NAME_LUT;
distar/pysc2/maps registry; the auto-install of bundled Ladder2019Season2
maps at distar/bin/rl_train.py:115-116). The table itself is game data,
extracted to ``data/map_info.json`` by tools/extract_map_info.py.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
from typing import Dict, List, Optional, Tuple

_DATA = os.path.join(os.path.dirname(__file__), "..", "..", "data", "map_info.json")

with open(_DATA) as _f:
    _PAYLOAD = json.load(_f)
MAPS: Dict[str, dict] = _PAYLOAD["maps"]

# any known spelling (battle.net, localized, filename stem) -> canonical name
LOCALIZED_BNET_NAME_TO_NAME_LUT: Dict[str, str] = {}
for _name, _info in MAPS.items():
    LOCALIZED_BNET_NAME_TO_NAME_LUT[_name] = _name
    if _info["battle_net"]:
        LOCALIZED_BNET_NAME_TO_NAME_LUT[_info["battle_net"]] = _name
    for _loc in _info["localized_names"]:
        LOCALIZED_BNET_NAME_TO_NAME_LUT[_loc] = _name


class Map:
    """One playable map (role of pysc2 maps.lib.Map)."""

    def __init__(self, name: str):
        if name not in MAPS:
            name = LOCALIZED_BNET_NAME_TO_NAME_LUT.get(name, name)
        if name not in MAPS:
            raise KeyError(
                f"Unknown map '{name}'. Known: {sorted(MAPS)[:10]}... "
                "(see distar_tpu_torch/data/map_info.json)"
            )
        self.name = name
        info = MAPS[name]
        self.battle_net = info["battle_net"]
        self.filename = info["map_path"]  # relative to <install>/Maps
        self.game_steps_per_episode = 0

    @property
    def path(self) -> Optional[str]:
        return self.filename

    def data(self, run_config) -> bytes:
        """Map bytes via the run config (reference lib.py map_data)."""
        if not self.filename:
            raise ValueError(f"Map '{self.name}' has no bundled path; install it first.")
        return run_config.map_data(self.filename)

    def __repr__(self) -> str:
        return f"Map({self.name!r}, {self.filename!r})"


def get(name: str) -> Map:
    return Map(name)


def get_map_size(map_name: str, cropped: bool = True) -> Tuple[int, int]:
    """(x, y) playable size (reference map_info.py:261-262)."""
    name = LOCALIZED_BNET_NAME_TO_NAME_LUT.get(map_name, map_name)
    info = MAPS[name]
    return tuple(info["map_size" if cropped else "uncropped_size"])


def get_localized_map_name(map_name: str) -> List[str]:
    name = LOCALIZED_BNET_NAME_TO_NAME_LUT.get(map_name, map_name)
    return MAPS[name]["localized_names"]


def bundled_maps_dir() -> str:
    """The Ladder2019Season2 .SC2Map bundle shipped with the package (role of
    the reference's distar/envs/maps/Ladder2019Season2/): offline hosts can
    play and decode without any network fetch. Integrity is pinned by
    MANIFEST.json (sha256 per file)."""
    return os.path.join(os.path.dirname(_DATA), "maps", "Ladder2019Season2")


def verify_bundled_maps(source_dir: Optional[str] = None) -> List[str]:
    """Check every bundled map against its MANIFEST.json sha256; returns the
    list of corrupt/missing filenames (empty == all good)."""
    import hashlib

    source_dir = source_dir or bundled_maps_dir()
    manifest_path = os.path.join(source_dir, "MANIFEST.json")
    with open(manifest_path) as f:
        manifest = json.load(f)["files"]
    bad = []
    for name, meta in manifest.items():
        path = os.path.join(source_dir, name)
        if not os.path.exists(path):
            bad.append(name)
            continue
        h = hashlib.sha256(open(path, "rb").read()).hexdigest()
        if h != meta["sha256"]:
            bad.append(name)
    return bad


def install_maps(source_dir: Optional[str] = None, sc2_dir: Optional[str] = None) -> int:
    """Copy .SC2Map files into the install's Maps dir (role of the
    auto-install at reference rl_train.py:115-116). ``source_dir`` defaults
    to the bundled Ladder2019Season2 set. Returns #installed."""
    if source_dir is None:
        source_dir = bundled_maps_dir()
    sc2_dir = os.path.expanduser(sc2_dir or os.environ.get("SC2PATH", "~/StarCraftII"))
    # maps sitting directly in source_dir install under Maps/<dirname>/ so
    # they land where map_data's primary 'Maps/Ladder2019Season2/<file>'
    # lookup (and a conventional install's idempotency check) expects them
    season = os.path.basename(os.path.normpath(source_dir))
    installed = 0
    for root, _, files in os.walk(source_dir):
        for f in files:
            if not f.lower().endswith(".sc2map"):
                continue
            rel = os.path.relpath(os.path.join(root, f), source_dir)
            season_prefixed = os.sep not in rel and bool(season)
            if season_prefixed:
                rel = os.path.join(season, rel)
            dst = os.path.join(sc2_dir, "Maps", rel)
            if os.path.exists(dst):
                continue
            # hosts that installed before the season-prefix change have the
            # map directly under Maps/ — treat that as already installed too
            if season_prefixed and os.path.exists(os.path.join(sc2_dir, "Maps", f)):
                continue
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copyfile(os.path.join(root, f), dst)
            installed += 1
    if installed:
        logging.info("installed %d maps into %s/Maps", installed, sc2_dir)
    return installed

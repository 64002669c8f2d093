"""LAN / remote human-play: an agent joins a game hosted on another machine.

Counterpart of ``distar_tpu.envs.sc2.lan``.

Role parity with the reference's LAN envs (reference:
distar/pysc2/env/lan_sc2_env.py — agent side: fetch the host's port config
over TCP, launch a local SC2 client, join the remote game via host_ip;
distar/pysc2/env/remote_sc2_env.py — join an externally-created game;
distar/pysc2/bin/play_vs_agent.py — human side: host the LAN game and serve
the config). This is how a remote human showmatch runs: the human's machine
hosts and plays full-screen; the agent machine joins over the network.

Wire format: ONE length-prefixed serialized dict (the comm shuttle's frame —
same data plane as trajectories) carrying
``{map_name, ports: {server_game, server_base, client_game, client_base},
race, realtime}``.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Optional, Sequence

from ...comm import shuttle
from ...comm.serializer import dumps, loads
from ..features import ProtoFeatures
from ..sc2_env import SC2Env
from .proto import sc_pb
from .run_configs import get as get_run_config

RACES = {"zerg": 2, "terran": 1, "protoss": 3, "random": 4}


@dataclasses.dataclass
class LanPorts:
    server_game: int
    server_base: int
    client_game: int
    client_base: int

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def serve_handshake(info: dict, timeout_ms: int = 600_000) -> int:
    """Host side: serve the game config once on an ephemeral port; the agent
    machine connects and receives it (role of the reference's tcp_client /
    tcp_server pair, lan_sc2_env.py)."""
    return shuttle.serve(dumps(info, compress=False), accept_count=1, timeout_ms=timeout_ms)


def fetch_handshake(host: str, port: int, timeout_ms: int = 600_000) -> dict:
    return loads(shuttle.fetch(host, port, timeout_ms=timeout_ms))


def host_lan_game(
    map_name: str,
    race: str = "zerg",
    realtime: bool = True,
    version: Optional[str] = None,
    handshake_timeout_ms: int = 600_000,
    run_config=None,
    controller=None,
    ports: Optional[LanPorts] = None,
):
    """Human/host side: launch SC2 full screen, create a 2-participant LAN
    game, publish the config, and join as the human (in the background — the
    join completes once the remote agent joins). Returns
    (controller, handshake_port, proc, join_thread); the human then plays
    through the client UI while the remote agent joins via ``LanSC2Env``.

    ``controller``/``ports`` injectable for tests (fake server).
    """
    from . import portpicker_compat as portpicker
    from . import maps as map_registry

    if run_config is None and controller is None:
        run_config = get_run_config(version=version)
    proc = None
    if controller is None:
        proc = run_config.start(want_rgb=False, full_screen=True)
        controller = proc.controller
    if ports is None:
        ports = LanPorts(*[portpicker.pick_unused_port() for _ in range(4)])

    map_inst = map_registry.get(map_name)
    create = sc_pb.RequestCreateGame(realtime=realtime, disable_fog=False)
    create.local_map.map_path = map_inst.path or map_inst.name
    if run_config is not None and map_inst.path:
        create.local_map.map_data = map_inst.data(run_config)
    create.player_setup.add(type=sc_pb.Participant)
    create.player_setup.add(type=sc_pb.Participant)
    controller.create_game(create)

    handshake_port = serve_handshake(
        {
            "map_name": map_inst.name,
            "ports": ports.as_dict(),
            "race": race,
            "realtime": realtime,
        },
        timeout_ms=handshake_timeout_ms,
    )
    logging.info(
        "LAN game '%s' hosted; agent handshake on port %d", map_inst.name, handshake_port
    )

    join = sc_pb.RequestJoinGame(options=sc_pb.InterfaceOptions(raw=False, score=True))
    join.race = RACES.get(race, RACES["zerg"])
    join.server_ports.game_port = ports.server_game
    join.server_ports.base_port = ports.server_base
    join.client_ports.add(game_port=ports.client_game, base_port=ports.client_base)
    join.player_name = "human"
    # join_game blocks until EVERY participant joined (SC2 semantics) — the
    # agent connects later from another machine, so the host's join runs in
    # the background; wait on the returned thread before playing
    import threading

    join_thread = threading.Thread(
        target=lambda: controller.join_game(join), daemon=True
    )
    join_thread.start()
    return controller, handshake_port, proc, join_thread


class LanSC2Env(SC2Env):
    """Agent side: join a remote/LAN game created elsewhere and drive it as a
    one-agent SC2Env (the human is on their own machine, never observed or
    acted by us — exactly the reference lan_sc2_env contract)."""

    def __init__(
        self,
        host: str,
        config_port: int,
        agent_race: str = "zerg",
        version: Optional[str] = None,
        episode_length: int = 100_000,
        controller_factory: Optional[Callable[[], object]] = None,
        **env_kwargs,
    ):
        info = fetch_handshake(host, config_port)
        ports = info["ports"]
        self._proc = None
        if controller_factory is not None:
            controller = controller_factory()
        else:
            run_config = get_run_config(version=version)
            self._proc = run_config.start(want_rgb=False)
            controller = self._proc.controller

        interface = sc_pb.InterfaceOptions(
            raw=True,
            score=True,
            raw_affects_selection=True,  # a human shares this game
            raw_crop_to_playable_area=True,
        )
        interface.feature_layer.width = 24
        interface.feature_layer.resolution.x = 1
        interface.feature_layer.resolution.y = 1
        try:
            from . import maps as map_registry

            map_size = map_registry.get_map_size(info["map_name"])
        except KeyError:
            map_size = (152, 160)
        interface.feature_layer.minimap_resolution.x = map_size[0]
        interface.feature_layer.minimap_resolution.y = map_size[1]
        interface.feature_layer.crop_to_playable_area = True

        join = sc_pb.RequestJoinGame(options=interface)
        join.race = RACES.get(agent_race, RACES["zerg"])
        join.player_name = "agent"
        join.host_ip = host
        # reversed roles: the host's client ports are OUR server ports
        join.server_ports.game_port = ports["server_game"]
        join.server_ports.base_port = ports["server_base"]
        join.client_ports.add(game_port=ports["client_game"], base_port=ports["client_base"])
        controller.join_game(join)

        features = ProtoFeatures(controller.game_info())
        super().__init__(
            controllers=[controller],
            features=[features],
            episode_length=episode_length,
            realtime=bool(info.get("realtime", True)),
            both_obs=False,
            **env_kwargs,
        )

    def close(self) -> None:
        super().close()
        if self._proc is not None:
            try:
                self._proc.close()
            except Exception:
                pass

"""The port's SC2 client stack (``distar_tpu_torch/envs/sc2/``) against the
JAX package's, on the CPU.

* Counterparts of tests/test_sc2_client.py (all but the headless observer,
  ``bin/observe.py``, not ported) run on the port's modules: the websocket
  protocol and ``RemoteController``'s status machine against the port's
  fake server, the launcher's create/join plumbing, the process launch over
  a fake install, version routing, the map registry, replays, the
  ``sc2_tools`` subcommands and the bundled maps (symlinks into the JAX
  package's bundle, held against the port's own manifest).
* Parity across the stacks: the port's controller against the JAX fake
  server and the JAX controller against the port's, one scripted session
  (ping, create, join, game info, observe, step, act, the game's end,
  restart, replay info): every request and response equal byte for byte
  to the JAX controller's against the JAX server.
* The port's stdlib websocket client keeps what ``_connect`` tells apart
  (a 404 or a refused dial means dial again; a closed handshake and a dead
  process mean ``ConnectError``), as websocket-client does under the JAX
  controller; fragments, pings and timeouts.
* ``parse_replay_header`` on MPQ header bytes built here (no real replay is
  in the repo), corrupt inputs too: the JAX parser's facts and errors.
* The vendored ``_proto_gen`` is byte-identical to the JAX copy.
"""
import os
import pickle
import socket
import struct
import sys
import threading

import numpy as np
import pytest

import distar_tpu.envs.sc2.fake_sc2 as jax_fake
import distar_tpu.envs.sc2.remote_controller as jax_rc
from distar_tpu.envs.sc2 import replay_header as jax_header
from distar_tpu_torch.envs.sc2 import fake_sc2, maps as map_registry, run_configs, wsclient
from distar_tpu_torch.envs.sc2 import replay_header
from distar_tpu_torch.envs.sc2.fake_sc2 import FakeGameCore, FakeSC2Server
from distar_tpu_torch.envs.sc2.launcher import Bot, Player, RealSC2Env, SC2GameLauncher, crop_and_deduplicate_names
from distar_tpu_torch.envs.sc2.proto import Status, sc_pb
from distar_tpu_torch.envs.sc2.protocol import ProtocolError
from distar_tpu_torch.envs.sc2.remote_controller import ConnectError, RemoteController
from distar_tpu_torch.lib import actions as ACT
from distar_tpu_torch.lib import features as F

from test_replay_decoder import make_replay

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def server():
    s = FakeSC2Server(game=FakeGameCore(end_at=300))
    yield s
    s.stop()


def connect(server):
    return RemoteController("127.0.0.1", server.port, timeout_seconds=5)


# ------------------------------------------------- counterparts: protocol
def test_controller_ping_and_status(server):
    c = connect(server)
    res = c.ping()
    assert res.base_build == server.game.base_build
    assert c.status == Status.launched
    c.quit()
    assert c.status == Status.quit


def test_valid_status_gating(server):
    c = connect(server)
    with pytest.raises(ProtocolError):
        c.observe()  # only legal in_game/in_replay/ended
    with pytest.raises(ProtocolError):
        c.step()
    c.quit()


def test_create_join_observe_step_act(server):
    c = connect(server)
    create = sc_pb.RequestCreateGame()
    create.local_map.map_path = "FakeMap.SC2Map"
    create.player_setup.add(type=sc_pb.Participant)
    create.player_setup.add(type=sc_pb.Computer, race=2, difficulty=7)
    c.create_game(create)
    assert c.status == Status.init_game

    join = sc_pb.RequestJoinGame(options=sc_pb.InterfaceOptions(raw=True, score=True))
    join.race = 2
    res = c.join_game(join)
    assert res.player_id == 1
    assert c.status == Status.in_game

    gi = c.game_info()
    assert gi.start_raw.map_size.x > 0

    obs = c.observe(target_game_loop=0)
    assert obs.observation.game_loop == 0
    assert len(obs.observation.raw_data.units) > 0

    c.step(10)
    obs = c.observe(target_game_loop=10)
    assert obs.observation.game_loop == 10

    result = c.acts([{"ability_id": 3674, "queue_command": False, "unit_tags": [10000, 10001]}])
    assert result == [1]
    assert server.game.action_log

    c.step(400)
    obs = c.observe(target_game_loop=400)
    assert list(obs.player_result)
    assert c.status == Status.ended
    assert c.status_ended

    c.restart()
    assert c.status == Status.in_game
    c.quit()


def test_observe_regurgitates_stub_observation(server):
    """The 2^32-1 stub obs is replaced by the previous obs + new results."""
    c = connect(server)
    create = sc_pb.RequestCreateGame()
    create.player_setup.add(type=sc_pb.Participant)
    c.create_game(create)
    c.join_game(sc_pb.RequestJoinGame(options=sc_pb.InterfaceOptions(raw=True)))
    first = c.observe()
    assert first.observation.game_loop == 0
    stub = sc_pb.ResponseObservation()
    stub.observation.game_loop = 2 ** 32 - 1
    pr = stub.player_result.add()
    pr.player_id = 1
    pr.result = sc_pb.Victory

    orig_send = c._client.send

    def fake_send(**kwargs):
        if "observation" in kwargs:
            return stub
        return orig_send(**kwargs)

    c._client.send = fake_send
    obs = c.observe()
    assert obs.observation.game_loop == first.observation.game_loop
    assert obs.player_result[0].result == sc_pb.Victory
    c._client.send = orig_send
    c.quit()


# ----------------------------------------- counterparts: the launcher
def two_player_env(server, **env_kwargs):
    launcher = SC2GameLauncher(
        map_name="KairosJunction",
        players=[Player("zerg"), Player("zerg")],
        controller_factory=lambda i: connect(server),
        relaunch_every_episodes=0,
    )
    return RealSC2Env(launcher, **env_kwargs)


def act_dict(action_type: int, delay: int = 4, n_tags: int = 16):
    sel = np.zeros(F.MAX_SELECTED_UNITS_NUM, np.int64)
    sel[1] = n_tags  # end token
    return {
        "action_type": np.asarray([action_type]),
        "delay": np.asarray([delay]),
        "queued": np.asarray([0]),
        "selected_units": sel,
        "target_unit": np.asarray([0]),
        "target_location": np.asarray([500]),
        "selected_units_num": np.asarray([2]),
    }


def test_multiplayer_create_join_and_episode(server):
    env = two_player_env(server)
    obs = env.reset()
    assert set(obs.keys()) == {0, 1}
    for i in (0, 1):
        assert obs[i]["entity_num"] > 0
        assert obs[i]["spatial_info"]["height_map"].shape == tuple(F.SPATIAL_SIZE)
        assert "value_feature" in obs[i]
    at = next(i for i, a in enumerate(ACT.ACTIONS)
              if a["selected_units"] and not a["target_unit"] and not a["target_location"])
    done = False
    for _ in range(100):
        obs, rewards, done, info = env.step({i: act_dict(at) for i in obs})
        if done:
            break
    assert done
    assert sorted(rewards.values()) == [-1.0, 1.0]
    win_idx = max(rewards, key=rewards.get)
    assert env._raw_obs[win_idx].observation.player_common.player_id == 1
    assert server.game.started
    env.close()


def test_launcher_bot_game_single_agent(server):
    launcher = SC2GameLauncher(map_name="KairosJunction", players=[Player("zerg"), Bot("zerg", 7)],
                               controller_factory=lambda i: connect(server))
    env = RealSC2Env(launcher)
    assert launcher.num_agents == 1
    obs = env.reset()
    assert set(obs.keys()) == {0}
    env.close()


def test_crop_and_deduplicate_names():
    names = crop_and_deduplicate_names(["a" * 40, "a" * 40, "short"])
    assert len(set(names)) == 3
    assert all(len(n) <= 32 for n in names)


# ------------------------------------ counterparts: process launch, routing
def test_sc_process_launch_and_connect(tmp_path, monkeypatch):
    """``StarcraftProcess`` launches the fake binary of a fake install
    (``write_fake_install``) through ``run_configs.get()``, dials until it
    serves, pings and tears down."""
    from distar_tpu_torch.envs.sc2 import sc_process

    monkeypatch.setattr(sc_process, "FIXED_PORT", None)
    monkeypatch.setenv("SC2PATH", fake_sc2.write_fake_install(str(tmp_path / "SC2"), REPO))
    rc = run_configs.get()
    assert rc.version.build_version == 75689  # the newest Versions/Base* of the install
    proc = rc.start(want_rgb=False, timeout_seconds=30)
    try:
        assert proc.running
        assert proc.controller.ping().game_version
    finally:
        proc.close()
    assert not proc.running


def test_no_install_raises_the_jax_message(tmp_path, monkeypatch):
    monkeypatch.setenv("SC2PATH", str(tmp_path / "nowhere"))
    with pytest.raises(Exception, match="Expected to find StarCraft II installed"):
        run_configs.get().start()


def test_version_routing():
    v = run_configs.VERSIONS["4.10.0"]
    assert v.build_version == 75689
    assert run_configs.BUILD2VERSION[81009] == "5.0.0"
    assert run_configs.BUILD2VERSION[80188] == "4.12.1"
    assert run_configs.version_for_build(75689).game_version == "4.10.0"
    assert run_configs.version_for_build(75690).game_version == "4.10.0"
    rc = run_configs.RunConfig(replay_dir="/tmp", data_dir="/tmp", tmp_dir=None, version="4.10")
    assert rc.version.game_version == "4.10.0"
    with pytest.raises(ValueError):
        run_configs.RunConfig(replay_dir="/tmp", data_dir="/tmp", tmp_dir=None, version="9.9.9")
    from distar_tpu.envs.sc2 import run_configs as jax_run_configs

    assert run_configs.VERSIONS == jax_run_configs.VERSIONS
    assert run_configs.BUILD2VERSION == jax_run_configs.BUILD2VERSION


def test_map_registry():
    assert map_registry.get_map_size("KairosJunction") == (120, 140)
    assert map_registry.get_map_size("KairosJunction", cropped=False) == (152, 168)
    assert map_registry.LOCALIZED_BNET_NAME_TO_NAME_LUT["Kairos Junction LE"] == "KairosJunction"
    m = map_registry.get("Kairos Junction LE")
    assert m.name == "KairosJunction"
    assert m.filename.endswith("KairosJunctionLE.SC2Map")
    with pytest.raises(KeyError):
        map_registry.get("NoSuchMap")
    from distar_tpu.envs.sc2 import maps as jax_maps

    assert map_registry.MAPS == jax_maps.MAPS
    assert map_registry.LOCALIZED_BNET_NAME_TO_NAME_LUT == jax_maps.LOCALIZED_BNET_NAME_TO_NAME_LUT


# ------------------------------------------------ counterparts: replays
def test_replay_info_and_action_stream(server):
    rep = {
        "base_build": 75689, "game_version": "4.10.0", "data_version": "FAKE",
        "map_name": "KairosJunction", "game_duration_loops": 200,
        "players": [{"player_id": 1, "race": 2, "mmr": 4800, "apm": 160, "result": 1},
                    {"player_id": 2, "race": 2, "mmr": 4600, "apm": 140, "result": 2}],
        "actions": [(10, 3674, [10000], None), (60, 1183, [10001], (20.0, 30.0)),
                    (120, 3674, [10002], 20000)],
    }
    server.game.replay_library["test.SC2Replay"] = rep
    c = connect(server)
    info = c.replay_info(replay_path="test.SC2Replay")
    assert info.base_build == 75689
    assert info.player_info[0].player_mmr == 4800
    assert info.game_duration_loops == 200

    req = sc_pb.RequestStartReplay(replay_path="test.SC2Replay", observed_player_id=1)
    req.options.raw = True
    c.start_replay(req)
    assert c.status == Status.in_replay
    harvested = []
    while not c.status_ended:
        c.step(50)
        obs = c.observe()
        harvested.extend(obs.actions)
        if obs.player_result:
            break
    assert [a.action_raw.unit_command.ability_id for a in harvested] == [3674, 1183, 3674]
    assert harvested[1].action_raw.unit_command.target_world_space_pos.x == 20.0
    assert harvested[2].action_raw.unit_command.target_unit_tag == 20000

    c2 = connect(server)
    assert c2.replay_info(replay_data=pickle.dumps(rep)).base_build == 75689
    c2.quit()
    c.quit()


def test_sc2_tools_cli_over_fake_server(server, capsys):
    """``replay-info``, ``map-list``, ``benchmark-observe`` and
    ``benchmark-replay`` through the port's client stack, each with
    ``--endpoint``."""
    from distar_tpu_torch.bin.sc2_tools import main as tools_main

    server.game.replay_library["bench.SC2Replay"] = make_replay()
    ep = f"127.0.0.1:{server.port}"
    argv = sys.argv
    try:
        sys.argv = ["sc2_tools", "replay-info", "bench.SC2Replay", "--endpoint", ep]
        tools_main()
        out = capsys.readouterr().out
        assert "KairosJunction" in out and "build 75689" in out

        sys.argv = ["sc2_tools", "map-list"]
        tools_main()
        assert "KairosJunction" in capsys.readouterr().out

        sys.argv = ["sc2_tools", "benchmark-observe", "--steps", "5", "--endpoint", ep]
        tools_main()
        assert "obs/s" in capsys.readouterr().out

        sys.argv = ["sc2_tools", "benchmark-replay", "bench.SC2Replay", "--endpoint", ep]
        tools_main()
        assert "steps/s" in capsys.readouterr().out
    finally:
        sys.argv = argv


@pytest.mark.parametrize("subcommand", ["replay-info", "map-list"])
def test_sc2_tools_prints_what_the_jax_tool_prints(subcommand, capsys):
    """Each package's ``sc2_tools`` against its own fake server with the same
    replay in its library: the same lines."""
    from distar_tpu.bin.sc2_tools import main as jax_tools
    from distar_tpu_torch.bin.sc2_tools import main as port_tools

    outs = []
    for tools, make_server in ((jax_tools, lambda: jax_fake.FakeSC2Server(game=jax_fake.FakeGameCore())),
                               (port_tools, lambda: FakeSC2Server(game=FakeGameCore()))):
        s = make_server()
        s.game.replay_library["bench.SC2Replay"] = make_replay()
        argv = sys.argv
        try:
            sys.argv = ["sc2_tools", subcommand] + (
                ["bench.SC2Replay", "--endpoint", f"127.0.0.1:{s.port}"] if subcommand == "replay-info" else [])
            tools()
        finally:
            sys.argv = argv
            s.stop()
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[1]


# -------------------------------------------------- counterparts: maps
def test_bundled_maps_manifest_and_fallback(tmp_path):
    """The bundle: the port's manifest verifies the bytes its symlinks reach,
    install_maps defaults to it, and ``RunConfig.map_data`` falls back to it
    for an install with no Maps."""
    assert map_registry.verify_bundled_maps() == []
    bundled = set(os.listdir(map_registry.bundled_maps_dir()))
    for stem in ("KairosJunctionLE", "KingsCoveLE", "NewRepugnancyLE", "CyberForestLE"):
        assert f"{stem}.SC2Map" in bundled
    n = map_registry.install_maps(sc2_dir=str(tmp_path))
    assert n == len([f for f in bundled if f.endswith(".SC2Map")])
    installed = tmp_path / "Maps" / "Ladder2019Season2" / "KairosJunctionLE.SC2Map"
    assert installed.exists() and not installed.is_symlink()  # the bytes, not a link
    assert map_registry.install_maps(sc2_dir=str(tmp_path)) == 0
    rc = run_configs.RunConfig(replay_dir="/tmp", data_dir=str(tmp_path / "no_such_install"),
                               tmp_dir=None, version="4.10")
    assert rc.map_data("Ladder2019Season2/KairosJunctionLE.SC2Map")[:4] == b"MPQ\x1a"
    assert rc.map_data("Ladder2019Season2/TurboCruise84LE.SC2Map")[:4] == b"MPQ\x1a"
    with pytest.raises(ValueError):
        rc.map_data("Ladder2019Season2/NoSuchLE.SC2Map")


def test_the_bundle_is_symlinks_to_the_jax_bundle_under_the_ports_manifest():
    """One git symlink per map into the JAX package's bundle, each resolving;
    the port's manifest lists the same files and hashes as the JAX one, and
    a changed byte behind a link fails ``verify_bundled_maps``."""
    import json

    from distar_tpu.envs.sc2 import maps as jax_maps

    port_dir, jax_dir = map_registry.bundled_maps_dir(), jax_maps.bundled_maps_dir()
    maps = sorted(f for f in os.listdir(port_dir) if f.endswith(".SC2Map"))
    assert maps == sorted(f for f in os.listdir(jax_dir) if f.endswith(".SC2Map"))
    for name in maps:
        link = os.path.join(port_dir, name)
        assert os.path.islink(link) and not os.path.isabs(os.readlink(link))
        assert os.path.samefile(link, os.path.join(jax_dir, name))
    port_manifest = json.load(open(os.path.join(port_dir, "MANIFEST.json")))["files"]
    assert port_manifest == json.load(open(os.path.join(jax_dir, "MANIFEST.json")))["files"]
    assert sorted(port_manifest) == maps


def test_verify_bundled_maps_catches_a_changed_byte(tmp_path):
    import shutil

    src = map_registry.bundled_maps_dir()
    dst = tmp_path / "bundle"
    dst.mkdir()
    shutil.copy(os.path.join(src, "MANIFEST.json"), dst)
    for name in ("AcropolisLE.SC2Map", "CyberForestLE.SC2Map"):
        shutil.copyfile(os.path.join(src, name), dst / name)
    data = bytearray((dst / "CyberForestLE.SC2Map").read_bytes())
    data[100] ^= 1
    (dst / "CyberForestLE.SC2Map").write_bytes(bytes(data))
    bad = map_registry.verify_bundled_maps(str(dst))
    assert "CyberForestLE.SC2Map" in bad and "AcropolisLE.SC2Map" not in bad


def test_proto_gen_is_byte_identical_to_the_jax_copy():
    from distar_tpu.envs.sc2 import proto as jax_proto
    from distar_tpu_torch.envs.sc2 import proto

    jax_dir = os.path.join(REPO, "distar_tpu", "envs", "sc2")
    port_dir = os.path.join(REPO, "distar_tpu_torch", "envs", "sc2")
    for sub in ("_proto_gen", "protos"):
        names = sorted(os.listdir(os.path.join(jax_dir, sub)))
        assert sorted(n for n in os.listdir(os.path.join(port_dir, sub)) if n != "__pycache__") == [
            n for n in names if n != "__pycache__"]
        for name in names:
            if name == "__pycache__":
                continue
            with open(os.path.join(jax_dir, sub, name), "rb") as a, open(os.path.join(port_dir, sub, name), "rb") as b:
                assert a.read() == b.read(), f"{sub}/{name}"
    # one descriptor pool: the two packages share message classes
    assert proto.sc_pb.Request is jax_proto.sc_pb.Request
    assert proto.PROVIDER == jax_proto.PROVIDER
    assert [s.name for s in proto.Status] == [s.name for s in jax_proto.Status]


# ------------------------------------------- parity across the two stacks
def _session(server, controller_cls):
    """One scripted session; every request the server decodes and every
    response the controller reads, as bytes."""
    requests, responses = [], []
    dispatch = server._dispatch

    def recording_dispatch(state, req):
        requests.append(req.SerializeToString())
        return dispatch(state, req)

    server._dispatch = recording_dispatch
    server.game.replay_library["p.SC2Replay"] = make_replay()
    c = controller_cls("127.0.0.1", server.port, timeout_seconds=5)
    read = c._client.read

    def recording_read():
        res = read()
        responses.append(res.SerializeToString())
        return res

    c._client.read = recording_read
    c.ping()
    create = sc_pb.RequestCreateGame(realtime=False)
    create.local_map.map_path = "Ladder2019Season2/KairosJunctionLE.SC2Map"
    create.player_setup.add(type=sc_pb.Participant)
    create.player_setup.add(type=sc_pb.Computer, race=2, difficulty=7)
    c.create_game(create)
    join = sc_pb.RequestJoinGame(options=sc_pb.InterfaceOptions(raw=True, score=True))
    join.race = 2
    c.join_game(join)
    c.game_info()
    c.observe(target_game_loop=0)
    c.step(60)
    c.observe(target_game_loop=60)
    c.acts([{"ability_id": 3674, "queue_command": True, "unit_tags": [10000, 10001],
             "target_world_space_pos": (12.5, 40.25)}])
    c.acts([{"ability_id": 1183, "queue_command": False, "unit_tags": [10002], "target_unit_tag": 20003}])
    c.step(250)
    c.observe(target_game_loop=310)
    c.restart()
    c.observe()
    c.replay_info(replay_path="p.SC2Replay")
    c.available_maps()
    status, asked = c.status, list(requests)  # every answered request
    c.quit()
    return asked, responses, status


def test_controllers_and_servers_agree_byte_for_byte_across_packages():
    sessions = {}
    for server_pkg, controller_pkg in (("jax", "jax"), ("jax", "port"), ("port", "jax"), ("port", "port")):
        server = (jax_fake.FakeSC2Server(game=jax_fake.FakeGameCore(end_at=300, seed=4)) if server_pkg == "jax"
                  else FakeSC2Server(game=FakeGameCore(end_at=300, seed=4)))
        try:
            controller_cls = jax_rc.RemoteController if controller_pkg == "jax" else RemoteController
            sessions[server_pkg, controller_pkg] = _session(server, controller_cls)
        finally:
            server.stop()
    want_req, want_res, want_status = sessions["jax", "jax"]
    assert len(want_res) == 15 and want_status.name == "in_game"
    for key, (req, res, status) in sessions.items():
        assert req == want_req, key
        assert res == want_res, key
        assert status.name == want_status.name, key


# ---------------------------------------------- the stdlib websocket client
class _Listener:
    """A TCP listener whose accepted sockets go to ``handle(sock, n)``."""

    def __init__(self, handle):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.sock.settimeout(0.1)
        self.port = self.sock.getsockname()[1]
        self.handle = handle
        self.accepted = 0
        self.stopped = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def _loop(self):
        while not self.stopped.is_set():
            try:
                conn, _ = self.sock.accept()
            except socket.timeout:
                continue
            conn.settimeout(10)
            self.accepted += 1
            threading.Thread(target=self.handle, args=(conn, self.accepted), daemon=True).start()

    def close(self):
        self.stopped.set()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()
        self.sock.close()


def _read_request(conn):
    data = b""
    while b"\r\n\r\n" not in data:
        chunk = conn.recv(4096)
        if not chunk:
            break
        data += chunk
    return data


@pytest.mark.parametrize("package", ["jax", "port"])
def test_connect_dials_again_after_a_404(package):
    """A booting binary answers 404 until /sc2api registers: both
    controllers dial again and then serve."""
    backend = FakeSC2Server(game=FakeGameCore())

    def handle(conn, n):
        if n <= 2:
            _read_request(conn)
            conn.sendall(b"HTTP/1.1 404 Not Found\r\n\r\n")
            conn.close()
        else:
            backend._serve_client(conn)

    listener = _Listener(handle)

    class Alive:
        running = True

    try:
        cls = jax_rc.RemoteController if package == "jax" else RemoteController
        c = cls("127.0.0.1", listener.port, proc=Alive(), timeout_seconds=20)
        assert c.ping().base_build == 75689 and listener.accepted == 3
        c.quit()
    finally:
        listener.close()
        backend.stop()


@pytest.mark.parametrize("package", ["jax", "port"])
def test_a_closed_handshake_raises_connect_error(package):
    """The endpoint closing the handshake (another controller owns it) ends
    the dialing at once with ``ConnectError``."""
    def handle(conn, n):
        _read_request(conn)
        conn.close()

    listener = _Listener(handle)
    try:
        cls = jax_rc.RemoteController if package == "jax" else RemoteController
        error = jax_rc.ConnectError if package == "jax" else ConnectError
        with pytest.raises(error, match="closed the handshake"):
            cls("127.0.0.1", listener.port, timeout_seconds=20)
        assert listener.accepted == 1
    finally:
        listener.close()


@pytest.mark.parametrize("package", ["jax", "port"])
def test_a_process_that_dies_raises_connect_error(package):
    """A refused dial means dial again while the process lives; once it
    has died, ``ConnectError``."""
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()  # nothing listens there

    class Dying:
        polls = 0

        @property
        def running(self):
            self.polls += 1
            return self.polls == 1

    cls = jax_rc.RemoteController if package == "jax" else RemoteController
    error = jax_rc.ConnectError if package == "jax" else ConnectError
    with pytest.raises(error, match="process is gone; stopped dialing .* after 1 attempts"):
        cls("127.0.0.1", port, proc=Dying(), timeout_seconds=20)


def _server_frame(opcode, payload, fin=True):
    n = len(payload)
    head = bytes([(0x80 if fin else 0) | opcode])
    head += bytes([n]) if n < 126 else bytes([126]) + struct.pack(">H", n)
    return head + payload


def test_wsclient_joins_fragments_answers_pings_and_masks():
    """Server side by hand: a ping, then a message in three fragments with a
    ping between them; the client answers both pings with the payload,
    masks what it sends, and a close frame reads as b''."""
    seen = {}

    def handle(conn, n):
        import base64
        import hashlib

        head = _read_request(conn).decode("latin-1")
        key = next(l.split(":", 1)[1].strip() for l in head.split("\r\n") if l.lower().startswith("sec-websocket-key"))
        accept = base64.b64encode(hashlib.sha1(key.encode() + b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11").digest())
        conn.sendall(b"HTTP/1.1 101 Switching Protocols\r\nUpgrade: websocket\r\nConnection: Upgrade\r\n"
                     b"Sec-WebSocket-Accept: " + accept + b"\r\n\r\n" + _server_frame(9, b"p1"))
        conn.sendall(_server_frame(2, b"ab", fin=False) + _server_frame(9, b"p2") + _server_frame(0, b"cd", fin=False)
                     + _server_frame(0, b"e" * 300))
        conv = fake_sc2._WSConn(conn)
        frames = []
        for _ in range(3):  # two pongs, then the client's message (read raw: _WSConn drops pongs)
            b1, b2 = conv._read_exact(2)
            n = b2 & 0x7F
            if n == 126:
                (n,) = struct.unpack(">H", conv._read_exact(2))
            mask = conv._read_exact(4)
            body = bytes(c ^ mask[i % 4] for i, c in enumerate(conv._read_exact(n)))
            frames.append((b1 & 0x0F, bool(b2 & 0x80), body))
        seen["frames"] = frames
        conn.sendall(_server_frame(8, struct.pack(">H", 1000)))
        seen["close"] = conv._read_exact(2)
        conn.close()

    listener = _Listener(handle)
    try:
        ws = wsclient.create_connection(f"ws://127.0.0.1:{listener.port}/sc2api", timeout=10)
        assert ws.recv() == b"abcd" + b"e" * 300
        ws.send(b"x" * 1000)
        assert ws.recv() == b""
        ws.close()
    finally:
        listener.close()
    assert seen["frames"] == [(10, True, b"p1"), (10, True, b"p2"), (2, True, b"x" * 1000)]
    assert seen["close"][0] & 0x0F == 8


@pytest.mark.parametrize("package", ["jax", "port"])
def test_read_errors_map_onto_the_protocol_errors_as_websocket_client(package):
    """Over each package's client (websocket-client under JAX, ``wsclient``
    in the port): a read past the timeout and a connection dropped without
    a close frame are the protocol's ``ConnectionError``; a close frame is
    an empty response, a ``ProtocolError``; a 404 is a bad status."""
    if package == "jax":
        import websocket as client

        from distar_tpu.envs.sc2 import protocol
    else:
        from distar_tpu_torch.envs.sc2 import protocol

        client = wsclient

    def handle(conn, n):
        if fake_sc2._WSConn(conn).handshake():
            conn.close()  # a drop, no close frame

    dropper = _Listener(handle)
    backend = FakeSC2Server(game=FakeGameCore())
    url = f"ws://127.0.0.1:{backend.port}/sc2api"
    try:
        ws = client.create_connection(url, timeout=10)
        (ws.sock if package == "jax" else ws._sock).settimeout(0.3)  # for the read only
        idle = protocol.StarcraftProtocol(ws)
        with pytest.raises(protocol.ConnectionError, match="Websocket timed out"):
            idle._read()  # nothing was asked, nothing comes
        idle.close()
        dropped = protocol.StarcraftProtocol(
            client.create_connection(f"ws://127.0.0.1:{dropper.port}/sc2api", timeout=5))
        with pytest.raises(protocol.ConnectionError, match="Connection already closed"):
            dropped._read()
        quitting = protocol.StarcraftProtocol(client.create_connection(url, timeout=5))
        quitting.write(sc_pb.Request(quit=sc_pb.RequestQuit()))
        with pytest.raises(protocol.ProtocolError, match="empty response"):
            quitting._read()  # the fake answers quit with a close frame
        with pytest.raises(client.WebSocketBadStatusException) as bad:
            client.create_connection(f"ws://127.0.0.1:{backend.port}/other", timeout=5)
        assert bad.value.status_code == 404
    finally:
        backend.stop()
        dropper.close()


# --------------------------------------------------------- replay header
def _vint(v):
    sign, v = (1, -v) if v < 0 else (0, v)
    first = ((v & 0x3F) << 1) | sign
    v >>= 6
    out = []
    while True:
        out.append(first | (0x80 if v else 0))
        if not v:
            return bytes(out)
        first = v & 0x7F
        v >>= 7


def _versioned(value):
    if isinstance(value, dict):
        return b"\x05" + _vint(len(value)) + b"".join(_vint(k) + _versioned(v) for k, v in value.items())
    if isinstance(value, bytes):
        return b"\x02" + _vint(len(value)) + value
    if isinstance(value, list):
        return b"\x00" + _vint(len(value)) + b"".join(_versioned(v) for v in value)
    if value is None:
        return b"\x04\x00"
    return b"\x09" + _vint(value)


def _mpq(header):
    payload = _versioned(header)
    return b"MPQ\x1b" + struct.pack("<III", 512, 1024, len(payload)) + payload + b"\x00" * 64


HEADERS = {
    "4.10.0": {0: b"StarCraft II replay\x1b11", 1: {0: 1, 1: 4, 2: 10, 3: 0, 4: 75689, 5: 75689},
               2: 2, 3: 13440, 4: [1, 2], 5: None},
    "5.0.3": {0: b"StarCraft II replay\x1b11", 1: {0: 1, 1: 5, 2: 0, 3: 3, 4: 81102, 5: 81009}, 3: 224000},
    "large-vints": {0: b"sig", 1: {1: 4, 2: 12, 3: 1, 4: 80188, 5: 80188}, 3: 2 ** 40 + 7},
}
CORRUPT = {
    "not-mpq": b"not a replay at all" + b"\x00" * 64,
    "bad-size": b"MPQ\x1b" + (8).to_bytes(4, "little") * 3 + b"\xff" * 8,
    "no-version": _mpq({0: b"sig", 3: 5}),
    "version-not-a-struct": _mpq({0: b"sig", 1: 7}),
    "truncated": _mpq(HEADERS["4.10.0"])[:30],
    "unknown-tag": b"MPQ\x1b" + struct.pack("<III", 512, 1024, 4) + b"\x0b\x00\x00\x00",
}


@pytest.mark.parametrize("name", sorted(HEADERS))
def test_parse_replay_header_matches_jax(name, tmp_path):
    data = _mpq(HEADERS[name])
    path = tmp_path / "r.SC2Replay"
    path.write_bytes(data)
    want = jax_header.parse_replay_header(data)
    for source in (data, str(path), open(path, "rb")):
        assert replay_header.parse_replay_header(source) == want
    assert want["base_build"] == HEADERS[name][1][5]


@pytest.mark.parametrize("name", sorted(CORRUPT))
def test_parse_replay_header_refuses_corrupt_input_as_jax(name):
    errors = []
    for parse in (jax_header.parse_replay_header, replay_header.parse_replay_header):
        with pytest.raises(Exception) as e:
            parse(CORRUPT[name])
        errors.append((type(e.value).__name__, str(e.value)))
    assert errors[0] == errors[1]

"""The port's SC2 env (``distar_tpu_torch/envs/sc2_env.py``) and the entry
points that play SC2 games, against the JAX package's, on the CPU.

* Counterparts of tests/test_sc2_env.py on the port's modules: variable
  delays, win extraction, dispatch, the episode cutoff, human mode, the
  replay hook and the LAN handshake.
* Parity: ``SC2Env`` over ``FakeController``s (seeded), with one scripted
  action sequence, the latency-noise draws included: equal observations,
  rewards, ``done``, infos and the raw commands each controller received.
* The entry points on ``--device cpu`` over a fake install
  (``fake_sc2.write_fake_install``, ``SC2PATH``): ``rl_train --type all
  --env sc2`` for one iteration; ``play.py`` ``agent_vs_bot`` (the fake
  binary launched through ``sc_process``), ``agent_vs_agent`` and
  ``human_vs_agent`` (both sides on one fake server through
  ``DISTAR_SC2_PORT``, as two real clients share one game); ``--lan
  host:port`` against a handshake served with ``serve_handshake``; and
  ``--lan-host`` as a process with an agent joining it.
"""
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest

from distar_tpu.envs import sc2_env as jax_sc2_env
from distar_tpu.envs.dummy_obs import build_dummy_game_info as jax_game_info
from distar_tpu.envs.features import ProtoFeatures as JaxProtoFeatures
from distar_tpu_torch.envs.dummy_obs import build_dummy_game_info
from distar_tpu_torch.envs.features import ProtoFeatures
from distar_tpu_torch.envs.sc2 import fake_sc2, sc_process
from distar_tpu_torch.envs.sc2.fake_sc2 import FakeGameCore, FakeSC2Server
from distar_tpu_torch.envs.sc2_env import FakeController, SC2Env
from distar_tpu_torch.lib import actions as ACT
from distar_tpu_torch.lib import features as F
from test_torch_proto_features import assert_same

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GAME_RE = r"games=(\d+) side0_winrate=\d\.\d\d side1_winrate=\d\.\d\d ties=\d+"


def _env(end_at=60, winner=1, **kwargs):
    gi = build_dummy_game_info()
    controllers = [FakeController(player_id=1, end_at=end_at, winner_player=winner),
                   FakeController(player_id=2, end_at=end_at, winner_player=winner)]
    return SC2Env(controllers, [ProtoFeatures(gi), ProtoFeatures(gi)], **kwargs), controllers


def _action(delay, action_type=0):
    return {
        "action_type": np.asarray(action_type),
        "delay": np.asarray(delay),
        "queued": np.asarray(0),
        "selected_units": np.zeros(F.MAX_SELECTED_UNITS_NUM, np.int64),
        "target_unit": np.asarray(0),
        "target_location": np.asarray(0),
    }


# -------------------------------------------------------------- counterparts
def test_reset_returns_feature_obs():
    env, _ = _env()
    obs = env.reset()
    assert set(obs) == {0, 1}
    assert obs[0]["entity_num"] == 8
    assert "value_feature" in obs[0]


def test_variable_delay_scheduling():
    env, _ = _env(end_at=10_000)
    env.reset()
    obs, rewards, done, info = env.step({0: _action(delay=4), 1: _action(delay=10)})
    assert info["game_loop"] == 4
    assert 0 in obs and 1 not in obs
    assert not done
    obs, rewards, done, info = env.step({0: _action(delay=6)})
    assert info["game_loop"] == 10
    assert set(obs) == {0, 1}


def test_action_dispatch_and_results():
    env, controllers = _env(end_at=10_000)
    env.reset()
    attack_pt = ACT.FUNC_ID_TO_ACTION_TYPE[2]
    a = _action(delay=2, action_type=attack_pt)
    a["selected_units"][1] = 8  # end token (entity_num == 8)
    obs, *_ = env.step({0: a, 1: _action(delay=5)})
    assert len(controllers[0].acts_log) == 1
    cmd = controllers[0].acts_log[0][0]
    assert cmd["ability_id"] == ACT.ACTIONS[attack_pt]["general_ability_id"]
    assert cmd["unit_tags"] == [100]
    assert obs[0]["action_result"] == [1]


def test_win_extraction_and_done():
    env, _ = _env(end_at=6, winner=2)
    env.reset()
    obs, rewards, done, info = env.step({0: _action(delay=8), 1: _action(delay=8)})
    assert done
    assert rewards[1] == 1.0 and rewards[0] == -1.0
    assert info["outcome"] == [-1, 1]
    with pytest.raises(AssertionError):
        env.step({0: _action(delay=1)})
    assert set(env.reset()) == {0, 1}


def test_episode_length_cutoff():
    env, _ = _env(end_at=10_000, episode_length=12)
    env.reset()
    _, rewards, done, _ = env.step({0: _action(delay=16), 1: _action(delay=16)})
    assert done
    assert rewards == {0: 0.0, 1: 0.0}


class _CountingController(FakeController):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.observe_calls = 0

    def observe(self, target_game_loop=0):
        self.observe_calls += 1
        return super().observe(target_game_loop=target_game_loop)


def test_human_mode_never_touches_human_controller():
    gi = build_dummy_game_info()
    controllers = [_CountingController(player_id=1, end_at=20, winner_player=2),
                   _CountingController(player_id=2, end_at=20, winner_player=2)]
    env = SC2Env(controllers, [ProtoFeatures(gi), ProtoFeatures(gi)], human_indices=[1])
    obs = env.reset()
    assert set(obs) == {0}
    assert "value_feature" not in obs[0]
    done = False
    while not done:
        obs, rewards, done, info = env.step({0: _action(delay=8)})
    assert controllers[1].observe_calls == 0
    assert controllers[1].acts_log == []
    assert rewards[0] == -1.0 and rewards[1] == 1.0
    assert 1 not in obs


def test_save_replay_hook_fires_on_episode_end():
    saved = []
    env, _ = _env(end_at=6, save_replay_episodes=1, replay_saver=lambda prefix: saved.append(prefix))
    env.reset()
    env.step({0: _action(delay=8), 1: _action(delay=8)})
    assert len(saved) == 1 and "outcome" in saved[0]


def test_lan_env_handshake_and_join():
    """The host creates the game and serves the port config over the
    port's shuttle; the agent fetches it, joins through its own client and
    drives a one-agent SC2Env; both clients share one fake game."""
    from distar_tpu_torch.envs.sc2.lan import LanPorts, LanSC2Env, host_lan_game
    from distar_tpu_torch.envs.sc2.remote_controller import RemoteController

    server = FakeSC2Server(game=FakeGameCore(end_at=400, map_size=(120, 140)))
    try:
        host_controller = RemoteController("127.0.0.1", server.port, timeout_seconds=5)
        controller, handshake_port, proc, join_thread = host_lan_game(
            "KairosJunction", race="zerg", realtime=False, controller=host_controller,
            ports=LanPorts(15000, 15001, 15002, 15003))
        assert proc is None
        env = LanSC2Env("127.0.0.1", handshake_port, agent_race="zerg",
                        controller_factory=lambda: RemoteController("127.0.0.1", server.port, timeout_seconds=5))
        join_thread.join(timeout=10)
        assert not join_thread.is_alive(), "host join never completed"
        obs = env.reset()
        assert 0 in obs and "entity_info" in obs[0] and "spatial_info" in obs[0]
        for _ in range(4):
            out, reward, done, info = env.step({0: _action(delay=2)})
            if done:
                break
        env.close()
    finally:
        server.stop()


# ------------------------------------------------------------------ parity
def _scripted_run(package, seed):
    """One env per package over seeded fake controllers; a fixed action
    script with latency noise; every return and every raw command."""
    if package == "jax":
        controller_cls, env_cls = jax_sc2_env.FakeController, jax_sc2_env.SC2Env
        gi, feats_cls = jax_game_info(map_y=120, map_x=112), JaxProtoFeatures
    else:
        controller_cls, env_cls = FakeController, SC2Env
        gi, feats_cls = build_dummy_game_info(map_y=120, map_x=112), ProtoFeatures
    controllers = [controller_cls(player_id=p, end_at=90, n_units=6, map_y=120, map_x=112, seed=seed + p,
                                  winner_player=2) for p in (1, 2)]
    env = env_cls(controllers, [feats_cls(gi), feats_cls(gi)], random_delay_weights=[0.5, 0.3, 0.2],
                  seed=seed, episode_length=10_000)
    rng = np.random.default_rng(seed)
    returns = [env.reset()]
    done, steps = False, 0
    while not done:
        due = returns[-1][0] if isinstance(returns[-1], tuple) else returns[-1]
        actions = {}
        for idx in due:
            a = _action(delay=int(rng.integers(1, 12)), action_type=int(rng.integers(0, ACT.NUM_ACTIONS)))
            a["selected_units"][: 3] = rng.integers(0, 6, 3)
            a["selected_units"][3] = 6
            a["target_unit"] = np.asarray(rng.integers(0, 6))
            a["target_location"] = np.asarray(rng.integers(0, 120 * 160))
            a["queued"] = np.asarray(rng.integers(0, 2))
            actions[idx] = a
        returns.append(env.step(actions))
        done = returns[-1][2]
        steps += 1
    return returns, [c.acts_log for c in controllers], steps


def test_sc2_env_over_fake_controllers_matches_jax():
    want, want_acts, steps = _scripted_run("jax", 5)
    got, got_acts, _ = _scripted_run("port", 5)
    assert steps > 10 and want[-1][2] and want[-1][1] == {0: -1.0, 1: 1.0}
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_same(g, w)
    assert_same(got_acts, want_acts)


# ------------------------------------------------------------- entry points
@pytest.fixture
def fake_install(tmp_path, monkeypatch):
    root = fake_sc2.write_fake_install(str(tmp_path / "StarCraftII"), REPO)
    monkeypatch.setenv("SC2PATH", root)
    monkeypatch.setattr(sc_process, "FIXED_PORT", None)
    return root


@pytest.fixture
def shared_game(fake_install, monkeypatch):
    """One fake server every client of the run dials (``DISTAR_SC2_PORT``)."""
    server = FakeSC2Server(game=FakeGameCore(end_at=240))
    monkeypatch.setattr(sc_process, "FIXED_PORT", str(server.port))
    yield server
    server.stop()


def _last_game_line(capsys, games=1):
    lines = [l for l in capsys.readouterr().out.splitlines() if re.fullmatch(GAME_RE, l)]
    assert lines and int(re.fullmatch(GAME_RE, lines[-1]).group(1)) == games, lines
    return lines[-1]


def test_rl_train_type_all_plays_sc2_for_an_iteration(shared_game, tmp_path, capsys):
    """``rl_train --type all --env sc2``: the league's self-play job on a
    two-agent SC2 game (the config's env block, the install of SC2PATH),
    one learner iteration on its trajectories."""
    from distar_tpu_torch.bin import rl_train

    rl_train.main(["--type", "all", "--env", "sc2", "--smoke-model", "--device", "cpu", "--iters", "1",
                   "--env-num", "1", "--traj-len", "2", "--batch-size", "2", "--no-health",
                   "--save-path", str(tmp_path / "exp"),
                   "--config", '{"env": {"game_steps_per_episode": 400, "map_name": "KairosJunction"}}'])
    assert "rl_train done: 1 iters" in capsys.readouterr().out
    assert shared_game.game.action_log  # both agents' commands reached the game


def test_play_agent_vs_bot_launches_the_fake_binary(fake_install, tmp_path, capsys):
    """``agent_vs_bot``: the install's binary launched through ``sc_process``,
    the maps installed, one game to the fake's scripted end."""
    from distar_tpu_torch.bin import play

    results = play.main(["--game_type", "agent_vs_bot", "--model2", "bot7", "--no-realtime", "--smoke-model",
                         "--device", "cpu", "--game-count", "1"])
    assert len(results) == 1 and results[0]["0"]["opponent_id"] == "bot7"
    assert results[0]["0"]["winloss"] == 1  # the fake's player 1 wins
    _last_game_line(capsys)
    assert os.path.exists(os.path.join(fake_install, "Maps", "Ladder2019Season2", "KairosJunctionLE.SC2Map"))


@pytest.mark.parametrize("game_type", ["agent_vs_agent", "human_vs_agent"])
def test_play_sc2_game_types_over_a_shared_game(shared_game, game_type, capsys):
    from distar_tpu_torch.bin import play

    results = play.main(["--game_type", game_type, "--no-realtime", "--smoke-model", "--device", "cpu"])
    assert len(results) == 1
    sides = {"agent_vs_agent": {"0", "1"}, "human_vs_agent": {"0"}}[game_type]
    assert sides <= set(results[0]) and "2" not in results[0]
    if game_type == "human_vs_agent":
        assert results[0]["0"]["opponent_id"] == "human"
    _last_game_line(capsys)


def test_play_lan_joins_a_served_handshake(shared_game, capsys):
    """``--lan host:port``: the agent fetches the config a host serves
    (``serve_handshake``), joins the game and plays it out."""
    from distar_tpu_torch.bin import play
    from distar_tpu_torch.envs.sc2.lan import serve_handshake

    port = serve_handshake({"map_name": "KairosJunction", "race": "zerg", "realtime": False,
                            "ports": {"server_game": 1, "server_base": 2, "client_game": 3, "client_base": 4}},
                           timeout_ms=60_000)
    results = play.main(["--lan", f"127.0.0.1:{port}", "--smoke-model", "--device", "cpu"])
    assert len(results) == 1 and results[0]["0"]["opponent_id"] == "remote_human"
    _last_game_line(capsys)


def test_play_lan_host_serves_an_agent_as_a_process(shared_game, fake_install, capsys):
    """``--lan-host`` as a process hosts the game and prints the handshake;
    an agent joins it with ``--lan`` and plays; the host keeps pinging
    until it is stopped."""
    from distar_tpu_torch.bin import play

    env = dict(os.environ, SC2PATH=fake_install, DISTAR_SC2_PORT=str(shared_game.port),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    host = subprocess.Popen([sys.executable, "-m", "distar_tpu_torch.bin.play", "--lan-host"], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        port, deadline = None, time.monotonic() + 60
        while port is None and time.monotonic() < deadline:
            line = host.stdout.readline()
            assert line, "the host exited before printing its endpoint"
            m = re.search(r"--lan (\S+):(\d+) ", line)
            port = m and int(m.group(2))
        assert port, "no handshake endpoint printed"
        results = play.main(["--lan", f"127.0.0.1:{port}", "--smoke-model", "--device", "cpu"])
        assert len(results) == 1
        _last_game_line(capsys)
        rest = []
        while not any("Agent joined" in l for l in rest):
            rest.append(host.stdout.readline())
            assert rest[-1], f"the host exited: {rest}"
        assert host.poll() is None  # still pinging its client
    finally:
        host.terminate()
        host.wait(timeout=30)

"""The port's two-pass replay decoder (``distar_tpu_torch/envs/
replay_decoder.py``), ``bin/gen_z.py`` and ``sl_train --type replay_actor``
against the JAX package's, on the CPU.

* Counterparts of tests/test_replay_decoder.py (the fleet report of
  ``bin/replay_fleet.py`` too, and its ``--pipeline`` run through the
  port's ``ReplayDecoder`` over a fake install), tests/test_gen_z_cli.py
  and tests/test_plugins.py's decoder resolution, on the port's modules.
* Parity: ``ReplayDecoder.run`` and ``decode_z`` on the same fake replays,
  both players, each package over its own stack; the decoder draws the
  last step's delay from the global ``random``, which is seeded before each
  package's run. The trajectories are equal field by field, in value and
  dtype. ``gen_z --replays`` over ``DISTAR_SC2_PORT`` writes the same Z
  library JSON.
* The slice as a whole: the decoded replays go through each package's
  ``ReplayDataset`` and ``SLDataloader`` (equal batches) and then through
  the JAX ``make_sl_train_step`` and the port's ``SLLearner`` step at
  SMALL_MODEL, from the port's seeded weights carried to JAX by
  ``model/convert.py``: loss, info and grad_norm within
  tests/test_torch_train.py's step tolerance (rtol 1e-4).
* ``sl_train --type replay_actor`` over a fake install, feeding a
  ``--remote`` learner.
"""
import json
import os
import pickle
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from conftest import SMALL_MODEL

from distar_tpu.envs import replay_decoder as jax_decoder
from distar_tpu.envs.sc2 import fake_sc2 as jax_fake
from distar_tpu.envs.sc2.remote_controller import RemoteController as JaxRemoteController
from distar_tpu.learner import sl_dataloader as jax_sl_dataloader
from distar_tpu.learner.sl_learner import make_sl_train_step as jax_train_step
from distar_tpu.losses import SupervisedLossConfig as JLossConfig
from distar_tpu.model import Model as JModel
from distar_tpu.model.config import default_model_config as jax_default_config
from distar_tpu.obs.dynamics import tree_spec as jax_tree_spec
from distar_tpu.parallel import GradClipConfig as JClipConfig
from distar_tpu.parallel import build_optimizer as jax_build_optimizer
from distar_tpu.utils import deep_merge_dicts as jax_merge
from distar_tpu_torch.envs.features import extract_z
from distar_tpu_torch.envs.replay_decoder import FilterActions, ReplayDecoder
from distar_tpu_torch.envs.sc2 import fake_sc2, sc_process
from distar_tpu_torch.envs.sc2.fake_sc2 import FakeGameCore, FakeSC2Server
from distar_tpu_torch.envs.sc2.proto import sc_pb
from distar_tpu_torch.envs.sc2.remote_controller import RemoteController
from distar_tpu_torch.learner import SLLearner
from distar_tpu_torch.learner.sl_dataloader import ReplayDataset, SLDataloader
from distar_tpu_torch.lib import actions as ACT
from distar_tpu_torch.lib import features as F
from distar_tpu_torch.model.convert import params_to_flax
from distar_tpu_torch.utils import deep_merge_dicts
from test_replay_decoder import make_replay
from test_torch_proto_features import assert_same

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_OVERLAY = {"encoder": {"entity": {"attention_impl": "pallas"}, "scatter": {"impl": "pallas"}}}
B, T = 2, 4


def gab(name: str) -> int:
    return next(a["general_ability_id"] for a in ACT.ACTIONS if a["name"] == name)


def action_index(name: str) -> int:
    return next(i for i, a in enumerate(ACT.ACTIONS) if a["name"] == name)


@pytest.fixture
def server():
    s = FakeSC2Server(game=FakeGameCore(end_at=100_000))
    yield s
    s.stop()


def _provider(server):
    return lambda version: RemoteController("127.0.0.1", server.port, timeout_seconds=5)


# -------------------------------------------------------------- counterparts
def test_two_pass_decode_end_to_end(server, tmp_path):
    server.game.replay_library["r.SC2Replay"] = make_replay()
    calls = []

    def provider(version):
        calls.append(version)
        return RemoteController("127.0.0.1", server.port, timeout_seconds=5)

    dec = ReplayDecoder(cfg={"minimum_action_length": 2, "parse_race": "Z"}, controller_provider=provider)
    traj = dec.run("r.SC2Replay", player_index=0)
    assert traj is not None and len(traj) >= 8
    assert calls[0] is None and "4.10.0" in calls
    step = traj[0]
    for key in ("spatial_info", "scalar_info", "entity_info", "entity_num", "action_info", "action_mask",
                "selected_units_num"):
        assert key in step, key
    assert "game_info" not in step
    at = int(step["action_info"]["action_type"])
    assert ACT.ACTIONS[at]["name"] in ("Build_Hatchery_pt", "Train_Drone_quick", "Attack_unit")
    assert int(step["action_info"]["delay"]) == 30
    hatch_bo = ACT.BEGINNING_ORDER_ACTIONS.index(action_index("Build_Hatchery_pt"))
    assert step["scalar_info"]["beginning_order"][0] == hatch_bo
    assert step["scalar_info"]["cumulative_stat"][ACT.CUMULATIVE_STAT_ACTIONS.index(
        action_index("Build_Hatchery_pt"))] == 1
    assert int(traj[1]["scalar_info"]["last_action_type"]) == at

    dec2 = ReplayDecoder(cfg={"minimum_action_length": 500, "parse_race": "Z"}, controller_provider=provider)
    assert dec2.run("r.SC2Replay", 0) is None
    dec3 = ReplayDecoder(cfg={"minimum_action_length": 2, "parse_race": "T"}, controller_provider=provider)
    assert dec3.run("r.SC2Replay", 0) is None
    for d in (dec, dec2, dec3):
        d.close()

    root = str(tmp_path / "ds")
    ReplayDataset.save(root, "r_p0", traj)
    batch = next(SLDataloader(ReplayDataset(root), batch_size=2, unroll_len=4))
    assert batch["spatial_info"]["height_map"].shape == (8, *F.SPATIAL_SIZE)
    assert batch["action_info"]["action_type"].shape == (8,)
    assert batch["new_episodes"].all()


def test_sl_dataloader_pads_short_trajectories(tmp_path):
    from distar_tpu_torch.learner.sl_dataloader import make_fake_dataset

    root = str(tmp_path / "short")
    make_fake_dataset(root, n_trajectories=2, steps_per_traj=3)
    batch = next(SLDataloader(ReplayDataset(root), batch_size=1, unroll_len=8))
    assert batch["action_info"]["action_type"].shape == (8,)
    for head, m in batch["action_mask"].items():
        assert m[3:].sum() == 0.0, head
        assert m[:3].sum() > 0.0, head


def test_decode_z_builds_library(server, tmp_path):
    from distar_tpu_torch.lib.z_library import ZLibrary, build_z_library, save_z_library

    server.game.replay_library["r.SC2Replay"] = make_replay()
    dec = ReplayDecoder(cfg={"parse_race": "Z"}, controller_provider=_provider(server))
    episodes = [ep for pi in (0, 1) if (ep := dec.decode_z("r.SC2Replay", pi)) is not None]
    dec.close()
    assert len(episodes) == 2
    winner = next(e for e in episodes if e["winloss"] == 1)
    assert winner["mix_race"] == "zerg" and winner["mmr"] == 4800
    hatch_bo = ACT.BEGINNING_ORDER_ACTIONS.index(action_index("Build_Hatchery_pt"))
    assert winner["beginning_order"][0] == hatch_bo
    path = save_z_library(build_z_library(episodes), str(tmp_path / "z.json"))
    assert ZLibrary(path).sample("KairosJunction", "zerg", winner["born_location"])["beginning_order"][0] == hatch_bo


def _burst_cases():
    train_gab = gab("Train_Queen_quick")

    def act(loop, ability=train_gab, tags=(42,)):
        a = sc_pb.Action()
        a.game_loop = loop
        a.action_raw.unit_command.ability_id = ability
        a.action_raw.unit_command.unit_tags.extend(tags)
        return a

    def obs_with_orders(n_orders, loop):
        ob = sc_pb.ResponseObservation()
        ob.observation.game_loop = loop
        u = ob.observation.raw_data.units.add()
        u.tag = 42
        for _ in range(n_orders):
            u.orders.add(ability_id=train_gab)
        return ob

    def obs_types(types, loop):
        ob = sc_pb.ResponseObservation()
        ob.observation.game_loop = loop
        for tag, ut in types.items():
            u = ob.observation.raw_data.units.add()
            u.tag, u.unit_type = tag, ut
        return ob

    pre, post = obs_with_orders(1, 50), obs_with_orders(3, 150)
    burst = [act(100 + i) for i in range(5)] + [act(300)]
    mburst = [act(700 + i, gab("Train_Drone_quick"), (42, 43)) for i in range(4)] + [act(990)]
    research = [act(500 + i, gab("Research_ZerglingMetabolicBoost_quick")) for i in range(4)] + [act(900)]
    return {
        "train": (pre, pre, post, burst),
        "morph": (obs_types({42: 151, 43: 151}, 650),) * 2 + (obs_types({42: 104, 43: 151}, 750), mburst),
        "research": (pre, pre, post, research),
    }


def test_filter_actions_dedups_train_spam():
    f = FilterActions(flag=True)
    cases = _burst_cases()
    cached, out = f.run(*cases["train"])
    assert len(out) == 2 and cached == [cases["train"][3][-1]] and out[-1].game_loop == 104
    assert len(f.run(*cases["morph"])[1]) == 1
    out2 = f.run(*cases["research"])[1]
    assert len(out2) == 1 and out2[0].game_loop == 500


@pytest.mark.parametrize("case", ["train", "morph", "research"])
def test_filter_actions_match_jax(case):
    args = _burst_cases()[case]
    for flag in (True, False):
        want = jax_decoder.FilterActions(flag=flag).run(*args)
        got = FilterActions(flag=flag).run(*args)
        assert [[a.SerializeToString() for a in part] for part in got] == [
            [a.SerializeToString() for a in part] for part in want]


def test_extract_z_spine_and_zergling_rules():
    sx = F.SPATIAL_SIZE[1]
    spine, zergling, hatch = action_index("Build_SpineCrawler_pt"), 322, action_index("Build_Hatchery_pt")

    def info(at, loc=0):
        return {"action_info": {"action_type": np.asarray(at), "target_location": np.asarray(loc)}}

    stream = [info(hatch, 50)] + [info(zergling)] * 12 + [info(spine, 11 * sx + 11), info(spine, 99 * sx + 99)]
    bo, cum, bo_len, bo_loc = extract_z(stream, 10 * sx + 10, 100 * sx + 100)
    names = [ACT.BEGINNING_ORDER_ACTIONS[i] for i in bo[:bo_len]]
    assert names.count(spine) == 1 and names.count(zergling) == 8 and names[0] == hatch
    assert bo_loc[0] == 50
    assert cum[ACT.CUMULATIVE_STAT_ACTIONS.index(hatch)] == 1


def test_replay_actor_shards_and_feeds_remote_dataloader(server):
    from distar_tpu_torch.comm import Adapter, Coordinator
    from distar_tpu_torch.learner.replay_actor import ReplayActor, RemoteSLDataloader, expand_replay_list

    paths = [f"r{i}.SC2Replay" for i in range(4)]
    shard0 = expand_replay_list(paths, epochs=2, ntasks=2, proc_id=0)
    shard1 = expand_replay_list(paths, epochs=2, ntasks=2, proc_id=1)
    assert len(shard0) == len(shard1) == 4 and sorted(shard0 + shard1) == sorted(paths * 2)
    for p in paths[:2]:
        server.game.replay_library[p] = make_replay()
    co = Coordinator()
    push, pull = Adapter(coordinator=co), Adapter(coordinator=co)
    actor = ReplayActor(
        replays=paths[:2], adapter_factory=lambda: push,
        decoder_factory=lambda: ReplayDecoder(cfg={"minimum_action_length": 2, "parse_race": "Z"},
                                              controller_provider=_provider(server)),
        num_workers=1, ntasks=1, proc_id=0)
    actor.run()
    assert actor.pushed >= 2
    batch = next(RemoteSLDataloader(pull, batch_size=2, unroll_len=4, pull_timeout=30.0))
    assert batch["entity_num"].shape == (2 * 4,)
    assert batch["new_episodes"].tolist() == [True, True]
    assert np.isfinite(batch["entity_num"]).all()


def test_plugins_resolve_the_ports_decoder():
    from distar_tpu_torch import plugins

    assert plugins.load_component("default", "ReplayDecoder") is ReplayDecoder
    assert plugins.load_component("", "ReplayDecoder") is ReplayDecoder
    assert plugins.load_component(None, "ReplayDecoder").__module__ == "distar_tpu_torch.envs.replay_decoder"


def test_decode_throughput_reaches_the_registry_under_the_jax_names(server):
    from distar_tpu_torch.obs import get_registry

    server.game.replay_library["r.SC2Replay"] = make_replay()
    before = get_registry().snapshot()
    dec = ReplayDecoder(cfg={"minimum_action_length": 2, "parse_race": "Z"}, controller_provider=_provider(server))
    traj = dec.run("r.SC2Replay", 1)
    dec.close()
    after = get_registry().snapshot()
    assert after["distar_replay_decoded_total"] == before.get("distar_replay_decoded_total", 0) + 1
    assert after["distar_replay_decoded_steps_total"] == before.get("distar_replay_decoded_steps_total", 0) + len(traj)
    assert after["distar_replay_decode_steps_per_s"] > 0


# -------------------------------------------------------------------- gen_z
def test_gen_z_replays_via_fake_endpoint(server, tmp_path, monkeypatch):
    from distar_tpu_torch.bin.gen_z import main
    from distar_tpu_torch.lib.z_library import ZLibrary

    replays = tmp_path / "replays"
    replays.mkdir()
    (replays / "r.SC2Replay").write_bytes(pickle.dumps(make_replay()))
    out = str(tmp_path / "z.json")
    monkeypatch.setenv("DISTAR_SC2_PORT", str(server.port))
    main(["--replays", str(replays), "--output", out, "--min-mmr", "0"])
    target = ZLibrary(out).sample_any("KairosJunction", mix_race="zerg")
    assert target is not None and len(target["beginning_order"]) > 0


def test_gen_z_input_jsonl(tmp_path):
    from distar_tpu_torch.bin.gen_z import main
    from distar_tpu_torch.lib.z_library import ZLibrary

    episodes = [
        {"map_name": "KairosJunction", "mix_race": "zerg", "born_location": 1, "beginning_order": [3, 5],
         "bo_location": [100, 200], "cumulative_stat": [0, 2], "winloss": 1, "mmr": 5000},
        {"map_name": "KairosJunction", "mix_race": "zerg", "born_location": 2, "beginning_order": [4],
         "bo_location": [150], "cumulative_stat": [1], "winloss": -1, "mmr": 4900},
    ]
    src = tmp_path / "eps.jsonl"
    src.write_text("\n".join(json.dumps(e) for e in episodes) + "\n")
    out = str(tmp_path / "z.json")
    main(["--input", str(src), "--output", out])
    assert ZLibrary(out).sample("KairosJunction", "zerg", 1)["beginning_order"][0] == 3


def test_gen_z_demo(tmp_path):
    from distar_tpu_torch.bin.gen_z import main
    from distar_tpu_torch.lib.z_library import ZLibrary

    out = str(tmp_path / "demo_z.json")
    main(["--demo", "--output", out])
    assert json.loads(open(out).read())
    ZLibrary(out)


@pytest.mark.parametrize("source", ["replays", "demo"])
def test_gen_z_writes_the_jax_z_library(source, tmp_path, monkeypatch):
    """Both packages' ``gen_z`` on the same replays (each over its own fake
    server through ``DISTAR_SC2_PORT``) or the same demo seed: the same
    JSON, byte for byte."""
    from distar_tpu.bin.gen_z import main as jax_main
    from distar_tpu_torch.bin.gen_z import main as port_main

    replays = tmp_path / "replays"
    replays.mkdir()
    second = make_replay(n_actions=30, loops_between=20)
    second["players"][0]["result"], second["players"][1]["result"] = 2, 1  # the other side wins
    for i, rep in enumerate((make_replay(), second)):
        (replays / f"r{i}.SC2Replay").write_bytes(pickle.dumps(rep))
    outs = []
    for main, server_cls, core_cls in ((jax_main, jax_fake.FakeSC2Server, jax_fake.FakeGameCore),
                                       (port_main, FakeSC2Server, FakeGameCore)):
        s = server_cls(game=core_cls(end_at=100_000))
        try:
            monkeypatch.setenv("DISTAR_SC2_PORT", str(s.port))
            out = str(tmp_path / f"z_{len(outs)}.json")
            main(["--replays", str(replays), "--output", out] if source == "replays" else ["--demo", "--output", out])
        finally:
            s.stop()
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1] and json.loads(outs[0])


# ------------------------------------------------------------------ parity
def _decode_both_players(package, names, library, seed, z_only=False):
    if package == "jax":
        server = jax_fake.FakeSC2Server(game=jax_fake.FakeGameCore(end_at=100_000))
        dec_cls, rc_cls = jax_decoder.ReplayDecoder, JaxRemoteController
    else:
        server = FakeSC2Server(game=FakeGameCore(end_at=100_000))
        dec_cls, rc_cls = ReplayDecoder, RemoteController
    server.game.replay_library.update(library)
    dec = dec_cls(cfg={"minimum_action_length": 2, "parse_race": "Z"},
                  controller_provider=lambda v: rc_cls("127.0.0.1", server.port, timeout_seconds=5))
    out = []
    try:
        for i, name in enumerate(names):
            for player in (0, 1):
                random.seed(seed + 2 * i + player)
                out.append(dec.decode_z(name, player) if z_only else dec.run(name, player))
    finally:
        dec.close()
        server.stop()
    return out


def _library():
    spam = make_replay(n_actions=18, loops_between=3)  # bursts inside the filter's 4-loop window
    spam["actions"] += [(spam["game_duration_loops"] - 40, gab("Train_Queen_quick"), [10000 + k % 8], None)
                        for k in range(3)]
    spam["actions"].sort(key=lambda a: a[0])
    return {"a.SC2Replay": make_replay(), "b.SC2Replay": make_replay(n_actions=20, loops_between=25),
            "c.SC2Replay": spam}


@pytest.fixture(scope="module")
def decoded():
    names = sorted(_library())
    return {pkg: _decode_both_players(pkg, names, _library(), seed=23) for pkg in ("jax", "port")}


def test_decoded_trajectories_match_jax(decoded):
    want, got = decoded["jax"], decoded["port"]
    assert len(want) == 6 and all(t for t in want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        assert_same(g, w)


def test_decode_z_matches_jax():
    names = sorted(_library())
    want = _decode_both_players("jax", names, _library(), 5, z_only=True)
    got = _decode_both_players("port", names, _library(), 5, z_only=True)
    assert all(w is not None for w in want)
    assert_same(got, want)


# ------------------------------------------------------ the slice as a whole
def _strip(batch):
    return {k: v for k, v in batch.items() if k not in ("new_episodes", "traj_lens")}


def test_decoded_replays_train_one_sl_step_as_jax(decoded, tmp_path):
    """Each package's decoded trajectories through its own ReplayDataset and
    SLDataloader (seed 3): equal batches. One JAX step
    (``make_sl_train_step``, the SL learner's adamw and clip) and one port
    ``SLLearner`` step from the same weights on them: loss, info and
    grad_norm within rtol 1e-4."""
    batches = {}
    for pkg, dataset_cls, loader_cls in (("jax", jax_sl_dataloader.ReplayDataset, jax_sl_dataloader.SLDataloader),
                                         ("port", ReplayDataset, SLDataloader)):
        root = str(tmp_path / pkg)
        for i, traj in enumerate(decoded[pkg]):
            dataset_cls.save(root, f"t{i}", traj)
        batches[pkg] = next(iter(loader_cls(dataset_cls(root), B, T, seed=3)))
    assert_same(batches["port"], batches["jax"])
    batch = batches["port"]
    assert batch["entity_num"].shape == (B * T,) and int(batch["entity_num"].max()) > 8

    learner = SLLearner({"learner": {"batch_size": B, "unroll_len": T},
                         "model": deep_merge_dicts(SMALL_MODEL, KERNEL_OVERLAY)}, device="cpu")
    params = jax.tree.map(jnp.asarray, params_to_flax(learner.model))
    cfg = jax_merge(jax_default_config(), SMALL_MODEL)
    opt = jax_build_optimizer(1e-3, (0.9, 0.999), 1e-8, 1e-5, JClipConfig("norm", 1.0))
    step = jax_train_step(JModel(cfg), JLossConfig(), opt, B,
                          dynamics=jax_tree_spec({}, {"type": "norm", "threshold": 1.0}))
    H = cfg.encoder.core_lstm.hidden_size
    hidden = tuple((jnp.zeros((B, H)), jnp.zeros((B, H))) for _ in range(cfg.encoder.core_lstm.num_layers))
    _, _, _, info = jax.jit(step)(params, opt.init(params), jax.tree.map(jnp.asarray, _strip(batches["jax"])),
                                  hidden)
    want = jax.tree.map(float, info)
    got = learner._train(batch)
    assert set(got) == set(want)
    assert np.isfinite(want["total_loss"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)


# ----------------------------------------------------------- the entry point
def test_sl_train_replay_actor_feeds_a_remote_learner(tmp_path, monkeypatch, capsys):
    """``sl_train --type replay_actor`` decodes a directory of replays with
    the default decoder, which launches the fake install's binary through
    ``run_configs`` (SC2PATH), and pushes both players' trajectories to the
    coordinator; ``sl_train --remote`` trains 2 steps on them."""
    from distar_tpu_torch.bin import sl_train
    from distar_tpu_torch.comm import Adapter, CoordinatorServer

    monkeypatch.setenv("SC2PATH", fake_sc2.write_fake_install(str(tmp_path / "SC2"), REPO))
    monkeypatch.setattr(sc_process, "FIXED_PORT", None)
    monkeypatch.setenv("DISTAR_EXPERIMENTS_ROOT", str(tmp_path / "exp"))
    replays = tmp_path / "replays"
    replays.mkdir()
    (replays / "r0.SC2Replay").write_bytes(pickle.dumps(make_replay(n_actions=132, loops_between=8)))
    co = CoordinatorServer()
    co.start()
    try:
        addr = f"{co.host}:{co.port}"
        actor = sl_train.replay_actor(sl_train.parser().parse_args(
            ["--type", "replay_actor", "--replays", str(replays), "--coordinator-addr", addr, "--no-health",
             "--no-supervise"]))
        assert (actor.pushed, actor.failed) == (2, 0)
        out = capsys.readouterr().out
        assert "replay_actor done: pushed=2 empty=0 failed=0" in out
        lrn = sl_train.main(["--remote", "--coordinator-addr", addr, "--device", "cpu", "--iters", "2",
                             "--batch-size", "2", "--traj-len", "4", "--no-supervise", "--no-health"])
        assert "sl_train done: 2 iters" in capsys.readouterr().out
        assert np.isfinite(lrn.last_log["total_loss"])
        # the prefetcher reads ahead and waits inside a pull: feed it and see it end
        from distar_tpu_torch.learner.sl_dataloader import make_fake_dataset

        lrn._dataloader.close()
        spare = make_fake_dataset(str(tmp_path / "spare"), n_trajectories=2, steps_per_traj=8)
        feeder = Adapter(coordinator_addr=(co.host, co.port))
        for i in range(2):
            feeder.push("sltraj", spare.load(i))
        lrn._dataloader._thread.join(timeout=60)
        assert not lrn._dataloader._thread.is_alive()
    finally:
        co.stop()


def test_replay_fleet_report(tmp_path):
    """The fleet ops CLI: sharded decode over ReplayActor with a frames/s
    and RSS-slope report; failures counted, not fatal."""
    from distar_tpu_torch.bin.replay_fleet import _FakeDecoder, process_tree_rss_mb, run_fleet

    for i in range(5):
        (tmp_path / f"r{i}.SC2Replay").touch()
    (tmp_path / "corrupt.SC2Replay").touch()
    report = run_fleet(
        str(tmp_path), workers=3,
        decoder_factory=lambda: _FakeDecoder(steps_per_replay=16),
        rss_interval_s=0.2,
    )
    assert report["replays"] == 6
    assert report["trajectories"] == 10  # 5 good replays x 2 players
    assert report["failed_decodes"] == 2
    assert report["frames"] == 160
    assert report["value"] > 0
    assert report["rss"]["peak_mb"] >= report["rss"]["start_mb"] * 0.5
    assert report["decoder"].startswith("fake")
    assert process_tree_rss_mb() > 10  # this test process alone
    # SLURM-style sharding: two tasks split the list without overlap
    r0 = run_fleet(str(tmp_path), workers=1, ntasks=2, proc_id=0,
                   decoder_factory=lambda: _FakeDecoder(4), rss_interval_s=1.0)
    r1 = run_fleet(str(tmp_path), workers=1, ntasks=2, proc_id=1,
                   decoder_factory=lambda: _FakeDecoder(4), rss_interval_s=1.0)
    assert r0["replays"] + r1["replays"] == 6


def test_replay_fleet_cli_decodes_through_the_fake_install(tmp_path):
    """``python -m distar_tpu_torch.bin.replay_fleet --pipeline default``:
    the port's ``ReplayDecoder`` (via ``plugins``) launches the fake
    install's binary and decodes both players of each replay; the report
    line carries the JAX report's keys."""
    import subprocess
    import sys

    install = fake_sc2.write_fake_install(str(tmp_path / "SC2"), REPO)
    replays = tmp_path / "replays"
    replays.mkdir()
    for i in range(2):
        (replays / f"r{i}.SC2Replay").write_bytes(pickle.dumps(make_replay(n_actions=132, loops_between=8)))
    out = subprocess.run(
        [sys.executable, "-m", "distar_tpu_torch.bin.replay_fleet", "--replays", str(replays),
         "--workers", "1", "--rss-interval", "0.5", "--pipeline", "default"],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, PYTHONPATH=REPO, SC2PATH=install, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(report) == {"metric", "value", "unit", "replays", "workers", "trajectories",
                           "failed_decodes", "empty_decodes", "frames", "wall_s", "rss", "decoder"}
    assert report["decoder"] == "sc2" and report["replays"] == 2
    assert (report["trajectories"], report["failed_decodes"]) == (4, 0)
    assert report["frames"] > 0 and report["value"] > 0

"""The port's league-RL loop on the CPU at SMALL_MODEL: ``Adapter`` pushes
read across packages on one coordinator, ``collate_trajectories``
bit-equal on JAX-made trajectories (and the RL step's batch layout),
weight publication across packages (``attach_comm``), the whole loop in
one process and with the league and coordinator over HTTP, the launcher
``bin/rl_train.py`` as a process, its replay flags' wiring (the replay
layouts and roles are tests/test_torch_replay_fleet.py's), and its
unported flags.

Published weights loaded into the other package's inference agree within
atol 2e-4 / rtol 1e-3 (tests/test_golden_parity.py:132)."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from conftest import SMALL_MODEL

from distar_tpu.actor.agent import Agent as JaxAgent
from distar_tpu.actor.agent import sample_fake_z as jax_sample_fake_z
from distar_tpu.actor.inference import BatchedInference as JaxBatchedInference
from distar_tpu.comm import Adapter as JaxAdapter
from distar_tpu.comm import CoordinatorServer as JaxCoordinatorServer
from distar_tpu.envs import MockEnv as JaxMockEnv
from distar_tpu.learner.hooks import HookRegistry as JaxHookRegistry
from distar_tpu.learner.rl_dataloader import collate_trajectories as jax_collate
from distar_tpu.learner.rl_learner import RLLearner as JaxRLLearner
from distar_tpu.lib import features as JF
from distar_tpu.model import Model as JModel
from distar_tpu.model.config import default_model_config as jax_default_config
from distar_tpu.utils import Config as JaxConfig
from distar_tpu.utils import deep_merge_dicts as jax_merge
from distar_tpu.utils.checkpoint import CountVar as JaxCountVar
from distar_tpu_torch.actor import Actor, BatchedInference
from distar_tpu_torch.bin import rl_train
from distar_tpu_torch.comm import Adapter, Coordinator, CoordinatorServer
from distar_tpu_torch.envs import MockEnv
from distar_tpu_torch.league import League, LeagueAPIServer, RemoteLeague
from distar_tpu_torch.learner import RLLearner, random_rl_batch
from distar_tpu_torch.learner.data import as_float32
from distar_tpu_torch.learner.rl_dataloader import CollationError, RLDataLoader, collate_trajectories
from distar_tpu_torch.lib import features as F
from distar_tpu_torch.model import Model, default_model_config, init_params
from distar_tpu_torch.model.convert import params_from_flax, params_to_flax, policy_params_from_flax
from distar_tpu_torch.utils import deep_merge_dicts
from test_torch_actor import assert_tree_equal, leaves
from test_torch_serve import jax_noise

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=2e-4, rtol=1e-3)
TRAJ_LEN = 2
N_ENV = 2

# tests/test_pipeline.py's league: PFSP only, MP0 against HP0 (sp and eval
# explicit zeros: the league's deep merge keeps default branch weights for
# keys an override leaves out)
LEAGUE_CFG = {
    "league": {
        "branch_probs": {"MainPlayer": {"sp": 0.0, "pfsp": 1.0, "eval": 0.0}},
        "active_players": {
            "player_id": ["MP0"], "checkpoint_path": ["mp0.ckpt"], "pipeline": ["default"],
            "frac_id": [1], "z_path": ["3map.json"], "z_prob": [0.0], "teacher_id": ["T"],
            "teacher_path": ["t.ckpt"], "one_phase_step": [10 ** 9], "chosen_weight": [1.0],
        },
        "historical_players": {
            "player_id": ["HP0"], "checkpoint_path": ["hp0.ckpt"], "pipeline": ["default"],
            "frac_id": [1], "z_path": ["3map.json"], "z_prob": [0.0],
        },
    }
}


def model_cfg(value: bool):
    cfg = deep_merge_dicts(default_model_config(), SMALL_MODEL)
    cfg.use_value_network = value
    return cfg


# ----------------------------------------------------------------- adapter
@pytest.mark.parametrize("server", ["port", "jax"])
def test_adapter_pushes_read_across_packages(server):
    """On one coordinator (either package's server), each package's
    adapter pulls what the other pushed, trace envelope and all."""
    co = (CoordinatorServer if server == "port" else JaxCoordinatorServer)()
    co.start()
    try:
        addr = (co.host, co.port)
        port_ad, jax_ad = Adapter(coordinator_addr=addr), JaxAdapter(coordinator_addr=addr)
        rng = np.random.default_rng(0)
        payload = {"x": rng.standard_normal((3, 4)).astype(np.float32), "n": 7, "s": ["a", 1.5]}
        port_ad.push("p2j", payload)
        got = jax_ad.pull("p2j", timeout=30)
        assert_tree_equal(got, payload)
        jax_ad.push("j2p", payload)
        assert_tree_equal(port_ad.pull("j2p", timeout=30), payload)
        assert port_ad.pull("j2p", block=False) is None
    finally:
        co.stop()


# --------------------------------------------------------------- collation
@pytest.fixture(scope="module")
def jax_trajectories():
    """Four JAX-made trajectories of TRAJ_LEN steps with value features
    (the JAX agent on the JAX mock env, fake model outputs)."""
    env = JaxMockEnv(episode_game_loops=50, seed=0, include_value_feature=True)
    obs = env.reset()
    ag = JaxAgent("MP0", z=jax_sample_fake_z(), traj_len=TRAJ_LEN)
    rng = np.random.default_rng(0)
    hidden = ((np.ones(32, np.float32), np.zeros(32, np.float32)),)
    trajs = []
    while len(trajs) < 4:
        out = {"action_info": JF.fake_action_info(), "action_logp": JF.fake_action_logp(),
               "selected_units_num": np.asarray(int(rng.integers(1, 5)))}
        out["action_info"]["action_type"] = np.asarray(int(rng.integers(0, 327)))
        ag.pre_process(obs[0])
        ag.post_process(out)
        next_obs, rewards, done, _ = env.step({0: out["action_info"], 1: out["action_info"]})
        traj = ag.collect_data(next_obs[0], rewards[0], done, JF.fake_action_logits(), hidden)
        if traj is not None:
            trajs.append(traj)
        obs = env.reset() if done else next_obs
    return trajs


def test_collate_trajectories_bit_equal_to_jax(jax_trajectories):
    assert_tree_equal(collate_trajectories(jax_trajectories), jax_collate(jax_trajectories))


def test_collated_batch_has_the_rl_step_layout(jax_trajectories):
    """After the learner's float32 placement, an actor-made batch has every
    key of ``random_rl_batch`` (what the RL step is held on) in its shape
    and dtype kind; the only extra is the behaviour Z's cumulative stat
    that the agent merges into the critic's features, which the value
    encoder does not read."""
    got = leaves(as_float32(collate_trajectories(jax_trajectories)))
    want = leaves(random_rl_batch(4, TRAJ_LEN, np.random.default_rng(0), hidden_size=32,
                                  hidden_layers=1, use_value_feature=True))
    assert set(want) <= set(got), sorted(set(want) - set(got))
    assert set(got) - set(want) == {"/value_feature/cumulative_stat"}
    for k, w in want.items():
        g = np.asarray(got[k])
        assert g.shape == w.shape, k
        assert g.dtype.kind == np.asarray(w).dtype.kind, k
        assert g.dtype != np.float64, k


@pytest.mark.parametrize("case", ["ragged", "empty", "no_steps"])
def test_collate_refuses_ragged_input(jax_trajectories, case):
    trajs = {"ragged": [jax_trajectories[0], jax_trajectories[1][:-1]], "empty": [],
             "no_steps": [jax_trajectories[0][-1:]]}[case]
    with pytest.raises(CollationError):
        collate_trajectories(trajs)


# ----------------------------------------------------------- publication
@pytest.fixture(scope="module")
def publications():
    """One publication from each package's learner, read by both packages'
    adapters: the port ``RLLearner``'s ``attach_comm`` and the JAX learner's
    (its publication hook over a learner state built without its mesh)."""
    co = Coordinator()
    port_ad, jax_ad = Adapter(coordinator=co), JaxAdapter(coordinator=co)
    learner = RLLearner({"learner": {"batch_size": 2, "unroll_len": TRAJ_LEN}, "model": SMALL_MODEL},
                        device="cpu")
    init_params(learner.model, 5)
    learner.attach_comm(port_ad, "MP0", send_model_freq=1)
    for _ in range(2):  # a pull pops its record: one publication for each reader
        learner.hooks.call("before_run", learner)
    from_port = (port_ad.pull("MP0model", timeout=30), jax_ad.pull("MP0model", timeout=30))

    jl = object.__new__(JaxRLLearner)
    jl.cfg = JaxConfig({"learner": {"batch_size": 2, "unroll_len": TRAJ_LEN}})
    jl.hooks = JaxHookRegistry()
    jl.last_iter = JaxCountVar(3)
    value_model = Model(model_cfg(True))
    init_params(value_model, 6)
    jl._state = {"params": params_to_flax(value_model)}
    jl.attach_comm(jax_ad, "MP1", send_model_freq=1)
    for _ in range(2):
        jl.hooks.call("before_run", jl)
    from_jax = (port_ad.pull("MP1model", timeout=30), jax_ad.pull("MP1model", timeout=30))
    return dict(learner=learner, from_port=from_port, from_jax=from_jax, jax_state=value_model.state_dict())


def test_params_to_flax_comes_off_in_one_copy(monkeypatch):
    """A learner's whole tree (value towers too) comes to the host in one
    transfer, loads back bit for bit, and shares no storage with the
    model."""
    model = Model(model_cfg(True))
    init_params(model, 5)
    copies, real_cpu = [], torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda t, *a, **k: copies.append(t.shape) or real_cpu(t, *a, **k))
    tree = params_to_flax(model)
    monkeypatch.undo()
    assert len(copies) == 1
    state = model.state_dict()
    back = params_from_flax(tree, model)
    assert all(torch.equal(back[k], v) for k, v in state.items())
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    assert all(torch.equal(params_from_flax(tree, model)[k], v) for k, v in back.items())


def test_policy_load_is_exact():
    """Every policy key must be there; only value towers may be left
    over."""
    tree = params_to_flax(Model(model_cfg(True)))["params"]
    shape_model = Model(model_cfg(False))
    policy_params_from_flax(tree, shape_model)  # value towers dropped
    bad = dict(tree, extra={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="unused"):
        policy_params_from_flax(bad, shape_model)
    missing = {k: v for k, v in tree.items() if k != "core_lstm"}
    with pytest.raises(ValueError, match="missing"):
        policy_params_from_flax(missing, shape_model)


def _actor_state(pub):
    actor = Actor(model_cfg=SMALL_MODEL, device="cpu")
    return actor._params_from_publication(pub)


@pytest.mark.parametrize("which", ["from_port", "from_jax"])
def test_publication_loads_into_either_package(publications, which):
    """A publication, read by the port actor and by the JAX inference, gives
    the same sampled actions and log-probabilities over three cycles
    under the same Gumbel draws; the port actor's policy weights are the
    learner's bit for bit."""
    port_pub, jax_pub = publications[which]
    assert port_pub["iter"] == jax_pub["iter"] == (0 if which == "from_port" else 3)
    assert port_pub["reset_flag"] is False
    state = _actor_state(port_pub)
    learner_state = (publications["learner"].model.state_dict() if which == "from_port"
                     else publications["jax_state"])
    for k, v in state.items():
        assert torch.equal(v, learner_state[k]), k

    jcfg = jax_merge(jax_default_config(), SMALL_MODEL)
    jcfg.use_value_network = False
    jinf = JaxBatchedInference(JModel(jcfg), jax_pub["params"], 2, seed=4)
    model = Model(model_cfg(False))
    model.load_state_dict(state)
    tinf = BatchedInference(model, 2, device="cpu")
    rng, key = np.random.default_rng(1), jax.random.PRNGKey(4)
    for _ in range(3):
        prepared = [F.random_step_data(rng) for _ in range(2)]
        key, sub = jax.random.split(key)
        want = jinf.sample(prepared)
        got = tinf.sample(prepared, noise=jax_noise(sub, model.cfg, 2))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["action_info"]["action_type"], w["action_info"]["action_type"])
            for h in F.ACTION_HEADS:
                np.testing.assert_allclose(g["action_logp"][h], np.asarray(w["action_logp"][h]), **TOL)


# -------------------------------------------------------------- the loop
def test_full_rl_loop(tmp_path):
    """Actor rollout -> data plane -> RLDataLoader -> learner -> weight
    publication and league train-info, in one process
    (tests/test_pipeline.py's loop)."""
    league = League(LEAGUE_CFG)
    co = Coordinator()
    actor_adapter, learner_adapter = Adapter(coordinator=co), Adapter(coordinator=co)
    actor = Actor(cfg={"actor": {"env_num": N_ENV, "traj_len": TRAJ_LEN, "seed": 3}}, league=league,
                  adapter=actor_adapter, model_cfg=SMALL_MODEL, device="cpu",
                  env_fn=lambda: MockEnv(episode_game_loops=300, seed=1))
    dataloader = RLDataLoader(learner_adapter, "MP0", batch_size=4)
    results = actor.run_job(episodes=2)
    assert len(results) >= 2
    assert league.all_players["MP0"].total_game_count >= 1
    assert league.elo.game_count >= 1

    batch = next(iter(dataloader))
    assert batch["action_info"]["action_type"].shape == (TRAJ_LEN, 4)
    assert batch["spatial_info"]["height_map"].shape[0] == TRAJ_LEN + 1
    assert batch["mask"]["selected_units_mask"].shape == (TRAJ_LEN, 4, 64)
    assert np.isfinite(batch["behaviour_logp"]["action_type"]).all()

    learner = RLLearner({"common": {"experiment_name": "e2e", "save_path": str(tmp_path)},
                         "learner": {"batch_size": 4, "unroll_len": TRAJ_LEN, "save_freq": 10 ** 9,
                                     "log_freq": 1},
                         "model": SMALL_MODEL}, device="cpu")
    learner.attach_comm(learner_adapter, "MP0", league=league, send_model_freq=1, send_train_info_freq=1)
    learner.set_dataloader(iter(lambda: batch, None))
    learner.run(max_iterations=2)
    assert learner.last_iter.val == 2
    assert np.isfinite(learner.variable_record.get("total_loss").avg)
    assert league.active_players["MP0"].total_agent_step > 0
    latest = -1
    while True:
        pub = actor_adapter.pull("MP0model", block=False)
        if pub is None:
            break
        assert "params" in pub
        latest = max(latest, pub["iter"])
    assert latest >= 1


def test_remote_roles_over_http():
    """League and coordinator as HTTP servers; the actor and the learner's
    adapter reach them by address (tests/test_pipeline.py's remote roles)."""
    league_server = LeagueAPIServer(League(LEAGUE_CFG))
    league_server.start()
    co_server = CoordinatorServer()
    co_server.start()
    try:
        remote = RemoteLeague(league_server.host, league_server.port)
        assert remote.register_learner("MP0", rank=0, world_size=1)["checkpoint_path"] == "mp0.ckpt"
        actor = Actor(cfg={"actor": {"env_num": 1, "traj_len": TRAJ_LEN, "seed": 9}}, league=remote,
                      adapter=Adapter(coordinator_addr=(co_server.host, co_server.port)),
                      model_cfg=SMALL_MODEL, device="cpu",
                      env_fn=lambda: MockEnv(episode_game_loops=120, seed=4))
        actor.run_job(episodes=1)
        learner_adapter = Adapter(coordinator_addr=(co_server.host, co_server.port))
        traj = learner_adapter.pull("MP0traj", timeout=30)
        assert len(traj) == TRAJ_LEN + 1
        assert isinstance(remote.learner_send_train_info("MP0", train_steps=10), dict)
    finally:
        league_server.stop()
        co_server.stop()


@pytest.mark.parametrize("server", ["coordinator", "league"])
def test_servers_report_a_caller_hanging_up_as_the_jax_servers_do(server, capsys):
    """A worker stopped in the middle of a request (the roles' SIGTERM)
    is reported by the coordinator and the league as by the JAX package's
    servers (the stdlib's traceback), as is any other handler error."""
    from distar_tpu.league import League as JaxLeague
    from distar_tpu.league import LeagueAPIServer as JaxLeagueAPIServer

    if server == "coordinator":
        servers = (CoordinatorServer(), JaxCoordinatorServer())
    else:
        servers = (LeagueAPIServer(League(LEAGUE_CFG)), JaxLeagueAPIServer(JaxLeague(LEAGUE_CFG)))
    try:
        for err in (BrokenPipeError(), ConnectionResetError(), ValueError("a handler fault")):
            said = []
            for srv in servers:
                try:
                    raise err
                except type(err):
                    srv._server.handle_error(None, ("127.0.0.1", 1))
                said.append(capsys.readouterr().err)
            assert type(err).__name__ in said[0] and "Traceback" in said[0], err
            assert said[0].splitlines()[:2] == said[1].splitlines()[:2], said
    finally:
        for srv in servers:
            srv._server.server_close()


def test_rl_train_all_as_a_process(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, DISTAR_EXPERIMENTS_ROOT=str(tmp_path),
               OMP_NUM_THREADS="1")  # one core each beside the other workers
    out = subprocess.run(
        [sys.executable, "-m", "distar_tpu_torch.bin.rl_train", "--type", "all", "--smoke-model",
         "--device", "cpu", "--iters", "2", "--env-num", "1", "--traj-len", "2", "--batch-size", "2",
         "--episode-game-loops", "60"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "rl_train done: 2 iters" in out.stdout


def test_rl_train_roles_as_processes(tmp_path):
    """Coordinator, league, learner and actor as four processes on the CPU:
    the learner trains on the actor's trajectories and exits 0 with its
    done line; SIGTERM ends the actor, the coordinator and the league with
    exit 0, the actor with no traceback. Fleet health is on, as the JAX
    defaults give it: the learner and the actor ship to the coordinator
    (every second here), whose ``/healthz`` lists both sources and whose
    ``/timeseries`` holds the learner's iterations up to its last; on
    SIGTERM the actor and the coordinator write a flight bundle under their
    ``flight/`` directory, and the league, which runs no fleet health, does
    not."""
    import json
    import signal
    import time
    import urllib.error
    import urllib.request

    env = dict(os.environ, PYTHONPATH=REPO, DISTAR_EXPERIMENTS_ROOT=str(tmp_path),
               OMP_NUM_THREADS="1")  # one core each beside the other workers
    cfg = __import__("json").dumps({"league": LEAGUE_CFG["league"]})
    procs = {}

    def start(role, *flags):
        log = open(tmp_path / f"{role}.log", "w")
        procs[role] = subprocess.Popen(
            [sys.executable, "-m", "distar_tpu_torch.bin.rl_train", "--type", role, "--device", "cpu",
             *flags], cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)

    def serving(role):
        deadline = time.time() + 120
        while time.time() < deadline:
            for ln in (tmp_path / f"{role}.log").read_text().splitlines():
                if ln.startswith(f"{role} serving on "):
                    return ln.rsplit(" ", 1)[1]
            time.sleep(0.1)
        raise AssertionError((tmp_path / f"{role}.log").read_text())

    try:
        start("coordinator", "--port", "0")
        start("league", "--port", "0", "--config", cfg)
        co, lg = serving("coordinator"), serving("league")
        sizes = ("--env-num", "1", "--traj-len", "2", "--batch-size", "2", "--episode-game-loops", "60")
        ship = ("--telemetry-interval-s", "1")
        start("learner", "--coordinator-addr", co, "--league-addr", lg, "--iters", "2",
              "--save-path", str(tmp_path / "learner"), *ship, *sizes)
        start("actor", "--coordinator-addr", co, "--league-addr", lg, "--save-path", str(tmp_path / "actor"),
              *ship, *sizes)
        assert procs["learner"].wait(timeout=240) == 0, (tmp_path / "learner.log").read_text()[-3000:]
        assert "learner done: 2 iters" in (tmp_path / "learner.log").read_text()

        def get(path):
            try:
                with urllib.request.urlopen(f"http://{co}{path}", timeout=10) as r:
                    return json.loads(r.read())
            except urllib.error.HTTPError as e:
                # 503 while a rule fires: the learner's distar_perf_mfu reads 0
                # (no flop count here), under learner_mfu_collapse's 2%, as the
                # JAX learner's does
                body = json.loads(e.read())
                assert e.code == 503 and set(body["firing"]) <= {"learner_mfu_collapse"}, body
                return body

        deadline = time.time() + 30
        while time.time() < deadline:
            sources = get("/healthz")["sources"]
            if "learner:MP0:0" in sources and any(s.startswith("actor:") for s in sources):
                break
            time.sleep(0.2)
        assert "learner:MP0:0" in sources and any(s.startswith("actor:") for s in sources), sources
        iters = get("/timeseries?name=distar_learner_iterations_total")
        # the learner's normal return ships its last counters
        assert iters["points"]["learner:MP0:0"][-1][1] == 2 and iters["stats"]["learner:MP0:0"]["count"] >= 1, iters
        for role in ("actor", "coordinator", "league"):
            assert procs[role].poll() is None, (tmp_path / f"{role}.log").read_text()[-3000:]
            procs[role].send_signal(signal.SIGTERM)
            assert procs[role].wait(timeout=60) == 0, (tmp_path / f"{role}.log").read_text()[-3000:]
        # the coordinator and the league may report the actor hanging up, as the JAX servers do
        assert "Traceback" not in (tmp_path / "actor.log").read_text()
        bundles = {role: sorted(tmp_path.glob(f"{where}/flight/flight_*.json"))
                   for role, where in (("actor", "actor"), ("coordinator", "rl_train"), ("league", "rl_train"))}
        assert len(bundles["actor"]) == 1 and len(bundles["coordinator"]) == 1, bundles
        for role in ("actor", "coordinator"):
            bundle = json.loads(bundles[role][0].read_text())
            assert [e for e in bundle["events"] if e["kind"] == "signal"] and bundle["registry_snapshot"]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def test_rl_train_all_distills_in_process(tmp_path, monkeypatch):
    """``--distill``: the student tier's learner on the actors' batches
    (no weight publication)."""
    monkeypatch.setenv("DISTAR_EXPERIMENTS_ROOT", str(tmp_path))
    loop = rl_train.main(["--type", "all", "--distill", "--device", "cpu", "--iters", "2", "--env-num", "1",
                          "--traj-len", "2", "--batch-size", "2", "--episode-game-loops", "60"])
    assert type(loop.learner).__name__ == "DistillLearner"
    assert loop.learner.last_iter.val == 2
    assert np.isfinite(loop.learner.variable_record.get("total_loss").avg)


@pytest.mark.parametrize("argv", [["--type", "replay"], ["--replay"], ["--replay-addr", "h:1"]],
                         ids=["type_replay", "replay", "replay_addr"])
def test_replay_flags_take_their_working_path(argv, tmp_path, monkeypatch, capsys):
    """The replay role serves until SIGTERM (exit through the handler, the
    handler restored); ``--replay`` wires ``--type all`` through one
    loopback ``ReplayServer`` (the actor's target, the learner's
    ``ReplayDataLoader``); ``--replay-addr`` gives the learner a
    ``SampleClient`` at that address and the actor its push target."""
    import signal
    import threading
    import time

    from distar_tpu_torch.learner.rl_dataloader import ReplayDataLoader
    from distar_tpu_torch.replay import SampleClient

    monkeypatch.setenv("DISTAR_EXPERIMENTS_ROOT", str(tmp_path))
    if argv == ["--type", "replay"]:
        before = signal.getsignal(signal.SIGTERM)

        def stop_once_serving():
            deadline = time.time() + 60
            while "replay store serving on" not in capsys.readouterr().out and time.time() < deadline:
                time.sleep(0.05)
            os.kill(os.getpid(), signal.SIGTERM)

        stopper = threading.Thread(target=stop_once_serving, daemon=True)
        stopper.start()
        rl_train.main(argv + ["--port", "0", "--replay-spill-dir", str(tmp_path / "spill"), "--device", "cpu"])
        stopper.join(timeout=10)
        assert not stopper.is_alive() and signal.getsignal(signal.SIGTERM) is before
        assert (tmp_path / "spill" / "MANIFEST").exists()  # flushed on the way out
    elif argv == ["--replay"]:
        loop = rl_train.build_all(_resolved(argv + ["--env-num", "1", "--device", "cpu"]))
        try:
            server, = loop.replay_servers
            assert loop.actor.cfg.replay.addr == f"{server.host}:{server.port}"
            assert isinstance(loop.learner._dataloader, ReplayDataLoader)
            assert loop.replay_stores == [server.store]
        finally:
            rl_train.close_all(loop)
    else:
        args = _resolved(argv + ["--device", "cpu"])
        client = rl_train._learner_replay_client(args, args.replay_addr)
        assert isinstance(client, SampleClient) and client._addr == ("h", 1)
        assert rl_train._replay_loader(args, args.replay_addr, "MP0").token == "MP0"


@pytest.mark.parametrize("argv,item", [
    (["--type", "learner", "--coordinator-addr", "127.0.0.1:1", "--mesh", "dp=2"], "does not factor"),
    (["--dist-method", "explicit"], "explicit requires"),
    (["--platform", "cpu"], "--device"),
])
def test_unported_flags_raise_naming_their_item(argv, item):
    """What is not ported raises naming its ROADMAP item; the mesh flags
    (item 7, ported) refuse what they cannot do, typed: dp=2 on a world
    of one process, ``--dist-method explicit`` without its address, world
    and rank."""
    from distar_tpu_torch.parallel import MeshConfigError
    from distar_tpu_torch.parallel.dist import dist_close

    error = {"does not factor": MeshConfigError, "explicit requires": SystemExit}.get(item, NotImplementedError)
    try:
        with pytest.raises(error, match=item):
            rl_train.main(argv + ["--device", "cpu"])
    finally:
        dist_close()


@pytest.mark.parametrize("every,block", [
    ("2", {"every_n": 2}), ("0", {"enabled": False}), (None, None)])
def test_dynamics_every_sets_the_learner_block_as_the_jax_launcher(every, block):
    """``--dynamics-every N``: the gauge-export stride; 0 turns the tree
    off; absent, the config's block (the JAX launcher's ``_dynamics_cfg``)."""
    from distar_tpu.bin import rl_train as jax_rl_train

    import types

    argv = ["--type", "learner"] + (["--dynamics-every", every] if every is not None else [])
    args = rl_train.parser().parse_known_args(argv)[0]
    jargs = types.SimpleNamespace(dynamics_every=args.dynamics_every)  # the JAX parser lives in its main()
    learner = rl_train._learner_cfg(args, {})["learner"]
    assert learner.get("dynamics") == block == jax_rl_train._dynamics_cfg(jargs).get("dynamics")


SMALL_ALL = ["--type", "all", "--device", "cpu", "--iters", "2", "--env-num", "1", "--traj-len", "2",
             "--batch-size", "2", "--episode-game-loops", "60"]


def test_telemetry_interval_ships_a_roles_snapshots(tmp_path):
    """``--telemetry-interval-s``: a role's shipper (``_init_health`` with a
    coordinator address) reaches the coordinator's store on that cadence,
    and leaves the process as it found it on the role's normal return."""
    import sys as _sys
    import time

    from distar_tpu_torch.obs import get_fleet_health

    args = _resolved(["--type", "actor", "--telemetry-interval-s", "0.2", "--health-sample-s", "0.1",
                      "--save-path", str(tmp_path), "--device", "cpu"])
    hook = _sys.excepthook
    srv = CoordinatorServer()
    srv.start()
    try:
        health = rl_train._init_health(args, roles=("actor", "trace"), source="actor:7",
                                       shipper_addr=(srv.host, srv.port))
        assert get_fleet_health() is health.fleet and health.shipper.interval_s == 0.2
        deadline = time.time() + 20
        while time.time() < deadline and "actor:7" not in health.fleet.store.sources():
            time.sleep(0.05)
        assert "actor:7" in health.fleet.store.sources()
        assert [r.name for r in health.fleet.evaluator.rules] == ["actor_env_starvation", "trace_e2e_slo"]
        rl_train._close_health(health)
        assert _sys.excepthook is hook and health.shipper._thread is None
    finally:
        srv.stop()


def test_no_health_runs_the_loop_without_fleet_health(tmp_path, monkeypatch):
    """``--no-health``: ``--type all`` trains with no sampler, rulebook,
    shipper or crash hook, and writes no flight directory."""
    from distar_tpu_torch import obs as pobs

    monkeypatch.setenv("DISTAR_EXPERIMENTS_ROOT", str(tmp_path))
    before = pobs.set_fleet_health(None)
    try:
        loop = rl_train.main(SMALL_ALL + ["--no-health", "--save-path", str(tmp_path / "run")])
        assert loop.learner.last_iter.val == 2
        assert pobs.set_fleet_health(None) is None  # never installed
        assert not (tmp_path / "run" / "flight").exists()
        assert rl_train._init_health(_resolved(["--no-health", "--device", "cpu"]), roles=("actor",)) is None
    finally:
        pobs.set_fleet_health(before)


def test_metrics_port_serves_metrics_and_health_routes(tmp_path, monkeypatch, capsys):
    """``--metrics-port``: the process's registry and fleet-health routes on
    that port, in every role the JAX launcher serves them from."""
    import json
    import urllib.request

    monkeypatch.setenv("DISTAR_EXPERIMENTS_ROOT", str(tmp_path))
    server = rl_train._maybe_serve_metrics(_resolved(["--metrics-port", "0", "--device", "cpu"]))
    try:
        base = f"http://{server.host}:{server.port}"
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            assert r.status == 200
        with urllib.request.urlopen(base + "/alerts", timeout=10) as r:
            assert "rules" in json.loads(r.read())
    finally:
        server.stop()
    assert rl_train._maybe_serve_metrics(_resolved(["--device", "cpu"])) is None
    loop = rl_train.main(SMALL_ALL + ["--metrics-port", "0", "--save-path", str(tmp_path / "run")])
    assert loop.learner.last_iter.val == 2
    assert "metrics on http://127.0.0.1:" in capsys.readouterr().out


JAXENV_SMALL = ["--smoke-model", "--device", "cpu", "--iters", "2", "--batch-size", "2", "--traj-len", "3",
                "--jaxenv-units", "2", "--jaxenv-episode-len", "8"]


def test_anakin_trains_on_the_cpu(tmp_path, capsys):
    """``--anakin --env jaxenv``: the learner on windows of the micro-battle
    world, device-pure from the first window, for 2 iterations."""
    learner = rl_train.main(["--anakin", "--env", "jaxenv", "--save-path", str(tmp_path)] + JAXENV_SMALL)
    out = capsys.readouterr().out
    assert "anakin device purity: {'pure': True, 'offending': []}" in out
    assert "learner done: 2 iters" in out and learner.last_iter.val == 2
    assert np.isfinite(learner.last_log["total_loss"])
    assert learner.cfg.learner.prefetch_depth == 0


def test_type_all_plays_the_jaxenv_host_env(tmp_path, capsys):
    """``--type all --env jaxenv``: the actor on the micro-battle world's
    host env, the learner on its trajectories, 2 iterations."""
    rl_train.main(["--type", "all", "--env", "jaxenv", "--env-num", "1", "--save-path", str(tmp_path)]
                  + JAXENV_SMALL)
    out = capsys.readouterr().out
    assert "rl_train done: 2 iters" in out


def test_anakin_refuses_another_env():
    """As the JAX launcher: ``--anakin`` with any env but jaxenv exits."""
    with pytest.raises(SystemExit, match="--anakin requires --env jaxenv"):
        rl_train.main(["--anakin", "--env", "mock", "--device", "cpu"])


def test_the_launcher_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rl_train.build_all(_resolved(["--env-num", "1"]))


def _resolved(argv):
    args = rl_train.parser().parse_args(argv)
    rl_train._resolve_args(args)
    return args

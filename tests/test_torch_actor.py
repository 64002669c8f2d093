"""The port's actor side on the CPU at SMALL_MODEL, against the JAX package:
the mock env (bit-equal over three win rules), the ``Agent`` (pre- and
post-processing, pseudo-rewards and trajectories bit-equal when fed the
same model outputs), the env worker pool, the rollout plane's three
backends (``remote`` against ``bin.serve`` as a process), a weight refresh
in the middle of a job, and one ``Actor.run_job`` against the JAX actor's
under the same weights and Gumbel draws; the replay-store push in both
directions (a port actor into a JAX store, a JAX actor into a port store,
each trajectory sampled back bit-equal, dtypes included), and
``bin/play.py --game_type mock``.

Actions equal; logits and log-probabilities within atol 2e-4 / rtol 1e-3
(tests/test_golden_parity.py:132); observations, rewards and Z bit-equal."""
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch
from conftest import SMALL_MODEL

from distar_tpu.actor import agent as jax_agent_mod
from distar_tpu.actor import env_pool as jax_env_pool
from distar_tpu.actor.actor import Actor as JaxActor
from distar_tpu.envs import MockEnv as JaxMockEnv
from distar_tpu_torch.actor import Actor, Agent, BatchedInference, EnvWorkerPool, RolloutPlane
from distar_tpu_torch.actor import env_pool as port_env_pool
from distar_tpu_torch.actor.agent import sample_fake_z
from distar_tpu_torch.envs import MockEnv
from distar_tpu_torch.lib import actions as ACT
from distar_tpu_torch.lib import features as F
from distar_tpu_torch.model import Model, default_model_config
from distar_tpu_torch.model.convert import params_from_flax, params_to_flax
from distar_tpu_torch.utils import deep_merge_dicts
from distar_tpu_torch.utils.checkpoint import save_checkpoint
from test_torch_serve import jax_noise

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=2e-4, rtol=1e-3)
FLOAT_OUT = ("logit", "action_logp", "teacher_logit", "behaviour_logp")


def leaves(tree, prefix=""):
    """``{path: leaf}`` of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(leaves(v, f"{prefix}/{k}"))
    return out


def assert_tree_equal(got, want):
    g, w = leaves(got), leaves(want)
    assert set(g) == set(w), sorted(set(g) ^ set(w))[:8]
    for k in w:
        np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)


def policy_cfg():
    cfg = deep_merge_dicts(default_model_config(), SMALL_MODEL)
    cfg.use_value_network = False
    return cfg


# ---------------------------------------------------------------- mock env
def random_actions(rng, n_agents=2):
    """Per-agent env actions: about half production (cumulative-stat)
    action types, so the battle rule's scores move."""
    out = {}
    for i in range(n_agents):
        at = int(rng.choice(ACT.CUMULATIVE_STAT_ACTIONS)) if rng.random() < 0.5 else int(
            rng.integers(0, ACT.NUM_ACTIONS))
        out[i] = {"action_type": np.asarray(at), "delay": np.asarray(int(rng.integers(0, 6)))}
    return out


@pytest.mark.parametrize("win_rule", ["random", "first", "battle"])
def test_mock_env_bit_equal_to_jax(win_rule):
    """40 steps over episodes of 30 game loops (a reset after each end):
    observations, rewards, done and info bit-equal."""
    jenv = JaxMockEnv(episode_game_loops=30, seed=5, win_rule=win_rule, include_value_feature=True)
    penv = MockEnv(episode_game_loops=30, seed=5, win_rule=win_rule, include_value_feature=True)
    assert_tree_equal(penv.reset(), jenv.reset())
    rng = np.random.default_rng(0)
    dones = 0
    for _ in range(40):
        actions = random_actions(rng)
        want, got = jenv.step(actions), penv.step(actions)
        assert_tree_equal(got, want)
        if want[2]:
            dones += 1
            assert_tree_equal(penv.reset(), jenv.reset())
    assert dones >= 2


# ------------------------------------------------------------------- agent
def fake_output(rng, action_type, entity_num):
    """A model output for one slot: the given action type, random heads."""
    su = np.zeros(F.MAX_SELECTED_UNITS_NUM, np.int64)
    n = int(rng.integers(1, 4))
    su[:n] = rng.integers(0, max(int(entity_num), 1), n)
    return {
        "action_info": {
            "action_type": np.asarray(action_type, np.int64),
            "delay": np.asarray(int(rng.integers(0, 4)), np.int64),
            "queued": np.asarray(int(rng.integers(0, 2)), np.int64),
            "selected_units": su,
            "target_unit": np.asarray(int(rng.integers(0, 8)), np.int64),
            "target_location": np.asarray(int(rng.integers(0, 152 * 160)), np.int64),
        },
        "action_logp": {k: rng.standard_normal(F.ACTION_SHAPES[k]).astype(np.float32)
                        for k in F.ACTION_HEADS},
        "selected_units_num": np.asarray(n, np.int64),
    }


def agent_action_types(rng, n, z):
    """Build-order and cumulative-stat actions (the pseudo-reward paths),
    the target's own build order (so some steps match it), the zergling
    guard's 322, cancels and random others."""
    cancels = [i for i, a in enumerate(ACT.ACTIONS) if a["name"] in ("Cancel_quick", "Cancel_Last_quick")]
    target = [ACT.BEGINNING_ORDER_ACTIONS[i] for i in z["beginning_order"]]
    pool = list(ACT.BEGINNING_ORDER_ACTIONS[1:]) + target * 20 + [322] * 12 + cancels * 6
    return [int(rng.choice(pool)) if rng.random() < 0.8 else int(rng.integers(0, ACT.NUM_ACTIONS))
            for _ in range(n)]


@pytest.mark.parametrize("clip_bo", [False, True])
def test_agent_bit_equal_to_jax(clip_bo):
    """60 steps of a 2-step-trajectory agent on the JAX mock env's
    observations (orders in the entity fields so cancels resolve), fed the
    same outputs: prepared observations, env actions, pseudo-rewards,
    trajectories and episode stats bit-equal."""
    env = JaxMockEnv(episode_game_loops=80, seed=2, include_value_feature=True)
    z = sample_fake_z(np.random.default_rng(4))
    kw = dict(z=dict(z), traj_len=2, clip_bo=clip_bo, seed=3, max_entities=48)
    jag, pag = jax_agent_mod.Agent("MP0", **kw), Agent("MP0", **kw)
    rng = np.random.default_rng(1)
    obs = env.reset()[0]
    hidden = ((np.ones(8, np.float32), np.zeros(8, np.float32)),)
    trajs, paid = 0, {"build_order": 0, "built_unit": 0}
    for at in agent_action_types(rng, 60, z):
        ent = obs["entity_info"]
        ent["order_length"][:] = rng.integers(0, 4, ent["order_length"].shape)
        ent["order_id_0"][:] = rng.integers(0, ACT.NUM_UNIT_MIX_ABILITIES, ent["order_id_0"].shape)
        for k in ("order_id_1", "order_id_2", "order_id_3"):
            ent[k][:] = rng.integers(0, len(ACT.QUEUE_ACTIONS) + 1, ent[k].shape)
        assert_tree_equal(pag.pre_process(obs), jag.pre_process(obs))
        out = fake_output(rng, at, obs["entity_num"])
        assert_tree_equal(pag.post_process(out), jag.post_process(out))
        next_obs, rewards, done, _ = env.step({0: out["action_info"], 1: out["action_info"]})
        next_obs[0]["action_result"] = [int(rng.integers(0, 3))]
        teacher = {k: rng.standard_normal(s).astype(np.float32) for k, s in F.LOGIT_SHAPES.items()}
        want = jag.collect_data(next_obs[0], rewards[0], done, teacher, hidden)
        got = pag.collect_data(next_obs[0], rewards[0], done, teacher, hidden)
        assert (got is None) == (want is None)
        if want is not None:
            trajs += 1
            assert_tree_equal(got, want)
            for step in want[:-1]:
                for k in paid:
                    paid[k] += step["reward"][k] != 0.0
        assert pag.episode_stats() == jag.episode_stats()
        if done:
            obs = env.reset()[0]
            jag.reset(), pag.reset()
        else:
            obs = next_obs[0]
    assert trajs >= 10
    assert min(paid.values()) > 0, paid  # both pseudo-rewards were paid


# ------------------------------------------------------------ env pool
def test_env_worker_pool_matches_jax():
    """The same seeded envs through both pools, each env on its own action
    stream: each env's resets and steps bit-equal, and a reset drops the
    abandoned episode's in-flight step (the epoch rule)."""
    def drive(pool_cls, env_cls):
        pool = pool_cls([lambda s=s: env_cls(episode_game_loops=40, seed=s) for s in (1, 2)])
        rngs = {e: np.random.default_rng(7 + e) for e in (0, 1)}
        seen = {0: [], 1: []}
        try:
            pool.reset(0), pool.reset(1)
            while min(len(v) for v in seen.values()) < 12:
                for e, kind, payload in pool.ready(timeout=5.0):
                    seen[e].append((kind, payload))
                    if len(seen[e]) == 5:
                        pool.submit(e, random_actions(rngs[e]))
                        pool.reset(e)  # the step just submitted is dropped
                    elif kind == port_env_pool.STEP and payload[2]:
                        pool.reset(e)
                    else:
                        pool.submit(e, random_actions(rngs[e]))
        finally:
            pool.close()
        return {e: v[:12] for e, v in seen.items()}

    got, want = drive(EnvWorkerPool, MockEnv), drive(jax_env_pool.EnvWorkerPool, JaxMockEnv)
    for e in (0, 1):
        assert_tree_equal(got[e], want[e])
        assert got[e][5][0] == port_env_pool.RESET


def test_env_worker_pool_reraises_a_worker_error():
    class Broken(MockEnv):
        def step(self, actions):
            raise ValueError("boom")

    pool = EnvWorkerPool([lambda: Broken(seed=0)])
    try:
        pool.reset(0)
        assert pool.ready(timeout=5.0)[0][1] == port_env_pool.RESET
        pool.submit(0, random_actions(np.random.default_rng(0)))
        with pytest.raises(RuntimeError, match="env worker 0 failed"):
            pool.ready(timeout=5.0)
    finally:
        pool.close()


# ------------------------------------------------------------ rollout plane
@pytest.fixture(scope="module")
def policy_weights():
    """A seeded SMALL_MODEL policy (no value towers) and a second set."""
    from distar_tpu_torch.model import init_params

    out = []
    for seed in (3, 4):
        m = Model(policy_cfg())
        init_params(m, seed)
        out.append(m.state_dict())
    return out


def plane_steps(client, steps):
    """Each cycle's outputs and teacher logits over ``steps`` (lists of
    per-slot observations); slot 0 resets after the second cycle."""
    rec = []
    for i, prepared in enumerate(steps):
        outs = client.sample(prepared)
        rec.append((outs, client.teacher_logits(prepared, outs)))
        if i == 1:
            client.reset_slot(0)
    return rec


def assert_plane_equal(got, want):
    for (go, gt), (wo, wt) in zip(got, want):
        for g, w, gtl, wtl in zip(go, wo, gt, wt):
            np.testing.assert_array_equal(g["action_info"]["action_type"], w["action_info"]["action_type"])
            for k in F.ACTION_HEADS:
                np.testing.assert_allclose(g["action_logp"][k], w["action_logp"][k], **TOL)
                np.testing.assert_allclose(gtl[k], wtl[k], **TOL)


@pytest.fixture(scope="module")
def plane_record(policy_weights):
    """Three cycles of two slots through the inline backend (the
    reference for the other two)."""
    rng = np.random.default_rng(5)
    steps = [[F.random_step_data(rng) for _ in range(2)] for _ in range(3)]
    plane = RolloutPlane("inline", model_cfg=policy_cfg(), device="cpu")
    client = plane.client_for("MP0", num_slots=2, params=policy_weights[0],
                              teacher_params=policy_weights[1], seed=0)
    rec = plane_steps(client, steps)
    hidden = client.hidden_for_slot(1)
    client.close()
    return dict(steps=steps, rec=rec, hidden=hidden)


def test_plane_local_backend_matches_inline(plane_record, policy_weights):
    """One shared in-process gateway: the same outputs, teacher logits
    (piggybacked on the flush) and carries as the inline engine."""
    plane = RolloutPlane("local", slots=2, model_cfg=policy_cfg(), device="cpu", max_delay_s=0.001)
    try:
        client = plane.client_for("MP0", num_slots=2, params=policy_weights[0],
                                  teacher_params=policy_weights[1], seed=0)
        assert_plane_equal(plane_steps(client, plane_record["steps"]), plane_record["rec"])
        for (h, c), (wh, wc) in zip(client.hidden_for_slot(1), plane_record["hidden"]):
            np.testing.assert_array_equal(h, wh)
            np.testing.assert_array_equal(c, wc)
        client.close()
    finally:
        plane.shutdown()


def _wait_line(proc, prefix, timeout=120.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        if line.startswith(prefix) or prefix in line:
            return line
    raise AssertionError(f"no {prefix!r} line from the process")


def test_plane_remote_backend_against_bin_serve(plane_record, policy_weights, tmp_path):
    """``bin.serve`` as a process on the CPU, serving a checkpoint of the
    same weights: the remote backend's outputs and teacher logits equal
    the inline engine's, and a refresh hot-swaps the gateway's version."""
    model = Model(policy_cfg())
    model.load_state_dict(policy_weights[0])
    ckpt = str(tmp_path / "policy.ckpt")
    save_checkpoint(ckpt, {"params": params_to_flax(model), "opt_state": ()})
    cfg = tmp_path / "cfg.json"
    cfg.write_text(__import__("json").dumps({"model": SMALL_MODEL}))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")  # one core each beside the other workers
    proc = subprocess.Popen(
        [sys.executable, "-m", "distar_tpu_torch.bin.serve", "--checkpoint", ckpt, "--config",
         str(cfg), "--device", "cpu", "--slots", "2", "--http-port", "0", "--tcp-port", "0",
         "--max-delay-ms", "1", "--transport", "tcp"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = _wait_line(proc, "serving:")
        tcp = [w for w in line.split() if w.startswith("tcp=")][0][4:]
        plane = RolloutPlane("remote", addr=tcp, model_cfg=policy_cfg(), transport="tcp")
        client = plane.client_for("MP0", num_slots=2, params=policy_weights[0],
                                  teacher_params=policy_weights[1], seed=0)
        assert_plane_equal(plane_steps(client, plane_record["steps"]), plane_record["rec"])
        client.refresh(policy_weights[1], iteration=5)
        assert client.target.status()["registry"]["current"] == "MP0@5"
        client.close()
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_refresh_in_a_job_lands_between_flushes(policy_weights):
    """Weights published while a job runs (a thread pushes them): every
    flush of the inline and the local backends runs on one version (the
    engine's weights are the same before and after it), and the job sees
    at least two versions."""
    for backend in ("inline", "local"):
        pubs = []
        model = Model(deep_merge_dicts(policy_cfg(), {"use_value_network": True}))

        class Pubs:
            def pull(self, token, block=False):
                return pubs.pop(0) if pubs and token == "MP0model" else None

            def push(self, *a, **k):
                pass

        actor = Actor(cfg={"actor": {"env_num": 2, "traj_len": 2, "model_update_interval_s": 0.0,
                                     "plane": {"backend": backend, "max_delay_s": 0.001}}},
                      adapter=Pubs(), model_cfg=SMALL_MODEL, device="cpu",
                      env_fn=lambda: MockEnv(episode_game_loops=120, seed=1),
                      init_params=policy_weights[0])
        flushes, versions = [], set()
        real = BatchedInference.sample

        def sample(self, prepared, active=None, noise=None):
            before = self.model.policy.action_type_head.state_dict()
            first = next(iter(before.values())).clone()
            out = real(self, prepared, active, noise)
            after = next(iter(self.model.policy.action_type_head.state_dict().values()))
            flushes.append(torch.equal(first, after))
            versions.add(float(first.sum()))
            if len(flushes) == 3:  # a learner publishes mid-job
                from distar_tpu_torch.model import init_params

                init_params(model, 9)
                pubs.append({"params": params_to_flax(model), "iter": 7, "reset_flag": False})
            return out

        BatchedInference.sample = sample
        try:
            actor.run_job(episodes=1, job={
                "player_ids": ["MP0", "MP0"], "send_data_players": [], "update_players": ["MP0"],
                "teacher_player_ids": ["none", "none"], "branch": "sp", "env_info": {}})
        finally:
            BatchedInference.sample = real
            actor.plane.shutdown()
        assert len(flushes) > 3 and all(flushes), (backend, flushes)
        assert len(versions) >= 2, backend
        assert actor.model_iter_highwater["MP0"] == 7


# ------------------------------------------------------------------ actor
class SyncPool:
    """A deterministic stand-in for ``EnvWorkerPool``: steps on submit,
    hands results out in env order."""

    def __init__(self, env_fns):
        self.envs = [fn() for fn in env_fns]
        self.pending = []

    def reset(self, e):
        self.pending = [p for p in self.pending if p[0] != e]
        self.pending.append((e, "reset", self.envs[e].reset()))

    def submit(self, e, actions):
        self.pending.append((e, "step", self.envs[e].step(actions)))

    def ready(self, timeout=None):
        out, self.pending = sorted(self.pending, key=lambda p: p[0]), []
        return out

    def close(self):
        pass


class Capture:
    """An adapter that keeps what is pushed and publishes nothing."""

    def __init__(self):
        self.pushed = []

    def push(self, token, data, **kw):
        self.pushed.append((token, data))

    def pull(self, token, block=False):
        return None


JOB = {"player_ids": ["MP0", "HP0"], "send_data_players": ["MP0"], "update_players": ["MP0"],
       "teacher_player_ids": ["T", "none"], "branch": "pfsp", "env_info": {"map_name": "mock"}}


@pytest.fixture(scope="module")
def actor_jobs():
    """One job of 2 envs, traj_len 2, two episodes, in both packages: the
    same weights carried across the bridge, the JAX key schedule's Gumbel draws fed to the
    port, the env steps made in one order."""
    from distar_tpu_torch.model import init_params

    model = Model(policy_cfg())
    init_params(model, 3)
    params = params_to_flax(model)  # the JAX actor's flax tree
    state = params_from_flax(params, model)  # and back: the port actor's
    actor_cfg = {"actor": {"env_num": 2, "traj_len": 2, "seed": 3}}

    real_init, real_sample = BatchedInference.__init__, BatchedInference.sample

    def init(self, model, num_slots, seed=0, device=None, teacher_params=None):
        real_init(self, model, num_slots, seed, device, teacher_params)
        self._jax_key = jax.random.PRNGKey(seed)

    def sample(self, prepared, active=None, noise=None):
        self._jax_key, key = jax.random.split(self._jax_key)
        return real_sample(self, prepared, active, noise=jax_noise(key, self.model.cfg, self.num_slots))

    out = {}
    for name, actor_cls, env_cls, pool_mod, kw in (
            ("jax", JaxActor, JaxMockEnv, jax_env_pool, dict(init_params=params)),
            ("port", Actor, MockEnv, port_env_pool, dict(init_params=state, device="cpu"))):
        adapter = Capture()
        actor = actor_cls(cfg=actor_cfg, adapter=adapter, model_cfg=SMALL_MODEL,
                          env_fn=lambda env_cls=env_cls: env_cls(episode_game_loops=150, seed=1), **kw)
        real_pool = pool_mod.EnvWorkerPool
        pool_mod.EnvWorkerPool = SyncPool
        BatchedInference.__init__, BatchedInference.sample = init, sample
        try:
            results = actor.run_job(episodes=2, job=dict(JOB))
        finally:
            pool_mod.EnvWorkerPool = real_pool
            BatchedInference.__init__, BatchedInference.sample = real_init, real_sample
        out[name] = dict(results=results, pushed=adapter.pushed)
    return out


def test_actor_job_results_bit_equal_to_jax(actor_jobs):
    got, want = actor_jobs["port"]["results"], actor_jobs["jax"]["results"]
    assert len(got) == len(want) >= 2
    assert got == want


def test_actor_job_trajectories_match_jax(actor_jobs):
    """Every pushed trajectory: observations, actions, rewards, masks and
    Z targets bit-equal; log-probabilities, teacher logits and the carried
    hidden state within the tolerance."""
    got, want = actor_jobs["port"]["pushed"], actor_jobs["jax"]["pushed"]
    assert len(got) == len(want) >= 4
    for (gt, gtraj), (wt, wtraj) in zip(got, want):
        assert gt == wt == "MP0traj"
        assert len(gtraj) == len(wtraj) == 3
        for gs, ws in zip(gtraj, wtraj):
            gl, wl = leaves({k: v for k, v in gs.items() if k != "trace"}), leaves(
                {k: v for k, v in ws.items() if k != "trace"})
            assert set(gl) == set(wl)
            for k, w in wl.items():
                if k.split("/")[1] in FLOAT_OUT or k.startswith("/hidden_state"):
                    np.testing.assert_allclose(np.asarray(gl[k]), np.asarray(w), err_msg=k, **TOL)
                else:
                    margin = ""
                    if k.startswith("/action_info") and not np.array_equal(gl[k], w):
                        margin = " (a sampled action differs: inspect its logit margin)"
                    np.testing.assert_array_equal(np.asarray(gl[k]), np.asarray(w), err_msg=k + margin)


def test_actor_without_cuda_raises_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Actor(model_cfg=SMALL_MODEL)


def assert_bits_equal(got, want):
    """Leaf for leaf the same dtype and the same values."""
    g, w = leaves(got), leaves(want)
    assert set(g) == set(w), sorted(set(g) ^ set(w))[:8]
    for k in w:
        a, b = np.asarray(g[k]), np.asarray(w[k])
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_actor_pushes_into_a_jax_store_bit_equal(policy_weights):
    """``actor.replay.enabled``: a port actor's job pushes every trajectory
    into a JAX ``ReplayServer`` (shared-memory rings where available) and no
    longer to the adapter; sampled back, each equals the one pushed."""
    import copy

    import distar_tpu.replay as jr

    store = jr.ReplayStore(table_factory=lambda n: jr.TableConfig(sampler="fifo", samples_per_insert=None))
    server = jr.ReplayServer(store, port=0).start()
    adapter = Capture()
    actor = Actor(cfg={"actor": {"env_num": 1, "traj_len": 2,
                                 "replay": {"enabled": True, "addr": f"{server.host}:{server.port}"}}},
                  adapter=adapter, model_cfg=SMALL_MODEL, device="cpu", init_params=policy_weights[0],
                  env_fn=lambda: MockEnv(episode_game_loops=60, seed=2))
    client = actor._get_replay_client()
    pushed, real_insert = [], client.insert
    client.insert = lambda table, traj, **kw: (pushed.append((table, copy.deepcopy(traj))),
                                               real_insert(table, traj, **kw))[1]
    try:
        actor.run_job(episodes=1, job=dict(JOB))
        assert pushed and not adapter.pushed and all(t == "MP0" for t, _ in pushed)
        items = store.sample("MP0", batch_size=len(pushed), timeout_s=10.0)
        for item, (_, traj) in zip(items, pushed):
            assert_bits_equal(item.data, traj)
    finally:
        client.close()
        server.stop()


def test_jax_actor_pushes_into_a_port_store_bit_equal():
    """The JAX actor's replay push into the port's ``ReplayServer``; with
    ``mirror`` the adapter gets the trajectory too."""
    import copy

    from distar_tpu_torch import replay as pr
    from test_rl_dataloader import tiny_traj

    store = pr.ReplayStore(table_factory=lambda n: pr.TableConfig(sampler="fifo", samples_per_insert=None))
    server = pr.ReplayServer(store, port=0).start()
    adapter = Capture()
    actor = JaxActor(cfg={"actor": {"replay": {"enabled": True, "mirror": True,
                                               "addr": f"{server.host}:{server.port}"}}},
                     adapter=adapter, model_cfg=SMALL_MODEL)
    rng = np.random.default_rng(5)
    trajs = [tiny_traj(sun=int(rng.integers(0, 4))) for _ in range(3)]
    try:
        for traj in copy.deepcopy(trajs):  # the mirror's push stamps a trace into its copy
            actor.push_trajectory("MP0", traj)
        assert len(adapter.pushed) == 3
        items, info = pr.SampleClient(server.host, server.port).sample("MP0", batch_size=3, timeout_s=10.0)
        assert [d["seq"] for d in info] == [0, 1, 2]
        for item, traj in zip(items, trajs):
            assert_bits_equal(item, traj)
    finally:
        actor._replay_client.close()
        server.stop()


@pytest.mark.parametrize("addr", ["h1:x", ",", "nohost"])
def test_malformed_replay_addr_fails_at_config_time_with_the_jax_message(addr):
    cfg = {"actor": {"replay": {"enabled": True, "addr": addr}}}
    with pytest.raises(ValueError) as mine:
        Actor(cfg=cfg, model_cfg=SMALL_MODEL, device="cpu")
    with pytest.raises(ValueError) as theirs:
        JaxActor(cfg=cfg, model_cfg=SMALL_MODEL)
    assert str(mine.value) == str(theirs.value) and "actor.replay.addr" in str(mine.value)


def test_replay_push_to_an_unreachable_store_is_dropped_and_counted(policy_weights):
    from distar_tpu_torch.obs import get_registry
    from distar_tpu_torch.resilience import NO_RETRY

    failures = lambda: sum(v for k, v in get_registry().snapshot().items()  # noqa: E731
                           if k.startswith("distar_actor_replay_push_failures_total"))
    actor = Actor(cfg={"actor": {"replay": {"enabled": True, "addr": "127.0.0.1:1"}}}, model_cfg=SMALL_MODEL,
                  device="cpu")
    from distar_tpu_torch.replay import InsertClient

    actor._replay_client = InsertClient("127.0.0.1", 1, retry_policy=NO_RETRY)
    before = failures()
    actor.push_trajectory("MP0", [{"x": np.zeros(2)}])
    assert failures() == before + 1


def test_play_mock_games_print_the_jax_report(tmp_path, capsys, policy_weights, monkeypatch):
    """``bin/play.py --game_type mock``: two games between a checkpoint the
    port wrote (``--model1``, a learner's tree with value towers) and the
    seeded weights, the JAX launcher's report line; without an SC2 install
    the SC2 game types and the LAN host exit naming SC2PATH (the games run
    in tests/test_torch_sc2_env.py); reference ``.pth`` checkpoints raise
    naming item 10."""
    import re

    from distar_tpu_torch.bin import play
    from distar_tpu_torch.model import init_params

    cfg = deep_merge_dicts(default_model_config(), SMALL_MODEL)
    cfg.use_value_network = True
    learner_model = Model(cfg)
    init_params(learner_model, 6)
    ckpt = str(tmp_path / "mp.ckpt")
    save_checkpoint(ckpt, {"params": params_to_flax(learner_model), "opt_state": ()})
    loaded = play.load_params(ckpt, deep_merge_dicts(default_model_config(), SMALL_MODEL))
    want = {k: v for k, v in learner_model.state_dict().items() if not k.startswith("value_")}
    assert set(loaded) == set(want) and all(torch.equal(loaded[k], want[k]) for k in want)
    results = play.main(["--game_type", "mock", "--device", "cpu", "--game-count", "2", "--model1", ckpt,
                         "--smoke-model", "--episode-game-loops", "60"])
    assert len(results) == 2
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"games=2 side0_winrate=\d\.\d\d side1_winrate=\d\.\d\d ties=\d", last), last
    # the SC2 game types and the LAN host need an install (SC2PATH); the mock
    # game type takes the SC2 flags and plays, as the JAX launcher does
    monkeypatch.setenv("SC2PATH", str(tmp_path / "no_install"))
    for argv in (["--game_type", "agent_vs_bot"], ["--lan-host"]):
        with pytest.raises(SystemExit, match="set the SC2PATH"):
            play.main(argv + ["--device", "cpu"])
    for argv in (["--game_type", "mock", "--lan", "h:1"], ["--game_type", "mock", "--map", "KairosJunction"]):
        assert len(play.main(argv + ["--device", "cpu", "--episode-game-loops", "60"])) == 1
    with pytest.raises(NotImplementedError, match="item 10"):
        play.load_params("ref.pth", cfg)


def test_scripted_side_against_a_model_side(policy_weights):
    """A ``scripted.random`` opponent rides the model-free path: no slot,
    no trajectory, results for both sides; plugins resolve the port's
    components."""
    from distar_tpu_torch import plugins

    assert plugins.load_component("default", "RLLearner").__module__.startswith("distar_tpu_torch")
    assert plugins.load_component("default", "ReplayDecoder").__module__ == "distar_tpu_torch.envs.replay_decoder"
    adapter = Capture()
    actor = Actor(cfg={"actor": {"env_num": 1, "traj_len": 2}}, adapter=adapter, model_cfg=SMALL_MODEL,
                  device="cpu", env_fn=lambda: MockEnv(episode_game_loops=60, seed=2),
                  init_params=policy_weights[0])
    results = actor.run_job(episodes=1, job={
        "player_ids": ["MP0", "SC0"], "pipelines": ["default", "scripted.random"],
        "send_data_players": ["MP0", "SC0"], "update_players": [], "teacher_player_ids": ["none", "none"],
        "branch": "eval", "env_info": {}})
    assert results[0]["1"]["player_id"] == "SC0"
    assert adapter.pushed and all(tok == "MP0traj" for tok, _ in adapter.pushed)

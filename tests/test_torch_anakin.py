"""The port's Anakin loop (``distar_tpu_torch.envs.jaxenv.anakin``) against
the JAX package's, on the CPU, and the port's learner on its batches.

The JAX runner plays B = 2 lanes x T = 3 steps of the JAX tests' tiny world
(``TINY_SCN``: episodes of 8 steps, so lanes finish and are re-seeded within
the windows run here) with SMALL_MODEL weights seeded in the port and carried to JAX through
the bridge (``params_to_flax``, back with ``params_from_flax``), and for every
window the scenarios and Gumbel draws JAX derives from its key (the fresh
lanes of ``split(k_seed, B)``, the draws of each ``split(k_scan, T)`` key,
regenerated as tests/test_torch_model.py does). Tolerances: actions,
selected_units_num, rewards, masks, done, steps, every observation leaf and
every env-state leaf exact; logits (the self-teacher's) and behaviour_logp
within LOGIT_TOL = 1e-4; the LSTM carry within CARRY_TOL = 1e-5 (the
SMALL_MODEL forward's float32 sums differ in order between XLA and torch).
"""
from functools import partial

import jax
import numpy as np
import pytest
import torch
from conftest import SMALL_MODEL
from test_torch_model import jax_gumbel_noise

from distar_tpu.envs import jaxenv as J
from distar_tpu.model import Model as JModel
from distar_tpu.model.config import default_model_config as jax_default_config
from distar_tpu.utils import deep_merge_dicts as jax_merge
from distar_tpu_torch.envs import jaxenv as P
from distar_tpu_torch.envs.jaxenv import anakin as panakin
from distar_tpu_torch.envs.jaxenv.scenario import Scenario
from distar_tpu_torch.learner.data import fake_rl_batch
from distar_tpu_torch.lib import features as F
from distar_tpu_torch.model import Model, default_model_config, init_params
from distar_tpu_torch.model.convert import params_from_flax, params_to_flax
from distar_tpu_torch.obs import get_registry
from distar_tpu_torch.utils import deep_merge_dicts

torch.set_num_threads(1)

B, T, WINDOWS = 2, 3, 5
LOGIT_TOL, CARRY_TOL = 1e-4, 1e-5
SCN = dict(units_per_squad=2, min_units=1, max_units=2, episode_len=8, spawn_margin=30.0, spawn_spread=6.0)
J_ENV, J_SCN = J.EnvConfig(units_per_squad=2), J.ScenarioConfig(**SCN)
P_ENV, P_SCN = P.EnvConfig(units_per_squad=2), P.ScenarioConfig(**SCN)


def to_port(jscn):
    return Scenario.from_numpy(jax.tree.map(np.asarray, jscn))


def port_model(np_params):
    model = Model(deep_merge_dicts(default_model_config(), SMALL_MODEL))
    model.load_state_dict(params_from_flax(np_params, model))
    return model.eval()


def flat(tree, prefix=""):
    """{path: leaf} of a tree of dicts and tuples."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flat(v, f"{prefix}/{k}"))
    return out


def host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX model and two sets of SMALL_MODEL weights (the policy's and
    the away seat's), seeded in the port and carried to JAX by the bridge."""
    jm = JModel(jax_merge(jax_default_config(), SMALL_MODEL))
    weights = []
    for seed in (0, 5):
        model = Model(deep_merge_dicts(default_model_config(), SMALL_MODEL))
        init_params(model, seed)
        weights.append(jax.tree.map(jax.numpy.asarray, params_to_flax(model)))
    return jm, *weights


def run_windows(jax_side, opponent_seat):
    """WINDOWS windows in both packages from one key; returns the batch and
    carry pairs of every window and the port model."""
    jm, params, opp_params = jax_side
    jr = J.AnakinRunner(jm, batch_size=B, unroll_len=T, env_cfg=J_ENV, scenario_cfg=J_SCN, seed=0,
                        opponent_seat=opponent_seat)
    model = port_model(jax.tree.map(np.asarray, params))
    opp_model = port_model(jax.tree.map(np.asarray, opp_params)) if opponent_seat else None
    pr = P.AnakinRunner(model, batch_size=B, unroll_len=T, env_cfg=P_ENV, scenario_cfg=P_SCN, seed=0,
                        opponent_seat=opponent_seat, device="cpu")
    gen = J.ScenarioGenerator(J_SCN)
    key = jax.random.PRNGKey(0)
    _, k_scn = jax.random.split(key)
    jcarry = jr.init_carry(key)
    pcarry = pr.init_carry(scenarios=to_port(gen.batch(k_scn, B)))
    windows = []
    for _ in range(WINDOWS):
        _, k_seed, k_scan = jax.random.split(jcarry[-1], 3)
        fresh = to_port(jax.vmap(gen.generate)(jax.random.split(k_seed, B)))
        noise = []
        for k_t in jax.random.split(k_scan, T):
            if opponent_seat:
                ka, kb = jax.random.split(k_t)
                noise.append((jax_gumbel_noise(ka, model.cfg, B), jax_gumbel_noise(kb, model.cfg, B)))
            else:
                noise.append(jax_gumbel_noise(k_t, model.cfg, B))
        if opponent_seat:
            jcarry, jbatch = jr.rollout(params, jcarry, opponent_params=opp_params)
            pcarry, pbatch = pr.rollout(model, pcarry, opponent_model=opp_model, scenarios=fresh, noise=noise)
        else:
            jcarry, jbatch = jr.rollout(params, jcarry)
            pcarry, pbatch = pr.rollout(model, pcarry, scenarios=fresh, noise=noise)
        # host copies: the next window donates the JAX carry
        windows.append((jax.tree.map(np.asarray, jbatch), pbatch, jax.tree.map(np.asarray, jcarry), pcarry))
    return windows, model


@pytest.fixture(scope="module")
def windows(jax_side):
    return run_windows(jax_side, opponent_seat=False)


@pytest.fixture(scope="module")
def opp_windows(jax_side):
    return run_windows(jax_side, opponent_seat=True)


def batch_problems(jbatch, pbatch):
    """Leaves of two window batches that differ past their tolerance."""
    want, got = flat(jbatch), flat(pbatch)
    assert sorted(want) == sorted(got)
    bad = []
    for path, w in want.items():
        g, w = host(got[path]), np.asarray(w)
        if path.startswith(("/teacher_logit", "/behaviour_logp")):
            ok = np.allclose(g, w, rtol=0.0, atol=LOGIT_TOL)
        elif path.startswith("/hidden_state"):
            ok = np.allclose(g, w, rtol=0.0, atol=CARRY_TOL)
        elif path == "/model_last_iter":
            ok = np.array_equal(g, w)
        else:  # observations, actions, rewards, masks, done, steps: exact
            ok = g.shape == w.shape and np.array_equal(g.astype(np.float64), w.astype(np.float64))
        if not ok:
            bad.append(path)
    return bad


def carry_problems(jcarry, pcarry):
    """The env state exact, the LSTM carries within CARRY_TOL."""
    bad = []
    for f in pcarry[0]._fields:
        if f != "scenario" and not np.array_equal(np.asarray(getattr(jcarry[0], f)), host(getattr(pcarry[0], f))):
            bad.append(f)
    for i, (jh, ph) in enumerate(zip(jcarry[1:-1], pcarry[1:])):
        for a, b in zip(jax.tree.leaves(jh), jax.tree.leaves(ph)):
            if not np.allclose(host(b), np.asarray(a), rtol=0.0, atol=CARRY_TOL):
                bad.append(f"hidden {i}")
    return bad


@pytest.mark.parametrize("w", range(WINDOWS))
def test_window_matches_jax(windows, w):
    jbatch, pbatch, jcarry, pcarry = windows[0][w]
    assert batch_problems(jbatch, pbatch) == []
    assert carry_problems(jcarry, pcarry) == []


def test_windows_reseed_finished_lanes(windows):
    """Over the windows some lanes finish (done at a window's end) and
    start a fresh episode at the next one: the case the re-seeding path
    and its zeroed carry take."""
    dones = [host(p["done"])[-1] for _, p, _, _ in windows[0]]
    steps = [host(p["step"])[0] for _, p, _, _ in windows[0]]
    reseeded = [w + 1 for w in range(WINDOWS - 1) if dones[w].any()]
    assert reseeded, dones
    for w in reseeded:
        lanes = dones[w - 1] > 0
        assert (steps[w][lanes] == 0).all() and (host(windows[0][w][1]["hidden_state"][0][0])[lanes] == 0).all()


@pytest.mark.parametrize("w", range(WINDOWS))
def test_away_seat_window_matches_jax(opp_windows, w):
    """The two-policy window, a frozen opponent of other weights on the
    away seat: the learner batch and the outcome leaves (winner, finished,
    steps) exact, the carries as above."""
    jbatch, pbatch, jcarry, pcarry = opp_windows[0][w]
    assert batch_problems(jbatch, pbatch) == []
    assert carry_problems(jcarry, pcarry) == []


def test_away_seat_episodes_finish(opp_windows):
    finished = sum(int(host(p["match_result"]["finished"]).sum()) for _, p, _, _ in opp_windows[0])
    assert finished > 0


def test_model_policy_matches_jax(jax_side, windows):
    """``ModelPolicy`` (the win-rate evaluator's model seat) on a window's
    first observation, with the JAX runner's first Gumbel draws: the
    actions the JAX window took, exact."""
    jbatch, _, _, _ = windows[0][0]
    model = windows[1]
    obs = {k: jax.tree.map(lambda a: torch.from_numpy(np.array(a[0])), jbatch[k])
           for k in ("spatial_info", "entity_info", "scalar_info", "entity_num")}
    hidden = tuple((torch.from_numpy(np.array(h)), torch.from_numpy(np.array(c))) for h, c in jbatch["hidden_state"])
    k_scan = jax.random.split(jax.random.split(jax.random.PRNGKey(0))[0], 3)[2]
    noise = jax_gumbel_noise(jax.random.split(k_scan, T)[0], model.cfg, B)
    with torch.no_grad():
        action, sun, _ = P.model_policy(model)(obs, hidden, noise=noise)
    for head in F.ACTION_HEADS:
        np.testing.assert_array_equal(action[head].numpy(), jbatch["action_info"][head][0], err_msg=head)
    np.testing.assert_array_equal(sun.numpy(), jbatch["selected_units_num"][0])


# ------------------------------------------------------- the port's loop
@pytest.fixture(scope="module")
def learner(tmp_path_factory):
    from distar_tpu_torch.learner import RLLearner

    cfg = {"common": {"experiment_name": "anakin_t", "save_path": str(tmp_path_factory.mktemp("anakin"))},
           "learner": {"batch_size": B, "unroll_len": T, "save_freq": 10 ** 9, "log_freq": 1,
                       "prefetch_depth": 0},
           "model": SMALL_MODEL}
    return RLLearner(cfg, device="cpu")


@pytest.fixture(scope="module")
def loader(learner):
    runner = P.AnakinRunner(learner.model, batch_size=B, unroll_len=T, env_cfg=P_ENV, scenario_cfg=P_SCN, seed=3)
    return P.AnakinDataLoader(runner, model_provider=lambda: learner.model)


def test_batch_layout_matches_fake_rl_batch(loader):
    """Leaf by leaf, the layout ``collate_trajectories`` hands the learner
    (``fake_rl_batch``): same tree, shapes and dtypes; every leaf a tensor
    on the runner's device but ``model_last_iter``, which the learner reads
    on the host."""
    batch = next(loader)
    lstm = SMALL_MODEL["encoder"]["core_lstm"]
    fake = flat(fake_rl_batch(B, T, hidden_size=lstm["hidden_size"], hidden_layers=lstm["num_layers"]))
    got = flat(batch)
    assert sorted(got) == sorted(fake)
    for path, want in fake.items():
        g = got[path]
        assert tuple(g.shape) == want.shape, path
        assert str(g.dtype).replace("torch.", "") == str(want.dtype), path
        assert isinstance(g, torch.Tensor) == (path != "/model_last_iter"), path
    assert batch["done"].shape == (T, B) and batch["entity_num"].shape == (T + 1, B)


def test_entity_cap_of_a_tensor_batch_matches_the_numpy_cap(loader):
    """``learner.max_entities`` on a batch made on the device: capped where
    it lies, leaf for leaf what the host path gives for its numpy copy."""
    from distar_tpu_torch.learner.data import cap_entities_rl

    batch = next(loader)
    for n in (2, 3):
        got = flat(cap_entities_rl(batch, n))
        want = flat(cap_entities_rl(jax.tree.map(host, batch), n))
        assert sorted(got) == sorted(want)
        for path, w in want.items():
            g = got[path]
            assert isinstance(g, torch.Tensor) or path == "/model_last_iter", path
            np.testing.assert_array_equal(host(g), np.asarray(w), err_msg=path)


def test_learner_trains_on_anakin_batches(learner, loader):
    """Two optimizer steps of the port's RLLearner on windows of its own
    live model: finite losses, and the batch reaches the step as it is (no
    host round trip: ``to_device``, ``as_float32`` and the prefetcher's
    ``place_on`` hand device tensors through)."""
    from distar_tpu_torch.learner.data import as_float32
    from distar_tpu_torch.learner.prefetch import place_on
    from distar_tpu_torch.utils.transfer import to_device

    batch = next(loader)
    for move in (lambda b: to_device(as_float32(b), torch.device("cpu")),
                 lambda b: place_on(b, torch.device("cpu"))):
        moved = move({k: v for k, v in batch.items() if k != "model_last_iter"})
        assert all(a is b for a, b in zip(jax.tree.leaves(moved), jax.tree.leaves(
            {k: v for k, v in batch.items() if k != "model_last_iter"})))
    learner.set_dataloader(loader)
    learner.run(max_iterations=2)
    assert learner.last_iter.val == 2
    assert np.isfinite(learner.variable_record.get("total_loss").avg)
    assert np.isfinite(learner.last_log["total_loss"])


def test_window_is_device_pure(loader, monkeypatch):
    """The CPU witness: a whole window with Tensor.item, .cpu, .numpy and
    .tolist patched to raise runs through, and ``purity_report`` finds no
    host read; a planted read inside the window is reported."""
    runner = loader.runner
    carry = runner.init_carry()
    assert runner.purity_report(loader._model(), carry) == {"pure": True, "offending": []}
    with monkeypatch.context() as m:
        for name in ("item", "cpu", "numpy", "tolist"):
            m.setattr(torch.Tensor, name, lambda *a, _n=name, **k: (_ for _ in ()).throw(
                AssertionError(f"host read {_n} inside the window")))
        carry, batch = runner.rollout(loader._model(), carry)
    assert batch["done"].shape == (T, B)
    real = panakin.observe
    monkeypatch.setattr(panakin, "observe", lambda cfg, st, team: (st.t.sum().item(), real(cfg, st, team))[1])
    report = runner.purity_report(loader._model(), carry)
    assert report["pure"] is False and "item" in report["offending"]


def test_window_metrics(loader):
    """The loader's series, under the JAX package's names."""
    before = get_registry().snapshot().get("distar_anakin_batches_total", 0.0)
    for _ in range(4):  # 12 steps of 8-step episodes: some finish
        next(loader)
    snap = get_registry().snapshot()
    assert snap["distar_rollout_plane_backend{backend=anakin}"] == 1.0
    assert snap["distar_anakin_batches_total"] == before + 4
    assert snap["distar_anakin_env_steps_per_s"] > 0.0
    assert snap["distar_anakin_window_seconds_count"] >= 4
    assert snap["distar_env_episodes_total{backend=anakin}"] >= 1


def test_away_seat_loader_drains_results_and_trains(learner):
    """An away-seat loader (the frozen opponent: a copy of the initial
    policy) gives batches of the single-policy layout, its finished
    episodes drained once each, and the learner steps on them."""
    runner = P.AnakinRunner(learner.model, batch_size=B, unroll_len=T, env_cfg=P_ENV, scenario_cfg=P_SCN,
                            seed=4, opponent_seat=True)
    opp = P.AnakinDataLoader(runner, model_provider=lambda: learner.model)
    batch = next(opp)
    assert "match_result" not in batch and sorted(flat(batch)) == sorted(flat(fake_rl_batch(
        B, T, hidden_size=32, hidden_layers=1)))
    frozen = opp._opponent_model()
    assert frozen is not learner.model and not any(p.requires_grad for p in frozen.parameters())
    for _ in range(5):
        next(opp)
    results = opp.drain_results()
    assert results and {r["winner"] for r in results} <= {"home", "away", "draw"}
    assert all(r["steps"] >= 0 for r in results) and opp.drain_results() == []
    learner.set_dataloader(opp)
    learner.run(max_iterations=learner.last_iter.val + 1)
    assert np.isfinite(learner.last_log["total_loss"])


def test_away_seat_requires_the_opponent_model(loader):
    runner = loader.runner
    model = loader._model()
    with pytest.raises(ValueError, match="opponent_seat=True"):
        runner.rollout(model, runner.init_carry(), opponent_model=model)
    opp = P.AnakinRunner(model, batch_size=B, unroll_len=T, env_cfg=P_ENV, scenario_cfg=P_SCN,
                         opponent_seat=True)
    with pytest.raises(ValueError, match="needs opponent_model"):
        opp.rollout(model, opp.init_carry())


def test_failed_window_drops_the_carry():
    """A window that raises leaves no carry behind: the next call (a
    supervised restart) initialises anew."""
    from types import SimpleNamespace

    calls = {"init": 0}

    def init_carry():
        calls["init"] += 1
        return ("carry", calls["init"])

    def rollout(model, carry, opponent_model=None):
        raise RuntimeError("window failed")

    stub = SimpleNamespace(opponent_seat=False, init_carry=init_carry, rollout=rollout, B=1, T=1,
                           model=object())
    dl = P.AnakinDataLoader(stub)
    for n in (1, 2):
        with pytest.raises(RuntimeError):
            next(dl)
        assert dl._carry is None and calls["init"] == n

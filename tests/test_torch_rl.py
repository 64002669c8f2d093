"""The port's RL and distillation learners against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The JAX
package runs its 'xla' strings in the model; the port runs the kernel
overlay, whose wrappers take their plain versions on CPU tensors. The
weights are the port's seeded ``init_params``, carried to JAX by
``params_to_flax``: one JAX compile of each train step (with the forward's
outputs and the gradients in the same jit) for the module, no JAX init.

Tolerances, each with its reason:
* the return recursions, float32 atol 1e-6 (the same arithmetic per
  element; XLA may fuse a multiply-add); ``upgo_returns`` exactly on the
  same values (its >= comparison is taken on identical inputs); the
  stacked (field, head) recursions bit for bit against one pair at a time
  (the same operations on the same elements).
* the RL and distillation losses on the same logits and values, every info
  key rtol 1e-5 (f32 sums in another order); their gradients with respect
  to the logits and values rtol 1e-4 plus atol 1e-6 x the largest element
  (the same formula through another autodiff).
* ``rl_forward`` logits and values, atol 2e-4 / rtol 1e-3
  (tests/test_torch_model.py).
* the full steps: loss, info and grad_norm rtol 1e-4 (atol 1e-6 for terms
  near 0). Gradients: all together within 1e-4 of the JAX gradient's
  global norm; each leaf within rtol 1e-3 plus atol 2e-3 x its largest
  element plus 1e-7 x the global norm (tests/test_torch_train.py, whose
  docstring gives the reasons). New parameters where |g| is clear of the
  noise (above 1e-5 x the global norm and 1e-2 x the leaf's largest
  element), rtol 1e-5 / atol 1e-6: Adam's first update is about
  lr x sign(g). The steps run at learning rate 1e-3 (the RL default is
  1e-5) so that an update stands above a parameter's f32 rounding.
* the value-pretrain gate: the policy heads unchanged bit for bit, in both
  packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import SMALL_MODEL

from distar_tpu.learner import data as jdata
from distar_tpu.learner.distill_learner import make_distill_train_step as jax_distill_step
from distar_tpu.learner.rl_learner import make_rl_train_step as jax_rl_step
from distar_tpu.losses import DistillLossConfig as JDistillConfig
from distar_tpu.losses import ReinforcementLossConfig as JRLConfig
from distar_tpu.losses import compute_distill_loss as jax_distill_loss
from distar_tpu.losses import compute_rl_loss as jax_rl_loss
from distar_tpu.model import Model as JModel
from distar_tpu.model.config import default_model_config as jax_default_config
from distar_tpu.model.config import student_model_config as jax_student_config
from distar_tpu.ops import rl as jrl
from distar_tpu.parallel import GradClipConfig as JClipConfig
from distar_tpu.parallel import build_optimizer as jax_build_optimizer
from distar_tpu.utils import deep_merge_dicts as jax_merge
from distar_tpu_torch.actor.inference import to_device
from distar_tpu_torch.learner import (
    DistillLearner,
    FakeRLDataloader,
    RLLearner,
    cap_entities_rl,
    fake_rl_batch,
    rl_loss,
)
from distar_tpu_torch.learner import random_rl_batch as random_batch
from distar_tpu_torch.learner.rl_learner import flatten_time
from distar_tpu_torch.lib import features as F
from distar_tpu_torch.losses import DistillLossConfig, ReinforcementLossConfig, compute_distill_loss
from distar_tpu_torch.losses import compute_rl_loss
from distar_tpu_torch.losses.rl_loss import HEADS, pg_advantages, td_returns
from distar_tpu_torch.model import Model, default_model_config, init_params
from distar_tpu_torch.model.convert import flax_names, params_from_flax, params_to_flax
from distar_tpu_torch.ops import kernels
from distar_tpu_torch.ops import rl as trl
from distar_tpu_torch.utils import deep_merge_dicts

torch.set_num_threads(1)

TOL = dict(atol=2e-4, rtol=1e-3)
KERNEL_OVERLAY = {"encoder": {"entity": {"attention_impl": "pallas"}, "scatter": {"impl": "pallas"}}}
B, T = 2, 3  # trajectories x steps of the step tests
LR = 1e-3
H = SMALL_MODEL["encoder"]["core_lstm"]["hidden_size"]


def _np(t):
    return t.detach().float().numpy()


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if isinstance(v, dict) else {"/".join(prefix + (k,)): v})
    return out


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


# --------------------------------------------------- (a) return recursions
def _recursion_inputs(rng, Tn=7, Bn=5):
    r = (rng.integers(-1, 2, (Tn, Bn)) + 0.1 * rng.standard_normal((Tn, Bn))).astype(np.float32)
    v = rng.standard_normal((Tn + 1, Bn)).astype(np.float32)
    g = rng.uniform(0.9, 1.0, (Tn, Bn)).astype(np.float32)
    lam = rng.uniform(0.5, 1.0, (Tn, Bn)).astype(np.float32)
    rho = np.minimum(np.exp(rng.standard_normal((Tn, Bn))), 1.0).astype(np.float32)
    c = np.minimum(np.exp(rng.standard_normal((Tn, Bn))), 1.0).astype(np.float32)
    return r, v, g, lam, rho, c


def _both(fn_j, fn_t, *args, **kw):
    want = np.asarray(fn_j(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args], **kw))
    got = fn_t(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args], **kw)
    return _np(got), want


@pytest.mark.parametrize("case", ["scalars", "tensors"])
def test_lambda_returns_match_jax(rng, case):
    r, v, g, lam, _, _ = _recursion_inputs(rng)
    gam, lm = (0.997, 0.8) if case == "scalars" else (g, lam)
    got, want = _both(jrl.generalized_lambda_returns, trl.generalized_lambda_returns, r, gam, v, lm)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    got, want = _both(jrl.multistep_forward_view, trl.multistep_forward_view, r, g, v[1:], lam)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_td_lambda_loss_matches_jax(rng):
    r, v, _, _, _, _ = _recursion_inputs(rng)
    mask = (rng.random(r.shape) < 0.8).astype(np.float32)
    want, want_g = jax.value_and_grad(lambda x: jrl.td_lambda_loss(x, jnp.asarray(r), 1.0, 0.8,
                                                                    jnp.asarray(mask)))(jnp.asarray(v))
    tv = torch.from_numpy(v).requires_grad_()
    got = trl.td_lambda_loss(tv, torch.from_numpy(r), 1.0, 0.8, torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(_np(tv.grad), np.asarray(want_g), atol=1e-6)  # the targets detached


def test_upgo_returns_equal_jax(rng):
    r, v, _, _, _, _ = _recursion_inputs(rng)
    r = np.round(r)  # integer rewards: ties of r + V[t+1] with V[t] only where the values tie
    v[3, :2] = v[2, :2] - r[2, :2]  # exact ties: the trace continues on >=
    got, want = _both(jrl.upgo_returns, trl.upgo_returns, r, v)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["defaults", "pg_rhos_and_tensors"])
def test_vtrace_advantages_match_jax(rng, case):
    r, v, g, lam, rho, c = _recursion_inputs(rng)
    if case == "defaults":
        got, want = _both(jrl.vtrace_advantages, trl.vtrace_advantages, rho, c, r, v)
    else:
        pg = np.minimum(rho * 1.5, 1.0).astype(np.float32)
        want = np.asarray(jrl.vtrace_advantages(*map(jnp.asarray, (rho, c, r, v, pg)),
                                                gammas=jnp.asarray(g), lambda_=jnp.asarray(lam)))
        got = _np(trl.vtrace_advantages(*map(torch.from_numpy, (rho, c, r, v, pg)),
                                        gammas=torch.from_numpy(g), lambda_=torch.from_numpy(lam)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_stacked_recursions_equal_one_pair_at_a_time(rng):
    """The loss's one V-trace recursion over every (field, head) pair and
    its one lambda-return recursion over every field give each pair's
    per-pair recursion bit for bit."""
    Tn, Bn = 6, 3
    fields = ("winloss", "build_order", "battle")
    rhos = {h: torch.from_numpy(np.minimum(np.exp(rng.standard_normal((Tn, Bn))), 1.0).astype(np.float32))
            for h in HEADS}
    rewards = {f: torch.from_numpy(rng.integers(-1, 2, (Tn, Bn)).astype(np.float32)) for f in fields}
    values = {f: torch.from_numpy(rng.standard_normal((Tn + 1, Bn)).astype(np.float32)) for f in fields}
    cfg = ReinforcementLossConfig(vtrace_lambda=0.9)
    stacked = pg_advantages(rhos, rewards, values, fields, cfg)
    for f in fields:
        for h in HEADS:
            one = trl.vtrace_advantages(rhos[h], rhos[h], rewards[f], values[f], gammas=cfg.pg_gamma,
                                        lambda_=cfg.vtrace_lambda)
            assert torch.equal(stacked[f, h], one), (f, h)
    gammas = dict(cfg.gammas)
    stacked = td_returns(rewards, values, fields, gammas, 0.8)
    for f in fields:
        one = trl.generalized_lambda_returns(rewards[f], gammas[f], values[f], 0.8)
        assert torch.equal(stacked[f], one), f


# --------------------------------------------------------- (b) the losses
def _loss_inputs(rng, case, Tn=4, Bn=3, S=6, N=16):
    """RL-loss inputs at small widths: logits with -1e9 slots where the
    model masks, a teacher near-deterministic on the label slots."""
    widths = {"action_type": 327, "delay": 128, "queued": 2, "target_unit": N, "target_location": 320}
    def logit():
        out = {k: rng.standard_normal((Tn, Bn, w)).astype(np.float32) for k, w in widths.items()}
        out["selected_units"] = rng.standard_normal((Tn, Bn, S, N + 1)).astype(np.float32)
        return out

    target, teacher, successive = logit(), logit(), logit()
    target["selected_units"][..., N - 3:N] = -1e9  # slots the pointer mask removed
    target["selected_units"][:, :, S - 1] = -1e9  # an all-padded row: log_softmax is uniform
    sun = rng.integers(1, S, (Tn, Bn))
    actions = {k: rng.integers(0, w, (Tn, Bn)) for k, w in widths.items()}
    actions["selected_units"] = rng.integers(0, N - 3, (Tn, Bn, S))
    actions["target_unit"] = rng.integers(0, N - 3, (Tn, Bn))
    for k in ("selected_units", "target_unit"):
        onehot = np.eye(widths.get(k, N + 1), dtype=np.float32)[actions[k]]
        teacher[k] = 40.0 * onehot - 20.0
    behaviour = {k: -np.abs(rng.standard_normal((Tn, Bn) + ((S,) if k == "selected_units" else ())))
                 .astype(np.float32) for k in HEADS}
    masks = {
        "actions_mask": {k: (rng.random((Tn, Bn)) < 0.7).astype(np.float32) for k in HEADS},
        "selected_units_mask": np.arange(S)[None, None] < sun[..., None],
        "build_order_mask": (rng.random((Tn, Bn)) < 0.7).astype(np.float32),
        "built_unit_mask": np.ones((Tn, Bn), np.float32),
        "effect_mask": (rng.random((Tn, Bn)) < 0.5).astype(np.float32),
        "cum_action_mask": (rng.random((Tn, Bn)) < 0.7).astype(np.float32),
    }
    rewards = {f: rng.integers(-1, 2, (Tn, Bn)).astype(np.float32) for f in jdata.RL_REWARD_FIELDS}
    values = {f: rng.standard_normal((Tn + 1, Bn)).astype(np.float32) for f in jdata.RL_REWARD_FIELDS}
    inputs = {"target_logit": target, "value": values, "action_log_prob": behaviour,
              "teacher_logit": teacher, "action": actions, "reward": rewards,
              "step": rng.integers(0, 5000, (Tn, Bn)).astype(np.float32), "mask": masks,
              "entity_num": rng.integers(8, N + 1, (Tn, Bn)), "selected_units_num": sun}
    if case == "pad_steps":
        # trajectory 0 ends at step 1 mid-window, pad steps after it
        done = np.zeros((Tn, Bn), np.float32)
        done[1:, 0] = 1.0
        step_mask = np.ones((Tn, Bn), np.float32)
        step_mask[2:, 0] = 0.0
        step_mask[-1, 1] = 0.0  # a zeroed tail
        inputs["done"], masks["step_mask"] = done, step_mask
    elif case == "dapo":
        inputs["successive_logit"] = successive
    return inputs


LOSS_CASES = {"defaults": {}, "dapo": dict(use_dapo=True, dapo_weight=0.5),
              "pad_steps": dict(pg_weights=(("winloss", 1.0), ("build_order", 0.3), ("built_unit", 0.0),
                                            ("effect", 0.2), ("upgrade", 0.1), ("battle", 0.0)),
                                baseline_weights=(("winloss", 10.0), ("build_order", 0.0),
                                                  ("built_unit", 0.5), ("effect", 0.0), ("upgrade", 0.0),
                                                  ("battle", 1.0)),
                                entropy_weight=0.1)}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_compute_rl_loss_matches_jax(rng, case):
    inputs = _loss_inputs(rng, case)
    jcfg, tcfg = JRLConfig(**LOSS_CASES[case]), ReinforcementLossConfig(**LOSS_CASES[case])
    diff = ("target_logit", "value")

    def jloss(d):
        return jax_rl_loss({**_j(inputs), **d}, jcfg)

    (want_total, want), want_g = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        _j({k: inputs[k] for k in diff}))
    tin = to_device(inputs, "cpu")
    leaves = {k: {f: t.requires_grad_() for f, t in tin[k].items()} for k in diff}
    got_total, got = compute_rl_loss({**tin, **leaves}, tcfg)
    got_total.backward()
    assert set(got) == set(want) and len(got) > 55
    np.testing.assert_allclose(float(got_total.detach()), float(want_total), rtol=1e-5)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    for k in diff:
        for f, t in leaves[k].items():
            w = np.asarray(want_g[k][f])
            np.testing.assert_allclose(_np(t.grad), w, rtol=1e-4, atol=1e-6 * np.abs(w).max() + 1e-9,
                                       err_msg=f"d {k}/{f}")


@pytest.mark.parametrize("temperature", [1.0, 2.0])
def test_compute_distill_loss_matches_jax(rng, temperature):
    inputs = _loss_inputs(rng, "pad_steps")
    d = {"student_logit": inputs["target_logit"], "teacher_logit": inputs["teacher_logit"],
         "mask": inputs["mask"]}
    (want_total, want), want_g = jax.value_and_grad(
        lambda s: jax_distill_loss({**_j(d), "student_logit": s}, JDistillConfig(temperature=temperature)),
        has_aux=True)(_j(d["student_logit"]))
    td = to_device(d, "cpu")
    for t in td["student_logit"].values():
        t.requires_grad_()
    got_total, got = compute_distill_loss(td, DistillLossConfig(temperature=temperature))
    got_total.backward()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-5, err_msg=k)
    for k, t in td["student_logit"].items():
        w = np.asarray(want_g[k])
        np.testing.assert_allclose(_np(t.grad), w, rtol=1e-4, atol=1e-6 * np.abs(w).max(), err_msg=k)


# ---------------------------------------------------------- (c) batches
def random_rl_batch(rng, value_feature=False, hidden_size=H, hidden_layers=1):
    """The package's ``random_rl_batch`` at B x T with a random initial state."""
    batch = random_batch(B, T, rng, hidden_size, hidden_layers, use_value_feature=value_feature)
    batch["hidden_state"] = tuple((rng.standard_normal((B, hidden_size)).astype(np.float32),
                                   rng.standard_normal((B, hidden_size)).astype(np.float32))
                                  for _ in range(hidden_layers))
    return batch


@pytest.mark.parametrize("value_feature", [False, True])
def test_fake_rl_batch_has_the_jax_schema_and_draws(value_feature):
    want = jdata.fake_rl_batch(2, 3, np.random.default_rng(5), 16, 2, use_value_feature=value_feature)
    got = fake_rl_batch(2, 3, np.random.default_rng(5), 16, 2, use_value_feature=value_feature)
    flat_w = _flat({k: v for k, v in want.items() if k != "hidden_state"})
    flat_g = _flat({k: v for k, v in got.items() if k != "hidden_state"})
    assert set(flat_g) == set(flat_w)
    for k, w in flat_w.items():
        assert flat_g[k].shape == w.shape and flat_g[k].dtype == w.dtype, k
        np.testing.assert_array_equal(flat_g[k], w, err_msg=k)
    for (gh, gc), (wh, wc) in zip(got["hidden_state"], want["hidden_state"], strict=True):
        assert gh.shape == wh.shape == (2, 16) and not gh.any() and not gc.any()
    loader = FakeRLDataloader(2, 3, 16, 2, seed=5, use_value_feature=value_feature)
    np.testing.assert_array_equal(next(loader)["reward"]["winloss"], want["reward"]["winloss"])


def test_cap_entities_rl_is_bit_equal_to_jax():
    batch = jdata.fake_rl_batch(2, 3, np.random.default_rng(6), 16, 1)
    n = 40
    ai = batch["action_info"]
    batch["entity_num"][0, :] = [30, 300]  # step 0, trajectory 1 overflows
    batch["entity_num"][1, 0] = 45  # overflow
    for b in range(2):
        ai["selected_units"][0, b, batch["selected_units_num"][0, b] - 1] = batch["entity_num"][0, b]
    ai["selected_units"][1, 1, 0] = 100  # an out-of-range lane
    ai["target_unit"][2] = [5, 60]
    batch["successive_logit"] = {k: v.copy() for k, v in batch["teacher_logit"].items()}
    want = jdata.cap_entities_rl(batch, n)
    got = cap_entities_rl(batch, n)
    assert got["hidden_state"] is want["hidden_state"] is batch["hidden_state"]
    want, got = (_flat({k: v for k, v in b.items() if k != "hidden_state"}) for b in (want, got))
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert got["entity_num"].max() == n and got["mask/actions_mask/selected_units"][0, 1] == 0
    assert got["teacher_logit/selected_units"].shape[-1] == n + 1


# --------------------------------------------------------- (d) the model
@pytest.mark.parametrize("atan", [False, True])
def test_value_baseline_matches_jax(rng, atan):
    """One tower from the JAX tower's own init (its last Dense at variance
    0.01 / fan_in), and the port's init of that Dense at the same scale."""
    from distar_tpu.model.value import ValueBaseline as JValueBaseline
    from distar_tpu_torch.model.value import ValueBaseline

    x = rng.standard_normal((6, 24)).astype(np.float32)
    jm, tm = JValueBaseline(res_dim=256, res_num=2, atan=atan), ValueBaseline(24, 256, 2, atan)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params), tm))
    got = tm(torch.from_numpy(x))
    assert got.shape == (6,) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(jm.apply(params, jnp.asarray(x))), atol=2e-5, rtol=2e-5)
    init_params(tm, 0)
    for w in (tm.Dense_0.weight.detach().numpy(), np.asarray(params["params"]["Dense_0"]["kernel"])):
        std = (0.01 / 256) ** 0.5
        assert abs(w.std() / std - 1) < 0.2 and np.abs(w).max() <= 2 * std / 0.8796


def _rl_cfg(value_feature, lib="port"):
    over = {"use_value_network": True, "use_value_feature": value_feature}
    if lib == "port":
        return deep_merge_dicts(deep_merge_dicts(deep_merge_dicts(default_model_config(), SMALL_MODEL),
                                                 KERNEL_OVERLAY), over)
    return jax_merge(jax_merge(jax_default_config(), SMALL_MODEL), over)


def test_model_without_towers_or_value_feature_raises():
    model = Model(deep_merge_dicts(default_model_config(), SMALL_MODEL))
    assert not any(n.startswith("value_") for n, _ in model.named_parameters())
    batch = to_device(fake_rl_batch(B, T, np.random.default_rng(1), H, 1), "cpu")
    with pytest.raises(ValueError, match="use_value_network"):
        rl_loss(model, ReinforcementLossConfig(), batch, B, T)
    with pytest.raises(ValueError, match="value_feature"):
        rl_loss(Model(_rl_cfg(True)), ReinforcementLossConfig(), batch, B, T)


@pytest.mark.parametrize("value_feature", [False, True])
def test_param_bridge_carries_towers_and_value_encoder(value_feature):
    """A JAX RL model's params fill every port parameter, each leaf used
    once; the port's go back to the same tree."""
    jm = JModel(_rl_cfg(value_feature, "jax"))
    jb = _j(fake_rl_batch(B, 1, np.random.default_rng(2), H, 1, use_value_feature=value_feature))
    flat = lambda t: jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:]), t)  # noqa: E731
    params = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), flat(jb["spatial_info"]), flat(jb["entity_info"]), flat(jb["scalar_info"]),
        jb["entity_num"].reshape(-1), jb["hidden_state"], jb["action_info"], jb["selected_units_num"], B, 1,
        value_feature=flat(jb["value_feature"]) if value_feature else None, method=jm.rl_forward))
    params = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), params)
    model = Model(_rl_cfg(value_feature))
    state = params_from_flax(params, model)  # raises unless every leaf and parameter match
    towers = {k.split(".")[0] for k in state if k.startswith("value_")}
    want = {f"value_{f}" for f in jdata.RL_REWARD_FIELDS} | ({"value_encoder"} if value_feature else set())
    assert towers == want
    init_params(model, 3)
    back = params_from_flax(params_to_flax(model), model)
    leaves = _flat(params_to_flax(model)["params"])
    assert sorted("params/" + k for k in leaves) == sorted(flax_names(model).values())
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k


@pytest.fixture(scope="module")
def rl_run():
    """The JAX RL step (``make_rl_train_step``, adam betas (0, 0.99), eps
    1e-5, global-norm clip 10) with its gradients and ``rl_forward``'s
    outputs in one jit, ungated and gated, from the port learner's seeded
    weights, on one random batch; the port's learners from the same seed."""
    rng = np.random.default_rng(11)
    batch = random_rl_batch(rng)
    learners = {gate: RLLearner({"learner": {"batch_size": B, "unroll_len": T, "learning_rate": LR,
                                             "value_pretrain_iters": gate},
                                 "model": deep_merge_dicts(SMALL_MODEL, KERNEL_OVERLAY)}, device="cpu")
                for gate in (-1, 1)}
    params = _j(params_to_flax(learners[-1].model))
    jm = JModel(_rl_cfg(False, "jax"))
    opt = jax_build_optimizer(LR, (0.0, 0.99), 1e-5, 0.0, JClipConfig("norm", 10.0))
    step = jax_rl_step(jm, JRLConfig(), opt, B, T)

    def forward(p, b):
        flat = lambda t: jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:]), t)  # noqa: E731
        return jm.apply(p, flat(b["spatial_info"]), flat(b["entity_info"]), flat(b["scalar_info"]),
                        b["entity_num"].reshape(-1), b["hidden_state"], b["action_info"],
                        b["selected_units_num"], B, T, method=jm.rl_forward)

    def loss_fn(p, b, gate):
        out = forward(p, b)
        inputs = {"target_logit": out["target_logit"], "value": out["value"],
                  "action_log_prob": b["behaviour_logp"], "teacher_logit": b["teacher_logit"],
                  "action": b["action_info"], "reward": b["reward"], "step": b["step"], "done": b["done"],
                  "mask": b["mask"], "entity_num": b["entity_num"].reshape(-1, B)[:T],
                  "selected_units_num": b["selected_units_num"]}
        total, info = jax_rl_loss(inputs, JRLConfig())
        return jnp.where(gate, info["td/total"], total)

    both = jax.jit(lambda p, b, gate: (step(p, opt.init(p), b, gate), jax.grad(loss_fn)(p, b, gate),
                                       forward(p, b)))
    jb = _j({k: v for k, v in batch.items() if k != "model_last_iter"})
    runs = {}
    for gate in (False, True):
        (new, _, info), grads, out = both(params, jb, jnp.asarray(gate))
        runs[gate] = dict(params=jax.tree.map(np.asarray, new), info=jax.tree.map(float, info),
                          grads=jax.tree.map(np.asarray, grads), out=jax.tree.map(np.asarray, out))
    return dict(batch=batch, runs=runs, params=jax.tree.map(np.asarray, params), learners=learners)


@pytest.mark.parametrize("head", F.ACTION_HEADS)
def test_rl_forward_logits_match_jax(rl_run, head):
    model = Model(_rl_cfg(False))
    model.load_state_dict(params_from_flax(rl_run["params"], model))
    tb = to_device({k: v for k, v in rl_run["batch"].items() if k != "model_last_iter"}, "cpu")
    with torch.no_grad():
        got = model.rl_forward(flatten_time(tb["spatial_info"]), flatten_time(tb["entity_info"]),
                               flatten_time(tb["scalar_info"]), tb["entity_num"].reshape(-1),
                               tb["hidden_state"], tb["action_info"], tb["selected_units_num"], B, T)
        pol = model.policy_forward(flatten_time(tb["spatial_info"]), flatten_time(tb["entity_info"]),
                                   flatten_time(tb["scalar_info"]), tb["entity_num"].reshape(-1),
                                   tb["hidden_state"], tb["action_info"], tb["selected_units_num"], B, T)
    want = rl_run["runs"][False]["out"]
    assert got["target_logit"][head].shape[:2] == (T, B)
    np.testing.assert_allclose(_np(got["target_logit"][head]), want["target_logit"][head], **TOL)
    assert torch.equal(pol["target_logit"][head], got["target_logit"][head])
    if head == "action_type":  # the six towers, once
        for f in jdata.RL_REWARD_FIELDS:
            assert got["value"][f].shape == (T + 1, B) and got["value"][f].dtype == torch.float32
            np.testing.assert_allclose(_np(got["value"][f]), want["value"][f], **TOL, err_msg=f)
        assert float(got["value"]["winloss"].abs().max()) < 0.2  # the towers start near 0


def test_rl_forward_with_value_feature_matches_jax():
    """The centralized critic: the value encoder's scatter, convs and
    build-order transformer feed the towers with the LSTM output and the
    baseline feature."""
    rng = np.random.default_rng(12)
    batch = random_rl_batch(rng, value_feature=True)
    model = Model(_rl_cfg(True))
    init_params(model, 5)
    jm = JModel(_rl_cfg(True, "jax"))
    jb = _j({k: v for k, v in batch.items() if k != "model_last_iter"})
    flat = lambda t: jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:]), t)  # noqa: E731
    want = jax.jit(lambda p, jb: jm.apply(
        p, flat(jb["spatial_info"]), flat(jb["entity_info"]), flat(jb["scalar_info"]),
        jb["entity_num"].reshape(-1), jb["hidden_state"], jb["action_info"], jb["selected_units_num"], B, T,
        value_feature=flat(jb["value_feature"]), method=jm.rl_forward))(_j(params_to_flax(model)), jb)
    tb = to_device({k: v for k, v in batch.items() if k != "model_last_iter"}, "cpu")
    with torch.no_grad():
        got = model.rl_forward(flatten_time(tb["spatial_info"]), flatten_time(tb["entity_info"]),
                               flatten_time(tb["scalar_info"]), tb["entity_num"].reshape(-1),
                               tb["hidden_state"], tb["action_info"], tb["selected_units_num"], B, T,
                               value_feature=flatten_time(tb["value_feature"]))
    for f in jdata.RL_REWARD_FIELDS:
        np.testing.assert_allclose(_np(got["value"][f]), np.asarray(want["value"][f]), **TOL, err_msg=f)
    np.testing.assert_allclose(_np(got["target_logit"]["action_type"]),
                               np.asarray(want["target_logit"]["action_type"]), **TOL)


# ------------------------------------------------------------ (e) RL step
@pytest.fixture(scope="module")
def port_rl_steps(rl_run):
    """The port's gradient on the batch, then one learner step each, ungated
    and gated (``value_pretrain_iters=1``)."""
    out = {}
    for gate, learner in rl_run["learners"].items():
        before = {n: p.detach().clone() for n, p in learner.model.named_parameters()}
        tb = to_device({k: v for k, v in rl_run["batch"].items() if k != "model_last_iter"}, "cpu")
        total, info = rl_loss(learner.model, learner.loss_cfg, tb, B, T)
        loss = info["td/total"] if gate == 1 else total
        names = [n for n, _ in learner.model.named_parameters()]
        grads = dict(zip(names, torch.autograd.grad(loss, list(learner.model.parameters()),
                                                     allow_unused=True, materialize_grads=True)))
        log = learner._train(rl_run["batch"])
        out[gate == 1] = dict(log=log, grads=grads, before=before,
                              after={n: p.detach().clone() for n, p in learner.model.named_parameters()})
    return out


@pytest.mark.parametrize("gated", [False, True])
def test_rl_step_loss_info_and_grad_norm_match_jax(rl_run, port_rl_steps, gated):
    want, got = rl_run["runs"][gated]["info"], port_rl_steps[gated]["log"]
    assert set(want) | {"staleness/mean", "staleness/max", "staleness/std"} == set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("gated", [False, True])
def test_rl_step_gradients_match_jax(rl_run, port_rl_steps, gated):
    model = rl_run["learners"][-1].model
    want = _flat(rl_run["runs"][gated]["grads"]["params"])
    got = _flat(params_to_flax(model, port_rl_steps[gated]["grads"])["params"])
    assert set(got) == set(want)
    norm = rl_run["runs"][gated]["info"]["grad_norm"]
    err = sum(float(((got[k] - w).astype(np.float64) ** 2).sum()) for k, w in want.items()) ** 0.5
    assert err <= 1e-4 * norm
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-3, atol=2e-3 * float(np.abs(w).max()) + 1e-7 * norm,
                                   err_msg=k)


@pytest.mark.parametrize("gated", [False, True])
def test_rl_step_new_params_match_jax_where_the_gradient_is_clear(rl_run, port_rl_steps, gated):
    model = rl_run["learners"][-1].model
    new = _flat(params_to_flax(model, port_rl_steps[gated]["after"])["params"])
    want = _flat(rl_run["runs"][gated]["params"]["params"])
    grads = _flat(rl_run["runs"][gated]["grads"]["params"])
    old = _flat(rl_run["params"]["params"])
    norm = rl_run["runs"][gated]["info"]["grad_norm"]
    compared = 0
    for k, w in want.items():
        clear = (np.abs(grads[k]) > 1e-2 * np.abs(grads[k]).max()) & (np.abs(grads[k]) > 1e-5 * norm)
        np.testing.assert_allclose(new[k][clear], w[clear], rtol=1e-5, atol=1e-6, err_msg=k)
        assert np.abs(new[k] - old[k]).max() <= 1.01 * LR  # Adam's first step: lr at most
        compared += int(clear.sum())
    assert compared > 0.1 * sum(g.size for g in grads.values())


def test_value_pretrain_gate_moves_only_the_critic(rl_run, port_rl_steps):
    """With the gate on only ``td/total``'s gradient flows: the policy heads
    stay bit-equal in both packages, the winloss tower (weight 10) moves, the
    towers of weight 0 do not."""
    run = port_rl_steps[True]
    old = _flat(rl_run["params"]["params"])
    want = _flat(rl_run["runs"][True]["params"]["params"])
    for name, p in run["after"].items():
        if name.startswith("policy."):
            assert torch.equal(p, run["before"][name]), name
    for k, w in want.items():
        if k.startswith("policy/") or k.startswith("value_battle/"):
            np.testing.assert_array_equal(w, old[k], err_msg=k)
    tower = "value_winloss.Dense_0.weight"
    assert not torch.equal(run["after"][tower], run["before"][tower])
    ungated = port_rl_steps[False]
    assert any(not torch.equal(ungated["after"][n], ungated["before"][n]) for n in run["after"]
               if n.startswith("policy."))


def test_rl_step_save_grad_names_are_the_jax_learners(rl_run):
    learner = RLLearner({"learner": {"batch_size": B, "unroll_len": T, "save_grad": True},
                         "model": SMALL_MODEL}, device="cpu")
    log = learner._train(rl_run["batch"])
    names = set(flax_names(learner.model).values())
    assert any(n.startswith("params/value_winloss/ResFCBlock2_0/") for n in names)
    assert {k for k in log if k.startswith("grad_norm/")} == {f"grad_norm/{n}" for n in names}
    assert {k for k in log if k.startswith("param_norm/")} == {f"param_norm/{n}" for n in names}
    np.testing.assert_allclose(sum(v ** 2 for k, v in log.items() if k.startswith("grad_norm/")) ** 0.5,
                               log["grad_norm"], rtol=1e-5)


# ------------------------------------------------------ (f) distillation
def test_distill_step_matches_jax():
    """One student step from the same weights: loss, info, grad_norm and,
    where the gradient is clear, the new parameters (adam betas (0.9, 0.99),
    eps 1e-5, lr 1e-3, global-norm clip 10, the distillation defaults)."""
    rng = np.random.default_rng(13)
    learner = DistillLearner({"learner": {"batch_size": B, "unroll_len": T},
                              "model": deep_merge_dicts(SMALL_MODEL, KERNEL_OVERLAY)}, device="cpu")
    batch = random_rl_batch(rng)  # the teacher's carry dims: the student ignores them
    params = _j(params_to_flax(learner.model))
    jcfg = jax_student_config(SMALL_MODEL)
    jcfg.use_value_network = False
    jm = JModel(jcfg)
    core = jcfg.encoder.core_lstm
    opt = jax_build_optimizer(1e-3, (0.9, 0.99), 1e-5, 0.0, JClipConfig("norm", 10.0))
    step = jax_distill_step(jm, JDistillConfig(), opt, B, T, core.hidden_size, core.num_layers)
    jb = _j({k: v for k, v in learner._strip_batch(batch).items() if k != "model_last_iter"})
    new, _, want = jax.jit(step)(params, opt.init(params), jb)
    before = {n: p.detach().clone() for n, p in learner.model.named_parameters()}
    got = learner._train(batch)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    new = _flat(jax.tree.map(np.asarray, new)["params"])
    mine = _flat(params_to_flax(learner.model)["params"])
    old = _flat(params_to_flax(learner.model, before)["params"])
    moved = 0
    for k, w in new.items():
        # Adam's first update is g / (|g| + eps) x lr: a move of 0.99 lr or more
        # is a gradient of 100 eps or more, clear of the noise
        clear = np.abs(w - old[k]) > 0.99 * 1e-3
        np.testing.assert_allclose(mine[k][clear], w[clear], rtol=1e-5, atol=1e-6, err_msg=k)
        moved += int(clear.sum())
    assert moved > 0.1 * sum(w.size for w in new.values())


# ---------------------------------------------------------- (g) learners
def test_learners_run_two_steps_on_the_cpu():
    rl = RLLearner({"learner": {"batch_size": B, "unroll_len": T, "log_freq": 1},
                    "model": {**SMALL_MODEL, "use_value_feature": True}}, device="cpu")
    rl.run(2)
    assert rl.last_iter == 2 and np.isfinite(rl.last_log["total_loss"])
    assert rl.last_log["staleness/mean"] == 1.0  # model_last_iter 0 at learner iteration 1
    st = DistillLearner({"learner": {"batch_size": B, "unroll_len": T}, "model": SMALL_MODEL}, device="cpu")
    st.run(2)
    assert st.last_iter == 2 and np.isfinite(st.last_log["divergence"])
    assert not any(n.startswith("value_") for n, _ in st.model.named_parameters())


def test_rl_learner_admin_requests(rl_run):
    """A config patch rebuilds the optimizer (its state from zero); a value
    reset draws only the towers and the value encoder anew."""
    learner = RLLearner({"learner": {"batch_size": B, "unroll_len": T},
                         "model": {**SMALL_MODEL, "use_value_feature": True}}, device="cpu")
    learner._train(next(learner._dataloader))
    assert learner.optimizer.count == 1
    learner.request_update_config({"learner": {"learning_rate": 3e-4}})
    before = {n: p.detach().clone() for n, p in learner.model.named_parameters()}
    learner.request_value_reset()
    learner._apply_admin_requests()
    assert learner.optimizer.count == 0 and learner.optimizer.learning_rate == 3e-4
    changed = {n for n, p in learner.model.named_parameters() if not torch.equal(p, before[n])}
    assert changed and all(n.startswith("value_") for n in changed)
    assert any(n.startswith("value_encoder.") for n in changed)
    assert learner.optimizer.params[0] is next(learner.model.parameters())
    assert np.isfinite(learner._train(next(learner._dataloader))["total_loss"])


@pytest.mark.parametrize("cls", [RLLearner, DistillLearner])
def test_learners_need_cuda_unless_told_cpu(monkeypatch, cls):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cls({"learner": {"batch_size": B, "unroll_len": T}, "model": SMALL_MODEL})


@pytest.mark.parametrize("cls,call,item", [
    (RLLearner, lambda lrn: lrn.attach_comm(None, "MP0"), "item 5"),
    (RLLearner, lambda lrn: lrn.shard_batch({}), "item 7"),
    (RLLearner, lambda lrn: lrn.request_save(), "item 4"),
    (RLLearner, lambda lrn: lrn.save("x.ckpt"), "item 4"),
    (DistillLearner, lambda lrn: lrn.save(lrn.checkpoint_path()), "item 4"),
])
def test_learner_parts_not_ported_raise(cls, call, item):
    learner = cls({"learner": {"batch_size": B, "unroll_len": T}, "model": SMALL_MODEL}, device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        call(learner)


@pytest.mark.parametrize("cls,learner_cfg,item", [
    (RLLearner, {"dynamics": {"every_n": 10}}, "item 9"),
    (DistillLearner, {"teacher_flops_per_step": 1e12}, "item 9"),
])
def test_learner_options_not_ported_raise(cls, learner_cfg, item):
    with pytest.raises(NotImplementedError, match=item):
        cls({"learner": {"batch_size": B, "unroll_len": T, **learner_cfg}, "model": SMALL_MODEL},
            device="cpu")


def test_kernel_launch_counts_stay_zero_on_the_cpu(rl_run):
    learner = RLLearner({"learner": {"batch_size": B, "unroll_len": T},
                         "model": deep_merge_dicts(SMALL_MODEL, KERNEL_OVERLAY)}, device="cpu")
    kernels.reset_launch_counts()
    learner._train(rl_run["batch"])
    assert all(n == 0 for n in kernels.launch_counts.values())

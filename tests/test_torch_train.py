"""The port's SL train step against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The JAX
package runs its Pallas kernels in interpret mode (the kernel backward
tests) and its 'xla' strings in the model (Pallas interpret at model scale
is kept out of the tier-1 budget, as in tests/test_torch_model.py); the
port runs the kernel overlay, whose wrappers take their plain versions on
CPU tensors and their JAX-formula backward passes. The weights are the
port's seeded ``init_params``, carried to JAX by ``params_to_flax``: one
JAX compile of the train step for the module, no JAX init.

Tolerances, each with its reason:
* kernel backward, float32 atol/rtol 2e-5 (tests/test_pallas_kernels.py's
  precedent); bfloat16 1e-2 (both compute in f32 and round once, so one
  bf16 ulp, 2^-8 relative); scatter gradients bit for bit (a gather).
* logits and LSTM state, atol 2e-4 / rtol 1e-3 (tests/test_torch_model.py).
* loss and info on the same logits, rtol 1e-5 (f32 sums in another order).
* the optimizer on the same gradients, rtol 1e-5 (f32 rounding of the same
  formula; ``b^n`` and the schedule in double here, in f32 in optax).
* the full step: loss, info and grad_norm rtol 1e-4. Gradients: all of
  them together within 1e-4 of the JAX gradient's global norm; each leaf
  within rtol 1e-3 plus atol 2e-3 x its largest element plus 1e-7 x the
  global norm. The per-leaf slack is for the build-order transformer's
  deepest leaves (measured 1.2e-3 of their largest element; that encoder
  alone matches JAX to 7e-7 on the same upstream gradient, so the
  difference is the upstream's, at the forward's 1e-4 level, summed
  through four layers); the global floor is for leaves whose true gradient
  is 0 (a bias that shifts every logit alike) and both packages give
  noise. New parameters only where |g| exceeds 1e-5 x the global norm and
  1e-2 x the leaf's largest gradient: from zero moments Adam's first update
  is about lr * sign(g) whatever |g|, so a gradient element at the noise
  floor can flip sign between the packages and move its parameter 2 lr.
* three steps with the carried state: losses rtol 1e-3.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from conftest import SMALL_MODEL

from distar_tpu.learner import data as jdata
from distar_tpu.learner.sl_learner import make_sl_train_step as jax_train_step
from distar_tpu.obs.dynamics import tree_spec as jax_tree_spec
from distar_tpu.losses import SupervisedLossConfig as JLossConfig
from distar_tpu.losses import compute_sl_loss as jax_sl_loss
from distar_tpu.model import Model as JModel
from distar_tpu.model.config import default_model_config as jax_default_config
from distar_tpu.ops.pallas_kernels import (
    masked_attention as pallas_attention,
    scatter_add_connection as pallas_scatter,
    scatter_add_onehot as pallas_onehot,
)
from distar_tpu.parallel import GradClipConfig as JClipConfig
from distar_tpu.parallel import build_optimizer as jax_build_optimizer
from distar_tpu.utils import deep_merge_dicts as jax_merge
from distar_tpu_torch.actor.inference import to_device
from distar_tpu_torch.bin import sl_train
from distar_tpu_torch.learner import SLLearner, cap_entities, fake_sl_batch, random_sl_batch, sl_loss
from distar_tpu_torch.lib import features as F
from distar_tpu_torch.losses import SupervisedLossConfig, compute_sl_loss
from distar_tpu_torch.model import Model, default_model_config, init_params
from distar_tpu_torch.model.convert import flax_names, params_from_flax, params_to_flax
from distar_tpu_torch.ops import kernels
from distar_tpu_torch.parallel import GradClipConfig, build_optimizer
from distar_tpu_torch.utils import deep_merge_dicts

torch.set_num_threads(1)

KTOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": dict(atol=1e-2, rtol=1e-2)}
TOL = dict(atol=2e-4, rtol=1e-3)
KERNEL_OVERLAY = {"encoder": {"entity": {"attention_impl": "pallas"}, "scatter": {"impl": "pallas"}}}
B, T = 2, 3  # trajectories x steps of the SL step tests


def _np(t):
    return t.detach().float().numpy()


# ------------------------------------------------------- (a) kernel backward
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_attention_backward_matches_jax_vjp(rng, dtype):
    """[2, 2, 16, 8] with one sample whose keys are all masked (its rows are
    mean(V)); the upstream gradient arrives strided."""
    Bq, H, N, Dh = 2, 2, 16, 8
    q, k, v = (rng.standard_normal((Bq, H, N, Dh)).astype(np.float32) for _ in range(3))
    w = rng.standard_normal((Bq, H, Dh, N)).astype(np.float32)
    mask = np.arange(N)[None, :] < np.array([0, 9])[:, None]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(t, jd) for t in (q, k, v))
    out, vjp = jax.vjp(lambda a, b, c: pallas_attention(a, b, c, jnp.asarray(mask), interpret=True),
                       jq, jk, jv)
    want = vjp(jnp.swapaxes(jnp.asarray(w, jd), -1, -2))
    tq, tk, tv = (torch.from_numpy(t).to(td).requires_grad_() for t in (q, k, v))
    kernels.reset_launch_counts()
    got = kernels.masked_attention(tq, tk, tv, torch.from_numpy(mask))
    assert type(got.grad_fn).__name__ == "_MaskedAttentionBackward"
    (got.transpose(-1, -2) * torch.from_numpy(w).to(td)).sum().backward()  # a strided dout
    assert kernels.launch_counts["masked_attention"] == 0  # plain version on the CPU
    np.testing.assert_allclose(_np(got), np.asarray(out, np.float32), **KTOL[dtype])
    for t, g in zip((tq, tk, tv), want):
        assert t.grad.dtype == td
        np.testing.assert_allclose(_np(t.grad), np.asarray(g, np.float32), **KTOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["scatter_add_connection", "scatter_add_onehot"])
def test_scatter_backward_matches_jax_vjp(rng, kernel, dtype):
    """Collisions and out-of-range indices (clipped to the edge cells): the
    gradient is the output gradient gathered at the clipped cells."""
    Bs, N, D, hw = 2, 24, 8, 63
    emb = rng.standard_normal((Bs, N, D)).astype(np.float32)
    idx = rng.integers(0, hw, (Bs, N)).astype(np.int32)
    idx[0, :4] = idx[0, 0]
    idx[:, 4], idx[:, 5] = -2, hw + 5
    dout = rng.standard_normal((Bs, hw, D)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    pallas = pallas_onehot if kernel == "scatter_add_onehot" else pallas_scatter
    _, vjp = jax.vjp(lambda e: pallas(e, jnp.asarray(idx), hw, interpret=True), jnp.asarray(emb, jd))
    (want,) = vjp(jnp.asarray(dout, jd))
    te = torch.from_numpy(emb).to(td).requires_grad_()
    getattr(kernels, kernel)(te, torch.from_numpy(idx), hw).backward(torch.from_numpy(dout).to(td))
    assert te.grad.dtype == td
    np.testing.assert_array_equal(_np(te.grad), np.asarray(want, np.float32))


def test_wrappers_skip_the_function_without_a_gradient(rng):
    q = torch.from_numpy(rng.standard_normal((1, 2, 8, 4)).astype(np.float32)).requires_grad_()
    mask = torch.ones(1, 8, dtype=torch.bool)
    with torch.no_grad():
        assert kernels.masked_attention(q, q, q, mask).grad_fn is None
    emb = torch.zeros(1, 8, 2)  # no requires_grad
    assert kernels.scatter_add_onehot(emb, torch.zeros(1, 8, dtype=torch.long), 9).grad_fn is None


# ----------------------------------------------------------- shared inputs
def port_learner(overlay=KERNEL_OVERLAY, **learner_cfg):
    return SLLearner({"learner": {"batch_size": B, "unroll_len": T, **learner_cfg},
                      "model": deep_merge_dicts(SMALL_MODEL, overlay)}, device="cpu")


def _strip(batch):
    return {k: v for k, v in batch.items() if k not in ("new_episodes", "traj_lens")}


def _jax_loss_fn(jm, batch_size):
    def loss_fn(p, b, h):
        logits, _ = jm.apply(p, b["spatial_info"], b["entity_info"], b["scalar_info"],
                             b["entity_num"], b["action_info"], b["selected_units_num"], h,
                             batch_size, method=jm.sl_forward)
        return jax_sl_loss(logits, b["action_info"], b["action_mask"], b["selected_units_num"],
                           b["entity_num"], JLossConfig())[0]
    return loss_fn


@pytest.fixture(scope="module")
def jax_run():
    """The JAX step (``make_sl_train_step`` with the SL learner's optimizer:
    adamw 1e-3, betas (0.9, 0.999), eps 1e-8, wd 1e-5, global-norm clip 1.0)
    and its gradients, in one jit, run for 3 steps on 3 batches with the
    state carried and trajectory 0 restarting at step 3 (the JAX learner's
    reset: the carry times ~new_episodes); the port's learner built from the
    same seed."""
    rng = np.random.default_rng(11)
    batches = [random_sl_batch(B, T, rng) for _ in range(3)]
    batches[2]["new_episodes"] = np.array([True, False])
    learner = port_learner()
    params = jax.tree.map(jnp.asarray, params_to_flax(learner.model))
    cfg = jax_merge(jax_default_config(), SMALL_MODEL)
    jm = JModel(cfg)
    opt = jax_build_optimizer(1e-3, (0.9, 0.999), 1e-8, 1e-5, JClipConfig("norm", 1.0))
    step = jax_train_step(jm, JLossConfig(), opt, B, dynamics=jax_tree_spec({}, {"type": "norm", "threshold": 1.0}))
    loss_fn = _jax_loss_fn(jm, B)
    both = jax.jit(lambda p, o, b, h: (step(p, o, b, h), jax.grad(loss_fn)(p, b, h)))
    H = cfg.encoder.core_lstm.hidden_size
    hidden = tuple((jnp.zeros((B, H)), jnp.zeros((B, H))) for _ in range(cfg.encoder.core_lstm.num_layers))
    opt_state = opt.init(params)
    steps = []
    p = params
    for batch in batches:
        keep = jnp.asarray(~batch["new_episodes"], jnp.float32)[:, None]
        hidden = tuple((h * keep, c * keep) for h, c in hidden)
        (p, opt_state, out_state, info), grads = both(p, opt_state, jax.tree.map(jnp.asarray, _strip(batch)),
                                                      hidden)
        hidden = jax.lax.stop_gradient(out_state)
        steps.append(dict(params=jax.tree.map(np.asarray, p), info=jax.tree.map(float, info),
                          grads=jax.tree.map(np.asarray, grads), state=jax.tree.map(np.asarray, out_state)))
    return dict(batches=batches, steps=steps, params=jax.tree.map(np.asarray, params), jm=jm,
                learner=learner)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if isinstance(v, dict) else {"/".join(prefix + (k,)): v})
    return out


# --------------------------------------------------- (b) forwards and heads
@pytest.fixture(scope="module")
def forward_run(jax_run):
    """The JAX ``sl_forward`` on the first batch (not jitted: op by op) and
    the port's, from the same weights and a random carried state."""
    rng = np.random.default_rng(3)
    batch = _strip(jax_run["batches"][0])
    H = SMALL_MODEL["encoder"]["core_lstm"]["hidden_size"]
    hidden = ((rng.standard_normal((B, H)).astype(np.float32), rng.standard_normal((B, H)).astype(np.float32)),)
    jm = jax_run["jm"]
    jb = jax.tree.map(jnp.asarray, batch)
    want_logits, want_state = jm.apply(
        jax.tree.map(jnp.asarray, jax_run["params"]), jb["spatial_info"], jb["entity_info"],
        jb["scalar_info"], jb["entity_num"], jb["action_info"], jb["selected_units_num"],
        jax.tree.map(jnp.asarray, hidden), B, method=jm.sl_forward)
    model = Model(deep_merge_dicts(deep_merge_dicts(default_model_config(), SMALL_MODEL), KERNEL_OVERLAY))
    model.load_state_dict(params_from_flax(jax_run["params"], model))
    tb = to_device(batch, "cpu")
    th = tuple((torch.from_numpy(h), torch.from_numpy(c)) for h, c in hidden)
    with torch.no_grad():
        got_logits, got_state = model.sl_forward(
            tb["spatial_info"], tb["entity_info"], tb["scalar_info"], tb["entity_num"],
            tb["action_info"], tb["selected_units_num"], th, B)
    return dict(want=(jax.tree.map(np.asarray, want_logits), jax.tree.map(np.asarray, want_state)),
                got=(got_logits, got_state), model=model, batch=tb, hidden=th)


@pytest.mark.parametrize("head", F.ACTION_HEADS)
def test_sl_forward_teacher_logits_match_jax(forward_run, head):
    np.testing.assert_allclose(_np(forward_run["got"][0][head]), forward_run["want"][0][head], **TOL)


def test_sl_forward_state_matches_jax(forward_run):
    for (th, tc), (jh, jc) in zip(forward_run["got"][1], forward_run["want"][1]):
        np.testing.assert_allclose(_np(th), jh, **TOL)
        np.testing.assert_allclose(_np(tc), jc, **TOL)


def test_teacher_logits_is_one_step_of_sl_forward(forward_run):
    """``teacher_logits`` on one step = ``sl_forward`` with T = 1."""
    model, tb, th = forward_run["model"], forward_run["batch"], forward_run["hidden"]
    one = {k: (v[::T] if not isinstance(v, dict) else {f: a[::T] for f, a in v.items()})
           for k, v in tb.items()}  # step 0 of each trajectory
    with torch.no_grad():
        out = model.teacher_logits(one["spatial_info"], one["entity_info"], one["scalar_info"],
                                   one["entity_num"], th, one["action_info"], one["selected_units_num"])
        logits, state = model.sl_forward(one["spatial_info"], one["entity_info"], one["scalar_info"],
                                         one["entity_num"], one["action_info"],
                                         one["selected_units_num"], th, B)
    for head in F.ACTION_HEADS:
        torch.testing.assert_close(out["logit"][head], logits[head], rtol=0, atol=0)
    for (h1, c1), (h2, c2) in zip(out["hidden_state"], state):
        torch.testing.assert_close(h1, h2, rtol=0, atol=0)


def test_selected_units_parallel_matches_scan_in_the_port(forward_run):
    """The batched teacher-forced decode against the step loop: the same
    logits on the real steps (after the end token the two mask differently,
    and the loss masks those steps out) and the same embedding downstream
    (the target-unit and location logits)."""
    scan = Model(deep_merge_dicts(forward_run["model"].cfg,
                                  {"policy": {"selected_units_head": {"train_impl": "scan"}}}))
    scan.load_state_dict(forward_run["model"].state_dict())
    tb, th = forward_run["batch"], forward_run["hidden"]
    with torch.no_grad():
        logits, _ = scan.sl_forward(tb["spatial_info"], tb["entity_info"], tb["scalar_info"],
                                    tb["entity_num"], tb["action_info"], tb["selected_units_num"], th, B)
    par = forward_run["got"][0]
    for i, n in enumerate(tb["selected_units_num"].tolist()):
        torch.testing.assert_close(logits["selected_units"][i, :n], par["selected_units"][i, :n],
                                   rtol=2e-4, atol=2e-4)
    for head in ("target_unit", "target_location"):
        torch.testing.assert_close(logits[head], par[head], rtol=2e-4, atol=2e-4)


# ------------------------------------------------------------- (c) SL loss
@pytest.mark.parametrize("label_smooth,candidate_mask,infer", [
    (0.0, True, True), (0.1, True, False), (0.0, False, True)])
def test_compute_sl_loss_matches_jax(rng, label_smooth, candidate_mask, infer):
    n, S, N, W = 6, F.MAX_SELECTED_UNITS_NUM, 32, 160
    widths = {"action_type": 327, "delay": 128, "queued": 2, "target_unit": N, "target_location": 8 * W}
    logits = {k: rng.standard_normal((n, w)).astype(np.float32) for k, w in widths.items()}
    logits["selected_units"] = rng.standard_normal((n, S, N + 1)).astype(np.float32)
    entity_num = rng.integers(8, N + 1, n)
    sun = rng.integers(1, 7, n)
    su = np.zeros((n, S), np.int64)
    for i in range(n):
        su[i, : sun[i] - 1] = rng.permutation(8)[: sun[i] - 1]
        su[i, sun[i] - 1] = entity_num[i]
    actions = {k: rng.integers(0, w, n) for k, w in widths.items()}
    actions["selected_units"] = su
    masks = {k: (rng.random(n) < 0.7).astype(np.float32) for k in F.ACTION_HEADS}
    pred = rng.integers(0, 8, (n, S))
    pred[np.arange(n), rng.integers(0, S, n)] = entity_num  # an end token somewhere
    pred[0] = 3  # a lane that never ends
    jcfg = JLossConfig(label_smooth=label_smooth, su_candidate_mask=candidate_mask)
    tcfg = SupervisedLossConfig(label_smooth=label_smooth, su_candidate_mask=candidate_mask)
    j = jax.tree.map(jnp.asarray, (logits, actions, masks, sun, entity_num))
    want_total, want = jax_sl_loss(*j, jcfg, infer_selected_units=jnp.asarray(pred) if infer else None)
    t = [to_device(x, "cpu") for x in (logits, actions, masks, sun, entity_num)]
    got_total, got = compute_sl_loss(*t, tcfg, infer_selected_units=torch.from_numpy(pred) if infer else None)
    assert set(got) == set(want)
    np.testing.assert_allclose(float(got_total), float(want_total), rtol=1e-5)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-6, err_msg=k)


# ----------------------------------------------------------- (d) optimizer
OPTIMIZERS = {
    "adam": {},
    "adamw": dict(weight_decay=1e-2),
    "rl_adam": dict(betas=(0.0, 0.99), eps=1e-5),
    "clip_value": dict(clip=dict(type="value", threshold=0.05)),
    "clip_norm": dict(clip=dict(type="norm", threshold=1.0)),
    "clip_norm_untriggered": dict(clip=dict(type="norm", threshold=1e3)),
    "clip_max_norm": dict(clip=dict(type="max_norm", threshold=0.5, begin_step=1)),
    "clip_momentum_norm": dict(clip=dict(type="momentum_norm", threshold=0.5, begin_step=2)),
    "warmup": dict(warmup_steps=2),
    "piecewise_decay": dict(decay_boundaries=(1, 2), decay_rate=0.5),
    "warmup_then_decay": dict(weight_decay=1e-2, warmup_steps=1, decay_boundaries=(1,), decay_rate=0.3),
}


@pytest.mark.parametrize("case", sorted(OPTIMIZERS))
def test_optimizer_matches_optax_on_the_same_gradients(rng, case):
    kw = {**dict(learning_rate=1e-2, betas=(0.9, 0.999), eps=1e-8), **OPTIMIZERS[case]}
    clip = kw.pop("clip", None)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 2, 3)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (3 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    opt = jax_build_optimizer(clip=JClipConfig(**clip) if clip else None, **kw)
    jp = jax.tree.map(jnp.asarray, params)
    state = opt.init(jp)
    tp = [torch.from_numpy(params[k].copy()) for k in shapes]
    topt = build_optimizer(tp, clip=GradClipConfig(**clip) if clip else None, **kw)
    for g in grads:
        upd, state = opt.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        topt.step([torch.from_numpy(g[k].copy()) for k in shapes])
    (adam,) = [s for s in jax.tree_util.tree_leaves(state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
               if isinstance(s, optax.ScaleByAdamState)]
    assert int(adam.count) == topt.count == 3
    for i, k in enumerate(shapes):
        np.testing.assert_allclose(tp[i].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-8, err_msg=k)
        np.testing.assert_allclose(topt.mu[i].numpy(), np.asarray(adam.mu[k]), rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(topt.nu[i].numpy(), np.asarray(adam.nu[k]), rtol=1e-5, atol=1e-12)


# --------------------------------------------------------- (e) the SL step
def test_param_bridge_round_trips(jax_run):
    model = jax_run["learner"].model
    leaves = _flat(params_to_flax(model)["params"])
    assert len(leaves) == 230 and len(flax_names(model)) == 230
    assert sorted("params/" + k for k in leaves) == sorted(flax_names(model).values())
    back = params_from_flax(params_to_flax(model), model)
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k


@pytest.fixture(scope="module")
def port_steps(jax_run):
    """The port's gradients on the first batch, then its learner's 3 steps."""
    learner = jax_run["learner"]
    batch = to_device(_strip(jax_run["batches"][0]), "cpu")
    total, _, _ = sl_loss(learner.model, learner.loss_cfg, batch, learner.hidden, B)
    names = [n for n, _ in learner.model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(total, list(learner.model.parameters()))))
    logs, params = [], []
    for b in jax_run["batches"]:
        logs.append(learner._train(b))
        params.append({n: p.detach().clone() for n, p in learner.model.named_parameters()})
    return dict(grads=grads, logs=logs, params=params, state=learner.hidden)


def test_sl_step_loss_info_and_grad_norm_match_jax(jax_run, port_steps):
    want, got = jax_run["steps"][0]["info"], port_steps["logs"][0]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_sl_step_gradients_match_jax(jax_run, port_steps):
    want = _flat(jax_run["steps"][0]["grads"]["params"])
    got = _flat(params_to_flax(jax_run["learner"].model, port_steps["grads"])["params"])
    assert set(got) == set(want)
    norm = jax_run["steps"][0]["info"]["grad_norm"]
    err = sum(float(((got[k] - w).astype(np.float64) ** 2).sum()) for k, w in want.items()) ** 0.5
    assert err <= 1e-4 * norm
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-3, atol=2e-3 * float(np.abs(w).max()) + 1e-7 * norm,
                                   err_msg=k)


def test_sl_step_new_params_match_jax_where_the_gradient_is_clear(jax_run, port_steps):
    new = _flat(params_to_flax(jax_run["learner"].model, port_steps["params"][0])["params"])
    want = _flat(jax_run["steps"][0]["params"]["params"])
    grads = _flat(jax_run["steps"][0]["grads"]["params"])
    old = _flat(jax_run["params"]["params"])
    norm = jax_run["steps"][0]["info"]["grad_norm"]
    compared = 0
    for k, w in want.items():
        clear = (np.abs(grads[k]) > 1e-2 * np.abs(grads[k]).max()) & (np.abs(grads[k]) > 1e-5 * norm)
        np.testing.assert_allclose(new[k][clear], w[clear], rtol=1e-5, atol=1e-6, err_msg=k)
        assert np.abs(new[k] - old[k]).max() <= 1.01e-3  # Adam's first step: lr at most
        compared += int(clear.sum())
    # a quarter of all elements at least: most of the rest have no gradient at all
    # (embedding rows of classes absent from the batch)
    assert compared > 0.25 * sum(g.size for g in grads.values())


def test_three_sl_steps_with_carry_and_reset_match_jax(jax_run, port_steps):
    """Steps 2 and 3 start from the carried, detached state; trajectory 0
    restarts at step 3 (``new_episodes``)."""
    for i, (got, want) in enumerate(zip(port_steps["logs"], jax_run["steps"])):
        np.testing.assert_allclose(got["total_loss"], want["info"]["total_loss"], rtol=1e-3,
                                   err_msg=f"step {i + 1}")
    for (th, tc), (jh, jc) in zip(port_steps["state"], jax_run["steps"][-1]["state"]):
        assert not th.requires_grad
        np.testing.assert_allclose(_np(th), jh, **TOL)
        np.testing.assert_allclose(_np(tc), jc, **TOL)


def test_sl_step_save_grad_names_are_the_jax_learners(jax_run):
    learner = port_learner(save_grad=True)
    log = learner._train(jax_run["batches"][0])
    names = set(flax_names(learner.model).values())
    assert {k for k in log if k.startswith("grad_norm/")} == {f"grad_norm/{n}" for n in names}
    assert {k for k in log if k.startswith("param_norm/")} == {f"param_norm/{n}" for n in names}
    grads = sum(v ** 2 for k, v in log.items() if k.startswith("grad_norm/"))
    np.testing.assert_allclose(grads ** 0.5, log["grad_norm"], rtol=1e-5)


# ------------------------------------------------------------- (f) batches
def test_fake_sl_batch_has_the_jax_schema_and_draws():
    want = jdata.fake_sl_batch(2, 3, np.random.default_rng(5))
    got = fake_sl_batch(2, 3, np.random.default_rng(5))
    flat_w, flat_g = _flat(want), _flat(got)
    assert set(flat_g) == set(flat_w)
    for k, w in flat_w.items():
        assert flat_g[k].shape == w.shape and flat_g[k].dtype == w.dtype, k
        np.testing.assert_array_equal(flat_g[k], w, err_msg=k)


def test_cap_entities_is_bit_equal_to_jax():
    batch = jdata.fake_sl_batch(2, 4, np.random.default_rng(6))
    n = 40
    ai = batch["action_info"]
    ai["selected_units"][0, 1] = 100  # points past the cap: masked out
    ai["target_unit"][:3] = [5, 60, 39]
    batch["entity_num"][:2] = [30, 300]
    ai["selected_units"][0, batch["selected_units_num"][0] - 1] = 30
    ai["selected_units"][1, batch["selected_units_num"][1] - 1] = 300  # end token past the cap
    want = _flat(jdata.cap_entities(batch, n))
    got = _flat(cap_entities(batch, n))
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert got["entity_num"].max() == n and got["action_mask/selected_units"][0] == 0


def test_max_entities_caps_the_learners_batches(jax_run):
    learner = port_learner(max_entities=64)
    batch = jax_run["batches"][0]
    capped = learner._cap(dict(batch))
    assert capped["entity_info"]["unit_type"].shape[1] == 64
    assert np.isfinite(learner._train(batch)["total_loss"])


# ------------------------------------------------------------- (g) remat
def test_remat_gives_the_same_gradients(jax_run):
    batch = to_device(_strip(jax_run["batches"][0]), "cpu")
    grads = {}
    for remat in (False, True):
        model = Model(deep_merge_dicts(deep_merge_dicts(default_model_config(), SMALL_MODEL),
                                       {**KERNEL_OVERLAY, "remat": remat}))
        init_params(model, 4)
        assert model.encoder.remat is remat
        core = model.cfg["encoder"]["core_lstm"]
        z = torch.zeros(B, core["hidden_size"])
        total, _, _ = sl_loss(model, SupervisedLossConfig(), batch, ((z, z),), B)
        grads[remat] = torch.autograd.grad(total, list(model.parameters()))
    for a, b in zip(grads[False], grads[True]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


# --------------------------------------------------------------- (h) the bin
def test_bin_learner_runs_two_steps_on_the_cpu(capsys, tmp_path):
    # a save path of its own: the bin resumes from the experiment's latest checkpoint
    sl_train.main(["--type", "learner", "--iters", "2", "--smoke-model", "--device", "cpu",
                   "--save-path", str(tmp_path)])
    out = capsys.readouterr().out
    assert "sl_train done: 2 iters" in out
    assert '"iter": 2' in out


@pytest.mark.parametrize("form", ["inline", "json", "yaml"])
def test_bin_config_overrides_the_model_and_learner(tmp_path, capsys, form):
    """``--config`` as the JAX launcher's: its model block stands in for the
    smoke model, its learner block cascades over the defaults, and its batch
    size stands where the flag is not given."""
    cfg = {"model": deep_merge_dicts(sl_train.SMOKE_MODEL, {"encoder": {
               "entity": {"attention_impl": "pallas"}, "scatter": {"impl": "pallas_onehot"}}}).to_dict(),
           "learner": {"log_freq": 1, "batch_size": 3}}
    spec = json.dumps(cfg)
    if form != "inline":
        path = tmp_path / f"cfg.{form}"
        path.write_text(spec)  # JSON is YAML too
        spec = str(path)
    args = sl_train.parser().parse_args(["--iters", "1", "--traj-len", "2", "--config", spec,
                                         "--device", "cpu", "--save-path", str(tmp_path / "run")])
    lrn = sl_train.learner(args)
    assert lrn.model_cfg.encoder.entity.attention_impl == "pallas"
    assert lrn.model_cfg.encoder.scatter.impl == "pallas_onehot"
    assert lrn.model_cfg.encoder.entity.layer_num == 1  # the smoke model the config carries
    assert (lrn.cfg.learner.batch_size, lrn.cfg.learner.unroll_len, lrn.cfg.learner.log_freq) == (3, 2, 1)
    assert '"iter": 1' in capsys.readouterr().out


def test_bin_learner_needs_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sl_train.main(["--type", "learner", "--iters", "1", "--smoke-model"])


def test_bin_dynamics_every_zero_turns_the_tree_off(tmp_path):
    """``--dynamics-every 0``: the step without the tree (the JAX
    launcher's off arm)."""
    lrn = sl_train.main(["--type", "learner", "--iters", "1", "--smoke-model", "--device", "cpu",
                         "--batch-size", "2", "--traj-len", "2", "--no-health", "--save-path", str(tmp_path),
                         "--dynamics-every", "0"])
    assert not lrn.cfg.learner.dynamics.enabled and not lrn._dynamics.enabled
    assert "grad_norm" in lrn.last_log and not any(k.startswith("dyn/") for k in lrn.last_log)


@pytest.mark.parametrize("argv,item", [
    (["--mesh", "dp=2", "--no-health"], "does not factor"),
    (["--remote", "--mesh", "dp=2", "--no-health"], "does not factor")])
def test_bin_parts_not_ported_raise(argv, item):
    """The SL runtime (``--data``, ``--eval-data``, ``--remote``, the
    coordinator and replay actor roles) is ported; ``--mesh`` (item 7,
    ported) refuses dp=2 on a world of one process, typed, before it
    reaches the coordinator."""
    from distar_tpu_torch.parallel import MeshConfigError
    from distar_tpu_torch.parallel.dist import dist_close

    try:
        with pytest.raises(MeshConfigError if "--mesh" in argv else NotImplementedError, match=item):
            sl_train.main(argv + ["--device", "cpu"])
    finally:
        dist_close()

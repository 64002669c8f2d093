"""The port's ``Model.sample_action`` against the JAX package's at SMALL_MODEL.

JAX params come from ``Model.init`` and cross into the port through the
bridge. The JAX side runs its 'xla' strings (the JAX tests hold 'pallas'
equal to 'xla', and Pallas interpret at model scale is kept out of this
process, tests/test_pallas_kernels.py:170-180); the port runs the kernel
overlay, whose wrappers take their plain versions on CPU tensors. Both
sample with the same Gumbel draws: JAX's ``categorical`` is exactly
``argmax(logits + gumbel(key))``, so the draws are regenerated from JAX's key
structure (split(rng, 6), then split(r[3], 64) for the pointer steps) and
handed to the port. Observations are random, in range.

Tolerance atol 2e-4 / rtol 1e-3: the precedent of
tests/test_golden_parity.py:132 for a whole-model forward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import SMALL_MODEL

from distar_tpu.model import Model as JModel
from distar_tpu.model.config import default_model_config as jax_default_config
from distar_tpu.utils import deep_merge_dicts as jax_merge
from distar_tpu_torch.lib import features as F
from distar_tpu_torch.model import Model, default_model_config, noise_shapes
from distar_tpu_torch.model.convert import params_from_flax
from distar_tpu_torch.utils import deep_merge_dicts

torch.set_num_threads(1)

B = 3
TOL = dict(atol=2e-4, rtol=1e-3)
KERNEL_OVERLAY = {"encoder": {"entity": {"attention_impl": "pallas"}, "scatter": {"impl": "pallas"}}}


def jax_gumbel_noise(key, cfg, batch):
    """The Gumbel draws ``Policy.sample`` makes from ``key``, per head, in the
    port's layout (the pointer decode as [B, 64, N+1])."""
    shapes = noise_shapes(cfg, batch)
    r = jax.random.split(key, 6)
    heads = ["action_type", "delay", "queued", None, "target_unit", "target_location"]
    out = {h: np.array(jax.random.gumbel(r[i], shapes[h])) for i, h in enumerate(heads) if h}
    step_keys = jax.random.split(r[3], shapes["selected_units"][1])
    out["selected_units"] = np.stack(
        [np.asarray(jax.random.gumbel(k, (batch, shapes["selected_units"][2]))) for k in step_keys], 1)
    return {k: torch.from_numpy(v) for k, v in out.items()}


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def port_model(overlay, state_dict):
    model = Model(deep_merge_dicts(deep_merge_dicts(default_model_config(), SMALL_MODEL), overlay))
    model.load_state_dict(state_dict)
    return model.eval()


@pytest.fixture(scope="module")
def run():
    cfg = jax_merge(jax_default_config(), SMALL_MODEL)
    jm = JModel(cfg)
    rng = np.random.default_rng(1)
    obs = F.batch_tree([F.random_step_data(rng) for _ in range(B)])
    H = cfg.encoder.core_lstm.hidden_size
    hidden = tuple((rng.standard_normal((B, H)).astype(np.float32),
                    rng.standard_normal((B, H)).astype(np.float32))
                   for _ in range(cfg.encoder.core_lstm.num_layers))
    jhidden = jax.tree.map(jnp.asarray, hidden)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), obs["spatial_info"], obs["entity_info"],
                              obs["scalar_info"], obs["entity_num"], jhidden, jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(7)
    want = jax.jit(lambda p, d, h, r: jm.apply(
        p, d["spatial_info"], d["entity_info"], d["scalar_info"], d["entity_num"], h, r,
        method=jm.sample_action))(params, obs, jhidden, key)
    want = jax.tree.map(np.asarray, want)
    np_params = jax.tree.map(np.asarray, params)
    model = Model(deep_merge_dicts(deep_merge_dicts(default_model_config(), SMALL_MODEL), KERNEL_OVERLAY))
    state = params_from_flax(np_params, model)
    model.load_state_dict(state)
    noise = jax_gumbel_noise(key, model.cfg, B)
    d = to_torch(obs)
    thidden = tuple((torch.from_numpy(h), torch.from_numpy(c)) for h, c in hidden)
    with torch.no_grad():
        got = model.eval().sample_action(d["spatial_info"], d["entity_info"], d["scalar_info"],
                                         d["entity_num"], thidden, noise=noise)
    return dict(want=want, got=got, params=np_params, state=state, obs=d, hidden=thidden,
                noise=noise, logits_key=key)


def test_jax_categorical_is_gumbel_argmax(run):
    """The premise of handing JAX's draws to the port."""
    logits = np.asarray(run["want"]["logit"]["action_type"])
    noise = run["noise"]["action_type"].numpy()
    np.testing.assert_array_equal(np.argmax(logits + noise, -1),
                                  np.asarray(run["want"]["action_info"]["action_type"]))


@pytest.mark.parametrize("head", F.ACTION_HEADS)
def test_actions_match(run, head):
    np.testing.assert_array_equal(run["got"]["action_info"][head].numpy(),
                                  run["want"]["action_info"][head])


@pytest.mark.parametrize("head", F.ACTION_HEADS)
def test_logits_and_logp_match(run, head):
    np.testing.assert_allclose(run["got"]["logit"][head].numpy(), run["want"]["logit"][head], **TOL)
    np.testing.assert_allclose(run["got"]["action_logp"][head].numpy(),
                               run["want"]["action_logp"][head], **TOL)


def test_selected_units_num_extra_units_and_shapes(run):
    got, want = run["got"], run["want"]
    np.testing.assert_array_equal(got["selected_units_num"].numpy(), want["selected_units_num"])
    np.testing.assert_array_equal(got["extra_units"].numpy(), want["extra_units"])
    np.testing.assert_array_equal(got["entity_num"].numpy(), want["entity_num"])
    for k, shape in F.LOGIT_SHAPES.items():
        assert tuple(got["logit"][k].shape) == (B,) + shape
    for k, shape in F.ACTION_SHAPES.items():
        assert tuple(got["action_info"][k].shape) == (B,) + shape


def test_new_hidden_state_matches(run):
    assert len(run["got"]["hidden_state"]) == len(run["want"]["hidden_state"])
    for (th, tc), (jh, jc) in zip(run["got"]["hidden_state"], run["want"]["hidden_state"]):
        assert th.dtype == torch.float32 and tc.dtype == torch.float32
        np.testing.assert_allclose(th.numpy(), jh, **TOL)
        np.testing.assert_allclose(tc.numpy(), jc, **TOL)


@pytest.mark.parametrize("scatter_impl", ["xla", "pallas_onehot"])
def test_config_strings_agree_in_the_port(run, scatter_impl):
    """The 'xla' strings and the other scatter kernel give the kernel
    overlay's forward (plain versions on the CPU)."""
    attn = "xla" if scatter_impl == "xla" else "pallas"
    model = port_model({"encoder": {"entity": {"attention_impl": attn}, "scatter": {"impl": scatter_impl}}},
                       run["state"])
    d = run["obs"]
    with torch.no_grad():
        out = model.sample_action(d["spatial_info"], d["entity_info"], d["scalar_info"],
                                  d["entity_num"], run["hidden"], noise=run["noise"])
    for k in F.ACTION_HEADS:
        np.testing.assert_array_equal(out["action_info"][k].numpy(), run["got"]["action_info"][k].numpy())
        np.testing.assert_allclose(out["logit"][k].numpy(), run["got"]["logit"][k].numpy(), **TOL)


def test_generator_noise_is_seeded(run):
    d = run["obs"]
    model = port_model(KERNEL_OVERLAY, run["state"])
    outs = []
    for seed in (3, 3, 4):
        with torch.no_grad():
            outs.append(model.sample_action(d["spatial_info"], d["entity_info"], d["scalar_info"],
                                            d["entity_num"], run["hidden"],
                                            generator=torch.Generator().manual_seed(seed)))
    assert torch.equal(outs[0]["action_info"]["target_location"], outs[1]["action_info"]["target_location"])
    assert not torch.equal(outs[0]["action_info"]["target_location"],
                           outs[2]["action_info"]["target_location"])


def test_bf16_compute_dtype_runs(run):
    model = port_model({**KERNEL_OVERLAY, "dtype": "bfloat16"}, run["state"])
    d = run["obs"]
    with torch.no_grad():
        out = model.sample_action(d["spatial_info"], d["entity_info"], d["scalar_info"],
                                  d["entity_num"], run["hidden"], noise=run["noise"])
    assert all(torch.isfinite(v).all() for v in out["logit"].values())
    assert all(h.dtype == torch.float32 for hc in out["hidden_state"] for h in hc)
    np.testing.assert_allclose(out["logit"]["delay"].numpy(), run["got"]["logit"]["delay"].numpy(),
                               atol=0.1)


def test_bridge_uses_every_leaf_once(run):
    leaves = jax.tree_util.tree_leaves(run["params"])
    assert len(run["state"]) == len(leaves) == 230
    assert sum(v.numel() for v in run["state"].values()) == sum(x.size for x in leaves) == 881223
    model = port_model(KERNEL_OVERLAY, run["state"])
    extra = dict(run["params"]["params"], stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="unused"):
        params_from_flax({"params": extra}, model)
    missing = {k: v for k, v in run["params"]["params"].items() if k != "core_lstm"}
    with pytest.raises(ValueError, match="missing"):
        params_from_flax({"params": missing}, model)


def test_bridge_fits_the_flagship():
    """329 leaves and 28,838,670 params at default_model_config(), counted
    with jax.eval_shape (no flagship init runs here)."""
    cfg = jax_default_config()
    jm = JModel(cfg)
    obs = F.batch_tree([F.fake_step_data() for _ in range(1)])
    H = cfg.encoder.core_lstm.hidden_size
    h = tuple((jnp.zeros((1, H)), jnp.zeros((1, H))) for _ in range(cfg.encoder.core_lstm.num_layers))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), obs["spatial_info"], obs["entity_info"], obs["scalar_info"],
        obs["entity_num"], h, jax.random.PRNGKey(1)))
    zeros = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    leaves = jax.tree_util.tree_leaves(zeros)
    assert len(leaves) == 329 and sum(x.size for x in leaves) == 28838670
    model = Model(default_model_config())
    state = params_from_flax(zeros, model)  # raises unless every leaf and param pairs up
    assert sum(v.numel() for v in state.values()) == sum(p.numel() for p in model.parameters())

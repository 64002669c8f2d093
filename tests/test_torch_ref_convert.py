"""The port's reference-checkpoint bridge (``distar_tpu_torch/model/
ref_convert.py`` and ``bin/play.py``'s ``.pth`` load) against the JAX
package's ``model/ref_convert.py``, on the CPU.

No reference ``.pth`` is in the repo, so the reference's layout is built
here: ``ref_convert.reference_state_dict`` runs the rules backwards over a
port model's seeded weights (``params_to_flax``), giving the reference's
key names and shapes. Then:

* the JAX ``convert_model`` of that state dict returns the port model's
  flax tree, leaf for leaf, bit for bit, at SMALL_MODEL and at the flagship
  (every policy leaf and the value towers): the key names and shapes are
  the ones the reference's converter reads, and the port's own
  ``convert_model`` returns the same tree;
* the per-part converters (the counterparts of tests/test_golden_parity.py's:
  the LSTM, the three encoders, the six heads, a value tower and the value
  encoder) equal the JAX ones on the same state dicts, and
  ``_nchw_fc_kernel`` re-orders an NCHW-flatten fc exactly as the JAX rule
  does;
* ``bin/play.load_params`` on a ``torch.save``d ``.pth`` (plain,
  ``{"model": sd}`` and ``module.``-prefixed) gives the seeded policy state
  dict bit for bit, and the port's forward on it equals the JAX forward on
  the JAX converter's params at SMALL_MODEL (atol 2e-4 / rtol 1e-3, the
  whole-model tolerance of tests/test_torch_model.py);
* a ``.pth`` whose keys or shapes the rules do not meet raises, as JAX's does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import SMALL_MODEL
from test_torch_model import jax_gumbel_noise, to_torch

from distar_tpu.model import Model as JModel
from distar_tpu.model import ref_convert as jref
from distar_tpu.model.config import default_model_config as jax_default_config
from distar_tpu.utils import deep_merge_dicts as jax_merge
from distar_tpu_torch.bin import play
from distar_tpu_torch.lib import features as F
from distar_tpu_torch.model import Model, default_model_config, init_params
from distar_tpu_torch.model import ref_convert
from distar_tpu_torch.model.convert import _flatten, params_to_flax
from distar_tpu_torch.utils import deep_merge_dicts

torch.set_num_threads(1)

TOL = dict(atol=2e-4, rtol=1e-3)
SIZES = {"small": SMALL_MODEL, "flagship": {}}


def port_cfg(overrides, value=True):
    cfg = deep_merge_dicts(default_model_config(), overrides)
    cfg.use_value_network = value
    cfg.use_value_feature = value
    return cfg


def seeded_tree(overrides, value=True, seed=0):
    model = Model(port_cfg(overrides, value))
    init_params(model, seed)
    return params_to_flax(model)["params"], model


def assert_same_tree(got, want):
    a, b = _flatten(got), _flatten(want)
    assert set(a) == set(b), sorted(set(a) ^ set(b))[:10]
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, (k, a[k].shape, b[k].shape)
        np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))


@pytest.fixture(scope="module")
def small():
    tree, _ = seeded_tree(SMALL_MODEL)
    return tree


@pytest.mark.parametrize("size", ["small", "flagship"])
def test_jax_convert_model_reads_the_reference_layout(size):
    overrides = SIZES[size]
    tree, _ = seeded_tree(overrides)
    sd = ref_convert.reference_state_dict(tree, port_cfg(overrides))
    assert all(isinstance(v, np.ndarray) for v in sd.values())
    assert any(k.startswith("value_networks.winloss.") for k in sd)
    want = {k: v for k, v in tree.items() if k != "value_encoder"}  # convert_model leaves it out
    assert_same_tree(jref.convert_model(sd, jax_merge(jax_default_config(), overrides))["params"], want)
    assert_same_tree(ref_convert.convert_model(sd, port_cfg(overrides))["params"], want)


#: (part, port subtree path, JAX converter, its second argument)
PARTS = [
    ("lnlstm", ("core_lstm",), "convert_lnlstm", lambda c: c.encoder.core_lstm.num_layers),
    ("entity_encoder", ("encoder", "entity_encoder"), "convert_entity_encoder", None),
    ("scalar_encoder", ("encoder", "scalar_encoder"), "convert_scalar_encoder", None),
    ("spatial_encoder", ("encoder", "spatial_encoder"), "convert_spatial_encoder", None),
    ("action_type_head", ("policy", "action_type_head"), "convert_action_type_head", None),
    ("delay_head", ("policy", "delay_head"), "convert_delay_head", None),
    ("queued_head", ("policy", "queued_head"), "convert_queued_head", None),
    ("selected_units_head", ("policy", "selected_units_head"), "convert_selected_units_head", None),
    ("target_unit_head", ("policy", "target_unit_head"), "convert_target_unit_head", None),
    ("location_head", ("policy", "location_head"), "convert_location_head", None),
    ("value_baseline", ("value_winloss",), "convert_value_baseline", lambda c: c.value.res_num),
    ("value_encoder", ("value_encoder",), "convert_value_encoder", None),
]


@pytest.mark.parametrize("part,path,name,arg", PARTS, ids=[p[0] for p in PARTS])
def test_part_converters_equal_jax(small, part, path, name, arg):
    cfg, jcfg = port_cfg(SMALL_MODEL), jax_merge(jax_default_config(), SMALL_MODEL)
    sub = small
    for key in path:
        sub = sub[key]
    sd = ref_convert.reference_part(part, sub, cfg)
    got = getattr(ref_convert, name)(sd, arg(cfg) if arg else cfg)["params"]
    want = getattr(jref, name)(sd, arg(jcfg) if arg else jcfg)["params"]
    assert_same_tree(got, want)
    assert_same_tree(got, sub)


def test_nchw_fc_kernel_equals_jax_and_keeps_the_map():
    """An fc over the reference's NCHW flatten equals the converted kernel
    over the port's NHWC flatten (the value encoder's and the spatial
    encoder's head)."""
    rng = np.random.default_rng(0)
    c, h, w, out = 3, 4, 5, 6
    weight = rng.standard_normal((out, c * h * w)).astype(np.float32)
    x = rng.standard_normal((c, h, w)).astype(np.float32)
    kernel = ref_convert._nchw_fc_kernel(weight, c, h, w)
    np.testing.assert_array_equal(kernel, jref._nchw_fc_kernel(weight, c, h, w))
    np.testing.assert_allclose(x.transpose(1, 2, 0).reshape(-1) @ kernel, weight @ x.reshape(-1),
                               rtol=1e-5, atol=1e-5)
    tree = {"Dense_0": {"kernel": kernel, "bias": np.zeros(out, np.float32)}}
    back = {}
    ref_convert._inv_nchw_fc(tree, "fc", c, h, w, back)
    np.testing.assert_array_equal(back["fc.0.weight"], weight)


def test_all_is_the_jax_modules():
    assert ref_convert.__all__ == jref.__all__


@pytest.fixture(scope="module")
def policy_pth(tmp_path_factory):
    """A policy-only SMALL_MODEL's seeded weights as a reference ``.pth``."""
    tree, model = seeded_tree(SMALL_MODEL, value=False, seed=5)
    sd = ref_convert.reference_state_dict(tree, port_cfg(SMALL_MODEL, value=False))
    path = tmp_path_factory.mktemp("pth") / "sm.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return path, sd, model.state_dict()


@pytest.mark.parametrize("layout", ["plain", "model", "module"])
def test_load_params_reads_a_pth_bit_for_bit(policy_pth, tmp_path, layout):
    path, sd, seeded = policy_pth
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    if layout == "model":
        torch.save({"model": tensors}, tmp_path / "x.pth")
        path = tmp_path / "x.pth"
    elif layout == "module":
        torch.save({f"module.{k}": v for k, v in tensors.items()}, tmp_path / "x.pt")
        path = tmp_path / "x.pt"
    got = play.load_params(str(path), deep_merge_dicts(default_model_config(), SMALL_MODEL))
    assert set(got) == set(seeded)
    for k, v in seeded.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_pth_forward_equals_the_jax_forward(policy_pth):
    path, sd, _ = policy_pth
    B = 2
    cfg = deep_merge_dicts(default_model_config(), SMALL_MODEL)
    model = Model(deep_merge_dicts(cfg, {"encoder": {"entity": {"attention_impl": "pallas"},
                                                     "scatter": {"impl": "pallas"}}}))
    model.load_state_dict(play.load_params(str(path), cfg))
    jcfg = jax_merge(jax_default_config(), SMALL_MODEL)
    jm = JModel(jcfg)
    jparams = jax.tree.map(jnp.asarray, jref.convert_model(dict(sd), jcfg))
    rng = np.random.default_rng(3)
    obs = F.batch_tree([F.random_step_data(rng) for _ in range(B)])
    H = jcfg.encoder.core_lstm.hidden_size
    hidden = tuple((rng.standard_normal((B, H)).astype(np.float32),
                    rng.standard_normal((B, H)).astype(np.float32))
                   for _ in range(jcfg.encoder.core_lstm.num_layers))
    key = jax.random.PRNGKey(11)
    want = jax.tree.map(np.asarray, jm.apply(
        jparams, obs["spatial_info"], obs["entity_info"], obs["scalar_info"], obs["entity_num"],
        jax.tree.map(jnp.asarray, hidden), key, method=jm.sample_action))
    d = to_torch(obs)
    with torch.no_grad():
        got = model.eval().sample_action(
            d["spatial_info"], d["entity_info"], d["scalar_info"], d["entity_num"],
            tuple((torch.from_numpy(h), torch.from_numpy(c)) for h, c in hidden),
            noise=jax_gumbel_noise(key, model.cfg, B))
    for head in F.ACTION_HEADS:
        np.testing.assert_array_equal(got["action_info"][head].numpy(), want["action_info"][head])
        np.testing.assert_allclose(got["logit"][head].numpy(), want["logit"][head], **TOL)
    for (th, tc), (jh, jc) in zip(got["hidden_state"], want["hidden_state"]):
        np.testing.assert_allclose(th.numpy(), jh, **TOL)
        np.testing.assert_allclose(tc.numpy(), jc, **TOL)


def test_a_pth_the_rules_do_not_meet_raises(policy_pth, tmp_path):
    _, sd, _ = policy_pth
    cfg = deep_merge_dicts(default_model_config(), SMALL_MODEL)
    missing = {k: torch.from_numpy(v) for k, v in sd.items() if k != "core_lstm.layers.0.cell.weight_ih"}
    torch.save(missing, tmp_path / "missing.pth")
    with pytest.raises(KeyError):
        play.load_params(str(tmp_path / "missing.pth"), cfg)
    with pytest.raises(KeyError):
        jref.convert_model({k: v.numpy() for k, v in missing.items()},
                           jax_merge(jax_default_config(), SMALL_MODEL))
    wrong = {k: torch.from_numpy(v) for k, v in sd.items()}
    key = "policy.delay_head.fc1.0.weight"
    wrong[key] = torch.zeros(wrong[key].shape[0] + 1, wrong[key].shape[1])
    torch.save(wrong, tmp_path / "wrong.pth")
    with pytest.raises(ValueError, match="delay_head"):
        play.load_params(str(tmp_path / "wrong.pth"), cfg)

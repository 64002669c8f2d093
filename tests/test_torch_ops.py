"""The port's ops (distar_tpu_torch/ops) against their flax counterparts in
distar_tpu/ops, with the flax weights carried across by the bridge
(distar_tpu_torch/model/convert.py). Inputs come from a numpy seed; f32
throughout, tolerance atol/rtol 2e-5 (tests/test_pallas_kernels.py:24) unless
a case says otherwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distar_tpu import ops as jops
from distar_tpu.ops.transformer import TransformerLayer as JTransformerLayer
from distar_tpu_torch import ops as tops
from distar_tpu_torch.model.convert import params_from_flax

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)


def _carry(flax_module, torch_module, *inputs, method=None):
    """Init the flax module on ``inputs``, load its params into the torch
    module through the bridge; returns the flax params."""
    params = flax_module.init(jax.random.PRNGKey(0), *[jnp.asarray(x) for x in inputs])
    sd = params_from_flax(jax.tree.map(np.asarray, params), torch_module)
    torch_module.load_state_dict(sd)
    return params


def _jax(flax_module, params, *inputs):
    return np.asarray(flax_module.apply(params, *[jnp.asarray(x) for x in inputs]))


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


@pytest.mark.parametrize("norm", [None, "LN"])
def test_fc_block(rng, norm):
    x = rng.standard_normal((5, 12)).astype(np.float32)
    tm = tops.FCBlock(12, 7, "relu", norm)
    jm = jops.FCBlock(7, "relu", norm)
    p = _carry(jm, tm, x)
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(), _jax(jm, p, x), **TOL)


def test_res_fc_block(rng):
    x = rng.standard_normal((5, 16)).astype(np.float32)
    tm, jm = tops.ResFCBlock(16), jops.ResFCBlock(16)
    p = _carry(jm, tm, x)
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(), _jax(jm, p, x), **TOL)


def test_res_fc_block2(rng):
    """The value towers' post-norm block: LN(x + fc(fc_relu(x)))."""
    x = rng.standard_normal((5, 16)).astype(np.float32)
    tm, jm = tops.ResFCBlock2(16), jops.blocks.ResFCBlock2(16)
    p = _carry(jm, tm, x)
    assert set(tm.state_dict()) == {"FCBlock_0.Dense_0.weight", "FCBlock_0.Dense_0.bias", "FCBlock_1.Dense_0.weight",
                                    "FCBlock_1.Dense_0.bias", "LayerNorm_0.weight", "LayerNorm_0.bias"}
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(), _jax(jm, p, x), **TOL)


def test_glu(rng):
    x = rng.standard_normal((4, 10)).astype(np.float32)
    ctx = rng.standard_normal((4, 6)).astype(np.float32)
    tm, jm = tops.GLU(10, 6, 3), jops.GLU(3)
    p = _carry(jm, tm, x, ctx)
    np.testing.assert_allclose(tm(torch.from_numpy(x), torch.from_numpy(ctx)).detach().numpy(),
                               _jax(jm, p, x, ctx), **TOL)


@pytest.mark.parametrize("kernel_size", [1, 3])
def test_conv_block_same_padding(rng, kernel_size):
    x = rng.standard_normal((2, 9, 11, 5)).astype(np.float32)  # NHWC
    tm, jm = tops.Conv2DBlock(5, 4, kernel_size, "relu"), jops.Conv2DBlock(4, kernel_size)
    p = _carry(jm, tm, x)
    np.testing.assert_allclose(_nhwc(tm(_nchw(x))), _jax(jm, p, x), **TOL)


def test_res_block(rng):
    x = rng.standard_normal((2, 8, 10, 6)).astype(np.float32)
    tm, jm = tops.ResBlock(6), jops.ResBlock(6)
    p = _carry(jm, tm, x)
    np.testing.assert_allclose(_nhwc(tm(_nchw(x))), _jax(jm, p, x), **TOL)


def test_gated_res_block_with_update_sp(rng):
    x = rng.standard_normal((2, 8, 10, 6)).astype(np.float32)
    tm, jm = tops.GatedResBlock(6), jops.GatedResBlock(6)
    p = _carry(jm, tm, x, x)
    p = jax.tree.map(lambda a: a, p)
    p["params"]["update_sp"] = jnp.asarray([0.37])  # a non-default scale must carry across
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, p), tm))
    np.testing.assert_allclose(_nhwc(tm(_nchw(x), _nchw(x))), _jax(jm, p, x, x), **TOL)


def test_one_hot_clamps_binary_encode_and_sequence_mask():
    ids = np.array([[-3, 0, 2, 4, 9]], np.int32)
    np.testing.assert_array_equal(tops.one_hot(torch.from_numpy(ids), 5).numpy(),
                                  np.asarray(jops.one_hot(jnp.asarray(ids), 5)))
    vals = np.array([0, 1, 5, 159, 1023], np.int32)
    np.testing.assert_array_equal(tops.binary_encode(torch.from_numpy(vals), 10).numpy(),
                                  np.asarray(jops.binary_encode(jnp.asarray(vals), 10)))
    lens = np.array([0, 3, 7])
    np.testing.assert_array_equal(tops.sequence_mask(torch.from_numpy(lens), 7).numpy(),
                                  np.asarray(jops.sequence_mask(jnp.asarray(lens), 7)))


def test_layer_norm_lstm_cell(rng):
    x = rng.standard_normal((3, 10)).astype(np.float32)
    h, c = (rng.standard_normal((3, 8)).astype(np.float32) for _ in range(2))
    tm, jm = tops.LayerNormLSTMCell(10, 8), jops.LayerNormLSTMCell(8)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), (jnp.asarray(h), jnp.asarray(c)))
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params), tm))
    jy, (jh, jc) = jm.apply(params, jnp.asarray(x), (jnp.asarray(h), jnp.asarray(c)))
    ty, (th, tc) = tm(torch.from_numpy(x), (torch.from_numpy(h), torch.from_numpy(c)))
    for a, b in ((ty, jy), (th, jh), (tc, jc)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)


def test_stacked_lstm_carries_state_over_time(rng):
    T, B, D, H, L = 4, 3, 10, 8, 2
    xs = rng.standard_normal((T, B, D)).astype(np.float32)
    st = tuple((rng.standard_normal((B, H)).astype(np.float32),
                rng.standard_normal((B, H)).astype(np.float32)) for _ in range(L))
    jst = jax.tree.map(jnp.asarray, st)
    tm, jm = tops.StackedLSTM(D, H, L), jops.StackedLSTM(H, L)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(xs), jst)
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params), tm))
    jy, jfinal = jm.apply(params, jnp.asarray(xs), jst)
    ty, tfinal = tm(torch.from_numpy(xs), tuple((torch.from_numpy(h), torch.from_numpy(c)) for h, c in st))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **TOL)
    for (th, tc), (jh, jc) in zip(tfinal, jfinal):
        np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh), **TOL)
        np.testing.assert_allclose(tc.detach().numpy(), np.asarray(jc), **TOL)


@pytest.mark.parametrize("ln_type", ["post", "pre"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_transformer_layer(rng, ln_type, impl):
    """'pallas' in the port runs the masked-attention kernel's plain version
    on a CPU tensor; the flax layer runs its 'xla' branch (the JAX tests
    hold the two equal)."""
    B, N, C = 3, 20, 16
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    mask = np.arange(N)[None, :] < np.array([1, 9, 20])[:, None]
    tm = tops.TransformerLayer(C, 8, 24, C, 2, 2, "relu", ln_type, attn_impl=impl)
    jm = JTransformerLayer(8, 24, C, 2, 2, "relu", ln_type)
    p = _carry(jm, tm, x, mask)
    got = tm(torch.from_numpy(x), torch.from_numpy(mask)).detach().numpy()
    np.testing.assert_allclose(got, _jax(jm, p, x, mask), **TOL)


def test_transformer_with_embedding_fc(rng):
    x = rng.standard_normal((2, 12, 30)).astype(np.float32)
    tm = tops.Transformer(30, head_dim=4, hidden_dim=16, output_dim=8, layer_num=2)
    jm = jops.Transformer(head_dim=4, hidden_dim=16, output_dim=8, layer_num=2)
    p = _carry(jm, tm, x)
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(), _jax(jm, p, x), **TOL)


def test_ring_attention_waits_for_the_parallel_slice(rng):
    """The parallel slice came: 'ring' without an sp mesh is a ring of one,
    equal to 'xla' on the same weights (tests/test_torch_parallel*.py hold
    it over ranks)."""
    tm, xla = tops.Attention(8, 4, 2, 8, impl="ring"), tops.Attention(8, 4, 2, 8, impl="xla")
    xla.load_state_dict(tm.state_dict())
    x = torch.tensor(rng.standard_normal((1, 4, 8)).astype(np.float32))
    np.testing.assert_allclose(tm(x).detach().numpy(), xla(x).detach().numpy(), **TOL)


def test_attention_pool(rng):
    x = rng.standard_normal((3, 10, 6)).astype(np.float32)
    mask = (np.arange(10)[None, :] < np.array([2, 5, 10])[:, None])[..., None]
    tm, jm = tops.AttentionPool(6, 2, 5), jops.AttentionPool(2, 5)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), mask=jnp.asarray(mask))
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params), tm))
    want = np.asarray(jm.apply(params, jnp.asarray(x), mask=jnp.asarray(mask)))
    got = tm(torch.from_numpy(x), mask=torch.from_numpy(mask)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("impl", ["xla", "pallas", "pallas_onehot"])
def test_scatter_connection_add(rng, impl):
    B, N, D, H, W = 2, 30, 4, 9, 7
    emb = rng.standard_normal((B, N, D)).astype(np.float32)
    loc = np.stack([rng.integers(-2, W + 3, (B, N)), rng.integers(-2, H + 3, (B, N))], -1)
    loc[0, :5] = loc[0, 0]  # collisions
    want = np.asarray(jops.scatter_connection(jnp.asarray(emb), jnp.asarray(loc), (H, W), "add"))
    got = tops.scatter_connection(torch.from_numpy(emb), torch.from_numpy(loc), (H, W), "add", impl=impl)
    assert got.shape == (B, H, W, D)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("impl", ["pallas", "pallas_onehot"])
def test_scatter_connection_add_bf16_bit_equal(rng, impl):
    """bf16 rows, as the 'bfloat16' compute dtype sends them: the JAX loop
    kernel ('pallas') adds them in bf16, rounding after every add in entity
    order; the one-hot kernel sums in f32 and rounds once. The port gives
    each bit for bit (int16 views), with the Pallas kernels in interpret
    mode. Collisions, out-of-range cells and padded rows (past a per-sample
    ``entity_num``, at cell (0, 0), ``-0.0 * x``) all on a 3x3 map."""
    B, N, D, H, W = 2, 64, 8, 3, 3
    emb = rng.standard_normal((B, N, D)).astype(np.float32)
    loc = np.stack([rng.integers(-2, W + 3, (B, N)), rng.integers(-2, H + 3, (B, N))], -1)
    loc[:, :6] = loc[:, :1]  # collisions
    for b, n in enumerate((40, 57)):
        loc[b, n:] = 0
        emb[b, n:] *= -0.0
    emb16 = torch.from_numpy(emb).to(torch.bfloat16)
    want = jops.scatter_connection(jnp.asarray(emb16.float().numpy(), jnp.bfloat16),
                                   jnp.asarray(loc), (H, W), "add", impl=impl)
    got = tops.scatter_connection(emb16, torch.from_numpy(loc), (H, W), "add", impl=impl)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


def test_scatter_connection_cover_and_bad_impl(rng):
    B, N, D, H, W = 2, 6, 3, 4, 5
    emb = rng.standard_normal((B, N, D)).astype(np.float32)
    cells = np.stack([rng.permutation(H * W)[:N] for _ in range(B)])  # distinct: cover is exact
    loc = np.stack([cells % W, cells // W], -1)
    want = np.asarray(jops.scatter_connection(jnp.asarray(emb), jnp.asarray(loc), (H, W), "cover"))
    got = tops.scatter_connection(torch.from_numpy(emb), torch.from_numpy(loc), (H, W), "cover")
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        tops.scatter_connection(torch.from_numpy(emb), torch.from_numpy(loc), (H, W), "cover", impl="pallas")
    with pytest.raises(ValueError):
        tops.scatter_connection(torch.from_numpy(emb), torch.from_numpy(loc), (H, W), impl="triton")

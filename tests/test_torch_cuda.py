"""The port's CUDA kernels against their plain versions, on the card.

Needs an NVIDIA GPU with nvcc; skips without one. This file imports
neither JAX nor the JAX package, so it runs where only the port is
installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from distar_tpu_torch.ops import kernels


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _scatter_inputs(rng, B, N, D, hw, case, device):
    """uniform: random cells, collisions, out-of-range indices; padded: rows
    past a per-sample ``entity_num`` at cell 0 with ``-0.0 * x`` embeddings,
    as observations arrive; one_cell: every row of a sample at one cell."""
    emb = rng.standard_normal((B, N, D)).astype(np.float32)
    idx = rng.integers(0, hw, (B, N))
    if case == "uniform":
        idx[0, :4] = idx[0, 0]  # collisions sum
        idx[:, 4], idx[:, 5] = -2, hw + 5  # out of range: clipped
    elif case == "padded":
        for b, n in enumerate(rng.integers(1, N + 1, B)):
            idx[b, n:] = 0
            emb[b, n:] *= -0.0
    else:
        idx[:] = rng.integers(0, hw, (B, 1))
    return torch.from_numpy(emb).to(device), torch.from_numpy(idx).to(device)


def _bits(t):
    return t.view(torch.int32)


ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # kernel vs plain, max abs
TILE = kernels.ATTENTION_KEY_TILE


def _attention_inputs(rng, B, H, N, Dh, mask, dtype, device, garbage=False):
    """q, k, v from the seed; with ``garbage`` the masked K/V rows are
    +-1e4 (finite, large), which must not reach the output."""
    q, k, v = (rng.standard_normal((B, H, N, Dh)).astype(np.float32) for _ in range(3))
    if garbage:
        keep = mask[:, None, :, None]
        k, v = (np.where(keep, t, 1e4 * np.sign(t)).astype(np.float32) for t in (k, v))
    return [torch.from_numpy(t).to(device, dtype) for t in (q, k, v)] + [
        torch.from_numpy(mask).to(device)]


def _attention_err(q, k, v, mask, want=None):
    got = kernels.masked_attention(q, k, v, mask)
    assert got.dtype == q.dtype and torch.isfinite(got.float()).all()
    want = kernels.masked_attention_plain(q, k, v, mask) if want is None else want
    return float((got.float() - want.float()).abs().max())


def _non_prefix_mask(rng, B, N, pattern):
    """last_tile: valid keys only in the last key tile; alternating: only in
    every other tile, starting with the second; both at random density, at
    least one valid key per sample."""
    tile = np.arange(N) // TILE
    where = tile == tile[-1] if pattern == "last_tile" else tile % 2 == 1
    if not where.any():  # one tile only: the alternating pattern keeps its first
        where = tile == 0
    mask = (rng.random((B, N)) < 0.5) & where
    mask[:, np.flatnonzero(where)[-1]] = True
    return mask


def _peaked_inputs(rng, B, H, N, Dh, device):
    """bf16 inputs, all keys valid, whose softmax rows weigh keys 0 and 1
    (scores about 20 and 20 - d, d = 0.05-0.15 by query; other keys about 0)
    with V rows +c and -c (c = 500-1000): an output of about c d / 2."""
    r = Dh ** 0.5  # undoes the 1/sqrt(Dh) scale
    q = np.zeros((B, H, N, Dh), np.float32)
    q[..., 0], q[..., 1] = 1.0, rng.uniform(0.5, 1.5, (B, H, N))
    k = 0.1 * rng.standard_normal((B, H, N, Dh)).astype(np.float32)
    k[:, :, :2] = 0.0
    k[:, :, :2, 0] = 20 * r
    k[:, :, 1, 1] = -0.1 * r
    v = rng.standard_normal((B, H, N, Dh)).astype(np.float32)
    c = rng.uniform(500, 1000, (B, H, Dh))
    v[:, :, 0], v[:, :, 1] = c, -c
    return [torch.from_numpy(t).to(device, torch.bfloat16) for t in (q, k, v)] + [
        torch.ones(B, N, dtype=torch.bool, device=device)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_masked_attention_kernel(cuda, dtype, tol):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((4, 2, 63, 32)).astype(np.float32))
               .to(cuda, dtype) for _ in range(3))
    mask = (torch.arange(63)[None, :] < torch.tensor([0, 1, 30, 63])[:, None]).to(cuda)
    kernels.reset_launch_counts()
    got = kernels.masked_attention(q, k, v, mask)
    assert kernels.launch_counts["masked_attention"] == 1 and got.dtype == dtype
    err = (got.float() - kernels.masked_attention_plain(q, k, v, mask).float()).abs().max()
    assert float(err) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [1, 63, 64, 65, 512])
@pytest.mark.parametrize("Dh", [4, 8, 32, 128])
def test_masked_attention_kernel_shapes(cuda, Dh, N, dtype):
    """Prefix masks with no, one, part and all keys valid; ragged key and
    query tiles; head dims padded to the kernel's 32, 64 or 128."""
    rng = np.random.default_rng(Dh * 1000 + N)
    mask = np.arange(N)[None, :] < np.array([0, 1, N // 2, N])[:, None]
    assert _attention_err(*_attention_inputs(rng, 4, 2, N, Dh, mask, dtype, cuda)) <= ATTN_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pattern", ["last_tile", "alternating"])
@pytest.mark.parametrize("N,Dh", [(512, 128), (65, 8)])
def test_masked_attention_kernel_non_prefix_masks(cuda, N, Dh, pattern, dtype):
    """Masks serving never sends: the tiles with no valid key are skipped,
    the partly valid ones computed with the -1e9 fill."""
    rng = np.random.default_rng(3)
    mask = _non_prefix_mask(rng, 4, N, pattern)
    assert _attention_err(*_attention_inputs(rng, 4, 2, N, Dh, mask, dtype, cuda)) <= ATTN_TOL[dtype]


@pytest.mark.cuda
def test_masked_attention_kernel_bf16_weights_near_f32(cuda):
    """bf16 rows whose output is the difference of two large weighted V rows
    (``_peaked_inputs``): the kernel keeps the softmax weights near f32 (P
    split into bf16 hi + lo), so it lands within one bf16 ulp of the plain
    version; weights rounded to bf16 land several ulps off."""
    q, k, v, mask = _peaked_inputs(np.random.default_rng(11), 4, 2, 64, 32, cuda)
    got = kernels.masked_attention(q, k, v, mask)
    want = kernels.masked_attention_plain(q, k, v, mask).float()
    assert float(want.abs().min()) > 1.0  # no output near zero, where an ulp is meaningless
    _, e = torch.frexp(want)
    assert float(((got.float() - want).abs() / torch.ldexp(torch.ones_like(want), e - 8)).max()) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,N,Dh", [(3, 2, 1100, 32), (1100, 1, 40, 8)])
def test_masked_attention_kernel_plan_edges(cuda, B, H, N, Dh, dtype):
    """The plan past one warp's word: more than 32 key tiles a sample (1100
    keys), and 1100 samples to rank. Sparse random masks, one sample with no
    valid key and one with all valid."""
    rng = np.random.default_rng(7)
    mask = rng.random((B, N)) < 0.05
    mask[0], mask[1] = False, True
    assert _attention_err(*_attention_inputs(rng, B, H, N, Dh, mask, dtype, cuda)) <= ATTN_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pattern", ["prefix", "alternating"])
def test_masked_attention_kernel_ignores_masked_rows(cuda, pattern, dtype):
    """Masked K/V rows at +-1e4 give the output of clean rows (every
    sample has a valid key, so no row averages the garbage)."""
    B, H, N, Dh = 4, 2, 512, 128
    rng = np.random.default_rng(4)
    mask = (np.arange(N)[None, :] < rng.integers(1, N + 1, (B, 1)) if pattern == "prefix"
            else _non_prefix_mask(rng, B, N, pattern))
    clean = _attention_inputs(np.random.default_rng(5), B, H, N, Dh, mask, dtype, cuda)
    dirty = _attention_inputs(np.random.default_rng(5), B, H, N, Dh, mask, dtype, cuda, garbage=True)
    assert not torch.equal(clean[1], dirty[1])
    assert _attention_err(*dirty, want=kernels.masked_attention_plain(*clean)) <= ATTN_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uniform", "padded", "one_cell"])
@pytest.mark.parametrize("hw", [63, 2048 + 37, 152 * 160])
@pytest.mark.parametrize("D", [32, 6])  # float4 path, and the scalar path
def test_scatter_kernels_bit_equal(cuda, hw, case, D):
    rng = np.random.default_rng(1)
    emb, idx = _scatter_inputs(rng, 2, 512, D, hw, case, cuda)
    loop = kernels.scatter_add_connection(emb, idx, hw)
    plain = kernels.scatter_add_plain(emb, idx, hw)
    # bit for bit, signs of zeros included
    assert torch.equal(_bits(loop), _bits(kernels.scatter_add_onehot(emb, idx, hw)))
    assert torch.equal(_bits(loop), _bits(plain))
    if case == "uniform":  # the matmul's sum order; a cell sums a handful of rows
        torch.testing.assert_close(loop, kernels.scatter_add_onehot_plain(emb, idx, hw), atol=1e-5,
                                   rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uniform", "padded", "one_cell"])
@pytest.mark.parametrize("D", [32, 6])  # 16-byte vectors of 8 bf16, and the scalar path
def test_scatter_kernels_bf16(cuda, case, D):
    """bfloat16 rows: the loop kernel adds in bfloat16, bit-equal to
    ``scatter_add_plain`` on the bfloat16 rows (the Pallas loop kernel's
    numerics); the 'pallas_onehot' route sums in float32 and rounds once."""
    from distar_tpu_torch.ops import scatter_connection

    hw = 152 * 160
    emb, idx = _scatter_inputs(np.random.default_rng(6), 2, 512, D, hw, case, cuda)
    emb = emb.bfloat16()
    loop = kernels.scatter_add_connection(emb, idx, hw)
    assert loop.dtype == torch.bfloat16
    assert torch.equal(loop.view(torch.int16), kernels.scatter_add_plain(emb, idx, hw).view(torch.int16))
    # the same through scatter_connection, cell (x, y) = (i % W, i // W)
    loc = torch.stack([idx.clamp(0, hw - 1) % 160, idx.clamp(0, hw - 1) // 160], -1)
    onehot = scatter_connection(emb, loc, (152, 160), impl="pallas_onehot").reshape(2, hw, D)
    once = kernels.scatter_add_plain(emb.float(), idx, hw).bfloat16()
    assert torch.equal(onehot.view(torch.int16), once.view(torch.int16))
    via = scatter_connection(emb, loc, (152, 160), impl="pallas").reshape(2, hw, D)
    assert torch.equal(via.view(torch.int16), loop.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["scatter_add_connection", "scatter_add_onehot"])
def test_scatter_launch_count_rises_by_one_per_call(cuda, name):
    emb, idx = _scatter_inputs(np.random.default_rng(2), 2, 64, 32, 63, "padded", cuda)
    kernels.reset_launch_counts()
    for n in range(1, 4):
        getattr(kernels, name)(emb, idx, 63)
        assert kernels.launch_counts == {k: n if k == name else 0 for k in kernels.launch_counts}


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 2, 8, 6, device=cuda)  # head dim not a multiple of 4
    with pytest.raises(ValueError):
        kernels.masked_attention(q, q, q, torch.ones(1, 8, dtype=torch.bool, device=cuda))
    emb = torch.zeros(1, 8, 4, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        kernels.scatter_add_connection(emb, torch.zeros(1, 8, dtype=torch.long, device=cuda), 9)
    wide = torch.zeros(1, 8, kernels.SCATTER_MAX_D + 4, device=cuda)  # rows wider than shared memory takes
    for fn in (kernels.scatter_add_connection, kernels.scatter_add_onehot):
        with pytest.raises(ValueError):
            fn(wide, torch.zeros(1, 8, dtype=torch.long, device=cuda), 9)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_masked_attention_gradient_matches_autograd_through_plain(cuda, dtype, tol):
    """The kernel's autograd Function: its forward (the kernel) against the
    plain version within ``tol`` max abs, and its backward (the JAX
    formula's float32 recompute, which sees the kernel only through the
    saved inputs) against autograd through the plain version; the backward
    launches no kernel. Gradient errors are absolute below 1 and relative
    above (a bf16 gradient of 8 has an ulp of 1/16). Sample 0 has no valid
    key: its output mean(V) does not depend on q or k, so autograd gives
    dq = dk = 0 there, while the JAX formula's ds = p (dp - sum(dp p)) with
    a uniform p does not vanish; the port keeps the JAX formula, so that
    sample is held on dv only (the model always has an entity)."""
    rng = np.random.default_rng(8)
    mask = np.arange(63)[None, :] < np.array([0, 1, 30, 63])[:, None]
    q, k, v, m = _attention_inputs(rng, 4, 2, 63, 32, mask, dtype, cuda)
    w = torch.from_numpy(rng.standard_normal((4, 2, 63, 32)).astype(np.float32)).to(cuda, dtype)
    outs, grads = {}, {}
    for name, fn in (("kernel", kernels.masked_attention), ("plain", kernels.masked_attention_plain)):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        kernels.reset_launch_counts()
        outs[name] = fn(*leaves, m)
        (outs[name] * w).sum().backward()
        assert kernels.launch_counts["masked_attention"] == (name == "kernel")
        grads[name] = [t.grad for t in leaves]
    assert outs["kernel"].dtype == dtype
    assert float((outs["kernel"].detach().float() - outs["plain"].detach().float()).abs().max()) <= tol
    for i, (got, want) in enumerate(zip(grads["kernel"], grads["plain"])):
        assert got.dtype == dtype
        got, want = got.float(), want.float()
        if i < 2:  # dq, dk: the samples with a valid key
            got, want = got[1:], want[1:]
        assert float(((got - want).abs() / want.abs().clamp_min(1.0)).max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uniform", "padded"])
@pytest.mark.parametrize("name", ["scatter_add_connection", "scatter_add_onehot"])
def test_scatter_gradient_matches_autograd_through_plain(cuda, name, case):
    """The kernel's autograd Function: its forward (the kernel) bit-equal to
    the entity-order loop, and its gather backward equal element for element
    to autograd through the kernel's plain version (each gradient is one
    dout element)."""
    hw = 152 * 160
    emb, idx = _scatter_inputs(np.random.default_rng(9), 2, 64, 32, hw, case, cuda)
    w = torch.from_numpy(np.random.default_rng(10).standard_normal((2, hw, 32)).astype(np.float32)).to(cuda)
    plain = kernels.scatter_add_plain if name == "scatter_add_connection" else kernels.scatter_add_onehot_plain
    grads = []
    for fn in (getattr(kernels, name), plain):
        e = emb.detach().clone().requires_grad_()
        out = fn(e, idx, hw)
        if fn is not plain:
            want = kernels.scatter_add_plain(emb, idx, hw)
            assert torch.equal(_bits(out.detach()), _bits(want))
        (out * w).sum().backward()
        grads.append(e.grad)
    assert torch.equal(grads[0], grads[1])


# the RL learner's shapes: (T+1) x B = 17 x 4 = 68 frames of 512 entities;
# the flagship's head dim 128 and scatter width 32, the student's 64 and 16
RL_FRAMES = 68


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dh", [128, 64])
def test_masked_attention_kernel_at_the_rl_shapes(cuda, Dh, dtype):
    rng = np.random.default_rng(Dh)
    mask = np.arange(512)[None, :] < np.maximum(rng.integers(1, 512, (RL_FRAMES, 1)), 8)
    assert _attention_err(*_attention_inputs(rng, RL_FRAMES, 2, 512, Dh, mask, dtype, cuda)) <= ATTN_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uniform", "padded"])
@pytest.mark.parametrize("D", [32, 16])
def test_scatter_kernels_at_the_rl_shapes(cuda, D, case):
    hw = 152 * 160
    emb, idx = _scatter_inputs(np.random.default_rng(D), RL_FRAMES, 512, D, hw, case, cuda)
    loop = kernels.scatter_add_connection(emb, idx, hw)
    assert torch.equal(_bits(loop), _bits(kernels.scatter_add_plain(emb, idx, hw)))
    assert torch.equal(_bits(loop), _bits(kernels.scatter_add_onehot(emb, idx, hw)))

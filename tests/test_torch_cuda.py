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


# ------------------------------------------------------ the learner runtime
def _array_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _array_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _array_leaves(v)]
    return [tree]


@pytest.mark.cuda
def test_prefetcher_places_on_a_side_stream_from_pinned_memory(cuda, monkeypatch):
    """The producer thread places on the prefetcher's own stream, from
    pinned host memory; the batches arrive in order, equal to their host
    values, and the consumer's stream reads them after the copy."""
    from distar_tpu_torch.learner.prefetch import DevicePrefetcher, place_on

    pinned = []
    real_pin = torch.Tensor.pin_memory
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda t, *a: pinned.append(1) or real_pin(t, *a))
    rng = np.random.default_rng(0)
    host = [{"x": rng.standard_normal((1024, 512)).astype(np.float32), "i": np.arange(7) + k}
            for k in range(4)]
    streams = []

    def place(batch):
        streams.append(torch.cuda.current_stream(cuda))
        return place_on(batch, cuda)

    pf = DevicePrefetcher(iter(host), place, depth=2, device=cuda)
    main = torch.cuda.current_stream(cuda)
    for k, batch in enumerate(pf):
        assert batch["x"].is_cuda and batch["x"].device == torch.device("cuda", 0)
        assert torch.equal(batch["x"].cpu(), torch.from_numpy(host[k]["x"]))
        assert batch["i"].tolist() == list(range(k, k + 7))
    assert len(streams) == 4 and all(s == pf._stream and s != main for s in streams)
    assert len(pinned) == 8  # every array went through pinned memory


@pytest.mark.cuda
def test_async_save_from_cuda_tensors_holds_the_saved_step(cuda, tmp_path):
    """A learner on the card saves in the background while it trains on:
    the checkpoint holds the state at the save, and a fresh learner on the
    card restores it bit for bit."""
    from distar_tpu_torch.bin.sl_train import SMOKE_MODEL
    from distar_tpu_torch.learner import SLLearner, random_sl_batch

    def learner(root):
        return SLLearner({"common": {"save_path": str(root)},
                          "learner": {"batch_size": 2, "unroll_len": 4, "save_freq": 10 ** 9},
                          "model": SMOKE_MODEL}, device=cuda)

    rng = np.random.default_rng(1)
    a = learner(tmp_path / "a")
    a._train(random_sl_batch(2, 4, rng))
    want = a.state
    path = str(tmp_path / "async.ckpt")
    a.save(path)  # the host copy is taken here, the write runs on
    a._train(random_sl_batch(2, 4, rng))  # an in-place update while it writes
    a._checkpointer.wait()
    assert a.checkpoint_manager.generations()[0]["path"] == path
    b = learner(tmp_path / "b")
    b.restore(path)
    got, want = _array_leaves(b.state), _array_leaves(want)
    assert len(got) == len(want) > 200
    for x, y in zip(got, want):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert next(b.model.parameters()).is_cuda and b.optimizer.mu[0].is_cuda



@pytest.mark.cuda
def test_rl_train_all_runs_on_the_card(cuda, tmp_path, monkeypatch):
    """``bin/rl_train.py --type all`` at the smoke model with the kernel
    overlay, on CUDA by default: two learner iterations on actor-made
    batches, the kernels launched on the actor's flushes and the
    learner's steps."""
    import json

    from distar_tpu_torch.bin import rl_train
    from distar_tpu_torch.bin.sl_train import SMOKE_MODEL
    from distar_tpu_torch.utils import deep_merge_dicts

    monkeypatch.setenv("DISTAR_EXPERIMENTS_ROOT", str(tmp_path))
    model = deep_merge_dicts(SMOKE_MODEL, {"encoder": {"entity": {"attention_impl": "pallas"},
                                                       "scatter": {"impl": "pallas"}}})
    kernels.reset_launch_counts()
    loop = rl_train.main(["--type", "all", "--iters", "2", "--env-num", "2", "--traj-len", "2",
                          "--batch-size", "2", "--episode-game-loops", "60",
                          "--config", json.dumps({"model": model})])
    assert loop.learner.last_iter.val == 2
    assert next(loop.learner.model.parameters()).is_cuda
    assert np.isfinite(loop.learner.variable_record.get("total_loss").avg)
    assert kernels.launch_counts["masked_attention"] > 0
    assert kernels.launch_counts["scatter_add_connection"] > 0


def _jaxenv_actions(rng, B, N, device):
    """Seeded actions in the contract layout, junk included (as
    tests/test_torch_jaxenv.py draws them)."""
    from distar_tpu_torch.envs.jaxenv.core import MICRO_ACTION_TYPES
    from distar_tpu_torch.lib import actions as ACT
    from distar_tpu_torch.lib import features as F

    micro = np.asarray(MICRO_ACTION_TYPES)
    action = {
        "action_type": np.where(rng.random(B) < 0.5, micro[rng.integers(0, len(micro), B)],
                                rng.integers(-2, ACT.NUM_ACTIONS + 2, B)),
        "delay": rng.integers(0, 128, B),
        "queued": rng.integers(0, 2, B),
        "selected_units": rng.integers(-1, N + 2, (B, F.MAX_SELECTED_UNITS_NUM)),
        "target_unit": rng.integers(-1, N + 2, B),
        "target_location": rng.integers(-5, F.SPATIAL_SIZE[0] * F.SPATIAL_SIZE[1] + 5, B),
    }
    sun = rng.integers(0, N + 3, B)
    return ({k: torch.from_numpy(v).to(device) for k, v in action.items()},
            torch.from_numpy(sun).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("away", ["scripted", "explicit"])
def test_jaxenv_step_on_the_card_matches_the_cpu(cuda, away):
    """The micro-battle world on CUDA against the same world on the CPU:
    one scenario batch (drawn on the CPU, copied over), 48 steps of 16
    lanes with seeded actions; every state leaf, reward, done, winner and
    observation leaf of both teams bit-equal at every step (the env's
    float32 operations are IEEE on both devices; its square roots and fused
    multiply-adds are taken in float64 and rounded once)."""
    from distar_tpu_torch.envs import jaxenv as P

    env, B = P.EnvConfig(units_per_squad=8), 16
    scn = P.ScenarioGenerator(P.ScenarioConfig(episode_len=48)).batch(B, torch.Generator().manual_seed(2))
    states = {"cpu": P.reset(env, scn), "cuda": P.reset(env, P.Scenario(*(x.to(cuda) for x in scn)))}
    rng = np.random.default_rng(3)
    for t in range(48):
        acts = [_jaxenv_actions(rng, B, env.num_units, "cpu") for _ in range(1 if away == "scripted" else 2)]
        out = {}
        for dev, st in states.items():
            args = [x for a, s in acts for x in ({k: v.to(dev) for k, v in a.items()}, s.to(dev))]
            out[dev] = P.step(env, st, *args)
            states[dev] = out[dev][0]
        for f in P.EnvState._fields[1:]:
            a, b = getattr(states["cpu"], f), getattr(states["cuda"], f).cpu()
            assert torch.equal(a, b), (t, f)
        for k in ("battle", "winloss"):
            assert torch.equal(out["cpu"][1][k], out["cuda"][1][k].cpu()), (t, k)
        assert torch.equal(out["cpu"][3], out["cuda"][3].cpu())
        for team in (0, 1):
            want, got = P.observe(env, states["cpu"], team), P.observe(env, states["cuda"], team)
            for section in ("spatial_info", "scalar_info", "entity_info"):
                for k, v in want[section].items():
                    assert torch.equal(v, got[section][k].cpu()), (t, team, section, k)
    assert bool(states["cuda"].done.all())


@pytest.mark.cuda
def test_anakin_window_on_the_card_is_device_pure(cuda):
    """A steady-state window of the smoke model with the kernel overlay
    runs under ``set_sync_debug_mode("error")`` and launches both kernels;
    ``purity_report`` finds it pure and finds a planted ``nonzero``; the
    learner steps on its batch."""
    from distar_tpu_torch.bin.sl_train import SMOKE_MODEL
    from distar_tpu_torch.envs import jaxenv as P
    from distar_tpu_torch.learner import RLLearner
    from distar_tpu_torch.utils import deep_merge_dicts

    model_cfg = deep_merge_dicts(SMOKE_MODEL, {"encoder": {"entity": {"attention_impl": "pallas"},
                                                           "scatter": {"impl": "pallas"}}})
    learner = RLLearner({"learner": {"batch_size": 4, "unroll_len": 4, "prefetch_depth": 0},
                         "model": model_cfg}, device=cuda)
    runner = P.AnakinRunner(learner.model, 4, 4, P.EnvConfig(units_per_squad=4),
                            P.ScenarioConfig(units_per_squad=4, max_units=4, episode_len=6))
    loader = P.AnakinDataLoader(runner, model_provider=lambda: learner.model)
    next(loader)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        carry, batch = runner.rollout(learner.model, loader._carry)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert kernels.launch_counts["masked_attention"] > 0 and kernels.launch_counts["scatter_add_connection"] > 0
    assert batch["spatial_info"]["height_map"].is_cuda
    assert runner.purity_report(learner.model, carry) == {"pure": True, "offending": []}
    planted = P.device_pure_report(lambda: torch.ones(3, device=cuda).nonzero())
    assert not planted["pure"] and planted["offending"][0].startswith("sync at "), planted
    log = learner._train(batch)
    assert np.isfinite(log["total_loss"])


def _league_args(extra, tmp_path):
    import json

    from distar_tpu_torch.bin import rl_train
    from distar_tpu_torch.bin.sl_train import SMOKE_MODEL
    from distar_tpu_torch.utils import deep_merge_dicts

    model = deep_merge_dicts(SMOKE_MODEL, {"encoder": {"entity": {"attention_impl": "pallas"},
                                                       "scatter": {"impl": "pallas"}}})
    args = rl_train.parser().parse_args(
        ["--batch-size", "2", "--traj-len", "3", "--jaxenv-units", "2", "--jaxenv-episode-len", "8",
         "--save-path", str(tmp_path), "--config", json.dumps({"model": model})] + extra)
    rl_train._resolve_args(args)
    return args


@pytest.mark.cuda
def test_league_learner_first_window_is_device_pure(cuda, tmp_path):
    """A league learner's first window (the home seat and the away seat's
    frozen initial policy) on CUDA, from a process with no lookup table on
    the card yet (the runner uploads them under the index-filled device
    name the generator's draws carry): pure by ``purity_report``, and a second
    window runs under ``set_sync_debug_mode("error")`` launching both
    kernels; one league round against an in-process control plane."""
    from distar_tpu_torch.bin import rl_train
    from distar_tpu_torch.envs.jaxenv import scenario
    from distar_tpu_torch.league.runtime.runner import LeagueRunner

    scenario._TABLES.clear()  # as in a fresh learner process: no table on the card yet
    runner = LeagueRunner(("MP0", "EP0"), save_path=str(tmp_path))
    addr = runner.start_control_plane()
    try:
        args = _league_args(["--type", "league-learner", "--player-id", "EP0", "--coordinator-addr", addr,
                             "--league-rounds", "1", "--no-supervise"], tmp_path)
        learner, loader, loop, report = rl_train.build_league_learner(args)
        assert report == {"pure": True, "offending": []}
        assert next(learner.model.parameters()).is_cuda
        next(loader)
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            carry, batch = loader.runner.rollout(learner.model, loader._carry,
                                                 opponent_model=loader._opponent_model())
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert kernels.launch_counts["masked_attention"] > 0
        assert kernels.launch_counts["scatter_add_connection"] > 0
        loader._carry = carry
        out = loop.run()
        assert out["jobs"] == 1 and out["mints"] == 1
    finally:
        runner.shutdown()


@pytest.mark.cuda
def test_arena_batch_on_the_card_matches_the_cpu(cuda, tmp_path):
    """One arena batch of a smoke-model generation against attack_nearest
    on CUDA and on the CPU, the same scenarios (drawn on the CPU) and the
    same Gumbel draws (each seat's from one CPU generator): the same
    winners and game steps."""
    from distar_tpu_torch import arena as A
    from distar_tpu_torch.arena import evaluator as E
    from distar_tpu_torch.bin.sl_train import SMOKE_MODEL
    from distar_tpu_torch.envs import jaxenv as P
    from distar_tpu_torch.model import Model, default_model_config, init_params, noise_shapes
    from distar_tpu_torch.model.convert import params_to_flax
    from distar_tpu_torch.utils import deep_merge_dicts
    from distar_tpu_torch.utils.checkpoint import CheckpointManager, save_checkpoint

    model_cfg = deep_merge_dicts(SMOKE_MODEL, {"encoder": {"entity": {"attention_impl": "pallas"},
                                                           "scatter": {"impl": "pallas"}}})
    model = Model(deep_merge_dicts(default_model_config(), model_cfg))
    init_params(model, 2)
    ckpt_dir = str(tmp_path / "ckpt")
    path = str(tmp_path / "ckpt" / "g.ckpt")
    import os

    os.makedirs(ckpt_dir)
    save_checkpoint(path, params_to_flax(model))
    CheckpointManager(ckpt_dir).record(path, step=7)
    env = P.EnvConfig(units_per_squad=2)
    scn = P.ScenarioConfig(units_per_squad=2, min_units=2, max_units=2, episode_len=24, spawn_margin=50.0,
                           spawn_spread=4.0, mirror_types=True, blocked_frac=0.0)
    real_scenarios, real_h2h = E.assignment_scenarios, E.head_to_head

    class Fed:
        def __init__(self, policy):
            self.policy, self.gen = policy, torch.Generator().manual_seed(11)

        def init_carry(self, batch, device=None):
            return self.policy.init_carry(batch, device)

        def __call__(self, obs, carry, generator=None):
            B = obs["entity_num"].shape[0]
            dev = obs["entity_num"].device
            noise = {k: -torch.log(-torch.log(torch.rand(s, generator=self.gen).clamp_min(1e-30))).to(dev)
                     for k, s in noise_shapes(self.policy.model.cfg, B).items()}
            return self.policy(obs, carry, noise=noise)

    results = {}
    try:
        E.assignment_scenarios = lambda seed, n, cfg, device: P.Scenario(
            *(x.to(device) for x in real_scenarios(seed, n, cfg, "cpu")))
        E.head_to_head = lambda a, b, **kw: real_h2h(*(Fed(p) if isinstance(p, P.ModelPolicy) else p
                                                       for p in (a, b)), **kw)
        for dev in ("cpu", cuda):
            ev = A.ArenaEvaluator(ckpt_dir, model_cfg, store=A.ArenaStore(), episodes=8, env_cfg=env,
                                  scenario_cfg=scn, device=dev)
            out = ev.evaluate_once()
            assert {out["assignment"]["home"], out["assignment"]["away"]} == {"main:7", "attack_nearest"}
            results[str(dev)] = [(m["winner"], m["game_steps"]) for m in out["result"]["matches"]]
    finally:
        E.assignment_scenarios, E.head_to_head = real_scenarios, real_h2h
    assert results["cpu"] == results["cuda"]

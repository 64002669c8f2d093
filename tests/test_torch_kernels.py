"""The port's kernel wrappers (distar_tpu_torch/ops/kernels.py) against the
JAX package's Pallas kernels, run in interpret mode on the CPU as
tests/test_pallas_kernels.py runs them.

On a CPU tensor each wrapper takes its plain PyTorch version; those are what
is held against Pallas here. The CUDA kernels themselves are held against
the plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distar_tpu.ops.pallas_kernels import (
    masked_attention as pallas_attention,
    scatter_add_connection as pallas_scatter,
    scatter_add_onehot as pallas_onehot,
)
from distar_tpu_torch.ops import build, kernels

torch.set_num_threads(1)

# f32: the precedent of tests/test_pallas_kernels.py. bf16: both sides
# compute in f32 and round once to bf16, so they differ by at most one bf16
# ulp (2^-8 relative) where the f32 results straddle a rounding boundary.
TOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": dict(atol=1e-2, rtol=1e-2)}


def _qkv(rng, B, H, N, Dh):
    return [rng.standard_normal((B, H, N, Dh)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lengths", [(1, 1, 1, 1), (0, 1, 23, 64), (64, 64, 64, 64)],
                         ids=["one_key", "none_one_partial_all", "all_keys"])
def test_masked_attention_plain_matches_pallas(rng, dtype, lengths):
    B, H, N, Dh = 4, 2, 64, 32
    q, k, v = _qkv(rng, B, H, N, Dh)
    mask = np.arange(N)[None, :] < np.asarray(lengths)[:, None]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = pallas_attention(*(jnp.asarray(t, jd) for t in (q, k, v)), jnp.asarray(mask),
                            interpret=True)
    got = kernels.masked_attention(*(torch.from_numpy(t).to(td) for t in (q, k, v)),
                                   torch.from_numpy(mask))
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL[dtype])


def test_masked_attention_row_without_keys_is_mean_v(rng):
    B, H, N, Dh = 1, 2, 16, 8
    q, k, v = (torch.from_numpy(t) for t in _qkv(rng, B, H, N, Dh))
    out = kernels.masked_attention(q, k, v, torch.zeros(B, N, dtype=torch.bool))
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), v.mean(dim=2, keepdim=True).expand_as(v).numpy(),
                               atol=2e-6)


SCATTER_CASES = ["uniform", "padded", "one_cell"]


def _scatter_inputs(rng, B, N, D, hw, case="uniform"):
    """uniform: random cells with forced collisions and out-of-range indices;
    padded: as observations arrive, ``entity_num`` drawn per sample and the
    rows past it at cell 0 with embeddings ``-0.0 * x`` (the model zeroes
    them, and the sign of a zero product varies); one_cell: every row of a
    sample at one cell."""
    emb = rng.standard_normal((B, N, D)).astype(np.float32)
    idx = rng.integers(0, hw, (B, N)).astype(np.int32)
    if case == "uniform":
        idx[0, :4] = idx[0, 0]  # collisions sum
        idx[:, 4] = -2  # out of range: clipped to 0
        idx[:, 5] = hw + 5  # out of range: clipped to hw-1
    elif case == "padded":
        for b, n in enumerate(rng.integers(1, N + 1, B)):
            idx[b, n:] = 0
            emb[b, n:] *= -0.0
    elif case == "one_cell":
        idx[:] = rng.integers(0, hw, (B, 1))
    else:
        raise ValueError(case)
    return emb, idx


@pytest.mark.parametrize("case", SCATTER_CASES)
@pytest.mark.parametrize("kernel", ["scatter_add_connection", "scatter_add_onehot"])
@pytest.mark.parametrize("hw", [63, 2048 + 37])  # ragged last chunk, and more than one chunk
def test_scatter_plain_matches_pallas(rng, kernel, hw, case):
    B, N, D = 2, 24, 8
    emb, idx = _scatter_inputs(rng, B, N, D, hw, case)
    pallas = pallas_onehot if kernel == "scatter_add_onehot" else pallas_scatter
    want = pallas(jnp.asarray(emb), jnp.asarray(idx), hw, interpret=True)
    got = getattr(kernels, kernel)(torch.from_numpy(emb), torch.from_numpy(idx), hw)
    assert got.shape == (B, hw, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])


@pytest.mark.parametrize("case", SCATTER_CASES)
def test_scatter_plain_versions_agree_and_loop_is_entity_order(rng, case):
    emb, idx = _scatter_inputs(rng, 3, 40, 4, 63, case)
    e, i = torch.from_numpy(emb), torch.from_numpy(idx)
    loop = kernels.scatter_add_plain(e, i, 63)
    np.testing.assert_allclose(kernels.scatter_add_onehot_plain(e, i, 63).numpy(), loop.numpy(),
                               atol=1e-6)
    ref = np.zeros((3, 63, 4), np.float32)
    for b in range(3):
        for n in range(40):
            ref[b, min(max(idx[b, n], 0), 62)] += emb[b, n]
    # bit for bit, signs of zeros included: the same order of f32 adds from +0.0
    assert np.array_equal(loop.numpy().view(np.uint32), ref.view(np.uint32))


def test_cpu_tensors_take_plain_versions_without_counting(rng):
    kernels.reset_launch_counts()
    q, k, v = (torch.from_numpy(t) for t in _qkv(rng, 1, 2, 8, 4))
    mask = torch.ones(1, 8, dtype=torch.bool)
    assert torch.equal(kernels.masked_attention(q, k, v, mask),
                       kernels.masked_attention_plain(q, k, v, mask))
    emb, idx = (torch.from_numpy(t) for t in _scatter_inputs(rng, 1, 8, 2, 9))
    assert torch.equal(kernels.scatter_add_connection(emb, idx, 9), kernels.scatter_add_plain(emb, idx, 9))
    assert torch.equal(kernels.scatter_add_onehot(emb, idx, 9),
                       kernels.scatter_add_onehot_plain(emb, idx, 9))
    assert kernels.launch_counts == {name: 0 for name in build.KERNELS}


def test_no_fallback_on_other_devices():
    """A tensor that is neither on the CPU nor on CUDA has no kernel and no
    plain path: the wrappers raise rather than compute somewhere else."""
    q = torch.empty(1, 2, 8, 4, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        kernels.masked_attention(q, q, q, torch.ones(1, 8, dtype=torch.bool, device="meta"))
    emb = torch.empty(1, 8, 2, device="meta")
    for fn in (kernels.scatter_add_connection, kernels.scatter_add_onehot):
        with pytest.raises(RuntimeError, match="no kernel"):
            fn(emb, torch.zeros(1, 8, dtype=torch.int32, device="meta"), 9)


def test_library_path_is_keyed_by_source_and_flags(monkeypatch, tmp_path):
    paths = {name: build.library_path(name) for name in build.KERNELS}
    assert len(set(paths.values())) == len(build.KERNELS)
    assert all(p.parent == build.BUILD_DIR for p in paths.values())
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.library_path("masked_attention") != paths["masked_attention"]
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS

    # an edit to any header, or a new one, rebuilds every kernel (on a copy of csrc/)
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {name: build.library_path(name) for name in build.KERNELS}
    with open(csrc / "common.cuh", "a") as f:
        f.write("// edited\n")
    edited = {name: build.library_path(name) for name in build.KERNELS}
    assert all(edited[name] != before[name] for name in build.KERNELS)
    (csrc / "scatter_common.cuh").write_text("#pragma once\n")
    assert all(build.library_path(name) != edited[name] for name in build.KERNELS)

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


def _scatter_inputs(rng, B, N, D, hw, device):
    emb = torch.from_numpy(rng.standard_normal((B, N, D)).astype(np.float32)).to(device)
    idx = rng.integers(0, hw, (B, N))
    idx[0, :4] = idx[0, 0]  # collisions sum
    idx[:, 4], idx[:, 5] = -2, hw + 5  # out of range: clipped
    return emb, torch.from_numpy(idx).to(device)


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
@pytest.mark.parametrize("hw", [63, 2048 + 37, 152 * 160])
def test_scatter_kernels_bit_equal(cuda, hw):
    rng = np.random.default_rng(1)
    emb, idx = _scatter_inputs(rng, 2, 512, 32, hw, cuda)
    loop = kernels.scatter_add_connection(emb, idx, hw)
    assert torch.equal(loop, kernels.scatter_add_onehot(emb, idx, hw))
    assert torch.equal(loop, kernels.scatter_add_plain(emb, idx, hw))
    torch.testing.assert_close(loop, kernels.scatter_add_onehot_plain(emb, idx, hw), atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 2, 8, 6, device=cuda)  # head dim not a multiple of 4
    with pytest.raises(ValueError):
        kernels.masked_attention(q, q, q, torch.ones(1, 8, dtype=torch.bool, device=cuda))
    emb = torch.zeros(1, 8, 4, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        kernels.scatter_add_connection(emb, torch.zeros(1, 8, dtype=torch.long, device=cuda), 9)

"""The three kernels of the serving path, each beside its plain version.

Counterparts of the Pallas kernels in ``distar_tpu/ops/pallas_kernels.py``:

* ``masked_attention``       — softmax(mask(q k^T / sqrt(Dh), -1e9)) v
* ``scatter_add_connection`` — per-batch scatter-add of entity rows onto the
  flattened map, entity order, collisions sum
* ``scatter_add_onehot``     — the same sum as onehot(idx)^T . emb

Each wrapper takes the plain PyTorch version for a tensor that lies on the
CPU. For a CUDA tensor it launches the hand-written kernel
(``csrc/<name>.cu``, built at first use by ``build.py``) or raises: there is
no fallback. ``launch_counts[name]`` counts the wrapper's kernel launches, so
a run can show that its main path went through the kernels.
"""
from __future__ import annotations

import torch

from . import build

NEG_INF = -1e9
ONEHOT_CHUNK = 2048  # cells per program, as the Pallas one-hot kernel

launch_counts = {name: 0 for name in build.KERNELS}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _check_cuda(name: str, tensors, dtypes) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous input")
    if tensors[0].dtype not in dtypes:
        raise TypeError(f"{name}: dtype {tensors[0].dtype} not in {dtypes}")


def _launch(name: str, device: torch.device, *args) -> None:
    fn = getattr(build.load(name), f"{name}_fwd")
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with cudaError {err}")
    launch_counts[name] += 1


def _dispatch(name: str, t: torch.Tensor) -> bool:
    """True for the plain version (a CPU tensor), False for the kernel (a
    CUDA tensor); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {t.device}")
    return False


# --------------------------------------------------------------- attention
def masked_attention_plain(q, k, v, mask, upcast: bool = True):
    """Softmax attention with the -1e9 key fill after the scale, written back
    in the input dtype. ``upcast`` computes in f32 (the Pallas kernel's
    numerics); without it the math stays in the input dtype (the JAX 'xla'
    attention's numerics)."""
    dtype = q.dtype
    if upcast:
        q, k, v = q.float(), k.float(), v.float()
    score = torch.einsum("bhqd,bhkd->bhqk", q, k) / (float(q.shape[-1]) ** 0.5)
    score = score.masked_fill(~mask.bool()[:, None, None, :], NEG_INF)
    p = torch.softmax(score, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v).to(dtype)


def masked_attention(q, k, v, mask):
    """q, k, v: [B, H, N, Dh] (float32 or bfloat16); mask: [B, N] key
    validity. Returns [B, H, N, Dh] in the input dtype."""
    if _dispatch("masked_attention", q):
        return masked_attention_plain(q, k, v, mask)
    B, H, N, Dh = q.shape
    if k.shape != q.shape or v.shape != q.shape or tuple(mask.shape) != (B, N):
        raise ValueError(f"masked_attention: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} mask{tuple(mask.shape)}")
    if Dh > 128 or Dh % 4:
        raise ValueError(f"masked_attention: head dim {Dh} (kernel takes a multiple of 4, <= 128)")
    mask = mask.to(torch.bool).contiguous()
    _check_cuda("masked_attention", (q, k, v, mask), (torch.float32, torch.bfloat16))
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("masked_attention: q, k, v dtypes differ")
    out = torch.empty_like(q)
    _launch("masked_attention", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            mask.data_ptr(), out.data_ptr(), B, H, N, Dh, 1.0 / (Dh ** 0.5),
            int(q.dtype == torch.bfloat16))
    return out


# ----------------------------------------------------------------- scatter
def scatter_add_plain(embeddings, flat_idx, hw: int):
    """Entity-order scatter-add: zero [B, hw, D], then add row i of every
    batch at its clipped cell, for i = 0..N-1. Within one i the B rows hit
    distinct batches, so the sum order is the loop kernel's exactly."""
    B, N, D = embeddings.shape
    idx = flat_idx.long().clamp(0, hw - 1)
    flat = idx + torch.arange(B, device=idx.device)[:, None] * hw
    out = torch.zeros(B * hw, D, dtype=embeddings.dtype, device=embeddings.device)
    for i in range(N):
        out[flat[:, i]] += embeddings[:, i]
    return out.view(B, hw, D)


def scatter_add_onehot_plain(embeddings, flat_idx, hw: int):
    """The one-hot formulation: per chunk of cells, onehot(idx)^T . emb in
    f32 (a matmul; its sum order is the matmul's, not entity order)."""
    B, N, D = embeddings.shape
    idx = flat_idx.long().clamp(0, hw - 1)
    out = []
    for c0 in range(0, hw, ONEHOT_CHUNK):
        cells = torch.arange(c0, min(c0 + ONEHOT_CHUNK, hw), device=idx.device)
        onehot = (idx[:, :, None] == cells).float()  # [B, N, chunk]
        out.append(torch.einsum("bnc,bnd->bcd", onehot, embeddings.float()))
    return torch.cat(out, dim=1).to(embeddings.dtype)


def _scatter_kernel(name: str, embeddings, flat_idx, hw: int):
    B, N, D = embeddings.shape
    if tuple(flat_idx.shape) != (B, N):
        raise ValueError(f"{name}: idx shape {tuple(flat_idx.shape)} for embeddings "
                         f"{tuple(embeddings.shape)}")
    idx = flat_idx.clamp(0, hw - 1).to(torch.int32).contiguous()
    _check_cuda(name, (embeddings, idx), (torch.float32,))
    out = torch.empty(B, hw, D, dtype=embeddings.dtype, device=embeddings.device)
    _launch(name, embeddings.device, embeddings.data_ptr(), idx.data_ptr(), out.data_ptr(),
            B, N, D, hw)
    return out


def scatter_add_connection(embeddings, flat_idx, hw: int):
    """embeddings: [B, N, D] float32 (invalid entities zeroed); flat_idx:
    [B, N] int cell index, clipped here to [0, hw-1]. Returns [B, hw, D]."""
    if _dispatch("scatter_add_connection", embeddings):
        return scatter_add_plain(embeddings, flat_idx, hw)
    return _scatter_kernel("scatter_add_connection", embeddings, flat_idx, hw)


def scatter_add_onehot(embeddings, flat_idx, hw: int):
    """The same function as :func:`scatter_add_connection`; the kernel gives
    the loop kernel's f32 result bit for bit."""
    if _dispatch("scatter_add_onehot", embeddings):
        return scatter_add_onehot_plain(embeddings, flat_idx, hw)
    return _scatter_kernel("scatter_add_onehot", embeddings, flat_idx, hw)

"""Scatter-connection: write per-entity embeddings onto the spatial map.

Counterpart of ``distar_tpu.ops.scatter.scatter_connection``: each entity's
D-dim embedding is added (or written) at its (x, y) cell of a [B, H, W, D]
map. x clips to [0, W-1] and y to [0, H-1], then ``flat = y*W + x``.
'pallas' and 'pallas_onehot' dispatch the add mode to the two scatter
kernels (float32; another dtype is summed in float32 and cast back).
"""
from __future__ import annotations

import torch

from . import kernels


def scatter_connection(
    embeddings: torch.Tensor,  # [B, N, D]
    locations: torch.Tensor,  # [B, N, 2] as (x, y) int
    spatial_size,  # (H, W)
    mode: str = "add",
    impl: str = "xla",  # 'xla' | 'pallas' | 'pallas_onehot' (add mode only)
) -> torch.Tensor:
    """Return the [B, H, W, D] map with embeddings scattered at entity cells."""
    B, N, D = embeddings.shape
    H, W = spatial_size
    x = locations[..., 0].long().clamp(0, W - 1)
    y = locations[..., 1].long().clamp(0, H - 1)
    flat_idx = y * W + x  # [B, N] in row-major (y, x) order

    if impl in ("pallas", "pallas_onehot"):
        if mode != "add":
            raise ValueError("the scatter kernels implement add mode")
        kernel = kernels.scatter_add_onehot if impl == "pallas_onehot" else kernels.scatter_add_connection
        out = kernel(embeddings.float().contiguous(), flat_idx, H * W)
        return out.to(embeddings.dtype).reshape(B, H, W, D)
    if impl != "xla":
        raise ValueError(f"unknown scatter impl {impl!r} (xla|pallas|pallas_onehot)")

    flat = (flat_idx + torch.arange(B, device=flat_idx.device)[:, None] * (H * W)).reshape(-1)
    buf = torch.zeros(B * H * W, D, dtype=embeddings.dtype, device=embeddings.device)
    flat_emb = embeddings.reshape(B * N, D)
    if mode == "add":
        buf.index_add_(0, flat, flat_emb)
    elif mode == "cover":
        buf[flat] = flat_emb
    else:
        raise NotImplementedError(mode)
    return buf.reshape(B, H, W, D)

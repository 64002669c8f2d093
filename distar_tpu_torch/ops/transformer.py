"""Masked set-attention transformer and learned-query attention pooling.

Counterparts of ``distar_tpu.ops.transformer``. Attention is over sets of
<= 512 entities with a key-validity mask broadcast over queries; masked
scores are filled with -1e9 after the scale (never -inf), so a row with no
valid key gives mean(V), not NaN. ``qkv`` splits as q | k | v and then each
is cut into heads, giving [B, H, N, Dh] attention tensors.

``impl``: 'xla' is the plain torch path; 'pallas' calls
``kernels.masked_attention`` (the CUDA kernel on CUDA tensors, its plain
version on CPU tensors); 'ring' needs the context-parallel mesh, which the
port does not have yet.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import kernels
from .blocks import LN_EPS, FCBlock

NEG_INF = -1e9


class Attention(nn.Module):
    def __init__(self, in_dim: int, head_dim: int, head_num: int, output_dim: int,
                 impl: str = "xla"):
        super().__init__()
        if impl not in ("xla", "pallas", "ring"):
            raise ValueError(f"unknown attention impl {impl!r} (xla|pallas|ring)")
        self.head_dim, self.head_num, self.impl = head_dim, head_num, impl
        self.Dense_0 = nn.Linear(in_dim, 3 * head_dim * head_num)
        self.Dense_1 = nn.Linear(head_dim * head_num, output_dim)

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        B, N, _ = x.shape
        q, k, v = self.Dense_0(x).chunk(3, dim=-1)

        def heads(t):
            return t.reshape(B, N, self.head_num, self.head_dim).transpose(1, 2).contiguous()

        q, k, v = heads(q), heads(k), heads(v)
        if mask is None:
            mask = torch.ones(B, N, dtype=torch.bool, device=x.device)
        if self.impl == "pallas":
            out = kernels.masked_attention(q, k, v, mask)
        elif self.impl == "ring":
            raise NotImplementedError("attention impl 'ring' needs the parallel/ slice of the port")
        else:
            out = kernels.masked_attention_plain(q, k, v, mask, upcast=False)
        out = out.transpose(1, 2).reshape(B, N, self.head_num * self.head_dim)
        return self.Dense_1(out)


class TransformerLayer(nn.Module):
    def __init__(self, in_dim: int, head_dim: int, hidden_dim: int, output_dim: int,
                 head_num: int, mlp_num: int, activation: str = "relu",
                 ln_type: str = "post", attn_impl: str = "xla"):
        super().__init__()
        if ln_type not in ("post", "pre"):
            raise NotImplementedError(ln_type)
        self.ln_type = ln_type
        self.Attention_0 = Attention(in_dim, head_dim, head_num, output_dim, impl=attn_impl)
        dims = [hidden_dim] * (mlp_num - 1) + [output_dim]
        self.mlp_num = len(dims)
        d_in = output_dim
        for i, d in enumerate(dims):
            self.add_module(f"FCBlock_{i}", FCBlock(d_in, d, activation))
            d_in = d
        self.LayerNorm_0 = nn.LayerNorm(output_dim, eps=LN_EPS)
        self.LayerNorm_1 = nn.LayerNorm(output_dim, eps=LN_EPS)

    def mlp(self, h):
        for i in range(self.mlp_num):
            h = getattr(self, f"FCBlock_{i}")(h)
        return h

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        if self.ln_type == "post":
            x = self.LayerNorm_0(x + self.Attention_0(x, mask))
            return self.LayerNorm_1(x + self.mlp(x))
        x = x + self.Attention_0(self.LayerNorm_0(x), mask)
        return x + self.mlp(self.LayerNorm_1(x))


class Transformer(nn.Module):
    """Embedding fc + N transformer layers, masked over invalid set slots."""

    def __init__(self, in_dim: int, head_dim: int = 128, hidden_dim: int = 1024,
                 output_dim: int = 256, head_num: int = 2, mlp_num: int = 2,
                 layer_num: int = 3, activation: str = "relu", ln_type: str = "pre",
                 attn_impl: str = "xla"):
        super().__init__()
        self.layer_num = layer_num
        self.FCBlock_0 = FCBlock(in_dim, output_dim, activation)
        for i in range(layer_num):
            self.add_module(f"TransformerLayer_{i}", TransformerLayer(
                output_dim, head_dim, hidden_dim, output_dim, head_num, mlp_num, activation,
                ln_type, attn_impl))

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        x = self.FCBlock_0(x)
        for i in range(self.layer_num):
            x = getattr(self, f"TransformerLayer_{i}")(x, mask)
        return x


class AttentionPool(nn.Module):
    """Learned-query pooling over a masked set, optional count embedding."""

    def __init__(self, in_dim: int, head_num: int, output_dim: int,
                 max_num: Optional[int] = None):
        super().__init__()
        self.head_num = head_num
        self.queries = nn.Parameter(torch.zeros(1, 1, head_num, in_dim))
        self.Dense_0 = nn.Linear(head_num * in_dim, output_dim)
        self.max_num = max_num
        if max_num is not None:
            self.Embed_0 = nn.Embedding(max_num, output_dim)

    def forward(self, x, num: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None):
        B, N, C = x.shape
        score = (x[:, :, None, :] * self.queries).sum(-1)  # B, N, H
        if mask is not None:
            if mask.dim() == 3:
                mask = mask[..., 0]
            score = score.masked_fill(~mask[:, :, None].bool(), NEG_INF)
        score = torch.softmax(score, dim=1)
        pooled = torch.einsum("bnc,bnh->bhc", x, score).reshape(B, self.head_num * C)
        pooled = self.Dense_0(pooled)
        if self.max_num is not None:
            count = self.Embed_0(num.long().clamp(0, self.max_num - 1))
            pooled = pooled + F.relu(count)
        return F.relu(pooled)

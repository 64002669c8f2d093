"""Core NN building blocks.

Counterparts of ``distar_tpu.ops.blocks``. Each module names its children
as flax auto-names them (``Dense_0``, ``LayerNorm_0``, ``Conv2DBlock_1``,
...), so a JAX params tree maps onto the ``state_dict`` key by key
(``model/convert.py``). Convolutions run in NCHW; the modules that flatten
or reshape a map keep the JAX package's NHWC order at that point. The
padding is flax's "SAME" at stride 1: 1 for a 3x3 kernel, 0 for 1x1.
LayerNorm epsilon is 1e-5 everywhere.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-5

ACTIVATIONS = {"relu": F.relu, None: lambda x: x}


def build_activation(name: Optional[str]) -> Callable:
    return ACTIVATIONS[name]


def one_hot(x: torch.Tensor, num_classes: int, clamp: bool = True) -> torch.Tensor:
    """One-hot with clamp-don't-crash semantics: out-of-range ids clip to the
    nearest class."""
    x = x.long()
    if clamp:
        x = x.clamp(0, num_classes - 1)
    return F.one_hot(x, num_classes).float()


def binary_encode(x: torch.Tensor, bit_num: int) -> torch.Tensor:
    """Fixed-width binary expansion, big-endian (low bit last)."""
    shifts = torch.arange(bit_num - 1, -1, -1, device=x.device, dtype=torch.int32)
    return ((x.int()[..., None] >> shifts) & 1).float()


def sequence_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[..., max_len] boolean mask: position i valid iff i < length."""
    return torch.arange(max_len, device=lengths.device) < lengths[..., None]


class FCBlock(nn.Module):
    """Linear + optional LayerNorm + activation."""

    def __init__(self, in_features: int, features: int, activation: Optional[str] = "relu",
                 norm: Optional[str] = None):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, features)
        if norm == "LN":
            self.LayerNorm_0 = nn.LayerNorm(features, eps=LN_EPS)
        self.act = build_activation(activation)

    def forward(self, x):
        x = self.Dense_0(x)
        if hasattr(self, "LayerNorm_0"):
            x = self.LayerNorm_0(x)
        return self.act(x)


class Conv2DBlock(nn.Module):
    """NCHW stride-1 conv with "SAME" padding + activation."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 activation: Optional[str] = "relu"):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, features, kernel_size, padding=kernel_size // 2)
        self.act = build_activation(activation)

    def forward(self, x):
        return self.act(self.Conv_0(x))


class ResBlock(nn.Module):
    """Two 3x3 convs with a skip: act(x + conv(conv(x)))."""

    def __init__(self, features: int, activation: str = "relu"):
        super().__init__()
        self.Conv2DBlock_0 = Conv2DBlock(features, features, 3, activation)
        self.Conv2DBlock_1 = Conv2DBlock(features, features, 3, None)
        self.act = build_activation(activation)

    def forward(self, x):
        return self.act(x + self.Conv2DBlock_1(self.Conv2DBlock_0(x)))


class ResFCBlock(nn.Module):
    """Residual fc block: act(x + fc(fc(x))), norm per fc as configured."""

    def __init__(self, features: int, activation: str = "relu", norm: Optional[str] = "LN"):
        super().__init__()
        self.FCBlock_0 = FCBlock(features, features, activation, norm)
        self.FCBlock_1 = FCBlock(features, features, None, norm)
        self.act = build_activation(activation)

    def forward(self, x):
        return self.act(x + self.FCBlock_1(self.FCBlock_0(x)))


class GLU(nn.Module):
    """Gated linear unit conditioned on a context vector:
    out = (sigmoid(W_c ctx) * x) W."""

    def __init__(self, in_features: int, context_dim: int, features: int):
        super().__init__()
        self.Dense_0 = nn.Linear(context_dim, in_features)
        self.Dense_1 = nn.Linear(in_features, features)

    def forward(self, x, context):
        return self.Dense_1(torch.sigmoid(self.Dense_0(context)) * x)


class GatedResBlock(nn.Module):
    """Conv res block whose residual is gated by a context map and scaled by
    the learned scalar ``update_sp``."""

    def __init__(self, features: int, activation: str = "relu"):
        super().__init__()
        self.Conv2DBlock_0 = Conv2DBlock(features, features, 3, activation)
        self.Conv2DBlock_1 = Conv2DBlock(features, features, 3, None)
        for i, a in enumerate((activation, activation, activation, None)):
            self.add_module(f"Conv2DBlock_{i + 2}", Conv2DBlock(features, features, 1, a))
        self.update_sp = nn.Parameter(torch.full((1,), 0.1))
        self.act = build_activation(activation)

    def forward(self, x, gate_map):
        y = self.Conv2DBlock_1(self.Conv2DBlock_0(x))
        g = gate_map
        for i in range(2, 6):
            g = getattr(self, f"Conv2DBlock_{i}")(g)
        y = torch.tanh(y * torch.sigmoid(g)) * self.update_sp
        return self.act(x + y)

"""Per-baseline value towers.

Counterpart of ``distar_tpu.model.value.ValueBaseline``: fc ->
``res_num`` x post-norm ResFCBlock2 -> Dense(1) -> float32, with an
optional atan squash into (-1, 1). ``init_params`` draws the last Dense
from a truncated normal of variance 0.01 / fan_in, as the JAX tower's
``variance_scaling(0.01, "fan_in", "truncated_normal")``, so a fresh
tower's values sit near 0.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..ops import FCBlock, ResFCBlock2

OUT_VARIANCE = 0.01  # the last Dense's init variance times its fan-in


class ValueBaseline(nn.Module):
    def __init__(self, input_dim: int, res_dim: int = 256, res_num: int = 16, atan: bool = False):
        super().__init__()
        self.FCBlock_0 = FCBlock(input_dim, res_dim, "relu")
        self.res_num = res_num
        for i in range(res_num):
            self.add_module(f"ResFCBlock2_{i}", ResFCBlock2(res_dim, "relu"))
        self.Dense_0 = nn.Linear(res_dim, 1)
        self.atan = atan

    def forward(self, x):
        x = self.FCBlock_0(x)
        for i in range(self.res_num):
            x = getattr(self, f"ResFCBlock2_{i}")(x)
        v = self.Dense_0(x)[..., 0].float()
        if self.atan:
            v = (2.0 / math.pi) * torch.atan((math.pi / 2.0) * v)
        return v

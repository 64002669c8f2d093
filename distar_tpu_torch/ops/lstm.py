"""Layer-normalised LSTM cell and a stacked runner.

Counterpart of ``distar_tpu.ops.lstm`` (``LayerNormLSTMCell``,
``StackedLSTM``): gates = LN(x W_ih) + LN(h W_hh) in the order i, f, g, o;
c' = LN(f*c + i*g); h' = o * tanh(c'). State is a tuple of (h, c) pairs,
one per layer, each [B, hidden]; the carry stays float32 whatever the
compute dtype.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .blocks import LN_EPS

LSTMState = Tuple[torch.Tensor, torch.Tensor]


class LayerNormLSTMCell(nn.Module):
    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.ih = nn.Linear(input_size, 4 * hidden_size, bias=False)
        self.ln_ih = nn.LayerNorm(4 * hidden_size, eps=LN_EPS)
        self.hh = nn.Linear(hidden_size, 4 * hidden_size, bias=False)
        self.ln_hh = nn.LayerNorm(4 * hidden_size, eps=LN_EPS)
        self.ln_c = nn.LayerNorm(hidden_size, eps=LN_EPS)

    def forward(self, x, state: LSTMState) -> Tuple[torch.Tensor, LSTMState]:
        h, c = state
        gates = self.ln_ih(self.ih(x)) + self.ln_hh(self.hh(h))
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = self.ln_c(torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g))
        h_new = (torch.sigmoid(o) * torch.tanh(c_new)).float()
        return h_new, (h_new, c_new.float())


class StackedLSTM(nn.Module):
    """N stacked cells over time: input [T, B, D] -> output [T, B, H] plus
    the final per-layer states."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer{i}", LayerNormLSTMCell(input_size if i == 0 else hidden_size,
                                                          hidden_size))

    def init_state(self, batch_size: int, device=None) -> Tuple[LSTMState, ...]:
        z = torch.zeros(batch_size, self.hidden_size, device=device)
        return tuple((z, z) for _ in range(self.num_layers))

    def forward(self, xs, states: Optional[Tuple[LSTMState, ...]] = None):
        if states is None:
            states = self.init_state(xs.shape[1], xs.device)
        states = list(states)
        ys = []
        for x in xs:
            for i in range(self.num_layers):
                x, states[i] = getattr(self, f"layer{i}")(x, states[i])
            ys.append(x)
        return torch.stack(ys), tuple(states)

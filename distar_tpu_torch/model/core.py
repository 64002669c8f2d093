"""The policy network's sampling forward.

Counterparts of ``distar_tpu.model.core``: ``Encoder`` (scalar + spatial +
entity with the entity -> map scatter connection) -> LN-LSTM core ->
``Policy.sample`` over the six heads. ``Model.sample_action`` is actor and
serving inference; the learner forwards and the value towers come with the
training slice.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..lib.actions import SELECTED_UNITS_MASK
from ..lib.features import ACTION_HEADS, MAX_ENTITY_NUM, MAX_SELECTED_UNITS_NUM
from ..ops import FCBlock, StackedLSTM, scatter_connection
from .config import cdtype, static_cfg
from .encoders import EntityEncoder, ScalarEncoder, SpatialEncoder, scalar_dims
from .heads import (
    ActionTypeHead,
    DelayHead,
    LocationHead,
    QueuedHead,
    SelectedUnitsHead,
    TargetUnitHead,
)


class Encoder(nn.Module):
    """Fuse the three observation encoders; scatter entity embeddings onto
    the map before the spatial conv stack."""

    def __init__(self, cfg):
        super().__init__()
        c = static_cfg(cfg)
        self.spatial_size = (c.spatial_y, c.spatial_x)
        self.scatter_type = c.encoder.scatter.type
        self.scatter_impl = c.encoder.scatter.get("impl", "xla")
        self.scalar_encoder = ScalarEncoder(cfg)
        self.entity_encoder = EntityEncoder(cfg)
        self.FCBlock_0 = FCBlock(c.encoder.entity.output_dim, c.encoder.scatter.output_dim, "relu")
        self.spatial_encoder = SpatialEncoder(cfg)

    def forward(self, spatial_info, entity_info, scalar_info, entity_num):
        embedded_scalar, scalar_context, baseline_feature = self.scalar_encoder(scalar_info)
        entity_embeddings, embedded_entity, entity_mask = self.entity_encoder(entity_info, entity_num)
        proj = self.FCBlock_0(entity_embeddings) * entity_mask[..., None]
        locations = torch.stack([entity_info["x"].long(), entity_info["y"].long()], dim=-1)
        scatter_map = scatter_connection(proj, locations, self.spatial_size, self.scatter_type,
                                         impl=self.scatter_impl)
        embedded_spatial, map_skip = self.spatial_encoder(spatial_info, scatter_map)
        lstm_input = torch.cat([embedded_scalar, embedded_entity, embedded_spatial], dim=-1)
        return lstm_input, scalar_context, baseline_feature, entity_embeddings, map_skip


class Policy(nn.Module):
    """The six-head autoregressive chain."""

    def __init__(self, cfg, input_dim: int, context_dim: int):
        super().__init__()
        c = static_cfg(cfg)
        gate_dim = c.policy.action_type_head.gate_dim
        entity_dim = c.encoder.entity.output_dim
        self.action_type_head = ActionTypeHead(cfg, input_dim, context_dim)
        self.delay_head = DelayHead(cfg, gate_dim)
        self.queued_head = QueuedHead(cfg, gate_dim)
        self.selected_units_head = SelectedUnitsHead(cfg, gate_dim, entity_dim)
        self.target_unit_head = TargetUnitHead(cfg, gate_dim, entity_dim)
        self.location_head = LocationHead(cfg, gate_dim, c.encoder.spatial.down_channels[-1])
        self.register_buffer("su_mask_table", torch.as_tensor(SELECTED_UNITS_MASK), persistent=False)

    def sample(self, lstm_output, entity_embeddings, map_skip, scalar_context, entity_num,
               noise: Dict[str, torch.Tensor], legal_mask=None):
        logit: Dict[str, torch.Tensor] = {}
        action: Dict[str, torch.Tensor] = {}
        logit["action_type"], action["action_type"], emb = self.action_type_head(
            lstm_output, scalar_context, noise["action_type"], legal_mask)
        logit["delay"], action["delay"], emb = self.delay_head(emb, noise["delay"])
        logit["queued"], action["queued"], emb = self.queued_head(emb, noise["queued"])
        su_mask = self.su_mask_table[action["action_type"]]
        (logit["selected_units"], action["selected_units"], emb, selected_units_num,
         extra_units) = self.selected_units_head(
            emb, entity_embeddings, entity_num, su_mask, noise["selected_units"])
        logit["target_unit"], action["target_unit"] = self.target_unit_head(
            emb, entity_embeddings, entity_num, noise["target_unit"])
        logit["target_location"], action["target_location"] = self.location_head(
            emb, map_skip, noise["target_location"])
        return action, selected_units_num, logit, extra_units


def noise_shapes(cfg, batch_size: int) -> Dict[str, tuple]:
    """Per-head shapes of the Gumbel noise ``sample_action`` consumes."""
    c = static_cfg(cfg)
    B = batch_size
    return {
        "action_type": (B, c.policy.action_type_head.action_num),
        "delay": (B, c.policy.delay_head.delay_dim),
        "queued": (B, c.policy.queued_head.queued_dim),
        "selected_units": (B, MAX_SELECTED_UNITS_NUM, MAX_ENTITY_NUM + 1),
        "target_unit": (B, MAX_ENTITY_NUM),
        "target_location": (B, c.spatial_y * c.spatial_x),
    }


def gumbel_noise(cfg, batch_size: int, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Standard Gumbel draws -log(-log(u)), u uniform in [tiny, 1), for
    every head, from ``generator`` (which must live on ``device``)."""
    tiny = torch.finfo(torch.float32).tiny
    out = {}
    for k in ACTION_HEADS:
        u = torch.rand(noise_shapes(cfg, batch_size)[k], generator=generator, device=device)
        out[k] = -torch.log(-torch.log(u.clamp_min(tiny)))
    return out


class Model(nn.Module):
    """Encoder + LSTM core + Policy (the sampling forward)."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        c = static_cfg(cfg)
        core = c.encoder.core_lstm
        embedded_scalar, scalar_context, _ = scalar_dims(cfg)
        lstm_in = embedded_scalar + c.encoder.entity.output_dim + c.encoder.spatial.fc_dim
        self.encoder = Encoder(cfg)
        self.policy = Policy(cfg, core.hidden_size, scalar_context)
        self.core_lstm = StackedLSTM(lstm_in, core.hidden_size, core.num_layers)
        self.compute_dtype = cdtype(cfg)

    def sample_action(self, spatial_info, entity_info, scalar_info, entity_num, hidden_state,
                      noise: Optional[Dict[str, torch.Tensor]] = None,
                      generator: Optional[torch.Generator] = None, legal_mask=None):
        """Single-step batched inference. ``noise`` gives every head's Gumbel
        draws (see :func:`noise_shapes`); without it they are drawn from
        ``generator``."""
        B = entity_num.shape[0]
        if noise is None:
            noise = gumbel_noise(self.cfg, B, generator, entity_num.device)
        amp = (torch.autocast(entity_num.device.type, dtype=torch.bfloat16)
               if self.compute_dtype == torch.bfloat16 else nullcontext())
        with amp:
            lstm_input, scalar_context, _, entity_embeddings, map_skip = self.encoder(
                spatial_info, entity_info, scalar_info, entity_num)
            lstm_output, out_state = self.core_lstm(lstm_input[None], hidden_state)
            action, selected_units_num, logit, extra_units = self.policy.sample(
                lstm_output[0], entity_embeddings, map_skip, scalar_context, entity_num,
                noise, legal_mask)
        logp = {k: log_prob(logit[k], action[k]) for k in action}
        return {
            "action_info": action,
            "action_logp": logp,
            "selected_units_num": selected_units_num,
            "entity_num": entity_num,
            "hidden_state": out_state,
            "logit": logit,
            "extra_units": extra_units,
        }

    forward = sample_action


def log_prob(logits: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """Categorical log-prob of ``action`` under ``logits`` (last axis)."""
    return F.log_softmax(logits.float(), dim=-1).gather(-1, action[..., None].long())[..., 0]


def init_params(model: nn.Module, seed: int = 0) -> None:
    """Fill every parameter from a seeded CPU generator, in the flax
    defaults' spirit: fan-in-scaled uniform weights, zero biases, unit
    LayerNorm scales, N(0, 1/n) embeddings, the gated block's 0.1 scale and
    the end-token embedding uniform in [0, 2/sqrt(32))."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            owner = model.get_submodule(name.rsplit(".", 1)[0]) if "." in name else model
            if leaf == "update_sp":
                val = torch.full(p.shape, 0.1)
            elif leaf == "end_embedding":
                val = torch.rand(p.shape, generator=g) * (2.0 / 32 ** 0.5)
            elif isinstance(owner, nn.LayerNorm):
                val = torch.ones(p.shape) if leaf == "weight" else torch.zeros(p.shape)
            elif isinstance(owner, nn.Embedding):
                val = torch.randn(p.shape, generator=g) / p.shape[0] ** 0.5
            elif leaf == "weight" and p.dim() >= 2:
                fan_in = p[0].numel()
                lim = (3.0 / fan_in) ** 0.5
                val = (torch.rand(p.shape, generator=g) * 2 - 1) * lim
            elif leaf == "queries":
                lim = (6.0 / (p.shape[-1] + p.shape[-2])) ** 0.5
                val = (torch.rand(p.shape, generator=g) * 2 - 1) * lim
            else:
                val = torch.zeros(p.shape)
            p.copy_(val)

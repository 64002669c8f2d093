"""The policy/value network and its forward modes.

Counterparts of ``distar_tpu.model.core``: ``Encoder`` (scalar + spatial +
entity with the entity -> map scatter connection) -> LN-LSTM core -> the six
heads, sampled (``Policy.sample``) or teacher-forced
(``Policy.train_forward``), and, with ``use_value_network``, one value
tower per baseline (``value_{name}``; with ``use_value_feature`` their
input adds the centralized critic's ``value_encoder``). Forward modes:

* ``sample_action``  — actor and serving inference: one step, every head
  sampled, log-probs and the new hidden state.
* ``teacher_logits`` — one step's teacher-forced logits for given actions.
* ``rl_forward``     — the RL learner's forward over flat [(T+1)*B]
  time-major windows: policy logits on the first T steps, the six
  baselines' values on all T+1.
* ``policy_forward`` — ``rl_forward``'s policy half, no towers (the
  distillation student).
* ``sl_forward``     — the supervised learner's forward over flat [B*T]
  batch-major windows, the LSTM state carried in and returned.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..lib.actions import SELECTED_UNITS_MASK
from ..lib.features import ACTION_HEADS, MAX_ENTITY_NUM, MAX_SELECTED_UNITS_NUM
from ..ops import FCBlock, StackedLSTM, scatter_connection
from .config import cdtype, static_cfg
from .encoders import (
    EntityEncoder,
    ScalarEncoder,
    SpatialEncoder,
    ValueEncoder,
    scalar_dims,
    value_encoder_dim,
)
from .heads import (
    ActionTypeHead,
    DelayHead,
    LocationHead,
    QueuedHead,
    SelectedUnitsHead,
    TargetUnitHead,
)
from .value import OUT_VARIANCE, ValueBaseline

NEG_INF = -1e9


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
        # recompute the spatial encoder in the backward pass instead of
        # keeping its activations, as the JAX package's nn.remat
        self.remat = bool(c.get("remat", False))

    def forward(self, spatial_info, entity_info, scalar_info, entity_num):
        embedded_scalar, scalar_context, baseline_feature = self.scalar_encoder(scalar_info)
        entity_embeddings, embedded_entity, entity_mask = self.entity_encoder(entity_info, entity_num)
        proj = self.FCBlock_0(entity_embeddings) * entity_mask[..., None]
        locations = torch.stack([entity_info["x"].long(), entity_info["y"].long()], dim=-1)
        scatter_map = scatter_connection(proj, locations, self.spatial_size, self.scatter_type,
                                         impl=self.scatter_impl)
        if self.remat and torch.is_grad_enabled():
            embedded_spatial, map_skip = torch.utils.checkpoint.checkpoint(
                self.spatial_encoder, spatial_info, scatter_map, use_reentrant=False)
        else:
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

    def train_forward(self, lstm_output, entity_embeddings, map_skip, scalar_context, entity_num,
                      action_info: Dict[str, torch.Tensor], selected_units_num):
        """Teacher-forced logits of every head for the labels in ``action_info``."""
        logit: Dict[str, torch.Tensor] = {}
        logit["action_type"], _, emb = self.action_type_head(
            lstm_output, scalar_context, action_type=action_info["action_type"].long())
        logit["delay"], _, emb = self.delay_head(emb, choice=action_info["delay"].long())
        logit["queued"], _, emb = self.queued_head(emb, choice=action_info["queued"].long())
        logit["selected_units"], _, emb, _, _ = self.selected_units_head(
            emb, entity_embeddings, entity_num, selected_units=action_info["selected_units"],
            selected_units_num=selected_units_num)
        logit["target_unit"], _ = self.target_unit_head(
            emb, entity_embeddings, entity_num, target_unit=action_info["target_unit"].long())
        logit["target_location"], _ = self.location_head(
            emb, map_skip, location=action_info["target_location"].long())
        return logit


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
    """Encoder + LSTM core + Policy (+ value towers)."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        c = static_cfg(cfg)
        core = c.encoder.core_lstm
        embedded_scalar, scalar_context, baseline = scalar_dims(cfg)
        lstm_in = embedded_scalar + c.encoder.entity.output_dim + c.encoder.spatial.fc_dim
        self.encoder = Encoder(cfg)
        self.policy = Policy(cfg, core.hidden_size, scalar_context)
        self.core_lstm = StackedLSTM(lstm_in, core.hidden_size, core.num_layers)
        self.compute_dtype = cdtype(cfg)
        # the towers are attributes value_{name}, not a ModuleDict, so their
        # parameter names are the flax tree's (model/convert.py)
        self.baselines = list(c.enable_baselines) if c.use_value_network else []
        critic_in = core.hidden_size
        if self.baselines and c.use_value_feature:
            self.value_encoder = ValueEncoder(cfg)
            critic_in += value_encoder_dim(cfg) + baseline
        for name in self.baselines:
            self.add_module(f"value_{name}", ValueBaseline(
                critic_in, c.value.res_dim, c.value.res_num, c.value.baselines[name].atan))

    def sample_action(self, spatial_info, entity_info, scalar_info, entity_num, hidden_state,
                      noise: Optional[Dict[str, torch.Tensor]] = None,
                      generator: Optional[torch.Generator] = None, legal_mask=None):
        """Single-step batched inference. ``noise`` gives every head's Gumbel
        draws (see :func:`noise_shapes`); without it they are drawn from
        ``generator``."""
        B = entity_num.shape[0]
        if noise is None:
            noise = gumbel_noise(self.cfg, B, generator, entity_num.device)
        with self._amp(entity_num.device):
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

    def _amp(self, device):
        """bf16 autocast under the 'bfloat16' compute dtype (params stay f32)."""
        if self.compute_dtype == torch.bfloat16:
            return torch.autocast(device.type, dtype=torch.bfloat16)
        return nullcontext()

    def teacher_logits(self, spatial_info, entity_info, scalar_info, entity_num, hidden_state,
                       action_info, selected_units_num):
        """One step's teacher-forced logits for the given actions."""
        with self._amp(entity_num.device):
            lstm_input, scalar_context, _, entity_embeddings, map_skip = self.encoder(
                spatial_info, entity_info, scalar_info, entity_num)
            lstm_output, out_state = self.core_lstm(lstm_input[None], hidden_state)
            logit = self.policy.train_forward(
                lstm_output[0], entity_embeddings, map_skip, scalar_context, entity_num,
                action_info, selected_units_num)
        return {"logit": logit, "hidden_state": out_state, "entity_num": entity_num,
                "selected_units_num": selected_units_num}

    def sl_forward(self, spatial_info, entity_info, scalar_info, entity_num, action_info,
                   selected_units_num, hidden_state, batch_size: int):
        """Teacher-forced forward over a flat [B*T, ...] batch laid out
        batch-major (trajectory b's T steps are rows b*T .. b*T + T-1): the
        LSTM runs over [T, B] from ``hidden_state``. Returns (logits, each
        [B*T, ...], the LSTM's final state)."""
        with self._amp(entity_num.device):
            lstm_input, scalar_context, _, entity_embeddings, map_skip = self.encoder(
                spatial_info, entity_info, scalar_info, entity_num)
            seq = lstm_input.reshape(batch_size, -1, lstm_input.shape[-1]).transpose(0, 1)
            lstm_output, out_state = self.core_lstm(seq, hidden_state)
            flat_out = lstm_output.transpose(0, 1).reshape(-1, lstm_output.shape[-1])
            logits = self.policy.train_forward(
                flat_out, entity_embeddings, map_skip, scalar_context, entity_num,
                action_info, selected_units_num)
        return logits, out_state

    def _learner_logits(self, spatial_info, entity_info, scalar_info, entity_num, hidden_state,
                        action_info, selected_units_num, batch_size: int, unroll_len: int):
        """The logits half of the learner forwards: encoder -> LSTM over the
        [T+1, B] window from ``hidden_state`` -> teacher-forced logits on the
        first T steps (rows t*B + b). Returns (logits [T, B, ...], the
        selected-units S axis padded to 64 with -1e9; the flat LSTM outputs
        [(T+1)*B, H]; the baseline feature)."""
        flat_action = {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in action_info.items()}
        lstm_input, scalar_context, baseline_feature, entity_embeddings, map_skip = self.encoder(
            spatial_info, entity_info, scalar_info, entity_num)
        seq = lstm_input.reshape(-1, batch_size, lstm_input.shape[-1])  # [T+1, B, D]
        lstm_output, _ = self.core_lstm(seq, hidden_state)
        flat_out = lstm_output.reshape(-1, lstm_output.shape[-1])
        n = unroll_len * batch_size
        logits = self.policy.train_forward(
            flat_out[:n], entity_embeddings[:n], [m[:n] for m in map_skip], scalar_context[:n],
            entity_num[:n], flat_action, selected_units_num.reshape(-1))
        logits = {k: v.reshape((unroll_len, batch_size) + tuple(v.shape[1:])) for k, v in logits.items()}
        su = logits["selected_units"]
        if su.shape[2] < MAX_SELECTED_UNITS_NUM:
            logits["selected_units"] = F.pad(su, (0, 0, 0, MAX_SELECTED_UNITS_NUM - su.shape[2]),
                                             value=NEG_INF)
        return logits, flat_out, baseline_feature

    def policy_forward(self, spatial_info, entity_info, scalar_info, entity_num, hidden_state,
                       action_info, selected_units_num, batch_size: int, unroll_len: int):
        """``rl_forward``'s policy half without the value towers (the
        distillation student's forward): ``{"target_logit": [T, B, ...]}``."""
        with self._amp(entity_num.device):
            logits, _, _ = self._learner_logits(
                spatial_info, entity_info, scalar_info, entity_num, hidden_state, action_info,
                selected_units_num, batch_size, unroll_len)
        return {"target_logit": logits}

    def rl_forward(self, spatial_info, entity_info, scalar_info, entity_num, hidden_state,
                   action_info, selected_units_num, batch_size: int, unroll_len: int,
                   value_feature=None):
        """Flat [(T+1)*B, ...] time-major inputs (row t*B + b) -> policy
        logits [T, B, ...] and each baseline's values [T+1, B] (float32).
        ``hidden_state`` is the trajectories' initial state, a tuple of (h,
        c) pairs each [B, H]. With ``only_update_baseline`` the towers'
        inputs are detached, so the critic trains only its own towers."""
        c = static_cfg(self.cfg)
        if not c.use_value_network:
            raise ValueError("rl_forward requires cfg.use_value_network=True (the RL learner builds "
                             "its model with value towers; actor-side models have none)")
        if c.use_value_feature and value_feature is None:
            raise ValueError("cfg.use_value_feature=True but the batch carries no value_feature "
                             "(lib.features.VALUE_FEATURE_INFO)")
        with self._amp(entity_num.device):
            logits, critic_input, baseline_feature = self._learner_logits(
                spatial_info, entity_info, scalar_info, entity_num, hidden_state, action_info,
                selected_units_num, batch_size, unroll_len)
            if c.only_update_baseline:
                critic_input, baseline_feature = critic_input.detach(), baseline_feature.detach()
            if c.use_value_feature:
                critic_input = torch.cat(
                    [critic_input, self.value_encoder(value_feature), baseline_feature], dim=1)
            values = {name: getattr(self, f"value_{name}")(critic_input).reshape(unroll_len + 1,
                                                                                 batch_size)
                      for name in self.baselines}
        return {"target_logit": logits, "value": values}


def log_prob(logits: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """Categorical log-prob of ``action`` under ``logits`` (last axis)."""
    return F.log_softmax(logits.float(), dim=-1).gather(-1, action[..., None].long())[..., 0]


def init_params(model: nn.Module, seed: int = 0, only: Optional[Callable[[str], bool]] = None) -> None:
    """Fill every parameter from a seeded CPU generator, in the flax
    defaults' spirit: fan-in-scaled uniform weights, zero biases, unit
    LayerNorm scales, N(0, 1/n) embeddings, the gated block's 0.1 scale and
    the end-token embedding uniform in [0, 2/sqrt(32)), and the value
    towers' last Dense from a truncated normal of variance 0.01 / fan_in.
    With ``only``, just the parameters whose names it accepts are drawn
    (the RL learner's value reset). Each parameter keeps its block of
    its draw (``parallel.spmd.param_shards``: the draw itself on one
    process)."""
    from ..parallel.spmd import param_shards

    shards = param_shards(model)
    g = torch.Generator().manual_seed(seed)
    tower_out = {id(m.Dense_0) for m in model.modules() if isinstance(m, ValueBaseline)}
    with torch.no_grad():
        for name, p in model.named_parameters():
            if only is not None and not only(name):
                continue
            shape = shards.shapes[shards.index[name]]
            leaf = name.rsplit(".", 1)[-1]
            owner = model.get_submodule(name.rsplit(".", 1)[0]) if "." in name else model
            if id(owner) in tower_out and leaf == "weight":
                # flax's truncated_normal: within 2 std, rescaled to unit variance
                std = (OUT_VARIANCE / shape[1]) ** 0.5 / 0.87962566103423978
                val = torch.nn.init.trunc_normal_(torch.empty(shape), 0.0, std, -2 * std, 2 * std,
                                                  generator=g)
            elif leaf == "update_sp":
                val = torch.full(shape, 0.1)
            elif leaf == "end_embedding":
                val = torch.rand(shape, generator=g) * (2.0 / 32 ** 0.5)
            elif isinstance(owner, nn.LayerNorm):
                val = torch.ones(shape) if leaf == "weight" else torch.zeros(shape)
            elif isinstance(owner, nn.Embedding):
                val = torch.randn(shape, generator=g) / shape[0] ** 0.5
            elif leaf == "weight" and len(shape) >= 2:
                fan_in = torch.Size(shape[1:]).numel()
                lim = (3.0 / fan_in) ** 0.5
                val = (torch.rand(shape, generator=g) * 2 - 1) * lim
            elif leaf == "queries":
                lim = (6.0 / (shape[-1] + shape[-2])) ** 0.5
                val = (torch.rand(shape, generator=g) * 2 - 1) * lim
            else:
                val = torch.zeros(shape)
            p.copy_(shards.block(name, val))

"""Autoregressive policy heads: the sampling and the teacher-forced paths.

Counterparts of ``distar_tpu.model.heads``: action_type -> delay -> queued
-> selected_units -> target_unit -> location, each head consuming and
extending the autoregressive embedding.

Each head takes either its Gumbel noise (sampling) or its label (teacher
forcing), as the JAX heads take ``action=None`` and a key, or a label.
Sampling is Gumbel-max: ``action = argmax(logits + gumbel)``, which is
exactly what ``jax.random.categorical`` computes. The noise has the shape of
the head's logits (the pointer decode [B, 64, N+1], one draw per step) and
comes from the caller, so a test can hand the port the draws JAX made.
Masked logits are filled with -1e9 and temperature divides after masking.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from ..lib.features import MAX_SELECTED_UNITS_NUM
from ..ops import GLU, Conv2DBlock, FCBlock, GatedResBlock, ResBlock, ResFCBlock, sequence_mask
from ..ops.lstm import LayerNormLSTMCell
from .config import static_cfg

NEG_INF = -1e9


def gumbel_sample(logits, noise):
    return torch.argmax(logits + noise, dim=-1)


def _pick(logits, noise, label):
    """The label when teacher-forced, else the Gumbel-max sample."""
    return gumbel_sample(logits, noise) if label is None else label


class ActionTypeHead(nn.Module):
    """ResFC tower + GLU logits over the action types; emits the initial
    autoregressive embedding."""

    def __init__(self, cfg, input_dim: int, context_dim: int):
        super().__init__()
        c = static_cfg(cfg)
        hc = c.policy.action_type_head
        self.temperature = c.temperature
        self.action_num = hc.action_num
        self.res_num = hc.res_num
        self.FCBlock_0 = FCBlock(input_dim, hc.res_dim, "relu")
        for i in range(hc.res_num):
            self.add_module(f"ResFCBlock_{i}", ResFCBlock(hc.res_dim, "relu", hc.norm_type))
        self.action_glu = GLU(hc.res_dim, context_dim, hc.action_num)
        self.FCBlock_1 = FCBlock(hc.action_num, hc.action_map_dim, "relu")
        self.FCBlock_2 = FCBlock(hc.action_map_dim, hc.action_map_dim, None)
        self.glu1 = GLU(hc.action_map_dim, context_dim, hc.gate_dim)
        self.glu2 = GLU(input_dim, context_dim, hc.gate_dim)

    def forward(self, lstm_output, scalar_context, noise=None, legal_mask=None, action_type=None):
        x = self.FCBlock_0(lstm_output)
        for i in range(self.res_num):
            x = getattr(self, f"ResFCBlock_{i}")(x)
        logits = self.action_glu(x, scalar_context).float() / self.temperature
        if legal_mask is not None:
            logits = logits.masked_fill(~legal_mask.bool(), NEG_INF)
        action_type = _pick(logits, noise, action_type)
        e1 = self.FCBlock_2(self.FCBlock_1(F.one_hot(action_type, self.action_num).float()))
        e1 = self.glu1(e1, scalar_context)
        e2 = self.glu2(lstm_output, scalar_context)
        return logits, action_type, e1 + e2


class _DecodeHead(nn.Module):
    """Shared shape of the delay and queued heads: a 2-layer decoder to the
    logits, then the sampled class embedded back into the embedding."""

    def __init__(self, embed_dim: int, decode_dim: int, classes: int, map_dim: int,
                 temperature: float):
        super().__init__()
        self.classes, self.temperature = classes, temperature
        self.FCBlock_0 = FCBlock(embed_dim, decode_dim, "relu")
        self.FCBlock_1 = FCBlock(decode_dim, decode_dim, "relu")
        self.FCBlock_2 = FCBlock(decode_dim, classes, None)
        self.FCBlock_3 = FCBlock(classes, map_dim, "relu")
        self.FCBlock_4 = FCBlock(map_dim, embed_dim, None)

    def forward(self, embedding, noise=None, choice=None):
        x = self.FCBlock_1(self.FCBlock_0(embedding))
        logits = self.FCBlock_2(x).float() / self.temperature
        choice = _pick(logits, noise, choice)
        e = self.FCBlock_4(self.FCBlock_3(F.one_hot(choice, self.classes).float()))
        return logits, choice, embedding + e


def DelayHead(cfg, embed_dim: int) -> _DecodeHead:
    """128-way delay logits; no temperature."""
    hc = static_cfg(cfg).policy.delay_head
    return _DecodeHead(embed_dim, hc.decode_dim, hc.delay_dim, hc.delay_map_dim, 1.0)


def QueuedHead(cfg, embed_dim: int) -> _DecodeHead:
    """Binary queued flag, tempered."""
    c = static_cfg(cfg)
    hc = c.policy.queued_head
    return _DecodeHead(embed_dim, hc.decode_dim, hc.queued_dim, hc.queued_map_dim, c.temperature)


class SelectedUnitsHead(nn.Module):
    """LSTM pointer network selecting <= 64 units with an end-flag token.

    A fixed 64-step decode; each step the query LSTM attends over the entity
    keys plus the end slot at index entity_num. Step 0 disables the end slot,
    later steps enable it and disable already-selected units; once a lane
    picks the end token its selection stops changing.

    ``forward`` samples. ``teacher_forward`` decodes given the labels, by
    ``train_impl``: 'parallel' (the default) computes every step's selection
    state from the labels at once and runs only the pointer LSTM step by
    step; 'scan' runs the sampling loop with the label as the pick and
    temperature 1.0. Neither divides the logits by the temperature, as in
    the JAX package.
    """

    def __init__(self, cfg, embed_dim: int, entity_dim: int):
        super().__init__()
        c = static_cfg(cfg)
        hc = c.policy.selected_units_head
        if hc.hidden_dim != hc.key_dim:
            raise ValueError("selected_units_head: hidden_dim must equal key_dim")
        self.temperature = c.temperature
        self.train_impl = hc.get("train_impl", "parallel")
        if self.train_impl not in ("parallel", "scan"):
            raise ValueError(f"selected_units_head.train_impl {self.train_impl!r} (parallel|scan)")
        self.key_fc = FCBlock(entity_dim, hc.key_dim, None)
        self.query_fc1 = FCBlock(embed_dim, hc.func_dim, "relu")
        self.query_fc2 = FCBlock(hc.func_dim, hc.key_dim, None)
        self.embed_fc1 = FCBlock(hc.key_dim, hc.func_dim, "relu")
        self.embed_fc2 = FCBlock(hc.func_dim, c.policy.action_type_head.gate_dim, None)
        self.num_layers = hc.get("num_layers", 1)
        for i in range(self.num_layers):
            self.add_module(f"lstm{i}", LayerNormLSTMCell(hc.key_dim, hc.hidden_dim))
        self.hidden_dim = hc.hidden_dim
        self.end_embedding = nn.Parameter(torch.zeros(hc.key_dim))

    def _keys(self, entity_embedding, entity_num):
        """Keys [B, N+1, K] with the end token at index entity_num, the slot
        indices [1, N+1], the end slot [B, N+1] and slot validity [B, N+1]."""
        N = entity_embedding.shape[1]
        slots = torch.arange(N + 1, device=entity_embedding.device)[None, :]
        key = self.key_fc(entity_embedding)
        key = torch.cat([key, torch.zeros_like(key[:, :1])], dim=1)
        is_end = slots == entity_num[:, None]
        key = torch.where(is_end[..., None], self.end_embedding.to(key.dtype), key)
        return key, slots, is_end, sequence_mask(entity_num + 1, N + 1)

    def _init_states(self, batch: int, device):
        h0 = torch.zeros(batch, self.hidden_dim, device=device)  # the carry stays f32
        return [(h0, h0) for _ in range(self.num_layers)]

    def _lstm(self, x, states):
        for layer in range(self.num_layers):
            x, states[layer] = getattr(self, f"lstm{layer}")(x, states[layer])
        return x

    def _decode(self, embedding, key, slots, is_end, valid, entity_num, su_mask, pick, temperature):
        """The step loop. ``pick(i, logits)`` chooses step i's slot.
        Returns (logits [B, 64, N+1], picks [B, 64], ae, count, extra_units)."""
        B = embedding.shape[0]
        S = MAX_SELECTED_UNITS_NUM
        states = self._init_states(B, embedding.device)
        logit_mask = valid & ~is_end  # end token off at step 0
        ae = embedding  # step 0 queries the raw embedding
        sel_onehot = torch.zeros(B, key.shape[1], device=embedding.device)
        end_flag = torch.zeros(B, dtype=torch.bool, device=embedding.device)
        num = torch.full((B,), S, device=embedding.device)
        if su_mask is not None:
            end_flag = ~su_mask.bool()
            num = torch.where(su_mask.bool(), num, 0)
        logits_seq, results = [], []
        for i in range(S):
            out = self._lstm(self.query_fc2(self.query_fc1(ae)), states)
            logits = (out[:, None, :] * key).sum(-1).float()
            logits = logits.masked_fill(~logit_mask, NEG_INF) / temperature
            result = pick(i, logits)
            picked_end = result == entity_num
            num = torch.where(picked_end & ~end_flag, i + 1, num)
            end_flag = end_flag | picked_end
            slot = slots == result[:, None]
            sel_onehot = torch.maximum(sel_onehot, ((~end_flag)[:, None] & slot).float())
            count = sel_onehot.sum(dim=1)
            pooled = (key * sel_onehot[..., None]).sum(dim=1) / count.clamp_min(1.0)[:, None]
            ae = embedding + self.embed_fc2(self.embed_fc1(pooled))
            logit_mask = (logit_mask | (is_end & valid)) & ~(slot & ~picked_end[:, None])
            logits_seq.append(logits)
            results.append(result)
        logits_seq = torch.stack(logits_seq, dim=1)  # B, S, N+1
        return logits_seq, torch.stack(results, dim=1), ae, num, _extra_units(logits_seq, entity_num, end_flag)

    def forward(self, embedding, entity_embedding, entity_num, su_mask, noise):
        """noise: [B, 64, N+1] Gumbel draws, one row per decode step.
        Returns (logits [B, 64, N+1], units [B, 64], ae, selected count,
        extra_units [B, N+1])."""
        key, slots, is_end, valid = self._keys(entity_embedding, entity_num)
        return self._decode(embedding, key, slots, is_end, valid, entity_num, su_mask,
                            lambda i, logits: gumbel_sample(logits, noise[:, i]), self.temperature)

    def teacher_forward(self, embedding, entity_embedding, entity_num, selected_units,
                        selected_units_num):
        """Teacher-forced decode of ``selected_units`` [B, <=64] (padded to
        64 with slot 0). Returns (logits [B, 64, N+1], labels [B, 64], ae,
        ``selected_units_num``, extra_units [B, N+1])."""
        S = MAX_SELECTED_UNITS_NUM
        labels = selected_units[:, :S].long()
        if labels.shape[1] < S:
            labels = F.pad(labels, (0, S - labels.shape[1]))
        key, slots, is_end, valid = self._keys(entity_embedding, entity_num)
        if self.train_impl == "scan":
            logits, _, ae, _, extra = self._decode(
                embedding, key, slots, is_end, valid, entity_num, None,
                lambda i, _logits: labels[:, i], 1.0)
            return logits, labels, ae, selected_units_num, extra
        return self._teacher_parallel(embedding, key, slots, is_end, valid, entity_num, labels,
                                      selected_units_num)

    def _teacher_parallel(self, base_ae, key, slots, is_end, valid, entity_num, labels,
                          selected_units_num):
        """Under teacher forcing each step's selection, mask and query input
        are functions of the labels alone, so they are computed for all 64
        steps at once (cumulative sums, one batched ``embed_fc``); only the
        pointer LSTM runs step by step. The logits equal the scan path's."""
        B, N1, _ = key.shape
        S = MAX_SELECTED_UNITS_NUM
        dev = key.device
        # [B, S, N+1]; a label outside [0, N] gives a zero row, as jax.nn.one_hot
        slot = (labels[..., None] == slots[:, None, :]).float()
        picked_end = labels == entity_num[:, None]  # [B, S]
        end_before = torch.cat([torch.zeros(B, 1, dtype=torch.bool, device=dev),
                                picked_end.cumsum(1)[:, :-1] > 0], dim=1)
        # the selection after each step i (ended lanes stop adding)
        add = slot * (~(end_before | picked_end))[..., None]
        sel_after = add.cumsum(1).clamp(max=1.0)
        # step i's query pools the selection of the steps before it
        sel_before = torch.cat([torch.zeros(B, 1, N1, device=dev), sel_after[:, :-1]], dim=1)
        pooled = torch.einsum("bsn,bnk->bsk", sel_before, key) / sel_before.sum(-1).clamp_min(1.0)[..., None]
        emb = self.embed_fc2(self.embed_fc1(pooled))  # [B, S, gate]
        # step 0 queries the raw embedding; later steps add the selection MLP,
        # whose biases act on an empty selection too
        first = (torch.arange(S, device=dev) == 0)[None, :, None]
        ae_all = base_ae[:, None, :] + emb.masked_fill(first, 0.0)
        # step i's mask: the end slot off at step 0, slots picked before off
        # (an end pick stays pickable)
        picked_before = torch.cat([torch.zeros(B, 1, N1, device=dev),
                                   (slot * (~picked_end)[..., None]).cumsum(1)[:, :-1]], dim=1)
        mask_all = valid[:, None, :] & ~(first & is_end[:, None, :]) & (picked_before == 0)
        q_in = self.query_fc2(self.query_fc1(ae_all))  # [B, S, K]
        states = self._init_states(B, dev)
        lstm_out = torch.stack([self._lstm(q_in[:, i], states) for i in range(S)], dim=1)
        logits = torch.einsum("bsk,bnk->bsn", lstm_out, key).float().masked_fill(~mask_all, NEG_INF)
        # the embedding after the last step feeds the target-unit and location heads
        final = sel_after[:, -1]
        pooled_final = torch.einsum("bn,bnk->bk", final, key) / final.sum(-1).clamp_min(1.0)[:, None]
        ae = base_ae + self.embed_fc2(self.embed_fc1(pooled_final))
        end_flag = end_before[:, -1] | picked_end[:, -1]
        return logits, labels, ae, selected_units_num, _extra_units(logits, entity_num, end_flag)


def _extra_units(logits_seq, entity_num, end_flag):
    """Entities scoring above the end token at the final step, for lanes
    that never ended."""
    last = logits_seq[:, -1]
    end_logit = last.gather(1, entity_num[:, None].long())
    return ((last > end_logit) & ~end_flag[:, None]).float()


class TargetUnitHead(nn.Module):
    """Key-query attention over entities."""

    def __init__(self, cfg, embed_dim: int, entity_dim: int):
        super().__init__()
        c = static_cfg(cfg)
        hc = c.policy.target_unit_head
        self.temperature = c.temperature
        self.FCBlock_0 = FCBlock(entity_dim, hc.key_dim, None)
        self.FCBlock_1 = FCBlock(embed_dim, hc.key_dim, "relu")
        self.FCBlock_2 = FCBlock(hc.key_dim, hc.key_dim, None)

    def forward(self, embedding, entity_embedding, entity_num, noise=None, target_unit=None):
        key = self.FCBlock_0(entity_embedding)
        q = self.FCBlock_2(self.FCBlock_1(embedding))
        logits = (q[:, None, :] * key).sum(-1).float()
        mask = sequence_mask(entity_num, entity_embedding.shape[1])
        logits = logits.masked_fill(~mask, NEG_INF) / self.temperature
        return logits, _pick(logits, noise, target_unit)


class LocationHead(nn.Module):
    """Gated res stack over map_skip + 3x bilinear upsample to the full map.

    The projection reshapes to (B, H/8, W/8, C) as in the JAX package (NHWC)
    and is then moved to NCHW, so its fc weights carry across unpermuted."""

    def __init__(self, cfg, embed_dim: int, skip_channels: int):
        super().__init__()
        c = static_cfg(cfg)
        hc = c.policy.location_head
        self.temperature = c.temperature
        self.H8, self.W8 = c.spatial_y // 8, c.spatial_x // 8
        self.reshape_channel = hc.reshape_channel
        self.res_num, self.gate = hc.res_num, hc.gate
        self.up_num = len(hc.upsample_dims)
        self.FCBlock_0 = FCBlock(embed_dim, self.H8 * self.W8 * hc.reshape_channel, "relu")
        self.Conv2DBlock_0 = Conv2DBlock(hc.reshape_channel + skip_channels, hc.res_dim, 1, "relu")
        block = GatedResBlock if hc.gate else ResBlock
        for i in range(hc.res_num):
            self.add_module(f"{block.__name__}_{i}", block(hc.res_dim, "relu"))
        ch = hc.res_dim
        for i, out in enumerate(hc.upsample_dims):
            act = "relu" if i < len(hc.upsample_dims) - 1 else None
            self.add_module(f"Conv2DBlock_{i + 1}", Conv2DBlock(ch, out, 3, act))
            ch = out

    def forward(self, embedding, map_skip: List[torch.Tensor], noise=None, location=None):
        B = embedding.shape[0]
        proj = self.FCBlock_0(embedding).reshape(B, self.H8, self.W8, self.reshape_channel)
        x = F.relu(torch.cat([proj.permute(0, 3, 1, 2), map_skip[-1]], dim=1))
        x = self.Conv2DBlock_0(x)
        for i in range(self.res_num):
            x = x + map_skip[len(map_skip) - i - 1]
            x = getattr(self, f"GatedResBlock_{i}")(x, x) if self.gate else getattr(self, f"ResBlock_{i}")(x)
        for i in range(self.up_num):
            h, w = x.shape[-2:]
            x = F.interpolate(x, size=(h * 2, w * 2), mode="bilinear", align_corners=False)
            x = getattr(self, f"Conv2DBlock_{i + 1}")(x)
        # one output channel, so the NCHW flatten is the NHWC one
        logits = x.reshape(B, -1).float() / self.temperature
        return logits, _pick(logits, noise, location)

"""Observation encoders: scalar, spatial and entity.

Counterparts of ``distar_tpu.model.encoders``. Entity features are a sum of
per-field projections into the transformer width (== concat -> Dense).
Spatial planes are built and convolved in NCHW; the one place a map is
flattened (the spatial fc) flattens in the JAX package's NHWC order, so the
fc weights carry across unpermuted.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import (
    AttentionPool,
    Conv2DBlock,
    FCBlock,
    ResBlock,
    Transformer,
    TransformerLayer,
    binary_encode,
    one_hot,
    scatter_connection,
    sequence_mask,
)
from ..lib.features import BEGINNING_ORDER_LENGTH
from .config import static_cfg


class BeginningBuildOrderEncoder(nn.Module):
    """Transformer over the 20-slot build-order sequence with a positional
    one-hot and the binary-encoded (x, y) of each order location."""

    def __init__(self, action_num: int, binary_dim: int = 10, head_dim: int = 8,
                 output_dim: int = 64, spatial_x: int = 160,
                 length: int = BEGINNING_ORDER_LENGTH):
        super().__init__()
        self.action_num, self.binary_dim, self.spatial_x = action_num, binary_dim, spatial_x
        self.Transformer_0 = Transformer(
            action_num + length + 2 * binary_dim, head_dim=head_dim, hidden_dim=output_dim * 2,
            output_dim=output_dim, head_num=2, mlp_num=2, layer_num=3, ln_type="pre",
        )
        self.FCBlock_0 = FCBlock(output_dim, output_dim, "relu")

    def forward(self, bo, bo_location):
        B, L = bo.shape
        a = one_hot(bo, self.action_num)
        pos = torch.eye(L, device=bo.device).expand(B, L, L)
        loc = bo_location.long()
        loc_x = binary_encode(torch.remainder(loc, self.spatial_x), self.binary_dim)
        loc_y = binary_encode(torch.div(loc, self.spatial_x, rounding_mode="floor"), self.binary_dim)
        x = self.Transformer_0(torch.cat([a, pos, loc_x, loc_y], dim=-1))
        return self.FCBlock_0(x.mean(dim=1))


TIME_DIM = 32  # the sin/cos time embedding's width, whatever the config says


def scalar_dims(cfg):
    """(embedded_scalar, scalar_context, baseline_feature) widths."""
    sc = static_cfg(cfg).encoder.scalar
    total, ctx, base = TIME_DIM, 0, 0
    for key, arc, n, out_dim, is_ctx, is_base in sc.fields:
        if arc == "time":
            continue
        d = sc.bo.output_dim if arc == "bo_transformer" else out_dim
        total += d
        ctx += d if is_ctx else 0
        base += d if is_base else 0
    return total, ctx, base


class ScalarEncoder(nn.Module):
    """Per-field scalar embeddings -> (embedded_scalar, scalar_context,
    baseline_feature). Output layout: field outputs in config order, then
    the sin/cos time embedding last."""

    def __init__(self, cfg):
        super().__init__()
        c = static_cfg(cfg)
        self.fields = [tuple(f) for f in c.encoder.scalar.fields]
        for key, arc, n, out_dim, _, _ in self.fields:
            if arc == "one_hot":
                self.add_module(f"embed_{key}", nn.Embedding(n, out_dim))
            elif arc == "fc":
                self.add_module(f"fc_{key}", FCBlock(n, out_dim, "relu"))
            elif arc == "bo_transformer":
                bo = c.encoder.scalar.bo
                self.bo_encoder = BeginningBuildOrderEncoder(
                    bo.action_num, bo.binary_dim, bo.head_dim, bo.output_dim, c.spatial_x)
            elif arc != "time":
                raise NotImplementedError(arc)

    def forward(self, x: Dict[str, torch.Tensor]):
        outs, ctx, base = [], [], []
        for key, arc, n, out_dim, is_ctx, is_base in self.fields:
            if arc == "time":
                continue
            if arc == "one_hot":
                emb = F.relu(getattr(self, f"embed_{key}")(x[key].long().clamp(0, n - 1)))
            elif arc == "fc":
                emb = getattr(self, f"fc_{key}")(x[key].float())
            else:
                emb = self.bo_encoder(x[key].float(), x["bo_location"])
            outs.append(emb)
            if is_ctx:
                ctx.append(emb)
            if is_base:
                base.append(emb)
        outs.append(self._time_embedding(x["time"].float()))
        return torch.cat(outs, -1), torch.cat(ctx, -1), torch.cat(base, -1)

    @staticmethod
    def _time_embedding(t, dim: int = TIME_DIM):
        idx = torch.arange(dim, dtype=torch.float32, device=t.device)
        denom = 1.0 / torch.pow(10000.0, torch.div(idx, 2, rounding_mode="floor") * 2 / dim)
        ang = t[:, None] * denom[None, :]
        even = (torch.arange(dim, device=t.device) % 2 == 0)[None, :]
        return torch.where(even, torch.sin(ang), torch.cos(ang))


def spatial_in_channels(cfg) -> int:
    c = static_cfg(cfg)
    n = 0
    for key, arc, classes in c.encoder.spatial.fields:
        n += classes if arc == "one_hot" else 1
    return n + c.encoder.scatter.output_dim


class SpatialEncoder(nn.Module):
    """One-hot planes + effect scatters + entity scatter map -> conv stack.

    Returns (embedded_spatial [B, fc_dim], map_skip list of NCHW maps) — the
    skip list feeds LocationHead.
    """

    def __init__(self, cfg):
        super().__init__()
        c = static_cfg(cfg)
        sp = c.encoder.spatial
        self.H, self.W = c.spatial_y, c.spatial_x
        self.fields = [tuple(f) for f in sp.fields]
        self.down_num = len(sp.down_channels)
        self.res_num = sp.resblock_num
        self.Conv2DBlock_0 = Conv2DBlock(spatial_in_channels(cfg), sp.project_dim, 1, "relu")
        ch, h, w = sp.project_dim, self.H, self.W
        for i, out in enumerate(sp.down_channels):
            self.add_module(f"Conv2DBlock_{i + 1}", Conv2DBlock(ch, out, 3, "relu"))
            ch, h, w = out, h // 2, w // 2
        for i in range(self.res_num):
            self.add_module(f"ResBlock_{i}", ResBlock(ch, "relu"))
        self.FCBlock_0 = FCBlock(h * w * ch, sp.fc_dim, "relu")

    def forward(self, x: Dict[str, torch.Tensor], scatter_map: torch.Tensor):
        """``scatter_map`` is [B, H, W, D] (the scatter's NHWC layout)."""
        H, W = self.H, self.W
        planes = []
        for key, arc, n in self.fields:
            v = x[key]
            if arc == "float":
                planes.append(v.float()[:, None] / 256.0)
            elif arc == "one_hot":
                planes.append(one_hot(v, n).permute(0, 3, 1, 2))
            elif arc == "scatter":
                # v: [B, EFFECT_LEN] flat cell indices; a cell listed at all
                # is set to 1 (an all-zero list marks cell 0)
                idx = v.long().clamp(0, H * W - 1)
                plane = torch.zeros(v.shape[0], H * W, device=v.device)
                plane.scatter_(1, idx, 1.0)
                planes.append(plane.view(-1, 1, H, W))
            else:
                raise NotImplementedError(arc)
        planes.append(scatter_map.permute(0, 3, 1, 2))
        h = self.Conv2DBlock_0(torch.cat(planes, dim=1))
        map_skip: List[torch.Tensor] = []
        for i in range(self.down_num):
            map_skip.append(h)
            h = F.max_pool2d(h, 2, 2)
            h = getattr(self, f"Conv2DBlock_{i + 1}")(h)
        for i in range(self.res_num):
            map_skip.append(h)
            h = getattr(self, f"ResBlock_{i}")(h)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # NHWC flatten, as the JAX fc
        return self.FCBlock_0(h), map_skip


def _entity_field_module(arc: str, n, width: int) -> nn.Module:
    if arc == "one_hot":
        return nn.Embedding(n, width)
    if arc == "binary":
        return nn.Linear(n, width, bias=False)
    if arc == "float":
        return nn.Linear(1, width, bias=False)
    raise NotImplementedError(arc)


class EntityEncoder(nn.Module):
    """Per-field embedding-sum -> set transformer -> per-entity embeddings
    + masked-mean pooled embedding."""

    def __init__(self, cfg):
        super().__init__()
        c = static_cfg(cfg)
        ent = c.encoder.entity
        width = ent.output_dim
        self.fields = [tuple(f) for f in ent.fields]
        for key, arc, n in self.fields:
            self.add_module(f"ent_{key}", _entity_field_module(arc, n, width))
        self.ent_embed_bias = nn.Parameter(torch.zeros(width))
        self.layer_num = ent.layer_num
        for i in range(ent.layer_num):
            self.add_module(f"TransformerLayer_{i}", TransformerLayer(
                width, ent.head_dim, ent.hidden_dim, ent.output_dim, ent.head_num, ent.mlp_num,
                "relu", ent.ln_type, attn_impl=ent.get("attention_impl", "xla")))
        self.entity_fc = FCBlock(width, width, "relu")
        self.reduce_type = c.entity_reduce_type
        if self.reduce_type == "attention_pool":
            self.AttentionPool_0 = AttentionPool(width, head_num=2, output_dim=width)
        elif self.reduce_type not in ("entity_num", "selected_units_num", "constant"):
            raise NotImplementedError(self.reduce_type)
        self.embed_fc = FCBlock(width, width, "relu")

    def forward(self, x: Dict[str, torch.Tensor], entity_num: torch.Tensor):
        h = None
        for key, arc, n in self.fields:
            v = x[key]
            mod = getattr(self, f"ent_{key}")
            if arc == "one_hot":
                emb = mod(v.long().clamp(0, n - 1))
            elif arc == "binary":
                emb = mod(binary_encode(v, n))
            else:
                emb = mod(v.float()[..., None])
            h = emb if h is None else h + emb
        h = F.relu(h + self.ent_embed_bias)
        mask = sequence_mask(entity_num, h.shape[1])
        for i in range(self.layer_num):
            h = getattr(self, f"TransformerLayer_{i}")(h, mask)
        # the pooled branch reduces relu(x), as the reference's in-place ReLU
        # before entity_fc makes it do
        h = F.relu(h)
        entity_embeddings = self.entity_fc(h)
        masked = h * mask[..., None]
        if self.reduce_type == "constant":
            pooled = masked.sum(dim=1) / 512.0
        elif self.reduce_type == "attention_pool":
            pooled = self.AttentionPool_0(h, mask=mask[..., None])
        else:
            pooled = masked.sum(dim=1) / entity_num.clamp_min(1)[:, None]
        return entity_embeddings, self.embed_fc(pooled), mask


def value_encoder_dim(cfg) -> int:
    """Width of :class:`ValueEncoder`'s output."""
    vc = static_cfg(cfg).value.encoder
    return sum(out for _, _, out in vc.fc_fields) + vc.spatial.fc_dim + vc.bo.output_dim


class ValueEncoder(nn.Module):
    """Centralized-critic encoder over opponent statistics and both sides'
    unit maps: per-field fc, per-unit embeddings scattered onto the map
    (the plain ``index_add_`` scatter: the JAX package runs no kernel here),
    a conv stack, and the opponent's build order. Input: a value-feature
    dict (``lib.features.VALUE_FEATURE_INFO``) with a leading batch axis."""

    def __init__(self, cfg):
        super().__init__()
        c = static_cfg(cfg)
        vc = c.value.encoder
        self.fc_fields = [tuple(f) for f in vc.fc_fields]
        self.unit_fields = [tuple(f) for f in vc.unit_fields]
        for key, n_in, out in self.fc_fields:
            self.add_module(f"fc_{key}", FCBlock(n_in, out, "relu"))
        for key, n, dim in self.unit_fields:
            self.add_module(f"embed_{key}", nn.Embedding(n, dim))
        self.scatter_project = FCBlock(sum(d for _, _, d in self.unit_fields), vc.scatter_dim, "relu")
        sp = vc.spatial
        self.down_num, self.res_num = len(sp.down_channels), sp.resblock_num
        self.Conv2DBlock_0 = Conv2DBlock(vc.scatter_dim + 2, sp.project_dim, 1, "relu")
        ch, h, w = sp.project_dim, c.spatial_y, c.spatial_x
        for i, out in enumerate(sp.down_channels):
            self.add_module(f"Conv2DBlock_{i + 1}", Conv2DBlock(ch, out, 3, "relu"))
            ch, h, w = out, h // 2, w // 2
        for i in range(self.res_num):
            self.add_module(f"ResBlock_{i}", ResBlock(ch, "relu"))
        self.spatial_fc = FCBlock(h * w * ch, sp.fc_dim, "relu")
        bo = vc.bo
        self.bo_encoder = BeginningBuildOrderEncoder(
            bo.action_num, bo.binary_dim, bo.head_dim, bo.output_dim, c.spatial_x)

    def forward(self, x: Dict[str, torch.Tensor]):
        fc_parts = [getattr(self, f"fc_{key}")(x[key].float()) for key, _, _ in self.fc_fields]
        unit_emb = torch.cat([getattr(self, f"embed_{key}")(x[key].long().clamp(0, n - 1))
                              for key, n, _ in self.unit_fields], dim=-1)
        proj = self.scatter_project(unit_emb)
        proj = proj * sequence_mask(x["total_unit_count"], proj.shape[1])[..., None]
        loc = torch.stack([x["unit_x"].long(), x["unit_y"].long()], dim=-1)
        H, W = x["own_units_spatial"].shape[-2:]
        smap = scatter_connection(proj, loc, (H, W), "add")  # [B, H, W, D]
        h = torch.cat([smap.permute(0, 3, 1, 2), x["own_units_spatial"].float()[:, None],
                       x["enemy_units_spatial"].float()[:, None]], dim=1)
        h = self.Conv2DBlock_0(h)
        for i in range(self.down_num):
            h = getattr(self, f"Conv2DBlock_{i + 1}")(F.max_pool2d(h, 2, 2))
        for i in range(self.res_num):
            h = getattr(self, f"ResBlock_{i}")(h)
        h = self.spatial_fc(h.permute(0, 2, 3, 1).reshape(h.shape[0], -1))  # NHWC flatten
        bo = self.bo_encoder(x["beginning_order"].float(), x["bo_location"])
        return torch.cat(fc_parts + [h, bo], dim=-1)

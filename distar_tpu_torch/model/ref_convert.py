"""Reference (DI-star torch) state dict -> the flax-layout params tree.

Counterpart of ``distar_tpu.model.ref_convert``, with the same rules: a
released reference checkpoint (a ``.pth``) becomes the flax-layout tree the
JAX package reads, and ``model.convert.params_from_flax`` /
``policy_params_from_flax`` take that tree to a port ``state_dict``. So the
reference's layout reaches the port by exactly the JAX package's mapping.

Layout rules:
  torch Linear weight [out, in]      -> flax Dense kernel [in, out] (transpose)
  torch Conv2d weight [O, I, kh, kw] -> flax Conv kernel [kh, kw, I, O]
  torch LayerNorm weight/bias        -> flax LayerNorm scale/bias
  torch NCHW flatten (view(B, -1))   -> the NHWC flatten: fc kernels over
                                        flattened conv maps are re-ordered
                                        (C,H,W) -> (H,W,C) row-wise
  reference one-hot-concat @ W       -> per-field Embed/Dense params are
                                        ROW SLICES of W^T at each field's
                                        column offset (entity encoder)

``reference_state_dict`` runs the rules backwards: a flax-layout tree (a
port model's ``params_to_flax``) as the reference's state dict, key names
and shapes the rules read. It writes the ``.pth`` files the tests and the
chip smoke load.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = [
    "convert_lnlstm",
    "convert_entity_encoder",
    "convert_scalar_encoder",
    "convert_spatial_encoder",
    "convert_action_type_head",
    "convert_delay_head",
    "convert_queued_head",
    "convert_selected_units_head",
    "convert_target_unit_head",
    "convert_location_head",
    "convert_value_baseline",
]


def _t(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).T)


def _ln(sd: Dict, prefix: str) -> Dict:
    return {"scale": np.asarray(sd[f"{prefix}.weight"]), "bias": np.asarray(sd[f"{prefix}.bias"])}


def _fc(sd: Dict, prefix: str) -> Dict:
    """reference fc_block -> {FCBlock}/Dense_0 params."""
    return {
        "Dense_0": {
            "kernel": _t(sd[f"{prefix}.0.weight"]),
            "bias": np.asarray(sd[f"{prefix}.0.bias"]),
        }
    }


def _dense(sd: Dict, prefix: str) -> Dict:
    return {"kernel": _t(sd[f"{prefix}.0.weight"]), "bias": np.asarray(sd[f"{prefix}.0.bias"])}


def _conv(sd: Dict, prefix: str) -> Dict:
    """reference conv2d_block -> flax Conv params (inside Conv2DBlock)."""
    w = np.asarray(sd[f"{prefix}.0.weight"])  # [O, I, kh, kw]
    return {
        "Conv_0": {
            "kernel": np.ascontiguousarray(w.transpose(2, 3, 1, 0)),
            "bias": np.asarray(sd[f"{prefix}.0.bias"]),
        }
    }


def _nchw_fc_kernel(w: np.ndarray, c: int, h: int, wdt: int) -> np.ndarray:
    """torch fc over an NCHW flatten -> kernel for our NHWC flatten."""
    out_dim = w.shape[0]
    k = w.reshape(out_dim, c, h, wdt).transpose(2, 3, 1, 0)  # H, W, C, out
    return np.ascontiguousarray(k.reshape(h * wdt * c, out_dim))


def _transformer_layer(sd: Dict, prefix: str, mlp_num: int = 2) -> Dict:
    out = {
        "Attention_0": {
            "Dense_0": {
                "kernel": _t(sd[f"{prefix}.attention.attention_pre.0.weight"]),
                "bias": np.asarray(sd[f"{prefix}.attention.attention_pre.0.bias"]),
            },
            "Dense_1": {
                "kernel": _t(sd[f"{prefix}.attention.project.0.weight"]),
                "bias": np.asarray(sd[f"{prefix}.attention.project.0.bias"]),
            },
        },
        "LayerNorm_0": _ln(sd, f"{prefix}.layernorm1"),
        "LayerNorm_1": _ln(sd, f"{prefix}.layernorm2"),
    }
    for i in range(mlp_num):
        out[f"FCBlock_{i}"] = _fc(sd, f"{prefix}.mlp.{i}")
    return out


def _transformer(sd: Dict, prefix: str, layer_num: int = 3, mlp_num: int = 2) -> Dict:
    """reference module_utils.Transformer (embedding fc + layers) -> our
    ops.Transformer params (FCBlock_0 embedding + TransformerLayer_i)."""
    out = {"FCBlock_0": _fc(sd, f"{prefix}.embedding")}
    for i in range(layer_num):
        out[f"TransformerLayer_{i}"] = _transformer_layer(sd, f"{prefix}.layers.{i}", mlp_num)
    return out


def _fc_ln(sd: Dict, prefix: str) -> Dict:
    """reference fc_block with norm -> FCBlock{Dense_0, LayerNorm_0}."""
    out = _fc(sd, prefix)
    out["LayerNorm_0"] = _ln(sd, f"{prefix}.1")
    return out


def _res_fc(sd: Dict, prefix: str) -> Dict:
    """reference ResFCBlock (norm per fc) -> ops.ResFCBlock."""
    return {"FCBlock_0": _fc_ln(sd, f"{prefix}.fc1"), "FCBlock_1": _fc_ln(sd, f"{prefix}.fc2")}


def _glu(sd: Dict, prefix: str) -> Dict:
    """reference GLU (layer1 = context gate, layer2 = output) -> ops.GLU."""
    return {
        "Dense_0": {"kernel": _t(sd[f"{prefix}.layer1.0.weight"]), "bias": np.asarray(sd[f"{prefix}.layer1.0.bias"])},
        "Dense_1": {"kernel": _t(sd[f"{prefix}.layer2.0.weight"]), "bias": np.asarray(sd[f"{prefix}.layer2.0.bias"])},
    }


def convert_lnlstm(sd: Dict, num_layers: int) -> Dict:
    """reference script_lnlstm state_dict -> ops.lstm.StackedLSTM params."""
    params = {}
    for i in range(num_layers):
        p = f"layers.{i}.cell"
        params[f"layer{i}"] = {
            "ih": {"kernel": _t(sd[f"{p}.weight_ih"])},
            "hh": {"kernel": _t(sd[f"{p}.weight_hh"])},
            "ln_ih": _ln(sd, f"{p}.layernorm_i"),
            "ln_hh": _ln(sd, f"{p}.layernorm_h"),
            "ln_c": _ln(sd, f"{p}.layernorm_c"),
        }
    return {"params": params}


def convert_entity_encoder(sd: Dict, cfg) -> Dict:
    """reference EntityEncoder state_dict -> model.encoders.EntityEncoder.

    The reference materialises each entity as a 997-wide one-hot/binary/raw
    concat and projects with transformer.embedding (fc 997->256,
    entity_encoder.py:59-80); our per-field embedding-sum is the same map
    with W^T split row-wise at each field's column offset."""
    ent = cfg.encoder.entity
    W = np.asarray(sd["transformer.embedding.0.weight"])  # [width, total]
    bias = np.asarray(sd["transformer.embedding.0.bias"])
    params = {"ent_embed_bias": bias}
    off = 0
    for key, arc, n in ent.fields:
        span = {"one_hot": n, "binary": n, "float": 1}[arc]
        block = _t(W[:, off : off + span])  # [span, width]
        if arc == "one_hot":
            params[f"ent_{key}"] = {"embedding": block}
        else:
            params[f"ent_{key}"] = {"kernel": block}
        off += span
    assert off == W.shape[1], f"field widths {off} != embedding input {W.shape[1]}"

    for i in range(ent.layer_num):
        params[f"TransformerLayer_{i}"] = _transformer_layer(
            sd, f"transformer.layers.{i}", ent.mlp_num
        )
    params["entity_fc"] = _fc(sd, "entity_fc")
    params["embed_fc"] = _fc(sd, "embed_fc")
    return {"params": params}


def _bo_encoder(sd: Dict, prefix: str) -> Dict:
    return {
        "Transformer_0": _transformer(sd, f"{prefix}.transformer"),
        "FCBlock_0": _fc(sd, f"{prefix}.embedd_fc"),
    }


def convert_scalar_encoder(sd: Dict, cfg) -> Dict:
    """reference ScalarEncoder state_dict -> model.encoders.ScalarEncoder."""
    params = {}
    for key, arc, _n, _out, _ctx, _base in cfg.encoder.scalar.fields:
        if arc == "one_hot":
            params[f"embed_{key}"] = {
                "embedding": np.asarray(sd[f"encode_modules.{key}.weight"])
            }
        elif arc == "fc":
            params[f"fc_{key}"] = _fc(sd, f"encode_modules.{key}")
        elif arc == "bo_transformer":
            params["bo_encoder"] = _bo_encoder(sd, f"encode_modules.{key}")
    return {"params": params}


def convert_spatial_encoder(sd: Dict, cfg) -> Dict:
    """reference SpatialEncoder state_dict -> model.encoders.SpatialEncoder.

    Ours auto-names blocks in call order: Conv2DBlock_0 (project), then one
    Conv2DBlock per downsample, then ResBlock_i, then FCBlock_0 (head). The
    fc head's kernel is re-ordered for the NHWC flatten."""
    sp = cfg.encoder.spatial
    params = {"Conv2DBlock_0": _conv(sd, "project")}
    for i in range(len(sp.down_channels)):
        params[f"Conv2DBlock_{i + 1}"] = _conv(sd, f"downsample.{i}")
    for i in range(sp.resblock_num):
        params[f"ResBlock_{i}"] = {
            "Conv2DBlock_0": _conv(sd, f"res.{i}.conv1"),
            "Conv2DBlock_1": _conv(sd, f"res.{i}.conv2"),
        }
    c = sp.down_channels[-1]
    h = cfg.static.spatial_y // (2 ** len(sp.down_channels)) if hasattr(cfg, "static") else None
    # head fc: torch flattens NCHW, ours NHWC
    w = np.asarray(sd["fc.0.weight"])
    hw = w.shape[1] // c
    # infer H from the known aspect (H/W ratio preserved through /8 pooling)
    from ..lib.features import SPATIAL_SIZE

    H = SPATIAL_SIZE[0] // (2 ** len(sp.down_channels))
    W_ = SPATIAL_SIZE[1] // (2 ** len(sp.down_channels))
    assert H * W_ == hw, (H, W_, hw)
    params["FCBlock_0"] = {
        "Dense_0": {"kernel": _nchw_fc_kernel(w, c, H, W_), "bias": np.asarray(sd["fc.0.bias"])}
    }
    return {"params": params}


def convert_action_type_head(sd: Dict, cfg) -> Dict:
    """reference ActionTypeHead -> model.heads.ActionTypeHead."""
    hc = cfg.policy.action_type_head
    params = {"FCBlock_0": _fc(sd, "project")}
    for i in range(hc.res_num):
        params[f"ResFCBlock_{i}"] = _res_fc(sd, f"res.{i}")
    params["action_glu"] = _glu(sd, "action_fc")
    params["FCBlock_1"] = _fc(sd, "action_map_fc1")
    params["FCBlock_2"] = _fc(sd, "action_map_fc2")
    params["glu1"] = _glu(sd, "glu1")
    params["glu2"] = _glu(sd, "glu2")
    return {"params": params}


def _fc_chain(sd: Dict, names) -> Dict:
    return {f"FCBlock_{i}": _fc(sd, name) for i, name in enumerate(names)}


def convert_delay_head(sd: Dict, cfg) -> Dict:
    return {"params": _fc_chain(sd, ["fc1", "fc2", "fc3", "embed_fc1", "embed_fc2"])}


def convert_queued_head(sd: Dict, cfg) -> Dict:
    return {"params": _fc_chain(sd, ["fc1", "fc2", "fc3", "embed_fc1", "embed_fc2"])}


def convert_selected_units_head(sd: Dict, cfg) -> Dict:
    hc = cfg.policy.selected_units_head
    params = {
        "key_fc": _fc(sd, "key_fc"),
        "query_fc1": _fc(sd, "query_fc1"),
        "query_fc2": _fc(sd, "query_fc2"),
        "embed_fc1": _fc(sd, "embed_fc1"),
        "embed_fc2": _fc(sd, "embed_fc2"),
        "end_embedding": np.asarray(sd["end_embedding"]).reshape(-1),
    }
    for i in range(hc.get("num_layers", 1)):
        p = f"lstm.layers.{i}.cell"
        params[f"lstm{i}"] = {
            "ih": {"kernel": _t(sd[f"{p}.weight_ih"])},
            "hh": {"kernel": _t(sd[f"{p}.weight_hh"])},
            "ln_ih": _ln(sd, f"{p}.layernorm_i"),
            "ln_hh": _ln(sd, f"{p}.layernorm_h"),
            "ln_c": _ln(sd, f"{p}.layernorm_c"),
        }
    return {"params": params}


def convert_target_unit_head(sd: Dict, cfg) -> Dict:
    return {"params": _fc_chain(sd, ["key_fc", "query_fc1", "query_fc2"])}


def convert_location_head(sd: Dict, cfg) -> Dict:
    """reference LocationHead (gate=True, bilinear upsample) ->
    model.heads.LocationHead. project_embed's output feeds a channel-FIRST
    reshape in the reference and channel-LAST in ours, so its rows are
    re-ordered (C,H,W) -> (H,W,C)."""
    hc = cfg.policy.location_head
    from ..lib.features import SPATIAL_SIZE

    H8, W8 = SPATIAL_SIZE[0] // 8, SPATIAL_SIZE[1] // 8
    c = hc.reshape_channel
    w = np.asarray(sd["project_embed.0.weight"])  # [C*H8*W8, in]
    b = np.asarray(sd["project_embed.0.bias"])
    w = w.reshape(c, H8, W8, -1).transpose(1, 2, 0, 3).reshape(c * H8 * W8, -1)
    b = b.reshape(c, H8, W8).transpose(1, 2, 0).reshape(-1)
    params = {
        "FCBlock_0": {"Dense_0": {"kernel": _t(w), "bias": b}},
        "Conv2DBlock_0": _conv(sd, "conv1"),
    }
    for i in range(hc.res_num):
        block = {
            "Conv2DBlock_0": _conv(sd, f"res.{i}.conv1"),
            "Conv2DBlock_1": _conv(sd, f"res.{i}.conv2"),
            "update_sp": np.asarray(sd[f"res.{i}.UpdateSP"]),
        }
        for g in range(4):
            block[f"Conv2DBlock_{g + 2}"] = _conv(sd, f"res.{i}.GateWeightG.{g}")
        params[f"GatedResBlock_{i}"] = block
    for i in range(len(hc.upsample_dims)):
        params[f"Conv2DBlock_{i + 1}"] = _conv(sd, f"upsample.{i}")
    return {"params": params}


def convert_value_baseline(sd: Dict, res_num: int) -> Dict:
    params = {"FCBlock_0": _fc(sd, "project")}
    for i in range(res_num):
        params[f"ResFCBlock2_{i}"] = {
            "FCBlock_0": _fc(sd, f"res.{i}.fc1"),
            "FCBlock_1": _fc(sd, f"res.{i}.fc2"),
            "LayerNorm_0": _ln(sd, f"res.{i}.norm"),
        }
    params["Dense_0"] = {
        "kernel": _t(sd["value_fc.0.weight"]),
        "bias": np.asarray(sd["value_fc.0.bias"]),
    }
    return {"params": params}


def _subdict(sd: Dict, prefix: str) -> Dict:
    p = prefix + "."
    return {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}


def convert_model(sd: Dict, cfg) -> Dict:
    """Full reference Model state_dict -> our Model params.

    Accepts raw reference checkpoints: 'model.'/'module.' prefixes are
    stripped. Value towers present in the state dict are converted under
    their value_<name> modules; the value encoder is not yet mapped."""
    for strip in ("model.", "module."):
        if any(k.startswith(strip) for k in sd):
            sd = {k[len(strip):] if k.startswith(strip) else k: v for k, v in sd.items()}

    params = {
        "encoder": {
            "scalar_encoder": convert_scalar_encoder(_subdict(sd, "encoder.scalar_encoder"), cfg)["params"],
            "entity_encoder": convert_entity_encoder(_subdict(sd, "encoder.entity_encoder"), cfg)["params"],
            "spatial_encoder": convert_spatial_encoder(_subdict(sd, "encoder.spatial_encoder"), cfg)["params"],
            "FCBlock_0": _fc(_subdict(sd, "encoder"), "scatter_project"),
        },
        "core_lstm": convert_lnlstm(_subdict(sd, "core_lstm"), cfg.encoder.core_lstm.num_layers)["params"],
        "policy": {
            "action_type_head": convert_action_type_head(_subdict(sd, "policy.action_type_head"), cfg)["params"],
            "delay_head": convert_delay_head(_subdict(sd, "policy.delay_head"), cfg)["params"],
            "queued_head": convert_queued_head(_subdict(sd, "policy.queued_head"), cfg)["params"],
            "selected_units_head": convert_selected_units_head(_subdict(sd, "policy.selected_units_head"), cfg)["params"],
            "target_unit_head": convert_target_unit_head(_subdict(sd, "policy.target_unit_head"), cfg)["params"],
            "location_head": convert_location_head(_subdict(sd, "policy.location_head"), cfg)["params"],
        },
    }
    for name in cfg.enable_baselines:
        sub = _subdict(sd, f"value_networks.{name}")
        if sub:
            params[f"value_{name}"] = convert_value_baseline(sub, cfg.value.res_num)["params"]
    return {"params": params}


def convert_value_encoder(sd: Dict, cfg) -> Dict:
    """reference ValueEncoder state_dict -> model.encoders.ValueEncoder."""
    vc = cfg.value.encoder
    params = {}
    for key, _in, _out in vc.fc_fields:
        ref_key = "cumulative_stat" if key == "enemy_cumulative_stat" else key
        params[f"fc_{key}"] = _fc(sd, f"encode_modules.{ref_key}")
    for key, _n, _dim in vc.unit_fields:
        params[f"embed_{key}"] = {"embedding": np.asarray(sd[f"encode_modules.{key}.weight"])}
    params["bo_encoder"] = _bo_encoder(sd, "encode_modules.beginning_order")
    params["scatter_project"] = _fc(sd, "scatter_project")
    params["Conv2DBlock_0"] = _conv(sd, "project")
    # downsample Sequential alternates MaxPool2d (no params) and conv blocks
    for i in range(len(vc.spatial.down_channels)):
        params[f"Conv2DBlock_{i + 1}"] = _conv(sd, f"downsample.{2 * i + 1}")
    for i in range(vc.spatial.resblock_num):
        params[f"ResBlock_{i}"] = {
            "Conv2DBlock_0": _conv(sd, f"res.{i}.conv1"),
            "Conv2DBlock_1": _conv(sd, f"res.{i}.conv2"),
        }
    c = vc.spatial.down_channels[-1]
    from ..lib.features import SPATIAL_SIZE

    H = SPATIAL_SIZE[0] // (2 ** len(vc.spatial.down_channels))
    W_ = SPATIAL_SIZE[1] // (2 ** len(vc.spatial.down_channels))
    w = np.asarray(sd["spatial_fc.0.weight"])
    params["spatial_fc"] = {
        "Dense_0": {"kernel": _nchw_fc_kernel(w, c, H, W_), "bias": np.asarray(sd["spatial_fc.0.bias"])}
    }
    return {"params": params}


# ------------------------------------------------------------ the way back
def _inv_fc(tree: Dict, prefix: str, out: Dict) -> None:
    out[f"{prefix}.0.weight"] = _t(tree["Dense_0"]["kernel"])
    out[f"{prefix}.0.bias"] = np.asarray(tree["Dense_0"]["bias"])


def _inv_ln(tree: Dict, prefix: str, out: Dict) -> None:
    out[f"{prefix}.weight"] = np.asarray(tree["scale"])
    out[f"{prefix}.bias"] = np.asarray(tree["bias"])


def _inv_conv(tree: Dict, prefix: str, out: Dict) -> None:
    out[f"{prefix}.0.weight"] = np.ascontiguousarray(np.asarray(tree["Conv_0"]["kernel"]).transpose(3, 2, 0, 1))
    out[f"{prefix}.0.bias"] = np.asarray(tree["Conv_0"]["bias"])


def _inv_nchw_fc(tree: Dict, prefix: str, c: int, h: int, wdt: int, out: Dict) -> None:
    k = np.asarray(tree["Dense_0"]["kernel"])  # [H*W*C, out]
    w = k.reshape(h, wdt, c, -1).transpose(3, 2, 0, 1)  # out, C, H, W
    out[f"{prefix}.0.weight"] = np.ascontiguousarray(w.reshape(w.shape[0], -1))
    out[f"{prefix}.0.bias"] = np.asarray(tree["Dense_0"]["bias"])


def _inv_transformer_layer(tree: Dict, prefix: str, mlp_num: int, out: Dict) -> None:
    att = tree["Attention_0"]
    _inv_fc({"Dense_0": att["Dense_0"]}, f"{prefix}.attention.attention_pre", out)
    _inv_fc({"Dense_0": att["Dense_1"]}, f"{prefix}.attention.project", out)
    _inv_ln(tree["LayerNorm_0"], f"{prefix}.layernorm1", out)
    _inv_ln(tree["LayerNorm_1"], f"{prefix}.layernorm2", out)
    for i in range(mlp_num):
        _inv_fc(tree[f"FCBlock_{i}"], f"{prefix}.mlp.{i}", out)


def _inv_transformer(tree: Dict, prefix: str, out: Dict) -> None:
    _inv_fc(tree["FCBlock_0"], f"{prefix}.embedding", out)
    layers = sorted(k for k in tree if k.startswith("TransformerLayer_"))
    for i in range(len(layers)):
        layer = tree[f"TransformerLayer_{i}"]
        mlp_num = len([k for k in layer if k.startswith("FCBlock_")])
        _inv_transformer_layer(layer, f"{prefix}.layers.{i}", mlp_num, out)


def _inv_bo_encoder(tree: Dict, prefix: str, out: Dict) -> None:
    _inv_transformer(tree["Transformer_0"], f"{prefix}.transformer", out)
    _inv_fc(tree["FCBlock_0"], f"{prefix}.embedd_fc", out)


def _inv_fc_ln(tree: Dict, prefix: str, out: Dict) -> None:
    _inv_fc(tree, prefix, out)
    _inv_ln(tree["LayerNorm_0"], f"{prefix}.1", out)


def _inv_glu(tree: Dict, prefix: str, out: Dict) -> None:
    _inv_fc({"Dense_0": tree["Dense_0"]}, f"{prefix}.layer1", out)
    _inv_fc({"Dense_0": tree["Dense_1"]}, f"{prefix}.layer2", out)


def _inv_lstm_cell(tree: Dict, prefix: str, out: Dict) -> None:
    out[f"{prefix}.weight_ih"] = _t(tree["ih"]["kernel"])
    out[f"{prefix}.weight_hh"] = _t(tree["hh"]["kernel"])
    for name, ref in (("ln_ih", "layernorm_i"), ("ln_hh", "layernorm_h"), ("ln_c", "layernorm_c")):
        _inv_ln(tree[name], f"{prefix}.{ref}", out)


def _inv_entity_encoder(tree: Dict, cfg, out: Dict) -> None:
    ent = cfg.encoder.entity
    blocks = []
    for key, arc, _n in ent.fields:
        leaf = tree[f"ent_{key}"]
        blocks.append(np.asarray(leaf["embedding" if arc == "one_hot" else "kernel"]))
    out["transformer.embedding.0.weight"] = _t(np.concatenate(blocks, 0))
    out["transformer.embedding.0.bias"] = np.asarray(tree["ent_embed_bias"])
    for i in range(ent.layer_num):
        _inv_transformer_layer(tree[f"TransformerLayer_{i}"], f"transformer.layers.{i}", ent.mlp_num, out)
    _inv_fc(tree["entity_fc"], "entity_fc", out)
    _inv_fc(tree["embed_fc"], "embed_fc", out)


def _inv_scalar_encoder(tree: Dict, cfg, out: Dict) -> None:
    for key, arc, _n, _out, _ctx, _base in cfg.encoder.scalar.fields:
        if arc == "one_hot":
            out[f"encode_modules.{key}.weight"] = np.asarray(tree[f"embed_{key}"]["embedding"])
        elif arc == "fc":
            _inv_fc(tree[f"fc_{key}"], f"encode_modules.{key}", out)
        elif arc == "bo_transformer":
            _inv_bo_encoder(tree["bo_encoder"], f"encode_modules.{key}", out)


def _down_hw(n_down: int):
    from ..lib.features import SPATIAL_SIZE

    return SPATIAL_SIZE[0] // (2 ** n_down), SPATIAL_SIZE[1] // (2 ** n_down)


def _inv_spatial_encoder(tree: Dict, cfg, out: Dict) -> None:
    sp = cfg.encoder.spatial
    _inv_conv(tree["Conv2DBlock_0"], "project", out)
    for i in range(len(sp.down_channels)):
        _inv_conv(tree[f"Conv2DBlock_{i + 1}"], f"downsample.{i}", out)
    for i in range(sp.resblock_num):
        _inv_conv(tree[f"ResBlock_{i}"]["Conv2DBlock_0"], f"res.{i}.conv1", out)
        _inv_conv(tree[f"ResBlock_{i}"]["Conv2DBlock_1"], f"res.{i}.conv2", out)
    H, W_ = _down_hw(len(sp.down_channels))
    _inv_nchw_fc(tree["FCBlock_0"], "fc", sp.down_channels[-1], H, W_, out)


def _inv_action_type_head(tree: Dict, cfg, out: Dict) -> None:
    _inv_fc(tree["FCBlock_0"], "project", out)
    for i in range(cfg.policy.action_type_head.res_num):
        block = tree[f"ResFCBlock_{i}"]
        _inv_fc_ln(block["FCBlock_0"], f"res.{i}.fc1", out)
        _inv_fc_ln(block["FCBlock_1"], f"res.{i}.fc2", out)
    _inv_glu(tree["action_glu"], "action_fc", out)
    _inv_fc(tree["FCBlock_1"], "action_map_fc1", out)
    _inv_fc(tree["FCBlock_2"], "action_map_fc2", out)
    _inv_glu(tree["glu1"], "glu1", out)
    _inv_glu(tree["glu2"], "glu2", out)


def _inv_fc_chain(tree: Dict, names, out: Dict) -> None:
    for i, name in enumerate(names):
        _inv_fc(tree[f"FCBlock_{i}"], name, out)


def _inv_selected_units_head(tree: Dict, cfg, out: Dict) -> None:
    for name in ("key_fc", "query_fc1", "query_fc2", "embed_fc1", "embed_fc2"):
        _inv_fc(tree[name], name, out)
    out["end_embedding"] = np.asarray(tree["end_embedding"]).reshape(1, -1)
    for i in range(cfg.policy.selected_units_head.get("num_layers", 1)):
        _inv_lstm_cell(tree[f"lstm{i}"], f"lstm.layers.{i}.cell", out)


def _inv_location_head(tree: Dict, cfg, out: Dict) -> None:
    hc = cfg.policy.location_head
    H8, W8 = _down_hw(3)
    c = hc.reshape_channel
    dense = tree["FCBlock_0"]["Dense_0"]
    w = _t(dense["kernel"])  # [H8*W8*C, in], rows (H, W, C)
    out["project_embed.0.weight"] = np.ascontiguousarray(
        w.reshape(H8, W8, c, -1).transpose(2, 0, 1, 3).reshape(c * H8 * W8, -1))
    out["project_embed.0.bias"] = np.ascontiguousarray(
        np.asarray(dense["bias"]).reshape(H8, W8, c).transpose(2, 0, 1).reshape(-1))
    _inv_conv(tree["Conv2DBlock_0"], "conv1", out)
    for i in range(hc.res_num):
        block = tree[f"GatedResBlock_{i}"]
        _inv_conv(block["Conv2DBlock_0"], f"res.{i}.conv1", out)
        _inv_conv(block["Conv2DBlock_1"], f"res.{i}.conv2", out)
        out[f"res.{i}.UpdateSP"] = np.asarray(block["update_sp"])
        for g in range(4):
            _inv_conv(block[f"Conv2DBlock_{g + 2}"], f"res.{i}.GateWeightG.{g}", out)
    for i in range(len(hc.upsample_dims)):
        _inv_conv(tree[f"Conv2DBlock_{i + 1}"], f"upsample.{i}", out)


def _inv_value_baseline(tree: Dict, res_num: int, out: Dict) -> None:
    _inv_fc(tree["FCBlock_0"], "project", out)
    for i in range(res_num):
        block = tree[f"ResFCBlock2_{i}"]
        _inv_fc(block["FCBlock_0"], f"res.{i}.fc1", out)
        _inv_fc(block["FCBlock_1"], f"res.{i}.fc2", out)
        _inv_ln(block["LayerNorm_0"], f"res.{i}.norm", out)
    out["value_fc.0.weight"] = _t(tree["Dense_0"]["kernel"])
    out["value_fc.0.bias"] = np.asarray(tree["Dense_0"]["bias"])


def _inv_value_encoder(tree: Dict, cfg, out: Dict) -> None:
    vc = cfg.value.encoder
    for key, _in, _out in vc.fc_fields:
        ref_key = "cumulative_stat" if key == "enemy_cumulative_stat" else key
        _inv_fc(tree[f"fc_{key}"], f"encode_modules.{ref_key}", out)
    for key, _n, _dim in vc.unit_fields:
        out[f"encode_modules.{key}.weight"] = np.asarray(tree[f"embed_{key}"]["embedding"])
    _inv_bo_encoder(tree["bo_encoder"], "encode_modules.beginning_order", out)
    _inv_fc(tree["scatter_project"], "scatter_project", out)
    _inv_conv(tree["Conv2DBlock_0"], "project", out)
    for i in range(len(vc.spatial.down_channels)):
        _inv_conv(tree[f"Conv2DBlock_{i + 1}"], f"downsample.{2 * i + 1}", out)
    for i in range(vc.spatial.resblock_num):
        _inv_conv(tree[f"ResBlock_{i}"]["Conv2DBlock_0"], f"res.{i}.conv1", out)
        _inv_conv(tree[f"ResBlock_{i}"]["Conv2DBlock_1"], f"res.{i}.conv2", out)
    H, W_ = _down_hw(len(vc.spatial.down_channels))
    _inv_nchw_fc(tree["spatial_fc"], "spatial_fc", vc.spatial.down_channels[-1], H, W_, out)


def _prefixed(prefix: str, fill, *args) -> Dict:
    part: Dict = {}
    fill(*args, part)
    return {f"{prefix}.{k}": v for k, v in part.items()}


def reference_part(part: str, tree: Dict, cfg) -> Dict:
    """One part's flax-layout subtree (``tree``, without the ``params``
    wrapper) as the reference module's state dict: the inverse of
    ``convert_<part>``. ``part`` is ``lnlstm``, ``entity_encoder``,
    ``scalar_encoder``, ``spatial_encoder``, one of the six heads, ``value_baseline``
    or ``value_encoder``."""
    out: Dict = {}
    if part == "lnlstm":
        for i in range(len(tree)):
            _inv_lstm_cell(tree[f"layer{i}"], f"layers.{i}.cell", out)
    elif part in ("delay_head", "queued_head"):
        _inv_fc_chain(tree, ["fc1", "fc2", "fc3", "embed_fc1", "embed_fc2"], out)
    elif part == "target_unit_head":
        _inv_fc_chain(tree, ["key_fc", "query_fc1", "query_fc2"], out)
    elif part == "value_baseline":
        _inv_value_baseline(tree, cfg.value.res_num, out)
    else:
        {"entity_encoder": _inv_entity_encoder, "scalar_encoder": _inv_scalar_encoder,
         "spatial_encoder": _inv_spatial_encoder, "action_type_head": _inv_action_type_head,
         "selected_units_head": _inv_selected_units_head, "location_head": _inv_location_head,
         "value_encoder": _inv_value_encoder}[part](tree, cfg, out)
    return out


def reference_state_dict(params: Dict, cfg) -> Dict[str, np.ndarray]:
    """A whole model's flax-layout tree as the reference ``Model``'s state
    dict: what ``convert_model`` reads (the value towers present in
    ``params`` under ``value_networks.<name>``, the value encoder under
    ``value_encoder``)."""
    if set(params) == {"params"}:
        params = params["params"]
    enc, pol = params["encoder"], params["policy"]
    sd: Dict[str, np.ndarray] = {}
    for name in ("scalar_encoder", "entity_encoder", "spatial_encoder"):
        sd.update({f"encoder.{name}.{k}": v for k, v in reference_part(name, enc[name], cfg).items()})
    sd.update(_prefixed("encoder", _inv_fc, enc["FCBlock_0"], "scatter_project"))
    sd.update({f"core_lstm.{k}": v for k, v in reference_part("lnlstm", params["core_lstm"], cfg).items()})
    for head in ("action_type_head", "delay_head", "queued_head", "selected_units_head",
                 "target_unit_head", "location_head"):
        sd.update({f"policy.{head}.{k}": v for k, v in reference_part(head, pol[head], cfg).items()})
    for name in cfg.enable_baselines:
        if f"value_{name}" in params:
            sd.update({f"value_networks.{name}.{k}": v
                       for k, v in reference_part("value_baseline", params[f"value_{name}"], cfg).items()})
    if "value_encoder" in params:
        sd.update({f"value_encoder.{k}": v
                   for k, v in reference_part("value_encoder", params["value_encoder"], cfg).items()})
    return sd

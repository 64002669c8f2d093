"""Default architecture configuration for the AlphaStar-style policy/value net.

The same keys and strings as ``distar_tpu.model.config`` (reference:
distar/agent/default/model/actor_critic_default_config.yaml), so a JAX
package config cascades over this one unchanged. The kernel switches are
``encoder.entity.attention_impl`` ('xla' | 'pallas' | 'ring') and
``encoder.scatter.impl`` ('xla' | 'pallas' | 'pallas_onehot'); 'pallas*'
selects the hand-written CUDA kernels on CUDA tensors.
"""
from __future__ import annotations

from typing import Any, Mapping

import torch

from ..lib import actions as A
from ..lib.features import MAX_DELAY, SPATIAL_SIZE
from ..utils import Config, deep_merge_dicts

SPATIAL_Y, SPATIAL_X = SPATIAL_SIZE


class StaticConfig:
    """Attribute-access view over any Mapping (or a pass-through)."""

    def __init__(self, data: Mapping):
        object.__setattr__(self, "_data", data)

    @staticmethod
    def _wrap(v: Any) -> Any:
        return StaticConfig(v) if isinstance(v, Mapping) else v

    def __getattr__(self, k: str) -> Any:
        try:
            return self._wrap(self._data[k])
        except KeyError as e:
            raise AttributeError(k) from e

    def __getitem__(self, k) -> Any:
        return self._wrap(self._data[k])

    def get(self, k, default=None) -> Any:
        v = self._data.get(k, default)
        return self._wrap(v) if isinstance(v, Mapping) else v

    def __contains__(self, k) -> bool:
        return k in self._data


def static_cfg(cfg) -> StaticConfig:
    """Wrap a Mapping (or pass a StaticConfig through) for attribute access."""
    return cfg if isinstance(cfg, StaticConfig) else StaticConfig(cfg)


def cdtype(cfg) -> torch.dtype:
    """Compute dtype from the model config: 'bfloat16' runs the forward
    under bf16 autocast (params stay float32)."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[
        static_cfg(cfg).get("dtype", "float32")
    ]


def default_model_config() -> Config:
    bo_encoder = {
        "action_num": A.NUM_BEGINNING_ORDER_ACTIONS,  # 174
        "binary_dim": 10,
        "head_dim": 8,
        "output_dim": 64,
    }
    return Config(
        {
            "spatial_y": SPATIAL_Y,
            "spatial_x": SPATIAL_X,
            "temperature": 1.0,
            "use_value_network": False,
            "use_value_feature": False,
            "only_update_baseline": False,
            "enable_baselines": [
                "winloss", "build_order", "built_unit", "effect", "upgrade", "battle",
            ],
            # entity pooled-embedding reduction: 'selected_units_num' divides the
            # masked sum by entity_num (reference default), 'constant' by 512.
            "entity_reduce_type": "selected_units_num",
            "dtype": "float32",  # compute dtype: 'bfloat16' runs under bf16 autocast
            # rematerialize the encoder blocks in the backward pass; a
            # training switch, read by no forward of the serving path
            "remat": False,
            "encoder": {
                "scalar": {
                    # ordered: (key, arc, in_dim_or_classes, out_dim, context?, baseline?)
                    "fields": [
                        ("agent_statistics", "fc", 10, 64, False, True),
                        ("home_race", "one_hot", 5, 32, True, False),
                        ("away_race", "one_hot", 5, 32, True, False),
                        ("upgrades", "fc", A.NUM_UPGRADES, 128, False, True),
                        ("time", "time", None, 32, False, False),
                        ("unit_counts_bow", "fc", A.NUM_UNIT_TYPES, 128, False, True),
                        ("last_delay", "one_hot", MAX_DELAY + 1, 64, False, False),
                        ("last_queued", "one_hot", 2, 32, False, False),
                        ("last_action_type", "one_hot", A.NUM_ACTIONS, 128, False, False),
                        ("cumulative_stat", "fc", A.NUM_CUMULATIVE_STAT_ACTIONS, 128, True, True),
                        ("beginning_order", "bo_transformer", None, 64, True, True),
                        ("unit_type_bool", "fc", A.NUM_UNIT_TYPES, 64, True, False),
                        ("enemy_unit_type_bool", "fc", A.NUM_UNIT_TYPES, 64, True, False),
                        ("unit_order_type", "fc", A.NUM_UNIT_MIX_ABILITIES, 64, True, False),
                    ],
                    "bo": bo_encoder,
                    # concat of outputs = 1024; context subset = 448; baseline = 512
                },
                "spatial": {
                    # (key, arc, classes) — 'float' divides by 256, 'scatter' is a
                    # coordinate-list effect plane
                    "fields": [
                        ("height_map", "float", None),
                        ("visibility_map", "one_hot", 4),
                        ("creep", "one_hot", 2),
                        ("player_relative", "one_hot", 5),
                        ("alerts", "one_hot", 2),
                        ("pathable", "one_hot", 2),
                        ("buildable", "one_hot", 2),
                        ("effect_PsiStorm", "scatter", None),
                        ("effect_NukeDot", "scatter", None),
                        ("effect_LiberatorDefenderZone", "scatter", None),
                        ("effect_BlindingCloud", "scatter", None),
                        ("effect_CorrosiveBile", "scatter", None),
                        ("effect_LurkerSpines", "scatter", None),
                    ],
                    "project_dim": 32,
                    "down_channels": [64, 128, 128],
                    "resblock_num": 4,
                    "fc_dim": 256,
                },
                "entity": {
                    # (key, arc, classes_or_bits); 'float' appends the raw value
                    "fields": [
                        ("unit_type", "one_hot", A.NUM_UNIT_TYPES),
                        ("alliance", "one_hot", 5),
                        ("cargo_space_taken", "one_hot", 9),
                        ("build_progress", "float", None),
                        ("health_ratio", "float", None),
                        ("shield_ratio", "float", None),
                        ("energy_ratio", "float", None),
                        ("display_type", "one_hot", 5),
                        ("x", "binary", 11),
                        ("y", "binary", 11),
                        ("cloak", "one_hot", 5),
                        ("is_blip", "one_hot", 2),
                        ("is_powered", "one_hot", 2),
                        ("mineral_contents", "float", None),
                        ("vespene_contents", "float", None),
                        ("cargo_space_max", "one_hot", 9),
                        ("assigned_harvesters", "one_hot", 24),
                        ("weapon_cooldown", "one_hot", 32),
                        ("order_length", "one_hot", 9),
                        ("order_id_0", "one_hot", A.NUM_ACTIONS),
                        ("order_id_1", "one_hot", A.QUEUE_ACTION_EMBEDDING_DIM),
                        ("is_hallucination", "one_hot", 2),
                        ("buff_id_0", "one_hot", A.NUM_BUFFS),
                        ("buff_id_1", "one_hot", A.NUM_BUFFS),
                        ("addon_unit_type", "one_hot", A.NUM_ADDON),
                        ("is_active", "one_hot", 2),
                        ("order_progress_0", "float", None),
                        ("order_progress_1", "float", None),
                        ("order_id_2", "one_hot", A.QUEUE_ACTION_EMBEDDING_DIM),
                        ("order_id_3", "one_hot", A.QUEUE_ACTION_EMBEDDING_DIM),
                        ("is_in_cargo", "one_hot", 2),
                        ("attack_upgrade_level", "one_hot", 4),
                        ("armor_upgrade_level", "one_hot", 4),
                        ("shield_upgrade_level", "one_hot", 4),
                        ("last_selected_units", "one_hot", 2),
                        ("last_targeted_unit", "one_hot", 2),
                    ],
                    "head_dim": 128,
                    "hidden_dim": 1024,
                    "output_dim": 256,
                    "head_num": 2,
                    "mlp_num": 2,
                    "layer_num": 3,
                    "ln_type": "post",
                },
                "scatter": {"output_dim": 32, "type": "add"},
                "core_lstm": {"input_size": 1536, "hidden_size": 384, "num_layers": 3},
            },
            "policy": {
                "action_type_head": {
                    "input_dim": 384,
                    "res_dim": 256,
                    "res_num": 2,
                    "action_num": A.NUM_ACTIONS,
                    "action_map_dim": 256,
                    "gate_dim": 1024,
                    "context_dim": 448,
                    "norm_type": "LN",
                },
                "delay_head": {"decode_dim": 256, "delay_dim": MAX_DELAY + 1, "delay_map_dim": 256},
                "queued_head": {"decode_dim": 256, "queued_dim": 2, "queued_map_dim": 256},
                "selected_units_head": {
                    "key_dim": 32,
                    "func_dim": 256,
                    "hidden_dim": 32,
                    "num_layers": 1,
                    "extra_units": True,
                    # teacher-forced decode: 'parallel' (batched, default) or
                    # 'scan' (step-by-step, the sampling path's structure)
                    "train_impl": "parallel",
                },
                "target_unit_head": {"key_dim": 32, "func_dim": 256},
                "location_head": {
                    "reshape_channel": 4,
                    "res_dim": 128,
                    "res_num": 4,
                    "map_skip_dim": 128,
                    "upsample_dims": [64, 32, 1],
                    "gate": True,
                },
            },
            "value": {
                # per-baseline tower params; atan squash only on winloss
                "baselines": {
                    "winloss": {"atan": True},
                    "build_order": {"atan": False},
                    "built_unit": {"atan": False},
                    "effect": {"atan": False},
                    "upgrade": {"atan": False},
                    "battle": {"atan": False},
                },
                "input_dim": 384,
                "res_dim": 256,
                "res_num": 16,
                "norm_type": "LN",
                "encoder": {
                    # value_feature fields (centralized critic; opponent info)
                    "fc_fields": [
                        ("enemy_unit_counts_bow", A.NUM_UNIT_TYPES, 64),
                        ("enemy_unit_type_bool", A.NUM_UNIT_TYPES, 64),
                        ("enemy_agent_statistics", 10, 64),
                        ("enemy_upgrades", A.NUM_UPGRADES, 32),
                        ("enemy_cumulative_stat", A.NUM_CUMULATIVE_STAT_ACTIONS, 128),
                    ],
                    "unit_fields": [("unit_alliance", 2, 16), ("unit_type", A.NUM_UNIT_TYPES, 48)],
                    "bo": bo_encoder,
                    "scatter_dim": 8,
                    "spatial": {"project_dim": 16, "down_channels": [16, 32, 32], "resblock_num": 4, "fc_dim": 128},
                },
            },
        }
    )


#: The distillation student's shrink overlay (cascaded over the teacher's
#: config by :func:`student_model_config`). Every head keeps its STRUCTURE
#: — same six heads, same action vocabularies, same logit axes — so the
#: student's wire outputs (logits, actions, versions) are drop-in
#: replacements for the teacher's on every serving surface; only widths,
#: depths and the LSTM carry dims shrink. Dims that derive from the
#: observation contract (scalar-field vocabularies, context_dim 448, the
#: spatial grid) are untouched: shrinking them would change semantics, not
#: just capacity.
STUDENT_SHRINK = {
    "encoder": {
        "entity": {
            # the entity transformer is the FLOP center: half the width,
            # quarter the MLP, one less block
            "head_dim": 64,
            "hidden_dim": 256,
            "output_dim": 128,
            "layer_num": 2,
        },
        "spatial": {
            "project_dim": 16,
            "down_channels": [32, 64, 64],
            "resblock_num": 2,
            "fc_dim": 128,
        },
        "scatter": {"output_dim": 16},
        # half the carry width; SAME layer count, so the (h, c)-tuple
        # structure the serve plane snapshots/restores is isomorphic
        # (input = 1024 scalar concat + 128 entity + 128 spatial)
        "core_lstm": {"input_size": 1280, "hidden_size": 192, "num_layers": 3},
    },
    "policy": {
        "action_type_head": {
            "input_dim": 192, "res_dim": 128, "res_num": 1,
            "action_map_dim": 128, "gate_dim": 256,
        },
        "delay_head": {"decode_dim": 128, "delay_map_dim": 128},
        "queued_head": {"decode_dim": 128, "queued_map_dim": 128},
        "selected_units_head": {"func_dim": 128},
        "target_unit_head": {"func_dim": 128},
        "location_head": {
            "res_dim": 64, "res_num": 2, "map_skip_dim": 64,
            "upsample_dims": [32, 16, 1],
        },
    },
    "value": {"input_dim": 192, "res_dim": 128, "res_num": 4},
}


def student_model_config(overrides: Mapping = None) -> Config:
    """The distillation student: :func:`default_model_config` with
    :data:`STUDENT_SHRINK` cascaded over it, then any user ``overrides``
    (so a smoke config shrinks the student the same way it shrinks the
    teacher). Head structure is identical to the teacher's by construction
    — only capacity differs — which is what lets student checkpoints roll
    through the same gateways, canary splits and player muxes as teacher
    ones (docs/serving.md, model tiering)."""
    cfg = deep_merge_dicts(default_model_config(), STUDENT_SHRINK)
    if overrides:
        cfg = deep_merge_dicts(cfg, overrides)
    return cfg

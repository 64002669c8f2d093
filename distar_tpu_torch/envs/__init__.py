"""Environments: the two-player contract, the game-free mock env, the SC2
env over its client stack (``sc2/``), the proto feature transforms and the
two-pass replay decoder, and the micro-battle world (``jaxenv``: its host
env, and the on-device Anakin loop).

Counterpart of ``distar_tpu.envs``, with the same exports. ``jaxenv`` and
``sc2`` are imported by their users.
"""
from .dummy_obs import build_dummy_game_info, build_dummy_obs
from .env import BaseEnv
from .features import ProtoFeatures, compute_battle_score, unpack_feature_layer
from .mock_env import MockEnv
from .sc2_env import FakeController, SC2Env

__all__ = [
    "BaseEnv",
    "MockEnv",
    "SC2Env",
    "FakeController",
    "ProtoFeatures",
    "compute_battle_score",
    "unpack_feature_layer",
    "build_dummy_game_info",
    "build_dummy_obs",
]

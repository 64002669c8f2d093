"""Environments: the two-player contract, the game-free mock env and the
micro-battle world (``jaxenv``: its host env, and the on-device Anakin loop).

Counterpart of ``distar_tpu.envs``' ``BaseEnv``, ``MockEnv`` and
``jaxenv``. The SC2 binding and the replay decoder (ROADMAP Queue 1 item
10) are not ported yet.
"""
from .env import BaseEnv
from .mock_env import MockEnv

__all__ = ["BaseEnv", "MockEnv"]

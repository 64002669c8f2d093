"""jaxenv in PyTorch: the micro-battle world on the device and the Anakin loop.

Counterpart of ``distar_tpu.envs.jaxenv`` (the JAX package's names are
kept, the launcher's ``--env jaxenv`` among them): a batched micro-battle
environment in tensors with a leading lane axis, speaking the real
Features observation and action contract, plus the Anakin rollout that
trains the flagship model against it with no host transfer inside a
window. docs/envs.md has the state, step and reward spec and the Features
mapping.
"""
from .anakin import AnakinDataLoader, AnakinRunner, device_pure_report
from .core import EnvConfig, EnvState, micro_legal_mask, reset, step
from .host import JaxMicroBattleEnv, episode_digest
from .obs import observe
from .scenario import Scenario, ScenarioConfig, ScenarioGenerator
from .winrate import (
    ModelPolicy,
    ScriptedPolicy,
    attack_nearest_policy,
    head_to_head,
    idle_policy,
    model_policy,
)

__all__ = [
    "AnakinDataLoader",
    "AnakinRunner",
    "device_pure_report",
    "EnvConfig",
    "EnvState",
    "micro_legal_mask",
    "reset",
    "step",
    "observe",
    "JaxMicroBattleEnv",
    "episode_digest",
    "Scenario",
    "ScenarioConfig",
    "ScenarioGenerator",
    "ModelPolicy",
    "ScriptedPolicy",
    "attack_nearest_policy",
    "idle_policy",
    "model_policy",
    "head_to_head",
]

"""The skill observatory: continuous evaluation arena over checkpoint
history, a durable payoff matrix with Wilson confidence intervals, and
ELO/TrueSkill rating trajectories — the measured substrate the PFSP
league matchmakes from.

Counterpart of ``distar_tpu.arena``: the store is host code, the
evaluator plays its head-to-heads on the port's jaxenv on the device. The
evaluator's names load on first use, so a process that only hosts the
store (the coordinator) does not import torch.
"""
from .store import (
    ANCHORS,
    ArenaStore,
    get_arena_store,
    match_key,
    match_seed,
    set_arena_store,
    wilson_interval,
)

__all__ = [
    "ANCHORS",
    "ArenaEvaluator",
    "ArenaStore",
    "anchor_policy",
    "assignment_scenarios",
    "get_arena_store",
    "match_key",
    "match_seed",
    "set_arena_store",
    "wilson_interval",
]

_EVALUATOR = ("ArenaEvaluator", "anchor_policy", "assignment_scenarios")


def __getattr__(name):
    if name in _EVALUATOR:
        from . import evaluator

        return getattr(evaluator, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

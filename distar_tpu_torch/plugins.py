"""Pipeline plugin registry: per-pipeline component resolution.

Counterpart of ``distar_tpu.plugins``; the default pipeline resolves to this
package's components, the SC2 ``ReplayDecoder``
(``envs.replay_decoder``) among them.

Role of the reference's agent plugin system (reference:
distar/agent/import_helper.py:1-19 resolves ``distar.agent.<pipeline>`` to
one of {Agent, RLLearner, SLLearner, ReplayDecoder}; distar/agent/template/
is the user-facing skeleton): every league player carries a ``pipeline``
name, and the Actor, the train CLIs, and the replay tooling resolve their
per-pipeline implementation through this one registry.

Pipelines:

- ``default`` (or empty) — the flagship model stack in this package.
- ``bot`` — a built-in SC2 bot side; has no importable components.
- ``scripted.<name>`` — model-free scripted agents (actor/scripted.py);
  they provide only ``Agent``.
- any other name — an importable module path (``my_pkg.my_pipeline``).
  The module exposes the component classes by name, the reference's
  ``distar/agent/<name>/`` convention generalized to any module on
  ``sys.path`` so user code lives outside the installed package.

Custom-pipeline agents implement docs/agent_contract.md and OWN their
inference: the Actor's fixed-shape lockstep batch is the default
pipeline's fast path, while a custom agent computes actions inside
``step(obs)`` however it likes (its own model, a policy table, a
remote call). They ride the Actor's model-free path — no inference slot,
no teacher, no trajectory assembly unless the agent does its own.
"""
from __future__ import annotations

import importlib

COMPONENTS = ("Agent", "RLLearner", "SLLearner", "ReplayDecoder")

_DEFAULTS = {
    "Agent": ("distar_tpu_torch.actor.agent", "Agent"),
    "RLLearner": ("distar_tpu_torch.learner", "RLLearner"),
    "SLLearner": ("distar_tpu_torch.learner", "SLLearner"),
    "ReplayDecoder": ("distar_tpu_torch.envs.replay_decoder", "ReplayDecoder"),
}


def is_default(pipeline) -> bool:
    return pipeline in (None, "", "default")


def is_external(pipeline) -> bool:
    """True for user-module pipelines (not default/bot/scripted).

    Any ``scripted.*`` name classifies as scripted — including typos,
    which load_component diagnoses against the registry rather than
    treating as an importable module.
    """
    return not (
        is_default(pipeline)
        or pipeline == "bot"
        or str(pipeline).startswith("scripted.")
    )


def is_model_free(pipeline) -> bool:
    """Sides whose agent acts without the Actor's batched inference slots:
    scripted built-ins and all external pipelines (which own their
    inference, see module docstring)."""
    return not is_default(pipeline) and pipeline != "bot"


def load_component(pipeline, component: str):
    """Resolve a component class for a pipeline name.

    Mirrors reference import_helper.import_module(pipeline, name), with
    error messages that point at the contract instead of a bare
    AttributeError deep inside importlib.
    """
    if component not in COMPONENTS:
        raise ValueError(
            f"unknown component {component!r}; one of {COMPONENTS}"
        )
    if is_default(pipeline):
        mod_name, attr = _DEFAULTS[component]
        return getattr(importlib.import_module(mod_name), attr)
    if pipeline == "bot":
        raise ValueError("'bot' sides are played by the SC2 engine; "
                         "they have no importable components")

    from .actor.scripted import SCRIPTED_PIPELINES, is_scripted

    if is_scripted(pipeline):
        if component != "Agent":
            raise ValueError(
                f"scripted pipeline {pipeline!r} provides only Agent, "
                f"not {component}"
            )
        return SCRIPTED_PIPELINES[pipeline]
    if str(pipeline).startswith("scripted."):
        # typo'd scripted name: diagnose against the registry instead of
        # falling through to a misleading plugin-module ImportError
        raise ValueError(
            f"unknown scripted pipeline {pipeline!r}; "
            f"one of {sorted(SCRIPTED_PIPELINES)}"
        )

    try:
        module = importlib.import_module(pipeline)
    except ImportError as e:
        raise ImportError(
            f"pipeline {pipeline!r} is not importable ({e}); a custom "
            "pipeline is a module on sys.path exposing "
            f"{'/'.join(COMPONENTS)} classes (docs/agent_contract.md)"
        ) from e
    try:
        return getattr(module, component)
    except AttributeError:
        raise AttributeError(
            f"pipeline module {pipeline!r} defines no {component!r}; "
            "expose the class by that exact name (docs/agent_contract.md)"
        ) from None


def build_agent(pipeline, player_id: str, seed: int = 0, race=None):
    """Construct a model-free agent for an Actor side.

    Scripted built-ins and external agents share one construction
    convention: keyword args (player_id, seed, race), and the class must
    tolerate unknown kwargs (the contract's ``**kwargs``).
    """
    from .actor.scripted import build_scripted, is_scripted

    if is_scripted(pipeline):
        return build_scripted(pipeline, player_id, seed=seed, race=race)
    cls = load_component(pipeline, "Agent")
    return cls(player_id=player_id, seed=seed, race=race)

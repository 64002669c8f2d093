"""Weight bridge between the JAX package's flax ``params`` tree and a port
``state_dict``, both ways (``params_from_flax``, ``params_to_flax``: the
whole tree off the device in one transfer, what a learner publishes to its
actors and checkpoints), and the load of a learner's tree into an actor's
policy-only model (``policy_params_from_flax``).

The port's modules carry flax's names, so a leaf at ``a/b/Dense_0/kernel``
lands at ``a.b.Dense_0.weight``. Layouts change on the way:

* Dense ``kernel[in, out]``    -> Linear ``weight[out, in]``
* Conv ``kernel[H, W, I, O]``  -> Conv2d ``weight[O, I, H, W]``
* Embed ``embedding[n, d]``    -> Embedding ``weight[n, d]``
* LayerNorm ``scale``          -> LayerNorm ``weight``
* bare params (``update_sp``, ``end_embedding``, ...) keep their names.

No fc rows are permuted: the port flattens (spatial fc) and reshapes
(location projection) maps in the JAX package's NHWC order. The way back
reads each parameter's owner module to know which flax leaf it was.

A model holds its blocks of the parameters as its placement
(``parallel.spmd.param_shards``) gives them, whole on one process:
``params_to_flax`` and ``learner_state_to_flax`` gather the whole tensors
(where the placement splits a leaf, a collective every rank calls), and
the loads keep each rank's blocks of the whole arrays they are given.

A learner's whole state crosses too (``learner_state_to_flax``,
``load_learner_state``): every JAX learner checkpoints ``{"params",
"opt_state"}``, the optax chain state of ``parallel.build_optimizer``:

    (clip state, (ScaleByAdamState(count, mu, nu)[, adamw's EmptyState],
                  EmptyState | ScaleByScheduleState(count)))

where the clip state is an ``EmptyState`` but for ``max_norm`` and
``momentum_norm``, whose ``_EMAState(ema, step, last_norm)`` holds one
scalar EMA (``max_norm``) or one a parameter in the params tree's layout
(``momentum_norm``); a schedule (warm-up or decay) replaces the last
``EmptyState``. Counts and steps are int32, the rest float32; the moments
take the flax layouts, as the parameters do. An empty state is an empty
tuple here, and both are an empty map on disk.
"""
from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch

from ..utils.transfer import to_host


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _port_leaf(path: tuple, value: np.ndarray):
    *mods, leaf = path
    if leaf == "kernel":
        name = "weight"
        value = value.T if value.ndim == 2 else value.transpose(3, 2, 0, 1)
    elif leaf in ("scale", "embedding"):
        name = "weight"
    else:
        name = leaf
    return ".".join([*mods, name]), value


def params_from_flax(params: Mapping, model: torch.nn.Module = None) -> Dict[str, torch.Tensor]:
    """Convert a flax params tree (numpy leaves; a top-level ``{"params":
    ...}`` wrapper is accepted) into a ``state_dict`` for ``model``. Raises
    unless every flax leaf is used exactly once and, when ``model`` is
    given, every port parameter is filled with a leaf of its shape."""
    if set(params) == {"params"}:
        params = params["params"]
    state: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params).items():
        key, value = _port_leaf(path, value)
        if key in state:
            raise ValueError(f"two flax leaves map to {key}")
        state[key] = torch.from_numpy(np.array(value, dtype=np.float32))
    if model is not None:
        want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        shards = _shards(model)
        want.update(zip(shards.names, shards.shapes))
        missing = sorted(set(want) - set(state))
        unused = sorted(set(state) - set(want))
        wrong = sorted(k for k in set(want) & set(state) if tuple(state[k].shape) != want[k])
        if missing or unused or wrong:
            raise ValueError(
                f"flax params do not fit the port: missing {missing[:8]}, unused {unused[:8]}, "
                f"shape mismatch {[(k, tuple(state[k].shape), want[k]) for k in wrong[:8]]}")
    return state


def _shards(model):
    from ..parallel.spmd import param_shards

    return param_shards(model)


@torch.no_grad()
def load_params(model: torch.nn.Module, state: Mapping[str, torch.Tensor]) -> None:
    """Every parameter of ``model`` from the whole tensors in ``state``
    (keyed by parameter name): each keeps its block of them."""
    shards = _shards(model)
    missing = sorted(set(shards.names) - set(state))
    if missing:
        raise ValueError(f"state lacks {missing[:8]}")
    for i, (name, p) in enumerate(zip(shards.names, shards.params)):
        p.copy_(shards.local(i, state[name].to(p.device)))


def flax_layout(model: torch.nn.Module, name: str):
    """(flax path, dim permutation) of parameter ``name`` of ``model``: the
    flax array is the torch tensor's ``permute(perm)`` (flax dim k is torch
    dim ``perm[k]``)."""
    *mods, leaf = name.split(".")
    owner = model.get_submodule(".".join(mods))
    if leaf == "weight":
        if isinstance(owner, torch.nn.Linear):
            return (*mods, "kernel"), (1, 0)
        if isinstance(owner, torch.nn.Conv2d):
            return (*mods, "kernel"), (2, 3, 1, 0)
        if isinstance(owner, torch.nn.LayerNorm):
            return (*mods, "scale"), None
        if isinstance(owner, torch.nn.Embedding):
            return (*mods, "embedding"), None
        raise ValueError(f"no flax leaf for {name} ({type(owner).__name__})")
    return (*mods, leaf), None


def _flax_leaf(model: torch.nn.Module, name: str):
    """(flax path, function of the torch tensor giving the flax array) of
    parameter ``name`` of ``model``."""
    path, perm = flax_layout(model, name)
    if perm is None:
        return path, lambda t: t
    return path, lambda t: t.permute(perm)


def flax_names(model: torch.nn.Module) -> Dict[str, str]:
    """Each parameter's flax tree path, as ``jax.tree_util`` names it under
    the ``params`` collection: ``params/encoder/.../kernel``."""
    return {name: "/".join(("params",) + _flax_leaf(model, name)[0])
            for name, _ in model.named_parameters()}


def params_to_flax(model: torch.nn.Module, tensors: Mapping[str, torch.Tensor] = None) -> dict:
    """The inverse of :func:`params_from_flax`: ``{"params": nested dict of
    numpy arrays}`` in flax layouts, from ``model``'s parameters or from
    ``tensors`` keyed like them (gradients, optimizer moments). Every leaf
    is put in its flax layout where it lies, and the lot comes to the host
    in one transfer (``to_host``: numpy views of one packed copy). The
    model's parameters are gathered whole (where its placement splits a
    leaf, every rank calls); ``tensors`` are whole already."""
    if tensors is None:
        shards = _shards(model)
        tensors = dict(zip(shards.names, shards.whole(shards.params)))
    tree: dict = {}
    with torch.no_grad():
        for name, t in tensors.items():
            path, to_flax = _flax_leaf(model, name)
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = to_flax(t.detach().float())
    return {"params": to_host(tree)}


def policy_params_from_flax(params: Mapping, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A learner's flax tree (policy and value towers) as a ``state_dict``
    for a policy-only ``model`` (``use_value_network = False``, as actors
    run it): the value towers' top-level subtrees are dropped where
    ``model`` has none, and the rest must fit exactly (``params_from_flax``:
    every parameter filled, no other leaf left over)."""
    if set(params) == {"params"}:
        params = params["params"]
    mine = {k.split(".")[0] for k in model.state_dict()}
    return params_from_flax({k: v for k, v in params.items()
                             if k in mine or not k.startswith("value_")}, model)


def frozen_model(cfg, path: str, device) -> torch.nn.Module:
    """A ``Model`` of ``cfg`` on ``device`` holding the weights of the
    checkpoint at ``path`` (either package's layout; a learner's value
    towers dropped where ``cfg`` has none), its parameters frozen: a league
    opponent or an arena player."""
    from ..utils.checkpoint import load_params
    from .core import Model

    model = Model(cfg)
    model.load_state_dict(policy_params_from_flax(load_params(path), model))
    return model.to(device).requires_grad_(False)


def _nest(leaves: Dict[str, np.ndarray]) -> dict:
    """``{"params/a/b": x}`` -> ``{"params": {"a": {"b": x}}}``."""
    out: dict = {}
    for path, value in leaves.items():
        *mods, leaf = path.split("/")
        node = out
        for k in mods:
            node = node.setdefault(k, {})
        node[leaf] = value
    return out


def _seq(node) -> list:
    """A tuple, list or ``{"__seq_<i>": ...}`` map (a tuple as stored) as a list."""
    if isinstance(node, dict):
        return [node[f"__seq_{i}"] for i in range(len(node))]
    return list(node)


def _param_names(model: torch.nn.Module, optimizer) -> List[str]:
    """The model's parameter names in ``optimizer.params`` order."""
    by_id = {id(p): n for n, p in model.named_parameters()}
    names = [by_id.get(id(p)) for p in optimizer.params]
    if None in names or len(names) != len(by_id):
        raise ValueError("the optimizer's parameters are not the model's")
    return names


def _ema_kind(optimizer) -> str:
    kind = optimizer.clip.cfg.type or "none"
    return kind if kind in ("max_norm", "momentum_norm") else ""


def learner_state_to_flax(model: torch.nn.Module, optimizer, trees=None) -> dict:
    """``{"params", "opt_state"}`` of a port learner (its ``model`` and
    ``parallel.Optimizer``) as the JAX learner of the same optimizer config
    holds it, in numpy copies: what a checkpoint of either package stores.
    ``trees`` gives the (params, mu, nu) flax trees to place in it instead
    (the sharded snapshot's blocks); by default every tree is whole (a
    model placed on a mesh gathers them: every rank must call)."""
    names = _param_names(model, optimizer)
    count = np.array(optimizer.count, np.int32)
    shards = _shards(model)

    def moments(tensors):
        return params_to_flax(model, dict(zip(names, shards.whole(tensors))))

    if trees is None:
        trees = (params_to_flax(model), moments(optimizer.mu), moments(optimizer.nu))
    params, mu_tree, nu_tree = trees
    inner = [(count, mu_tree, nu_tree)]
    if optimizer.weight_decay > 0.0:
        inner.append(())
    inner.append((count,) if optimizer.warmup_steps > 0 or optimizer.decay_boundaries else ())
    clip, kind = optimizer.clip, _ema_kind(optimizer)
    clip_state = ()
    if kind:
        n = 1 if kind == "max_norm" else len(names)
        ema = np.zeros(n, np.float32) if clip.ema is None else (
            clip.ema.detach().float().cpu().numpy().reshape(n))
        if kind == "max_norm":
            ema = np.array(ema[0])
        else:
            flax = flax_names(model)
            ema = _nest({flax[name]: np.array(e) for name, e in zip(names, ema)})
        last = 0.0 if clip.last_norm is None else float(clip.last_norm)
        clip_state = (ema, np.array(clip.step, np.int32), np.array(last, np.float32))
    return {"params": params, "opt_state": (clip_state, tuple(inner))}


@torch.no_grad()
def load_learner_state(state: Mapping, model: torch.nn.Module, optimizer) -> None:
    """Load ``{"params", "opt_state"}`` in the layout of
    ``learner_state_to_flax`` (as stored, or restored into that function's
    tree by ``utils.checkpoint.load_checkpoint(..., target=)``) into
    ``model`` and ``optimizer``, in place."""
    names = _param_names(model, optimizer)
    load_params(model, params_from_flax(state["params"], model))
    clip_state, inner = _seq(state["opt_state"])
    count, mu, nu = _seq(_seq(inner)[0])
    shards = _shards(model)
    optimizer.load_moments(*([shards.block(name, loaded[name]) for name in names]
                             for loaded in (params_from_flax(mu, model), params_from_flax(nu, model))))
    optimizer.count = int(np.asarray(count))
    kind, clip = _ema_kind(optimizer), optimizer.clip
    if kind:
        ema, step, last = _seq(clip_state)
        device = optimizer.params[0].device
        if kind == "max_norm":
            clip.ema = torch.tensor(float(np.asarray(ema)), device=device)
        else:
            flat = {"/".join(k): v for k, v in _flatten(ema).items()}
            flax = flax_names(model)
            clip.ema = torch.tensor([float(flat[flax[n]]) for n in names], device=device)
        clip.step = int(np.asarray(step))
        clip.last_norm = torch.tensor(float(np.asarray(last)), device=device)

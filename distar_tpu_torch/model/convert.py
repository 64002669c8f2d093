"""Weight bridge between the JAX package's flax ``params`` tree and a port
``state_dict``, both ways (``params_from_flax``, ``params_to_flax``).

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
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


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
        missing = sorted(set(want) - set(state))
        unused = sorted(set(state) - set(want))
        wrong = sorted(k for k in set(want) & set(state) if tuple(state[k].shape) != want[k])
        if missing or unused or wrong:
            raise ValueError(
                f"flax params do not fit the port: missing {missing[:8]}, unused {unused[:8]}, "
                f"shape mismatch {[(k, tuple(state[k].shape), want[k]) for k in wrong[:8]]}")
    return state


def _flax_leaf(model: torch.nn.Module, name: str):
    """(flax path, function of the torch tensor giving the flax array) of
    parameter ``name`` of ``model``."""
    *mods, leaf = name.split(".")
    owner = model.get_submodule(".".join(mods))
    if leaf == "weight":
        if isinstance(owner, torch.nn.Linear):
            return (*mods, "kernel"), lambda t: t.T
        if isinstance(owner, torch.nn.Conv2d):
            return (*mods, "kernel"), lambda t: t.permute(2, 3, 1, 0)
        if isinstance(owner, torch.nn.LayerNorm):
            return (*mods, "scale"), lambda t: t
        if isinstance(owner, torch.nn.Embedding):
            return (*mods, "embedding"), lambda t: t
        raise ValueError(f"no flax leaf for {name} ({type(owner).__name__})")
    return (*mods, leaf), lambda t: t


def flax_names(model: torch.nn.Module) -> Dict[str, str]:
    """Each parameter's flax tree path, as ``jax.tree_util`` names it under
    the ``params`` collection: ``params/encoder/.../kernel``."""
    return {name: "/".join(("params",) + _flax_leaf(model, name)[0])
            for name, _ in model.named_parameters()}


def params_to_flax(model: torch.nn.Module, tensors: Mapping[str, torch.Tensor] = None) -> dict:
    """The inverse of :func:`params_from_flax`: ``{"params": nested dict of
    numpy arrays}`` in flax layouts, from ``model``'s parameters or from
    ``tensors`` keyed like them (gradients, optimizer moments)."""
    tensors = dict(model.named_parameters()) if tensors is None else tensors
    out: dict = {}
    for name, t in tensors.items():
        path, to_flax = _flax_leaf(model, name)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.array(to_flax(t.detach().float().cpu()).numpy(), order="C")  # a copy
    return {"params": out}

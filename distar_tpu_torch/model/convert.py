"""Weight bridge: the JAX package's flax ``params`` tree -> a port ``state_dict``.

The port's modules carry flax's names, so a leaf at ``a/b/Dense_0/kernel``
lands at ``a.b.Dense_0.weight``. Layouts change on the way:

* Dense ``kernel[in, out]``    -> Linear ``weight[out, in]``
* Conv ``kernel[H, W, I, O]``  -> Conv2d ``weight[O, I, H, W]``
* Embed ``embedding[n, d]``    -> Embedding ``weight[n, d]``
* LayerNorm ``scale``          -> LayerNorm ``weight``
* bare params (``update_sp``, ``end_embedding``, ...) keep their names.

No fc rows are permuted: the port flattens (spatial fc) and reshapes
(location projection) maps in the JAX package's NHWC order.
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

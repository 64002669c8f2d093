"""Gradient clipping modes, as the first link of the optimizer chain.

Counterpart of ``distar_tpu.parallel.grad_clip``:

* ``none``          — no clipping.
* ``value``         — each element clamped to [-threshold, threshold].
* ``norm``          — optax's ``clip_by_global_norm``: when the global L2
                      norm g exceeds the threshold, every element becomes
                      (x / g) * threshold (no epsilon, so this is not
                      ``torch.nn.utils.clip_grad_norm_``).
* ``max_norm``      — clip to threshold x an EMA of recent global norms
                      (the hard threshold for the first ``begin_step``
                      updates), scale min(1, limit / (g + 1e-6)).
* ``momentum_norm`` — the same per parameter, against an EMA of that
                      parameter's norms.

Gradients are lists of tensors, clipped in place; the EMA state lives on
the gradients' device, so clipping never waits for the card. Where the
gradients are blocks of split leaves (``parallel.spmd``), ``norms`` gives
each whole leaf's norm from them (``ParamShards.leaf_norms``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional

import torch

CLIP_TYPES = ("none", "value", "norm", "max_norm", "momentum_norm")


@dataclasses.dataclass(frozen=True)
class GradClipConfig:
    type: str = "none"  # none | value | norm | max_norm | momentum_norm
    threshold: float = 1.0
    norm_type: int = 2
    momentum: float = 0.999
    begin_step: int = 100  # steps before the EMA is trusted (max_norm, momentum_norm)


def tensor_norms(tensors: List[torch.Tensor]) -> torch.Tensor:
    """The L2 norm of each tensor, stacked."""
    return torch.stack(torch._foreach_norm(tensors))


def global_norm(tensors: List[torch.Tensor], norms: Callable = tensor_norms) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``),
    from each leaf's norm as ``norms`` reads it."""
    return torch.linalg.vector_norm(norms(tensors))


class GradClip:
    """One clip mode with its state; ``clip(grads)`` clips in place.
    ``norms`` reads each leaf's norm (default: of the tensor as it is)."""

    def __init__(self, cfg: GradClipConfig = GradClipConfig(), norms: Optional[Callable] = None):
        if (cfg.type or "none") not in CLIP_TYPES:
            raise NotImplementedError(cfg.type)
        self.cfg = cfg
        self.norms = norms or tensor_norms
        self.step = 0
        self.ema = None  # [] for max_norm, [leaves] for momentum_norm
        # optax's _EMAState.last_norm: the global norm before (max_norm) or
        # after (momentum_norm) clipping; kept for the checkpoint only
        self.last_norm = None

    @torch.no_grad()
    def clip(self, grads: List[torch.Tensor]) -> None:
        cfg = self.cfg
        t = cfg.threshold
        kind = cfg.type or "none"
        if kind == "none":
            return
        if kind == "value":
            torch._foreach_clamp_min_(grads, -t)
            torch._foreach_clamp_max_(grads, t)
            return
        if kind == "norm":
            g = self.global_norm(grads)
            keep = g < t
            torch._foreach_div_(grads, torch.where(keep, torch.ones_like(g), g))
            torch._foreach_mul_(grads, torch.where(keep, torch.ones_like(g), torch.full_like(g, t)))
            return
        if kind == "max_norm":
            norm = self.global_norm(grads)
        else:
            norm = self.norms(grads)
        m = cfg.momentum
        self.ema = norm if self.step == 0 else m * self.ema + (1 - m) * norm
        limit = t if self.step < cfg.begin_step else t * self.ema
        scale = (limit / (norm + 1e-6)).clamp(max=1.0)
        if kind == "max_norm":
            torch._foreach_mul_(grads, scale)
            self.last_norm = norm
        else:
            for g, s in zip(grads, scale.unbind()):
                g.mul_(s)
            self.last_norm = self.global_norm(grads)
        self.step += 1

    def global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global L2 norm of ``grads`` (of the whole leaves)."""
        return global_norm(grads, self.norms)


def clipped_count(grads: List[torch.Tensor], threshold: float) -> torch.Tensor:
    """The number of gradient elements with ``|g| > threshold``, as a
    one-element float32 tensor on the gradients' device (summed over the
    ranks that hold blocks of the gradients, it is the whole count)."""
    clipped = torch.zeros(1, dtype=torch.float32, device=grads[0].device)
    for g in grads:
        clipped = clipped + (g.float().abs() > threshold).sum().float()
    return clipped


def clip_activation(global_norm: torch.Tensor, clip_type: str, threshold: float,
                    clipped: torch.Tensor = None, total: int = 0):
    """How much of the gradient signal the configured clip removes this
    step, for the training-dynamics tree, as ``(fraction, active)`` 0-d
    float32 tensors on the gradients' device (no host sync):

      * ``norm``  — the fraction of the global L2 norm removed,
        ``max(0, 1 - threshold/||g||)``; active when ``||g|| > threshold``;
      * ``value`` — the fraction of the ``total`` gradient elements with
        ``|g| > threshold`` (``clipped``: ``clipped_count`` of the raw
        gradients, before the clip); active when any element is clipped;
      * otherwise zeros (the EMA modes keep their limit in the optimizer
        state, as in the JAX package, and report no guess)."""
    zero = torch.zeros((), dtype=torch.float32, device=global_norm.device)
    if clip_type == "norm":
        gn = global_norm.float()
        frac = (1.0 - threshold / gn.clamp(min=1e-12)).clamp(min=0.0)
        return frac, (gn > threshold).float()
    if clip_type == "value":
        n = clipped.reshape(())
        return n / max(float(total), 1.0), (n > 0).float()
    return zero, zero.clone()


def leaf_norms(named: Mapping[str, torch.Tensor], prefix: str,
               norms: Callable = tensor_norms) -> Dict[str, torch.Tensor]:
    """``{prefix/name: L2 norm}`` per tensor, for ``save_grad`` logging. The
    learner passes the JAX package's tree paths as names
    (``model.convert.flax_names``), so the keys are the JAX learner's."""
    names = list(named)
    return {f"{prefix}/{k}": n for k, n in zip(names, norms([named[k].float() for k in names]).unbind())}

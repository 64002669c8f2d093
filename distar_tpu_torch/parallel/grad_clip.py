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
the gradients' device, so clipping never waits for the card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping

import torch

CLIP_TYPES = ("none", "value", "norm", "max_norm", "momentum_norm")


@dataclasses.dataclass(frozen=True)
class GradClipConfig:
    type: str = "none"  # none | value | norm | max_norm | momentum_norm
    threshold: float = 1.0
    norm_type: int = 2
    momentum: float = 0.999
    begin_step: int = 100  # steps before the EMA is trusted (max_norm, momentum_norm)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class GradClip:
    """One clip mode with its state; ``clip(grads)`` clips in place."""

    def __init__(self, cfg: GradClipConfig = GradClipConfig()):
        if (cfg.type or "none") not in CLIP_TYPES:
            raise NotImplementedError(cfg.type)
        self.cfg = cfg
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
            g = global_norm(grads)
            keep = g < t
            torch._foreach_div_(grads, torch.where(keep, torch.ones_like(g), g))
            torch._foreach_mul_(grads, torch.where(keep, torch.ones_like(g), torch.full_like(g, t)))
            return
        if kind == "max_norm":
            norm = global_norm(grads)
        else:
            norm = torch.stack(torch._foreach_norm(grads))
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
            self.last_norm = global_norm(grads)
        self.step += 1


def clip_activation(grads: List[torch.Tensor], global_norm: torch.Tensor, clip_type: str,
                    threshold: float):
    """How much of the gradient signal the configured clip removes this
    step, for the training-dynamics tree, as ``(fraction, active)`` 0-d
    float32 tensors on the gradients' device (no host sync):

      * ``norm``  — the fraction of the global L2 norm removed,
        ``max(0, 1 - threshold/||g||)``; active when ``||g|| > threshold``;
      * ``value`` — the fraction of gradient elements with ``|g| >
        threshold``; active when any element is clipped;
      * otherwise zeros (the EMA modes keep their limit in the optimizer
        state, as in the JAX package, and report no guess).

    ``grads`` are the raw gradients (before the clip)."""
    zero = torch.zeros((), dtype=torch.float32, device=global_norm.device)
    if clip_type == "norm":
        gn = global_norm.float()
        frac = (1.0 - threshold / gn.clamp(min=1e-12)).clamp(min=0.0)
        return frac, (gn > threshold).float()
    if clip_type == "value":
        clipped = zero
        total = 0
        for g in grads:
            clipped = clipped + (g.float().abs() > threshold).sum().float()
            total += g.numel()
        return clipped / max(float(total), 1.0), (clipped > 0).float()
    return zero, zero.clone()


def leaf_norms(named: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """``{prefix/name: L2 norm}`` per tensor, for ``save_grad`` logging. The
    learner passes the JAX package's tree paths as names
    (``model.convert.flax_names``), so the keys are the JAX learner's."""
    names = list(named)
    norms = torch._foreach_norm([named[k].float() for k in names])
    return {f"{prefix}/{k}": n for k, n in zip(names, norms)}

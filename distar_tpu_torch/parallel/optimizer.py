"""The optimizer chain: clip -> adam or adamw -> learning-rate schedule.

Counterpart of ``distar_tpu.parallel.optimizer.build_optimizer`` (an optax
chain), written as a plain update on lists of tensors with ``torch._foreach``
ops (a few launches for all parameters, not a few per parameter). The
update is optax's, in its order:

    mu  = b1 mu + (1 - b1) g               nu = b2 nu + (1 - b2) g^2
    u   = (mu / (1 - b1^n)) / (sqrt(nu / (1 - b2^n)) + eps)   n = updates so far
    u  += weight_decay * p                 (adamw: every parameter, from the pre-step p)
    p  -= lr(count) * u                    count = n - 1: the first update reads count 0

The schedule is optax's: piecewise-constant decay (x decay_rate from each
boundary on) and, with ``warmup_steps``, a linear warm-up from 0 joined in
front of it (the decay then counts from the end of the warm-up), so the
first update of a warm-up moves nothing.

On a mesh that splits parameters (``spmd.shard_model``) the parameters,
and so the gradients, mu, nu and the update, are this rank's blocks: the
update is elementwise, and the clip reads its norms from the blocks
(``norms``: ``ParamShards.leaf_norms``), so the global norm is the
single-process one.
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

import torch

from .grad_clip import GradClip, GradClipConfig


class Optimizer:
    """The chain's state for a fixed list of parameters; ``step(grads)``
    clips ``grads`` in place, updates the parameters in place and returns
    the update it applied. adamw when
    ``weight_decay`` > 0, else adam; defaults as the JAX package's
    ``build_optimizer`` (the RL learner's Adam, betas (0, 0.99), eps 1e-5)."""

    def __init__(self, params: Iterable[torch.Tensor], learning_rate: float = 1e-5,
                 betas: Tuple[float, float] = (0.0, 0.99), eps: float = 1e-5,
                 weight_decay: float = 0.0, clip: Optional[GradClipConfig] = None,
                 warmup_steps: int = 0, decay_boundaries: Sequence[int] = (),
                 decay_rate: float = 1.0, norms=None):
        self.params = list(params)
        self.learning_rate, self.b1, self.b2 = float(learning_rate), float(betas[0]), float(betas[1])
        self.eps, self.weight_decay = float(eps), float(weight_decay)
        self.warmup_steps = int(warmup_steps)
        self.decay_boundaries = sorted({int(b) for b in decay_boundaries})
        self.decay_rate = float(decay_rate)
        self.clip = GradClip(clip or GradClipConfig(), norms=norms)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def load_moments(self, mu, nu) -> None:
        """Set mu and nu, each shaped as the parameters."""
        for dst, src in ((self.mu, mu), (self.nu, nu)):
            for t, v in zip(dst, src):
                t.copy_(v)

    def lr(self, count: int) -> float:
        """The schedule's learning rate at update ``count`` (from 0)."""
        if self.warmup_steps > 0 and count < self.warmup_steps:
            return self.learning_rate * count / self.warmup_steps
        c = count - self.warmup_steps if self.warmup_steps > 0 else count
        return self.learning_rate * self.decay_rate ** sum(c >= b for b in self.decay_boundaries)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]):
        """One update; returns ``(update, lr)``: the parameters moved by
        ``-lr * update`` (what optax's updates are, over ``-lr``), for the
        training-dynamics tree's update norms."""
        grads, params = list(grads), self.params
        self.clip.clip(grads)
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)
        n = self.count + 1
        denom = torch._foreach_div(self.nu, 1 - b2 ** n)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(self.mu, 1 - b1 ** n)
        torch._foreach_div_(update, denom)
        if self.weight_decay > 0.0:
            torch._foreach_add_(update, params, alpha=self.weight_decay)
        lr = self.lr(self.count)
        torch._foreach_add_(params, update, alpha=-lr)
        self.count = n
        return update, lr


build_optimizer = Optimizer

"""RL return and advantage primitives as plain tensor functions.

Counterparts of ``distar_tpu.ops.rl``. Time-major: rewards [T, ...] and
bootstrap values [T+1, ...]; every other axis broadcasts, so stacked
(field, head) pairs run as one recursion. Each reverse ``lax.scan`` of the
JAX package is a loop over reversed T with the same arithmetic per element,
in the same order (the factors that do not depend on the carry are formed
for every step at once).
"""
from __future__ import annotations

from typing import Union

import torch

Scalar = Union[float, torch.Tensor]


def _as_tb(x: Scalar, like: torch.Tensor) -> torch.Tensor:
    if not isinstance(x, torch.Tensor) or x.dim() == 0:
        return x * torch.ones_like(like)
    return x


def multistep_forward_view(
    rewards: torch.Tensor,  # [T, ...]
    gammas: torch.Tensor,  # [T, ...]
    bootstrap_values: torch.Tensor,  # [T, ...] = V[1..T]
    lambda_: torch.Tensor,  # [T, ...]
) -> torch.Tensor:
    """Sutton & Barto (12.18) lambda-return recursion:
    result[T-1] = r[T-1] + g[T-1] V[T];
    result[t] = r[t] + g[t] (l[t] result[t+1] + (1-l[t]) V[t+1])."""
    shape = torch.broadcast_shapes(rewards.shape, gammas.shape, bootstrap_values.shape, lambda_.shape)
    rewards, gammas, bootstrap_values, lambda_ = (
        t.expand(shape) for t in (rewards, gammas, bootstrap_values, lambda_))
    discounts = gammas * lambda_
    carry = rewards[-1] + gammas[-1] * bootstrap_values[-1]
    rest = (gammas - discounts) * bootstrap_values  # the (g - d) v term of every step
    out = [carry]
    for t in range(shape[0] - 2, -1, -1):
        carry = rewards[t] + discounts[t] * carry + rest[t]
        out.append(carry)
    return torch.stack(out[::-1])


def generalized_lambda_returns(
    rewards: torch.Tensor,  # [T, ...]
    gammas: Scalar,
    bootstrap_values: torch.Tensor,  # [T+1, ...]
    lambda_: Scalar,
) -> torch.Tensor:
    gammas = _as_tb(gammas, rewards)
    lambda_ = _as_tb(lambda_, rewards)
    return multistep_forward_view(rewards, gammas, bootstrap_values[1:], lambda_)


def td_lambda_loss(
    values: torch.Tensor,  # [T+1, B]
    rewards: torch.Tensor,  # [T, B]
    gamma: Scalar = 1.0,
    lambda_: Scalar = 0.8,
    mask: torch.Tensor = None,  # [T, B] optional
) -> torch.Tensor:
    """0.5 * (G_lambda - V)^2 with the targets detached, mean-reduced."""
    returns = generalized_lambda_returns(rewards, gamma, values.detach(), lambda_)
    loss = 0.5 * torch.square(returns - values[:-1])
    if mask is not None:
        loss = loss * mask
    return loss.mean()


def upgo_returns(rewards: torch.Tensor, bootstrap_values: torch.Tensor) -> torch.Tensor:
    """UPGO targets: lambda-returns where the trace continues (lambda=1)
    iff r_{t+1} + V_{t+2} >= V_{t+1} (shifted as in the reference)."""
    lambdas = (rewards + bootstrap_values[1:]) >= bootstrap_values[:-1]
    lambdas = torch.cat([lambdas[1:], torch.ones_like(lambdas[-1:])], dim=0)
    return generalized_lambda_returns(rewards, 1.0, bootstrap_values, lambdas.to(rewards.dtype))


def vtrace_advantages(
    clipped_rhos: torch.Tensor,  # [T, ...]
    clipped_cs: torch.Tensor,  # [T, ...]
    rewards: torch.Tensor,  # [T, ...]
    bootstrap_values: torch.Tensor,  # [T+1, ...]
    clipped_pg_rhos: torch.Tensor = None,
    gammas: Scalar = 1.0,
    lambda_: Scalar = 0.8,
) -> torch.Tensor:
    """IMPALA V-trace advantages (Espeholt et al. 2018), lambda-weighted as
    in the reference: vs_t = V_t + delta_t + g l c_t (vs_{t+1} - V_{t+1});
    adv = pg_rho * (r + g vs_{t+1} - V_t)."""
    gammas = _as_tb(gammas, rewards)
    lambda_ = _as_tb(lambda_, rewards)
    deltas = clipped_rhos * (rewards + gammas * bootstrap_values[1:] - bootstrap_values[:-1])
    shape = torch.broadcast_shapes(deltas.shape, gammas.shape, lambda_.shape, clipped_cs.shape)
    deltas = deltas.expand(shape)
    factor = (gammas * lambda_ * clipped_cs).expand(shape)  # g l c of every step
    carry = torch.zeros(shape[1:], dtype=deltas.dtype, device=deltas.device)  # vs_{t+1} - V_{t+1}
    diffs = []
    for t in range(shape[0] - 1, -1, -1):
        carry = deltas[t] + factor[t] * carry
        diffs.append(carry)
    vs = bootstrap_values[:-1] + torch.stack(diffs[::-1])  # [T, ...]
    vs_tp1 = torch.cat([vs[1:], bootstrap_values[-1:].expand_as(vs[:1])], dim=0)
    if clipped_pg_rhos is None:
        clipped_pg_rhos = clipped_rhos
    return clipped_pg_rhos * (rewards + gammas * vs_tp1 - bootstrap_values[:-1])

"""Actor-learner distillation loss: masked per-head KL against the teacher.

Counterpart of ``distar_tpu.losses.distill_loss``: the forward KL
``KL(teacher || student)`` of every action head, with the RL loss's KL
masks (``selected_units`` summed over the S axis under
``selected_units_mask``; heads outside ``ALWAYS_ON`` gated on
``actions_mask[head]``; every head times ``step_mask``). Input layout
(time-major, the RL batch's own shapes):

  student_logit[head]   [T, B, ...]
  teacher_logit[head]   [T, B, ...]
  mask:
    actions_mask[head]  [T, B]
    selected_units_mask [T, B, S]
    step_mask           [T, B]   (optional; 1 real / 0 pad)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .rl_loss import ALWAYS_ON, HEADS, _default_head_weights


@dataclasses.dataclass(frozen=True)
class DistillLossConfig:
    """Head weights as the RL loss's; ``temperature`` softens both
    distributions, and the KL is taken at that temperature."""

    temperature: float = 1.0
    selected_units_head_weight: float = 0.01

    def head_weights(self) -> Dict[str, float]:
        return _default_head_weights(self.selected_units_head_weight)


def compute_distill_loss(
    inputs: Dict,
    cfg: DistillLossConfig = DistillLossConfig(),
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, info): the weighted masked KL summed over heads. ``info`` has
    ``kl/<head>`` (per-head means), the weighted ``kl/total``,
    ``divergence`` (the unweighted sum of the head means) and
    ``total_loss``."""
    student = inputs["student_logit"]
    teacher = inputs["teacher_logit"]
    masks = inputs["mask"]
    su_mask = masks["selected_units_mask"]
    tau = cfg.temperature

    step_mask = masks.get("step_mask")
    if step_mask is None:
        step_mask = torch.ones(student["action_type"].shape[:2], device=su_mask.device)
    else:
        step_mask = step_mask.float()

    info: Dict[str, torch.Tensor] = {}
    head_w = cfg.head_weights()
    total = 0.0
    divergence = 0.0
    for head in HEADS:
        t_logp = F.log_softmax(teacher[head] / tau, dim=-1)
        s_logp = F.log_softmax(student[head] / tau, dim=-1)
        kl = (torch.exp(t_logp) * (t_logp - s_logp)).sum(-1)
        if head == "selected_units":
            kl = (kl * su_mask).sum(-1)
        kl = kl * step_mask
        if head not in ALWAYS_ON:
            kl = kl * masks["actions_mask"][head]
        kl_mean = kl.mean()
        info[f"kl/{head}"] = kl_mean
        total = total + kl_mean * head_w[head]
        divergence = divergence + kl_mean
    info["kl/total"] = total
    info["divergence"] = divergence
    info["total_loss"] = total
    return total, info

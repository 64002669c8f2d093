"""Supervised (behaviour-cloning) loss: per-head cross entropy and metrics.

Counterpart of ``distar_tpu.losses.sl_loss``: per-head CE with optional
label smoothing and per-head applicability masks; the selected-units
candidate mask (at step i every *other* ground-truth unit leaves the
softmax, so the order of a selection is not penalised; end-flag steps use a
dummy class that masks nothing); the end-flag loss; and the metric grid
(action_type_acc, delay L1, queued acc, selected-units IoU, target_unit acc,
location L2). Default weights as ``default_supervised_loss.yaml``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops import sequence_mask

NEG_INF = -1e9

# every non-loss scalar the SL info dict holds
SL_METRIC_KEYS = (
    "action_type_acc",
    "delay_distance_L1",
    "queued_acc",
    "target_unit_acc",
    "target_location_distance_L2",
    "selected_units_iou",
    "selected_units_loss_norm",
    "selected_units_end_flag_loss",
)


@dataclasses.dataclass(frozen=True)
class SupervisedLossConfig:
    action_type: float = 30.0
    delay: float = 9.0
    queued: float = 1.0
    selected_units: float = 4.0
    target_unit: float = 4.0
    target_location: float = 8.0
    label_smooth: float = 0.0  # 0.1 in the reference when label_smooth: True
    su_candidate_mask: bool = True
    spatial_x: int = 160

    def weights(self) -> Dict[str, float]:
        return {
            "action_type": self.action_type,
            "delay": self.delay,
            "queued": self.queued,
            "selected_units": self.selected_units,
            "target_unit": self.target_unit,
            "target_location": self.target_location,
        }


def _ce(logits, labels, smoothing: float = 0.0):
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[..., None].long())[..., 0]
    if smoothing > 0.0:
        return (1.0 - smoothing) * nll + smoothing * -logp.mean(dim=-1)
    return nll


def _masked_mean(x, mask):
    valid = mask.sum()
    return torch.where(valid > 0, (x * mask).sum() / valid.clamp_min(1), torch.zeros_like(valid))


def _one_hot(labels, n: int):
    """[..., n] float one-hot; labels outside [0, n) give a zero row (as
    ``jax.nn.one_hot``)."""
    return (labels[..., None] == torch.arange(n, device=labels.device)).float()


def compute_sl_loss(
    logits: Dict[str, torch.Tensor],
    actions: Dict[str, torch.Tensor],
    action_masks: Dict[str, torch.Tensor],
    selected_units_num: torch.Tensor,  # [B]
    entity_num: torch.Tensor,  # [B]
    cfg: SupervisedLossConfig = SupervisedLossConfig(),
    infer_selected_units: Optional[torch.Tensor] = None,  # [B, S] sampled, for IoU
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The weighted total loss and the info dict (losses and metrics, 0-d
    tensors detached from the graph)."""
    info: Dict[str, torch.Tensor] = {}
    w = cfg.weights()
    total = 0.0

    # ------------------------------------------------------------ flat heads
    for head in ("action_type", "delay", "queued", "target_unit", "target_location"):
        lab = actions[head].long()
        mask = action_masks[head].float()
        loss = _masked_mean(_ce(logits[head], lab, cfg.label_smooth), mask)
        info[f"{head}_loss"] = loss
        total = total + loss * w[head]
        pred = logits[head].detach().argmax(-1)
        if head == "action_type":
            info["action_type_acc"] = (pred == lab).float().mean()
        elif head == "delay":
            info["delay_distance_L1"] = _masked_mean((pred - lab).abs().float(), mask)
        elif head == "queued":
            info["queued_acc"] = _masked_mean((pred == lab).float(), mask)
        elif head == "target_unit":
            info["target_unit_acc"] = _masked_mean((pred == lab).float(), mask)
        else:
            W = cfg.spatial_x
            d2 = (pred % W - lab % W) ** 2 + (pred // W - lab // W) ** 2
            info["target_location_distance_L2"] = _masked_mean(d2.float().sqrt(), mask)

    # --------------------------------------------------------- selected units
    su_logits = logits["selected_units"]  # [B, S, N+1]
    B, S, N1 = su_logits.shape
    labels = actions["selected_units"].long()[:, :S]  # [B, S]
    lengths = selected_units_num.long()
    mask = action_masks["selected_units"].float()  # [B]
    len_wo_end = (lengths - 1).clamp_min(0)

    if cfg.su_candidate_mask:
        # at step i every ground-truth unit but the step's own label is
        # masked out; end-flag positions take the dummy class N+1
        eff_labels = torch.where(sequence_mask(len_wo_end, S), labels, N1)
        step_own = _one_hot(eff_labels, N1 + 1)[..., :N1].bool()  # [B, S, N+1]
        labeled_any = step_own.any(dim=1)  # [B, N+1]
        allowed = ~labeled_any[:, None, :] | step_own
        su_logits = su_logits.masked_fill(~allowed, NEG_INF)

    ce = _ce(su_logits, labels)  # [B, S]
    ce = torch.where(sequence_mask(lengths, S), ce, torch.zeros_like(ce)) * mask[:, None]
    su_loss = ce.sum() / B
    info["selected_units_loss"] = su_loss
    info["selected_units_loss_norm"] = ce.sum() / (lengths.sum() + 1e-6)
    end_idx = (lengths - 1).clamp(0, S - 1)
    info["selected_units_end_flag_loss"] = ce.gather(1, end_idx[:, None]).mean()
    total = total + su_loss * w["selected_units"]

    # IoU between the sampled and the labelled unit sets (ignoring order)
    if infer_selected_units is not None:
        preds = infer_selected_units.long()[:, :S]
        # predicted steps up to the first end token
        is_end = preds == entity_num[:, None]
        pred_len = torch.where(is_end.any(dim=1), is_end.int().argmax(dim=1), S)
        pred_mask = sequence_mask(pred_len, S)
        lab_mask = sequence_mask(len_wo_end if cfg.su_candidate_mask else lengths, S)
        pred_bag = (_one_hot(preds, N1) * pred_mask[..., None]).sum(1) > 0
        lab_bag = (_one_hot(labels, N1) * lab_mask[..., None]).sum(1) > 0
        inter = (pred_bag & lab_bag).sum(-1)
        union = (pred_bag | lab_bag).sum(-1)
        info["selected_units_iou"] = _masked_mean(inter / union.clamp_min(1), mask)
    else:
        info["selected_units_iou"] = torch.zeros((), device=su_logits.device)

    info["total_loss"] = total
    return total, {k: v.detach() for k, v in info.items()}

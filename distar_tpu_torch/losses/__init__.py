from .distill_loss import DistillLossConfig, compute_distill_loss
from .rl_loss import (
    HEADS,
    LOSS_TERMS,
    REWARD_FIELDS,
    ReinforcementLossConfig,
    compute_rl_loss,
)
from .sl_loss import SL_METRIC_KEYS, SupervisedLossConfig, compute_sl_loss

__all__ = [
    "DistillLossConfig",
    "HEADS",
    "LOSS_TERMS",
    "REWARD_FIELDS",
    "ReinforcementLossConfig",
    "SL_METRIC_KEYS",
    "SupervisedLossConfig",
    "compute_distill_loss",
    "compute_rl_loss",
    "compute_sl_loss",
]

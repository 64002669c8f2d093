from .sl_loss import SL_METRIC_KEYS, SupervisedLossConfig, compute_sl_loss

__all__ = ["SL_METRIC_KEYS", "SupervisedLossConfig", "compute_sl_loss"]

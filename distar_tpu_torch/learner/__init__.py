from .data import FakeSLDataloader, cap_entities, fake_sl_batch, random_sl_batch
from .sl_learner import SL_LEARNER_DEFAULTS, SLLearner, make_sl_train_step, sl_loss

__all__ = [
    "FakeSLDataloader",
    "SLLearner",
    "SL_LEARNER_DEFAULTS",
    "cap_entities",
    "fake_sl_batch",
    "random_sl_batch",
    "make_sl_train_step",
    "sl_loss",
]

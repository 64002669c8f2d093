from .base_learner import BaseLearner
from .data import (
    RL_REWARD_FIELDS,
    FakeRLDataloader,
    FakeSLDataloader,
    cap_entities,
    cap_entities_rl,
    fake_rl_batch,
    fake_sl_batch,
    random_rl_batch,
    random_sl_batch,
)
from .distill_learner import (
    DISTILL_LEARNER_DEFAULTS,
    DistillLearner,
    distill_loss,
    make_distill_train_step,
)
from .rl_dataloader import CollationError, RLDataLoader, ReplayDataLoader, collate_trajectories
from .rl_learner import RL_LEARNER_DEFAULTS, RLLearner, make_rl_train_step, rl_loss
from .sl_learner import SL_LEARNER_DEFAULTS, SLLearner, make_sl_train_step, sl_loss

__all__ = [
    "BaseLearner",
    "CollationError",
    "DISTILL_LEARNER_DEFAULTS",
    "DistillLearner",
    "FakeRLDataloader",
    "FakeSLDataloader",
    "RLDataLoader",
    "ReplayDataLoader",
    "RLLearner",
    "RL_LEARNER_DEFAULTS",
    "RL_REWARD_FIELDS",
    "SLLearner",
    "SL_LEARNER_DEFAULTS",
    "cap_entities",
    "cap_entities_rl",
    "collate_trajectories",
    "distill_loss",
    "fake_rl_batch",
    "fake_sl_batch",
    "make_distill_train_step",
    "make_rl_train_step",
    "make_sl_train_step",
    "random_rl_batch",
    "random_sl_batch",
    "rl_loss",
    "sl_loss",
]

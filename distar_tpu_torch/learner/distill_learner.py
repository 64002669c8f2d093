"""Actor-learner distillation: the student tier's learner.

Counterpart of ``distar_tpu.learner.distill_learner``: trains the small
student policy (``model.student_model_config``, no value towers) on the RL
learner's own batches, against the teacher logits every batch carries,
through the masked per-head KL of ``losses.distill_loss``. The batch's
``hidden_state`` has the teacher's LSTM dims, so every window trains the
student from a zero state of its own dims, built inside the step.

Not ported yet: the ``distar_distill_*`` gauges and the FLOPs-derived cost
ratio (ROADMAP Queue 1 item 9), and student checkpoints (item 4); each
raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..actor.inference import to_device
from ..losses import DistillLossConfig, compute_distill_loss
from ..model import Model, init_params, student_model_config
from ..parallel.grad_clip import global_norm
from ..utils import deep_merge_dicts
from .base_learner import DEFAULT_LEARNER_CONFIG, BaseLearner, host_scalars
from .data import FakeRLDataloader, cap_entities_rl
from .rl_learner import flatten_time

DISTILL_LEARNER_DEFAULTS = deep_merge_dicts(
    DEFAULT_LEARNER_CONFIG,
    {
        "learner": {
            "player_id": "MP0",
            "batch_size": 4,
            "unroll_len": 16,
            # distillation is supervised: a larger learning rate than the
            # RL learner's 1e-5
            "learning_rate": 1e-3,
            "betas": [0.9, 0.99],
            "eps": 1e-5,
            "grad_clip": {"type": "norm", "threshold": 10.0},
            "max_entities": None,
            # cascades into DistillLossConfig (temperature, head weights)
            "distill": {},
        },
        "model": {},
    },
)

# the RL batch's fields that distillation does not read
_UNUSED_FIELDS = ("hidden_state", "reward", "step", "done", "behaviour_logp", "value_feature",
                  "successive_logit")


def make_distill_loss_config(learner_cfg) -> DistillLossConfig:
    return DistillLossConfig(**dict(learner_cfg.get("distill", {}) or {}))


def distill_loss(model: Model, loss_cfg: DistillLossConfig, batch, batch_size: int,
                 unroll_len: int):
    """(total loss, info) of one RL batch for the student, from a zero
    initial state of the student's own dims (not the batch's)."""
    core = model.cfg["encoder"]["core_lstm"]
    z = torch.zeros(batch_size, core["hidden_size"], device=batch["entity_num"].device)
    out = model.policy_forward(
        flatten_time(batch["spatial_info"]), flatten_time(batch["entity_info"]),
        flatten_time(batch["scalar_info"]), batch["entity_num"].reshape(-1),
        tuple((z, z) for _ in range(core["num_layers"])), batch["action_info"],
        batch["selected_units_num"], batch_size, unroll_len)
    return compute_distill_loss({"student_logit": out["target_logit"],
                                 "teacher_logit": batch["teacher_logit"], "mask": batch["mask"]},
                                loss_cfg)


def make_distill_train_step(model: Model, loss_cfg: DistillLossConfig, optimizer,
                            batch_size: int, unroll_len: int):
    """``train_step(batch) -> info``: the KL loss's info, ``grad_norm``
    (before clipping) and the optimizer's update in place."""
    params = optimizer.params

    def train_step(batch):
        total, info = distill_loss(model, loss_cfg, batch, batch_size, unroll_len)
        grads = list(torch.autograd.grad(total, params, allow_unused=True, materialize_grads=True))
        info = {k: v.detach() for k, v in info.items()}
        info["grad_norm"] = global_norm(grads)
        optimizer.step(grads)
        return info

    return train_step


class DistillLearner(BaseLearner):
    """The student-tier learner on one device (``device=None``: CUDA, or
    raise)."""

    _CAP_FN = staticmethod(cap_entities_rl)

    def __init__(self, cfg: Optional[dict] = None, device=None):
        cfg = deep_merge_dicts(DISTILL_LEARNER_DEFAULTS, cfg or {})
        if cfg.learner.get("teacher_flops_per_step"):
            raise NotImplementedError("learner.teacher_flops_per_step: the step-cost gauge is not "
                                      "ported yet (ROADMAP Queue 1 item 9, obs/perf.py)")
        self.model_cfg = student_model_config(cfg.get("model", {}))
        self.model_cfg.use_value_network = False
        self.loss_cfg = make_distill_loss_config(cfg.learner)
        super().__init__(cfg, device)

    def _setup_dataloader(self) -> None:
        lc, core = self.cfg.learner, self.model_cfg.encoder.core_lstm
        self._dataloader = iter(FakeRLDataloader(lc.batch_size, lc.unroll_len,
                                                 hidden_size=core.hidden_size,
                                                 hidden_layers=core.num_layers))

    def set_dataloader(self, it) -> None:
        self._dataloader = iter(it)

    def _setup_state(self) -> None:
        lc = self.cfg.learner
        self.model = Model(self.model_cfg)
        init_params(self.model, 0)
        self.model.to(self.device).train()
        self.optimizer = self._build_optimizer(self.model.parameters())
        self._train_step = make_distill_train_step(self.model, self.loss_cfg, self.optimizer,
                                                   lc.batch_size, lc.unroll_len)

    def _strip_batch(self, data: Dict) -> Dict:
        """Drop the RL batch's fields that distillation does not read."""
        return {k: v for k, v in data.items() if k not in _UNUSED_FIELDS}

    def _train(self, data) -> Dict[str, Any]:
        data = dict(data)
        for k in ("model_last_iter", "trace_span_ids", "trace_age_s"):
            data.pop(k, None)
        data = self._strip_batch(self._cap(data))
        return host_scalars(self._train_step(to_device(data, self.device)))

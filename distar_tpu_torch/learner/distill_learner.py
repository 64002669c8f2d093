"""Actor-learner distillation: the student tier's learner.

Counterpart of ``distar_tpu.learner.distill_learner``: trains the small
student policy (``model.student_model_config``, no value towers) on the RL
learner's own batches, against the teacher logits every batch carries,
through the masked per-head KL of ``losses.distill_loss``. The batch's
``hidden_state`` has the teacher's LSTM dims, so every window trains the
student from a zero state of its own dims, built inside the step.

Its checkpoints are ``student_iteration_<n>.ckpt`` under the role
``student``, so a teacher's resume never picks a student's generation. The
``distar_distill_*`` gauges are the JAX learner's: the KL and each head's,
the newest student and teacher generations, and, with
``learner.teacher_flops_per_step``, the student/teacher step-cost ratio
(the student's count from ``obs.perf.count_flops``).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..actor.inference import to_device
from ..losses import DistillLossConfig, compute_distill_loss
from ..model import Model, init_params, student_model_config
from ..obs.dynamics import DynamicsTree
from ..obs.perf import count_flops, to_meta
from ..parallel.grad_clip import global_norm
from ..utils import deep_merge_dicts
from .base_learner import DEFAULT_LEARNER_CONFIG, BaseLearner, host_scalars
from .data import FakeRLDataloader, as_float32, cap_entities_rl
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
            # when set, the learner publishes its FLOPs-derived step-cost
            # ratio gauge (distar_distill_step_cost_ratio)
            "teacher_flops_per_step": 0,
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
                            batch_size: int, unroll_len: int, dynamics=None):
    """``train_step(batch) -> info``: the KL loss's info, ``grad_norm``
    (before clipping), with ``dynamics`` the training-dynamics tree, and
    the optimizer's update in place."""
    params = optimizer.params
    tree = DynamicsTree(model, params, dynamics) if dynamics is not None else None

    def train_step(batch):
        total, info = distill_loss(model, loss_cfg, batch, batch_size, unroll_len)
        grads = list(torch.autograd.grad(total, params, allow_unused=True, materialize_grads=True))
        info = {k: v.detach() for k, v in info.items()}
        info["grad_norm"] = global_norm(grads)
        if tree is not None:
            info.update(tree.before_update(params, grads, batch))
        update, lr = optimizer.step(grads)
        if tree is not None:
            info.update(tree.after_update(update, lr))
        return info

    return train_step


class DistillLearner(BaseLearner):
    """The student-tier learner on one device (``device=None``: CUDA, or
    raise). ``mesh`` is accepted, as the JAX learner accepts it for the
    launchers' sake, and not used: the student's step runs unsharded."""

    _CAP_FN = staticmethod(cap_entities_rl)
    CKPT_ROLE = "student"

    def __init__(self, cfg: Optional[dict] = None, device=None, mesh=None):
        cfg = deep_merge_dicts(DISTILL_LEARNER_DEFAULTS, cfg or {})
        self.model_cfg = student_model_config(cfg.get("model", {}))
        self.model_cfg.use_value_network = False
        self.loss_cfg = make_distill_loss_config(cfg.learner)
        super().__init__(cfg, device)

    def _setup_dataloader(self) -> None:
        lc, core = self.cfg.learner, self.model_cfg.encoder.core_lstm
        self._dataloader = iter(FakeRLDataloader(lc.batch_size, lc.unroll_len,
                                                 hidden_size=core.hidden_size,
                                                 hidden_layers=core.num_layers))

    def _setup_state(self) -> None:
        lc = self.cfg.learner
        self.model = Model(self.model_cfg)
        init_params(self.model, self.init_prng_seed)
        self.model.to(self.device).train()
        self.optimizer = self._build_optimizer(self.model.parameters())
        self._train_step = make_distill_train_step(self.model, self.loss_cfg, self.optimizer,
                                                   lc.batch_size, lc.unroll_len,
                                                   dynamics=self._dynamics_spec())
        reg = self.metrics
        self._g_kl = reg.gauge(
            "distar_distill_kl",
            "student-vs-teacher masked KL (unweighted sum over heads) at the "
            "last distill step — the distill_divergence_runaway input")
        self._g_head_kl = {}
        self._g_student_gen = reg.gauge(
            "distar_distill_student_generation",
            "learner iteration of the newest published student checkpoint")
        self._g_teacher_gen = reg.gauge(
            "distar_distill_teacher_generation",
            "newest teacher iteration observed in the training batches")
        teacher_flops = float(lc.get("teacher_flops_per_step") or 0)
        if teacher_flops > 0:
            # the student's count on a batch of the fake loader's shapes
            core = self.model_cfg.encoder.core_lstm
            sample = dict(next(iter(FakeRLDataloader(lc.batch_size, lc.unroll_len,
                                                     hidden_size=core.hidden_size,
                                                     hidden_layers=core.num_layers))))
            sample.pop("model_last_iter", None)
            student_flops = count_flops(self._flop_counter(to_meta(
                as_float32(self._strip_batch(self._cap(sample))))))
            if student_flops:
                reg.gauge(
                    "distar_distill_step_cost_ratio",
                    "student/teacher per-step cost ratio (FLOPs-derived; "
                    "teacher side from learner.teacher_flops_per_step)",
                ).set(student_flops / teacher_flops)

    def _flop_loss(self, model, batch):
        lc = self.cfg.learner
        return distill_loss(model, self.loss_cfg, batch, lc.batch_size, lc.unroll_len)[0]

    def save(self, path: str, sync: bool = False) -> None:
        super().save(path, sync=sync)
        self._g_student_gen.set(float(self.last_iter.val))

    def checkpoint_path(self) -> str:
        return os.path.join(self.save_dir, "checkpoints", f"student_iteration_{self.last_iter.val}.ckpt")

    def _strip_batch(self, data: Dict) -> Dict:
        """Drop the RL batch's fields that distillation does not read."""
        return {k: v for k, v in data.items() if k not in _UNUSED_FIELDS}

    def _train(self, data) -> Dict[str, Any]:
        data = dict(data)
        model_last_iter = np.asarray(data.pop("model_last_iter", 0.0))
        for k in ("trace_span_ids", "trace_age_s"):
            data.pop(k, None)
        data = to_device(as_float32(self._strip_batch(self._cap(data))), self.device)
        self._perf_note_step(data)
        log = host_scalars(self._train_step(data))
        self._g_kl.set(log["divergence"])
        for head in ("action_type", "delay", "queued", "selected_units", "target_unit",
                     "target_location"):
            g = self._g_head_kl.get(head)
            if g is None:
                g = self._g_head_kl[head] = self.metrics.gauge(
                    "distar_distill_head_kl", "per-action-head masked KL vs the teacher", head=head)
            g.set(log[f"kl/{head}"])
        self._g_teacher_gen.set(float(np.max(model_last_iter)))
        self._apply_pending_save()
        return log

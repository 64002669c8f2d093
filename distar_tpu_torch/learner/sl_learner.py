"""Supervised learner: behaviour cloning from replay windows.

Counterpart of ``distar_tpu.learner.sl_learner``: teacher-forced CE training
with the LSTM state carried from one batch to the next and zeroed for the
trajectories that restarted (``new_episodes``). The carry lives in the
learner on the device and is detached after every step, so a step's
backward never reaches into the step before it.

Not ported yet: the loss-spike guard, checkpoints, hooks, prefetch, the
replay dataloader and the held-out evaluation.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..actor.inference import to_device
from ..losses import SupervisedLossConfig, compute_sl_loss
from ..model import Model, default_model_config, init_params
from ..model.convert import flax_names
from ..parallel.grad_clip import global_norm, leaf_norms
from ..utils import deep_merge_dicts
from .base_learner import DEFAULT_LEARNER_CONFIG, BaseLearner, host_scalars
from .data import FakeSLDataloader, cap_entities

SL_LEARNER_DEFAULTS = deep_merge_dicts(
    DEFAULT_LEARNER_CONFIG,
    {
        "learner": {
            "batch_size": 2,
            "unroll_len": 32,
            "learning_rate": 1e-3,
            "betas": [0.9, 0.999],
            "eps": 1e-8,
            "weight_decay": 1e-5,
            "grad_clip": {"type": "norm", "threshold": 1.0},
            "label_smooth": 0.0,
            # per-parameter grad and param norms in the step's scalars
            "save_grad": False,
            # pad-to-bucket entity cap (see data.cap_entities)
            "max_entities": None,
        },
        "model": {},
    },
)


def sl_loss(model: Model, loss_cfg: SupervisedLossConfig, batch, hidden_state, batch_size: int):
    """(total loss, info, the LSTM's final state) of one SL batch."""
    logits, out_state = model.sl_forward(
        batch["spatial_info"], batch["entity_info"], batch["scalar_info"], batch["entity_num"],
        batch["action_info"], batch["selected_units_num"], hidden_state, batch_size)
    total, info = compute_sl_loss(logits, batch["action_info"], batch["action_mask"],
                                  batch["selected_units_num"], batch["entity_num"], loss_cfg)
    return total, info, out_state


def make_sl_train_step(model: Model, loss_cfg: SupervisedLossConfig, optimizer,
                       batch_size: int, save_grad: bool = False):
    """``train_step(batch, hidden_state) -> (new hidden state, info)``: the
    loss, its gradient, ``info["grad_norm"]`` (the global norm before
    clipping), with ``save_grad`` the per-parameter norms of gradients and
    parameters under the JAX learner's names, and the optimizer's update of
    ``optimizer.params`` in place. The state returned is detached."""
    params = optimizer.params
    names = list(flax_names(model).values()) if save_grad else None

    def train_step(batch, hidden_state):
        total, info, out_state = sl_loss(model, loss_cfg, batch, hidden_state, batch_size)
        grads = list(torch.autograd.grad(total, params, allow_unused=True, materialize_grads=True))
        info["grad_norm"] = global_norm(grads)
        if save_grad:
            info.update(leaf_norms(dict(zip(names, grads)), "grad_norm"))
            info.update(leaf_norms(dict(zip(names, params)), "param_norm"))
        optimizer.step(grads)
        return tuple((h.detach(), c.detach()) for h, c in out_state), info

    return train_step


class SLLearner(BaseLearner):
    """The SL learner on one device (``device=None``: CUDA, or raise)."""

    _CAP_FN = staticmethod(cap_entities)

    def __init__(self, cfg: Optional[dict] = None, device=None):
        cfg = deep_merge_dicts(SL_LEARNER_DEFAULTS, cfg or {})
        self.model_cfg = deep_merge_dicts(default_model_config(), cfg.get("model", {}))
        self.loss_cfg = SupervisedLossConfig(label_smooth=cfg.learner.label_smooth)
        super().__init__(cfg, device)

    def _setup_dataloader(self) -> None:
        lc = self.cfg.learner
        self._dataloader = iter(FakeSLDataloader(lc.batch_size, lc.unroll_len))

    def set_dataloader(self, it) -> None:
        self._dataloader = iter(it)

    def _setup_state(self) -> None:
        lc = self.cfg.learner
        self.model = Model(self.model_cfg)
        init_params(self.model, 0)  # the JAX learner's init_prng_seed
        self.model.to(self.device).train()
        core = self.model_cfg.encoder.core_lstm
        z = torch.zeros(lc.batch_size, core.hidden_size, device=self.device)
        self.hidden = tuple((z, z) for _ in range(core.num_layers))
        self.optimizer = self._build_optimizer(self.model.parameters())
        self._train_step = make_sl_train_step(self.model, self.loss_cfg, self.optimizer,
                                              lc.batch_size, save_grad=lc.get("save_grad", False))

    def _train(self, data) -> Dict[str, float]:
        data = self._cap(dict(data))  # callers may reuse the batch dict
        new_episodes = np.asarray(data.pop("new_episodes"))
        data.pop("traj_lens", None)
        if new_episodes.any():
            # zero the carry of the trajectories that restarted
            keep = torch.as_tensor(~new_episodes, dtype=torch.float32, device=self.device)[:, None]
            self.hidden = tuple((h * keep, c * keep) for h, c in self.hidden)
        self.hidden, info = self._train_step(to_device(data, self.device), self.hidden)
        return host_scalars(info)

"""RL learner: V-trace/UPGO/TD(lambda) training of the policy and its value
towers on one device.

Counterpart of ``distar_tpu.learner.rl_learner``: the model with value
towers, Adam (betas (0, 0.99), eps 1e-5) after a global-norm clip, the
value-pretrain gate, staleness statistics, and the config-patch and
value-reset admin requests. One step is forward, loss, backward and the
optimizer's update in place; the batch is time-major and its observations
are flattened to rows t*B + b.

Not ported yet, each raising ``NotImplementedError``: ``attach_comm`` (the
weight publication and league train-info of ``bin/rl_train.py``'s roles,
ROADMAP Queue 1 item 5), ``shard_batch`` and meshes (item 7), the
training-dynamics tree (item 9) and the admin save (item 4).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..actor.inference import to_device
from ..losses import ReinforcementLossConfig, compute_rl_loss
from ..model import Model, default_model_config, init_params
from ..model.convert import flax_names
from ..parallel.grad_clip import global_norm, leaf_norms
from ..utils import deep_merge_dicts
from .base_learner import DEFAULT_LEARNER_CONFIG, BaseLearner, host_scalars
from .data import FakeRLDataloader, cap_entities_rl

RL_LEARNER_DEFAULTS = deep_merge_dicts(
    DEFAULT_LEARNER_CONFIG,
    {
        "learner": {
            "player_id": "MP0",
            "batch_size": 4,
            "unroll_len": 16,
            "learning_rate": 1e-5,
            "betas": [0.0, 0.99],
            "eps": 1e-5,
            "grad_clip": {"type": "norm", "threshold": 10.0},
            "value_pretrain_iters": -1,
            "use_dapo": False,
            # per-parameter grad and param norms in the step's scalars
            "save_grad": False,
            # pad-to-bucket entity cap (see data.cap_entities_rl)
            "max_entities": None,
        },
        "model": {},
    },
)


def make_loss_config(learner_cfg) -> ReinforcementLossConfig:
    """Any ``ReinforcementLossConfig`` field overridden from
    ``learner.loss`` (lists become the dataclass's tuples of tuples); an
    explicit ``loss.use_dapo`` wins over ``learner.use_dapo``."""
    overrides = {
        k: (tuple(tuple(x) for x in v) if isinstance(v, (list, tuple)) else v)
        for k, v in dict(learner_cfg.get("loss", {}) or {}).items()
    }
    overrides.setdefault("use_dapo", learner_cfg.use_dapo)
    return ReinforcementLossConfig(**overrides)


def flatten_time(tree):
    """[T(+1), B, ...] leaves -> [T(+1)*B, ...] (row t*B + b)."""
    if isinstance(tree, dict):
        return {k: flatten_time(v) for k, v in tree.items()}
    return tree.reshape((-1,) + tuple(tree.shape[2:]))


def rl_loss(model: Model, loss_cfg: ReinforcementLossConfig, batch, batch_size: int,
            unroll_len: int):
    """(total loss, info) of one RL batch; ``info["td/total"]`` is the
    critic's loss alone."""
    value_feature = batch.get("value_feature")
    out = model.rl_forward(
        flatten_time(batch["spatial_info"]), flatten_time(batch["entity_info"]),
        flatten_time(batch["scalar_info"]), batch["entity_num"].reshape(-1),
        batch["hidden_state"], batch["action_info"], batch["selected_units_num"],
        batch_size, unroll_len,
        value_feature=None if value_feature is None else flatten_time(value_feature))
    inputs = {
        "target_logit": out["target_logit"],
        "value": out["value"],
        "action_log_prob": batch["behaviour_logp"],
        "teacher_logit": batch["teacher_logit"],
        "action": batch["action_info"],
        "reward": batch["reward"],
        "step": batch["step"],
        "done": batch.get("done"),
        "mask": batch["mask"],
        "entity_num": batch["entity_num"].reshape(-1, batch_size)[:unroll_len],
        "selected_units_num": batch["selected_units_num"],
    }
    if loss_cfg.use_dapo:
        inputs["successive_logit"] = batch["successive_logit"]
    return compute_rl_loss(inputs, dataclasses.replace(loss_cfg, only_update_value=False))


def make_rl_train_step(model: Model, loss_cfg: ReinforcementLossConfig, optimizer,
                       batch_size: int, unroll_len: int, save_grad: bool = False):
    """``train_step(batch, only_update_value=False) -> info``: the full
    loss's info, its gradient (with ``only_update_value``, the gradient of
    ``td/total`` alone: the critic trains and every parameter outside its
    graph gets a zero gradient, so Adam with b1 = 0 leaves it as it was),
    ``info["grad_norm"]`` (the global norm before clipping), with
    ``save_grad`` the per-parameter norms of gradients and parameters under
    the JAX learner's names, and the optimizer's update of
    ``optimizer.params`` in place. The info values are detached 0-d tensors."""
    params = optimizer.params
    names = list(flax_names(model).values()) if save_grad else None

    def train_step(batch, only_update_value: bool = False):
        total, info = rl_loss(model, loss_cfg, batch, batch_size, unroll_len)
        loss = info["td/total"] if only_update_value else total
        grads = list(torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True))
        info = {k: torch.as_tensor(v).detach() for k, v in info.items()}
        info["grad_norm"] = global_norm(grads)
        if save_grad:
            info.update(leaf_norms(dict(zip(names, grads)), "grad_norm"))
            info.update(leaf_norms(dict(zip(names, params)), "param_norm"))
        optimizer.step(grads)
        return info

    return train_step


def _is_critic(name: str) -> bool:
    """A parameter of a value tower or of the value encoder."""
    return name.startswith("value_")


class RLLearner(BaseLearner):
    """The league-RL learner on one device (``device=None``: CUDA, or raise)."""

    _CAP_FN = staticmethod(cap_entities_rl)

    def __init__(self, cfg: Optional[dict] = None, device=None):
        cfg = deep_merge_dicts(RL_LEARNER_DEFAULTS, cfg or {})
        self.model_cfg = deep_merge_dicts(default_model_config(), cfg.get("model", {}))
        self.model_cfg.use_value_network = True
        self.loss_cfg = make_loss_config(cfg.learner)
        self._remaining_value_pretrain = cfg.learner.get("value_pretrain_iters", -1)
        self._pending_config_patch = None
        self._pending_value_reset = False
        self._last_span_ids = []
        super().__init__(cfg, device)

    # ------------------------------------------------------------ state init
    def _setup_dataloader(self) -> None:
        lc, core = self.cfg.learner, self.model_cfg.encoder.core_lstm
        self._dataloader = iter(FakeRLDataloader(
            lc.batch_size, lc.unroll_len, hidden_size=core.hidden_size,
            hidden_layers=core.num_layers, use_value_feature=self.model_cfg.use_value_feature))

    def set_dataloader(self, it) -> None:
        self._dataloader = iter(it)

    def _setup_state(self) -> None:
        self.model = Model(self.model_cfg)
        init_params(self.model, 0)  # the JAX learner's init_prng_seed
        self.model.to(self.device).train()
        self._build_step()

    def _build_step(self) -> None:
        """A new optimizer (its state from zero) and train step."""
        lc = self.cfg.learner
        self.optimizer = self._build_optimizer(self.model.parameters())
        self._train_step = make_rl_train_step(self.model, self.loss_cfg, self.optimizer,
                                              lc.batch_size, lc.unroll_len,
                                              save_grad=lc.get("save_grad", False))

    def shard_batch(self, batch):
        raise NotImplementedError("shard_batch: meshes and sharded batches are not ported yet "
                                  "(ROADMAP Queue 1 item 7, parallel/)")

    def attach_comm(self, adapter, player_id: str, league=None, **kwargs) -> None:
        raise NotImplementedError("attach_comm: weight publication and league train-info are not "
                                  "ported yet (ROADMAP Queue 1 item 5, bin/rl_train.py's roles)")

    # ----------------------------------------------------------------- admin
    def request_update_config(self, cfg_patch: dict) -> None:
        self._pending_config_patch = cfg_patch

    def request_value_reset(self) -> None:
        self._pending_value_reset = True

    def _apply_admin_requests(self) -> None:
        patch = self._pending_config_patch
        if patch:
            self._pending_config_patch = None
            self.cfg = deep_merge_dicts(self.cfg, patch)
            # hyperparameter changes rebuild the optimizer; its state resets
            self._build_step()
        if self._pending_value_reset:
            self._pending_value_reset = False
            # fresh draws for the value towers and the value encoder only
            init_params(self.model, self.last_iter + 1, only=_is_critic)

    # ------------------------------------------------------------- training
    def step_value_pretrain(self) -> bool:
        """The value-pretrain gate: during the first value_pretrain_iters
        steps only the critic trains."""
        if self._remaining_value_pretrain > 0:
            self._remaining_value_pretrain -= 1
            return True
        return False

    def _train(self, data) -> Dict[str, Any]:
        only_value = self.step_value_pretrain()
        data = dict(data)  # callers may reuse the batch dict
        model_last_iter = np.asarray(data.pop("model_last_iter"))
        staleness = self.last_iter - model_last_iter
        # pipeline-span fields minted in the actor (host side)
        span_ids = data.pop("trace_span_ids", None)
        trace_age = data.pop("trace_age_s", None)
        info = self._train_step(to_device(self._cap(data), self.device), only_value)
        log = host_scalars(info)
        log["staleness/mean"] = float(staleness.mean())
        log["staleness/max"] = float(staleness.max())
        log["staleness/std"] = float(staleness.std())
        if trace_age is not None and len(trace_age):
            log["trace/age_s_mean"] = float(np.mean(trace_age))
            log["trace/age_s_max"] = float(np.max(trace_age))
            self._last_span_ids = list(span_ids or [])
        self._apply_admin_requests()
        return log

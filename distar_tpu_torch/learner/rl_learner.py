"""RL learner: V-trace/UPGO/TD(lambda) training of the policy and its value
towers on one device.

Counterpart of ``distar_tpu.learner.rl_learner``: the model with value
towers, Adam (betas (0, 0.99), eps 1e-5) after a global-norm clip, the
value-pretrain gate, staleness statistics, and the config-patch and
value-reset admin requests, and ``attach_comm``: the weight publication to
the actors (the JAX package's payload, a flax-layout numpy tree) and the
league's train-info with its reset. One step is forward, loss, backward and
the optimizer's update in place; the batch is time-major and its
observations are flattened to rows t*B + b. ``_place_batch`` is the
prefetcher's placing (``learner.prefetch_depth``, default 2; 0 turns it
off): the capped, float32 batch on the device from pinned memory on a side
stream, ``model_last_iter`` and the trace fields left on the host.

Each step also computes the training-dynamics tree (``obs/dynamics.py``;
``learner.dynamics``). On a mesh (``mesh=``) ``shard_batch`` takes this
rank's rows (B over dp x fsdp; T stays whole on every rank), the model
runs on them, and its outputs and the loss's inputs are gathered back to
the whole batch before the loss (``parallel.spmd``).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..actor.inference import to_device
from ..losses import ReinforcementLossConfig, compute_rl_loss
from ..model import Model, default_model_config, init_params
from ..model.convert import flax_names, params_to_flax
from ..obs.dynamics import DynamicsTree
from ..parallel.grad_clip import leaf_norms
from ..parallel.spmd import gather_rows, param_shards, reduce_grads, reduce_info, take_rows
from ..utils import deep_merge_dicts
from .base_learner import DEFAULT_LEARNER_CONFIG, BaseLearner, host_scalars
from .hooks import LambdaHook
from .data import FakeRLDataloader, as_float32, cap_entities_rl
from .prefetch import place_on

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
            unroll_len: int, mesh=None):
    """(total loss, info) of one RL batch; ``info["td/total"]`` is the
    critic's loss alone. On a ``mesh`` ``batch`` holds this rank's
    ``batch_size`` rows, and the loss is the whole batch's (its inputs
    gathered over the batch extent along B)."""
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
    inputs = gather_rows(inputs, 1, mesh)
    return compute_rl_loss(inputs, dataclasses.replace(loss_cfg, only_update_value=False))


def make_rl_train_step(model: Model, loss_cfg: ReinforcementLossConfig, optimizer,
                       batch_size: int, unroll_len: int, save_grad: bool = False,
                       dynamics=None, mesh=None):
    """``train_step(batch, only_update_value=False) -> info``: the full
    loss's info, its gradient (with ``only_update_value``, the gradient of
    ``td/total`` alone: the critic trains and every parameter outside its
    graph gets a zero gradient, so Adam with b1 = 0 leaves it as it was),
    ``info["grad_norm"]`` (the global norm before clipping), with
    ``save_grad`` the per-parameter norms of gradients and parameters under
    the JAX learner's names, with ``dynamics`` (an ``obs.DynamicsSpec``, or
    None) the training-dynamics tree over the pre-step parameters, the raw
    gradients, the update and the batch, and the optimizer's update of
    ``optimizer.params`` in place. The info values are detached 0-d tensors."""
    params = optimizer.params
    names = list(flax_names(model).values()) if save_grad else None
    shards = param_shards(model)
    tree = DynamicsTree(model, params, dynamics) if dynamics is not None else None
    norms = optimizer.clip.norms

    def train_step(batch, only_update_value: bool = False):
        total, info = rl_loss(model, loss_cfg, batch, batch_size, unroll_len, mesh=mesh)
        loss = info["td/total"] if only_update_value else total
        grads = list(torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True))
        # each rank's rows' share, summed: the whole batch's gradient
        reduce_grads(grads, mesh, shards)
        info = {k: torch.as_tensor(v).detach() for k, v in info.items()}
        info["grad_norm"] = optimizer.clip.global_norm(grads)
        if save_grad:
            info.update(leaf_norms(dict(zip(names, grads)), "grad_norm", norms))
            info.update(leaf_norms(dict(zip(names, params)), "param_norm", norms))
        if tree is not None:
            info.update(tree.before_update(params, grads, batch))
            reduce_info(info, "dyn/nonfinite_batch/", mesh)
        update, lr = optimizer.step(grads)
        if tree is not None:
            info.update(tree.after_update(update, lr))
        return info

    return train_step


def _is_critic(name: str) -> bool:
    """A parameter of a value tower or of the value encoder."""
    return name.startswith("value_")


class RLLearner(BaseLearner):
    """The league-RL learner on one device (``device=None``: CUDA, or
    raise), or one rank of a ``mesh``."""

    _CAP_FN = staticmethod(cap_entities_rl)

    def __init__(self, cfg: Optional[dict] = None, device=None, mesh=None):
        cfg = deep_merge_dicts(RL_LEARNER_DEFAULTS, cfg or {})
        self.model_cfg = deep_merge_dicts(default_model_config(), cfg.get("model", {}))
        self.model_cfg.use_value_network = True
        self.loss_cfg = make_loss_config(cfg.learner)
        self._remaining_value_pretrain = cfg.learner.get("value_pretrain_iters", -1)
        self._pending_config_patch = None
        self._pending_value_reset = False
        self._last_span_ids = []
        super().__init__(cfg, device, mesh=mesh)

    # ------------------------------------------------------------ state init
    def _setup_dataloader(self) -> None:
        lc, core = self.cfg.learner, self.model_cfg.encoder.core_lstm
        self._dataloader = iter(FakeRLDataloader(
            lc.batch_size, lc.unroll_len, hidden_size=core.hidden_size,
            hidden_layers=core.num_layers, use_value_feature=self.model_cfg.use_value_feature))

    def _setup_state(self) -> None:
        self.model = Model(self.model_cfg)
        init_params(self.model, self.init_prng_seed)
        self.model.to(self.device).train()
        self._build_step()

    def _build_step(self) -> None:
        """A new optimizer (its state from zero) and train step."""
        lc = self.cfg.learner
        self.optimizer = self._build_optimizer(self.model.parameters())
        self._train_step = make_rl_train_step(self.model, self.loss_cfg, self.optimizer,
                                              self.local_batch_size, lc.unroll_len,
                                              save_grad=lc.get("save_grad", False),
                                              dynamics=self._dynamics_spec(), mesh=self.mesh)

    def _place_batch(self, batch):
        """The prefetcher's placing: the capped batch, cast as the step
        casts it, on the device (from pinned memory on CUDA), with
        ``model_last_iter`` and the trace fields kept on the host."""
        batch = dict(batch)
        host = {"model_last_iter": np.asarray(batch.pop("model_last_iter"))}
        for k in ("trace_span_ids", "trace_age_s"):
            if k in batch:
                host[k] = batch.pop(k)
        out = self.shard_batch(self._cap(batch))
        out.update(host)
        out["_on_device"] = True
        return out

    def _rows(self, batch):
        """This rank's rows of a global host batch: B is axis 1 of the
        time-major leaves and axis 0 of ``hidden_state`` (the whole batch
        without a mesh; the batch as it is from a ``local`` loader)."""
        if self.mesh is None:
            return batch
        B, local = int(self.cfg.learner.batch_size), self._local_rows
        batch = dict(batch)
        hidden = batch.pop("hidden_state", None)
        out = take_rows(batch, 1, self.mesh, B, local)
        if hidden is not None:
            out["hidden_state"] = take_rows(hidden, 0, self.mesh, B, local)
        return out

    def shard_batch(self, batch):
        """Place a host batch for this rank: its rows (B over dp x fsdp,
        as ``parallel.assemble_global`` cuts it; T stays whole, sp splits
        only attention), cast as the step casts it, on the device (from
        pinned memory on CUDA)."""
        return place_on(as_float32(self._rows(batch)), self.device)

    def attach_comm(self, adapter, player_id: str, league=None, send_model_freq: int = 4,
                    send_train_info_freq: int = 4, model_accept_count: int = 8) -> None:
        """Publish the weights to the actors before the run and every
        ``send_model_freq`` iterations (``{player_id}model``: ``{"params":
        flax-layout numpy tree, "iter", "reset_flag"}``, taken off the device
        in one transfer), and send the league train-info every
        ``send_train_info_freq`` iterations: a reply naming an existing
        reset checkpoint restores it, and the next publication carries
        ``reset_flag`` so the actors restart their episodes. On a mesh
        every rank attaches: only rank 0 pushes the weights and talks to
        the league, whose reset it hands the other ranks; where the
        placement splits a leaf, every rank joins the gather of the
        weights."""
        lc = self.cfg.learner
        frames_per_iter = lc.batch_size * lc.unroll_len
        self._pending_reset_flag = False
        lead = self.rank == 0

        def send_model(learner):
            if lead or param_shards(learner.model).splits:
                params = params_to_flax(learner.model)
            if lead:
                adapter.push(
                    f"{player_id}model",
                    {
                        "params": params,
                        "iter": learner.last_iter.val,
                        # actors restart episodes when a league reset swapped the
                        # checkpoint (reference actor_comm.py:191-196)
                        "reset_flag": learner._pending_reset_flag,
                    },
                    accept_count=model_accept_count,
                    timeout_ms=120_000,
                )
            learner._pending_reset_flag = False

        def send_train_info(learner):
            if league is None:
                return
            reset_path = None
            if lead:
                reply = league.learner_send_train_info(
                    player_id, train_steps=frames_per_iter * send_train_info_freq)
                reset_path = (reply or {}).get("reset_checkpoint_path")
            if learner.mesh is not None and dist.get_world_size() > 1:
                box = [reset_path]
                dist.broadcast_object_list(box, src=0)
                reset_path = box[0]
            if reset_path:
                if os.path.exists(reset_path):
                    learner.restore(reset_path)
                    # only a real checkpoint swap makes actors restart
                    learner._pending_reset_flag = True
                    learner.logger.info(f"league reset: restored {reset_path}")
                else:
                    learner.logger.info(
                        f"league reset requested ({reset_path}); checkpoint absent, keeping weights")

        self.hooks.add(LambdaHook("send_model", "after_iter", send_model, freq=send_model_freq))
        self.hooks.add(LambdaHook("send_model_init", "before_run", send_model))
        self.hooks.add(
            LambdaHook("send_train_info", "after_iter", send_train_info, freq=send_train_info_freq))

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
        self._apply_pending_save()
        if self._pending_value_reset:
            self._pending_value_reset = False
            # fresh draws for the value towers and the value encoder only
            init_params(self.model, self.last_iter.val + 1, only=_is_critic)

    # ------------------------------------------------------------- training
    def step_value_pretrain(self) -> bool:
        """The value-pretrain gate: during the first value_pretrain_iters
        steps only the critic trains."""
        if self._remaining_value_pretrain > 0:
            self._remaining_value_pretrain -= 1
            return True
        return False

    def _dynamics_aux(self) -> Dict[str, Any]:
        """Pre-step extras for a black-box bundle: the value-pretrain gate
        the step is ABOUT to use (read before ``_train`` moves it)."""
        return {"only_update_value": self._remaining_value_pretrain > 0}

    def _flop_loss(self, model, batch):
        return rl_loss(model, self.loss_cfg, batch, self.local_batch_size, self.cfg.learner.unroll_len)[0]

    def _train(self, data) -> Dict[str, Any]:
        only_value = self.step_value_pretrain()
        data = dict(data)  # callers may reuse the batch dict
        on_device = data.pop("_on_device", False)
        model_last_iter = np.asarray(data.pop("model_last_iter"))
        staleness = self.last_iter.val - model_last_iter
        # pipeline-span fields minted in the actor (host side)
        span_ids = data.pop("trace_span_ids", None)
        trace_age = data.pop("trace_age_s", None)
        if not on_device:
            data = to_device(as_float32(self._rows(self._cap(data))), self.device)
        self._perf_note_step(data)
        info = self._train_step(data, only_value)
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

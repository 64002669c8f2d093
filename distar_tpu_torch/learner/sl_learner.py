"""Supervised learner: behaviour cloning from replay windows.

Counterpart of ``distar_tpu.learner.sl_learner``: teacher-forced CE training
with the LSTM state carried from one batch to the next and zeroed for the
trajectories that restarted (``new_episodes``). The carry lives in the
learner on the device and is detached after every step, so a step's
backward never reaches into the step before it.

Beside the step: ``evaluate`` (the held-out metric pass), ``_place_batch``
(the prefetcher's placing) and, with ``learner.debug_loss_spike``, the
loss-spike guard, which dumps a step's inputs and a checkpoint when a loss
term jumps or goes non-finite.

On a mesh (``mesh=``) each rank takes its trajectories' rows (the flat
rows b*T + t of its block of B, and its carry), and the logits and the
labels are gathered back to the whole batch before the loss, so every
masked mean divides by the whole batch's count (``parallel.spmd``).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..actor.inference import to_device, to_host
from ..losses import SupervisedLossConfig, compute_sl_loss
from ..model import Model, default_model_config, init_params
from ..model.convert import flax_names
from ..obs.dynamics import DynamicsTree
from ..parallel.grad_clip import leaf_norms
from ..parallel.spmd import gather_rows, param_shards, reduce_grads, reduce_info, take_rows
from ..utils import deep_merge_dicts
from .base_learner import DEFAULT_LEARNER_CONFIG, BaseLearner, host_scalars
from .data import FakeSLDataloader, cap_entities
from .prefetch import place_on

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
            # loss-spike debug snapshots (the reference's SL debug mode)
            "debug_loss_spike": False,
            "debug_spike_factor": 10.0,
            "debug_spike_warmup": 200,
        },
        "model": {},
    },
)


def sl_loss(model: Model, loss_cfg: SupervisedLossConfig, batch, hidden_state, batch_size: int,
            mesh=None):
    """(total loss, info, the LSTM's final state) of one SL batch. On a
    ``mesh`` ``batch`` holds this rank's ``batch_size`` trajectories, and
    the loss is the whole batch's (logits and labels gathered over the
    batch extent); the state stays this rank's."""
    logits, out_state = model.sl_forward(
        batch["spatial_info"], batch["entity_info"], batch["scalar_info"], batch["entity_num"],
        batch["action_info"], batch["selected_units_num"], hidden_state, batch_size)
    inputs = gather_rows((logits, batch["action_info"], batch["action_mask"],
                          batch["selected_units_num"], batch["entity_num"]), 0, mesh)
    total, info = compute_sl_loss(*inputs, loss_cfg)
    return total, info, out_state


def make_sl_train_step(model: Model, loss_cfg: SupervisedLossConfig, optimizer,
                       batch_size: int, save_grad: bool = False, dynamics=None, mesh=None):
    """``train_step(batch, hidden_state) -> (new hidden state, info)``: the
    loss, its gradient, ``info["grad_norm"]`` (the global norm before
    clipping), with ``save_grad`` the per-parameter norms of gradients and
    parameters under the JAX learner's names, with ``dynamics`` (an
    ``obs.DynamicsSpec``, or None) the training-dynamics tree over the
    pre-step parameters, the raw gradients, the update and the batch, and
    the optimizer's update of ``optimizer.params`` in place. The state
    returned is detached. On a ``mesh`` the gradient shares are summed over
    the batch extent, as in the RL step."""
    params = optimizer.params
    names = list(flax_names(model).values()) if save_grad else None
    shards = param_shards(model)
    tree = DynamicsTree(model, params, dynamics) if dynamics is not None else None
    norms = optimizer.clip.norms

    def train_step(batch, hidden_state):
        total, info, out_state = sl_loss(model, loss_cfg, batch, hidden_state, batch_size, mesh=mesh)
        grads = list(torch.autograd.grad(total, params, allow_unused=True, materialize_grads=True))
        reduce_grads(grads, mesh, shards)
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
        return tuple((h.detach(), c.detach()) for h, c in out_state), info

    return train_step


class SLLearner(BaseLearner):
    """The SL learner on one device (``device=None``: CUDA, or raise), or
    one rank of a ``mesh``."""

    _CAP_FN = staticmethod(cap_entities)

    def __init__(self, cfg: Optional[dict] = None, device=None, mesh=None):
        cfg = deep_merge_dicts(SL_LEARNER_DEFAULTS, cfg or {})
        self.model_cfg = deep_merge_dicts(default_model_config(), cfg.get("model", {}))
        self.loss_cfg = SupervisedLossConfig(label_smooth=cfg.learner.label_smooth)
        super().__init__(cfg, device, mesh=mesh)

    def _setup_dataloader(self) -> None:
        lc = self.cfg.learner
        self._dataloader = iter(FakeSLDataloader(lc.batch_size, lc.unroll_len))

    def _zero_hidden(self, rows: Optional[int] = None):
        core = self.model_cfg.encoder.core_lstm
        z = torch.zeros(rows or self.local_batch_size, core.hidden_size, device=self.device)
        return tuple((z, z) for _ in range(core.num_layers))

    def _setup_state(self) -> None:
        lc = self.cfg.learner
        self.model = Model(self.model_cfg)
        init_params(self.model, self.init_prng_seed)
        self.model.to(self.device).train()
        self.hidden = self._zero_hidden()
        self.optimizer = self._build_optimizer(self.model.parameters())
        self._train_step = make_sl_train_step(self.model, self.loss_cfg, self.optimizer,
                                              self.local_batch_size,
                                              save_grad=lc.get("save_grad", False),
                                              dynamics=self._dynamics_spec(), mesh=self.mesh)

    def _rows(self, data):
        """This rank's rows of a global host batch: its block of the B
        trajectories, i.e. of the flat rows b*T + t and of the [B] fields
        (the whole batch without a mesh; the batch as it is from a
        ``local`` loader)."""
        if self.mesh is None:
            return data
        lc, local = self.cfg.learner, self._local_rows
        B, T = int(lc.batch_size), int(lc.unroll_len)
        flat = take_rows({k: v for k, v in data.items() if k not in ("new_episodes", "traj_lens")},
                         0, self.mesh, B * T, local)
        flat.update(take_rows({k: data[k] for k in ("new_episodes", "traj_lens") if k in data},
                              0, self.mesh, B, local))
        return flat

    @torch.no_grad()
    def evaluate(self, dataloader, max_batches: int = 0) -> Dict[str, float]:
        """The held-out metric pass: the SL forward and loss over
        ``dataloader``'s batches with no gradient and no change of state,
        each scalar averaged over the batches. The carry starts cold per
        batch (the unroll within a window still carries it). Stops after
        ``max_batches`` (0: when the loader ends)."""
        B = self.cfg.learner.batch_size
        sums: Dict[str, float] = {}
        n = 0
        for batch in dataloader:
            batch = self._cap(dict(batch))
            batch.pop("new_episodes", None)
            batch.pop("traj_lens", None)
            total, info, _ = sl_loss(self.model, self.loss_cfg, to_device(batch, self.device),
                                     self._zero_hidden(B), B)
            info["total_loss"] = total
            for k, v in host_scalars(info).items():
                sums[k] = sums.get(k, 0.0) + v
            n += 1
            if max_batches and n >= max_batches:
                break
        return {k: v / max(n, 1) for k, v in sums.items()}

    def _place_batch(self, data):
        """The prefetcher's placing: the capped batch on the device (from
        pinned memory on CUDA), the host fields kept as numpy."""
        data = self._rows(self._cap(dict(data)))
        host = {k: np.asarray(data.pop(k)) for k in ("new_episodes", "traj_lens") if k in data}
        out = place_on(data, self.device)
        out.update(host)
        out["_on_device"] = True
        return out

    def _dynamics_aux(self) -> Dict[str, Any]:
        """Pre-step extras for a black-box bundle: the LSTM carry BEFORE
        this step's episode reset (a replay restores it and lets ``_train``
        apply the reset from the batch's own ``new_episodes``). Tensor refs:
        the copy happens only if a bundle is written."""
        return {"hidden_state": self.hidden}

    def _flop_loss(self, model, batch):
        batch = dict(batch)
        batch.pop("new_episodes", None)
        batch.pop("traj_lens", None)
        z = torch.zeros(self.local_batch_size, model.cfg["encoder"]["core_lstm"]["hidden_size"])
        hidden = tuple((z, z) for _ in range(model.cfg["encoder"]["core_lstm"]["num_layers"]))
        return sl_loss(model, self.loss_cfg, batch, hidden, self.local_batch_size)[0]

    def _train(self, data) -> Dict[str, float]:
        data = dict(data)  # callers may reuse the batch dict
        on_device = data.pop("_on_device", False)
        if not on_device:
            data = self._rows(self._cap(data))
        new_episodes = np.asarray(data.pop("new_episodes"))
        traj_lens = data.pop("traj_lens", None)
        if new_episodes.any():
            # zero the carry of the trajectories that restarted
            keep = torch.as_tensor(~new_episodes, dtype=torch.float32, device=self.device)[:, None]
            self.hidden = tuple((h * keep, c * keep) for h, c in self.hidden)
        batch = data if on_device else to_device(data, self.device)
        pre_step = {"batch": batch, "hidden_state": self.hidden, "new_episodes": new_episodes,
                    "traj_lens": traj_lens}
        self._perf_note_step(batch)
        self.hidden, info = self._train_step(batch, self.hidden)
        log = host_scalars(info)
        if self.cfg.learner.get("debug_loss_spike", False):
            self._loss_spike_guard(log, pre_step)
        return log

    # snapshots a run: a misbehaving trigger must not fill the disk
    _DEBUG_DUMP_CAP = 20
    # an EMA this small is no signal yet (a masked head's loss is exactly 0
    # on batches without its actions): growth from it is not a spike
    _DEBUG_EMA_FLOOR = 0.01

    def _loss_spike_guard(self, log: Dict[str, float], pre_step: dict) -> None:
        """Track every loss term's EMA (0.95 / 0.05); when one exceeds
        ``debug_spike_factor`` x its EMA after ``debug_spike_warmup`` steps,
        or turns non-finite (even at the first step), dump the step's inputs
        and save a checkpoint beside them: one dump a step, one a
        divergence, at most ``_DEBUG_DUMP_CAP`` a run."""
        if not hasattr(self, "_debug_ema"):
            self._debug_ema = {}
            self._debug_dumps = 0
            self._debug_nonfinite = set()  # keys already dumped as non-finite
        factor = float(self.cfg.learner.get("debug_spike_factor", 10.0))
        warmup = int(self.cfg.learner.get("debug_spike_warmup", 200))
        dumped = False
        for k, v in log.items():
            if "loss" not in k:
                continue
            prev = self._debug_ema.get(k)
            blown_up = not np.isfinite(v)
            if not blown_up:
                self._debug_nonfinite.discard(k)  # recovered: armed again
            elif k in self._debug_nonfinite:
                continue
            spiked = blown_up or (prev is not None and np.isfinite(prev)
                                  and prev > self._DEBUG_EMA_FLOOR and v > prev * factor)
            if (spiked and (blown_up or self.last_iter.val > warmup) and not dumped
                    and self._debug_dumps < self._DEBUG_DUMP_CAP):
                dumped = True
                self._debug_dumps += 1
                if blown_up:
                    self._debug_nonfinite.add(k)
                self._dump_spike(k, v, prev, log, pre_step)
            if not blown_up:  # never poison the EMA with inf or nan
                self._debug_ema[k] = v if prev is None else prev * 0.95 + v * 0.05

    def _dump_spike(self, key, value, ema, log, pre_step) -> None:
        from ..comm.serializer import dumps

        os.makedirs(os.path.join(self.save_dir, "debug"), exist_ok=True)
        path = os.path.join(self.save_dir, "debug",
                            f"{key.replace('/', '_')}_iter_{self.last_iter.val}"
                            f"_rank{self.rank}_{self._debug_dumps}.spike")
        snapshot: Dict[str, Any] = {
            "key": key, "value": value, "ema": ema, "log": log,
            "batch": to_host(pre_step["batch"]),
            "hidden_state": tuple((h.cpu().numpy(), c.cpu().numpy()) for h, c in pre_step["hidden_state"]),
            "new_episodes": pre_step["new_episodes"], "traj_lens": pre_step["traj_lens"],
            "note": "params in the companion checkpoint are one optimizer step PAST the spike; "
                    "batch/hidden_state are the step's exact inputs"}
        with open(path, "wb") as f:
            f.write(dumps(snapshot, compress=True))
        self.save(self.checkpoint_path(), sync=True)  # debug artifacts are durable
        ema_txt = f"{ema:.4f}" if ema is not None else "unseeded"
        self.logger.info(f"loss spike: {key}={value:.4f} (ema {ema_txt}); snapshot {path}")

"""Batched inference for actors and the serving gateway.

Counterpart of ``distar_tpu.actor.inference.BatchedInference``: every slot's
prepared observation is stacked into one fixed-shape device batch and one
``sample_action`` serves all slots. The object owns the per-slot LSTM
carries on the device and the Gumbel noise generator. Each flush copies its
whole output to the host in ONE device->host transfer (every leaf packed
into one byte buffer) and hands out per-slot views of that host copy.

It also owns the optional frozen-teacher side of the rollout contract: a
teacher copy of the model, its ``teacher_params`` and one teacher LSTM
carry per slot, advanced by ``teacher_step`` and zeroed with the policy
carry in ``reset_slot``.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional

import numpy as np
import torch

from ..lib import features as F
from ..model.core import Model, gumbel_noise


def resolve_device(device=None) -> torch.device:
    """The entry points' device rule: CUDA unless the caller asks for
    another device, and no silent slide onto the CPU when CUDA is absent.

    On CUDA it also turns TF32 off for matmuls and cuDNN convolutions (the
    process-wide ``torch.backends`` switches): the model's float32 is held
    as float32, where torch's defaults let cuDNN round convolution inputs
    to TF32's 10-bit mantissa. bfloat16 runs are not affected."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_device(v, device) for v in tree)
    return torch.from_numpy(np.ascontiguousarray(tree)).to(device, non_blocking=True)


def to_host(tree):
    """Copy a nested dict of device tensors to host numpy with one transfer:
    the leaves are packed into one byte buffer on the device (each padded
    to 8 bytes, so every host view is aligned), copied, and unpacked as
    views of the host copy."""
    chunks, spec = [], []

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
            return
        raw = t.contiguous().reshape(-1).view(torch.uint8)
        pad = -raw.numel() % 8
        chunks.append(raw)
        if pad:
            chunks.append(raw.new_zeros(pad))
        spec.append((path, t.dtype, tuple(t.shape), raw.numel() + pad))

    walk(tree, ())
    host = torch.cat(chunks).cpu().numpy()
    out: Dict = {}
    off = 0
    for path, dtype, shape, nbytes in spec:
        np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
        n = int(np.prod(shape, dtype=np.int64))
        arr = host[off:off + n * np_dtype.itemsize].view(np_dtype).reshape(shape)
        off += nbytes
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr
    return out


def _slot_view(tree, i):
    if isinstance(tree, dict):
        return {k: _slot_view(v, i) for k, v in tree.items()}
    return tree[i]


class BatchedInference:
    """Owns the model and hidden states for all slots of one player, and
    the optional frozen teacher (its weights and per-slot carries)."""

    def __init__(self, model: Model, num_slots: int, seed: int = 0, device=None,
                 teacher_params=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.num_slots = num_slots
        core = model.cfg["encoder"]["core_lstm"]
        self._hidden_size = core["hidden_size"]
        self._num_layers = core["num_layers"]
        self.hidden = self._zero_hidden()
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.teacher_params = None
        self.teacher_model: Optional[Model] = None
        self.teacher_hidden = self._zero_hidden()
        if teacher_params is not None:
            self.set_teacher_params(teacher_params)

    def _zero_hidden(self):
        z = torch.zeros(self.num_slots, self._hidden_size, device=self.device)
        return tuple((z, z) for _ in range(self._num_layers))

    def set_params(self, params) -> None:
        """Install new weights (a ``state_dict`` of the same shapes). The
        gateway calls this at a flush boundary, between forwards."""
        self.model.load_state_dict(params)

    def set_teacher_params(self, params) -> None:
        """Install (or replace) the frozen teacher's weights, a
        ``state_dict`` of the policy model's shapes: they load into a copy
        of the model kept for the teacher."""
        if self.teacher_model is None:
            self.teacher_model = copy.deepcopy(self.model).eval()
        self.teacher_model.load_state_dict(params)
        self.teacher_params = params

    @torch.no_grad()
    def warmup(self, template_obs: dict, params=None) -> None:
        """One throwaway batched forward on scratch hidden state and scratch
        noise: touches neither the live weights (``params``, when given,
        run through ``torch.func.functional_call``), nor any slot's carry,
        nor the noise generator."""
        batch = to_device(F.batch_tree([template_obs] * self.num_slots), self.device)
        g = torch.Generator(device=self.device).manual_seed(0)
        args = (batch["spatial_info"], batch["entity_info"], batch["scalar_info"],
                batch["entity_num"], self._zero_hidden())
        if params is None:
            self.model.sample_action(*args, generator=g)
        else:
            params = {k: v.to(self.device) for k, v in params.items()}
            torch.func.functional_call(self.model, params, args, {"generator": g})

    def reset_slot(self, idx: int) -> None:
        """Zero one slot's policy AND teacher hidden state (episode
        boundary: the slot's whole recurrent state restarts together)."""
        i = torch.tensor([idx], device=self.device)
        self.hidden = tuple((h.index_fill(0, i, 0.0), c.index_fill(0, i, 0.0)) for h, c in self.hidden)
        self.teacher_hidden = tuple((h.index_fill(0, i, 0.0), c.index_fill(0, i, 0.0))
                                    for h, c in self.teacher_hidden)

    def hidden_for_slot(self, idx: int):
        """The slot's carry as host numpy ((h, c) per layer), one fetch."""
        flat = torch.stack([t[idx] for hc in self.hidden for t in hc]).cpu().numpy()
        return tuple((flat[2 * i], flat[2 * i + 1]) for i in range(self._num_layers))

    @torch.no_grad()
    def sample(self, prepared: List[dict], active: Optional[List[bool]] = None,
               noise: Optional[Dict[str, torch.Tensor]] = None) -> List[dict]:
        """One batched forward over all slots; returns per-slot outputs.

        ``active`` marks slots that are acting this cycle: inactive slots are
        batch filler, keep their previous hidden state, and their outputs
        must be ignored. ``noise`` gives the Gumbel draws explicitly (see
        ``model.noise_shapes``); by default they come from the generator.
        """
        if len(prepared) != self.num_slots:
            raise ValueError(f"{len(prepared)} observations for {self.num_slots} slots")
        batch = to_device(F.batch_tree(prepared), self.device)
        if noise is None:
            noise = gumbel_noise(self.model.cfg, self.num_slots, self.generator, self.device)
        else:
            noise = {k: v.to(self.device) for k, v in noise.items()}
        out = self.model.sample_action(
            batch["spatial_info"], batch["entity_info"], batch["scalar_info"],
            batch["entity_num"], self.hidden, noise=noise)
        self.hidden = self._merge_hidden(out.pop("hidden_state"), self.hidden, active)
        host = to_host(out)
        return [_slot_view(host, i) for i in range(self.num_slots)]

    def _merge_hidden(self, new, old, active: Optional[List[bool]]):
        if active is None or all(active):
            return new
        mask = torch.as_tensor(np.asarray(active, bool), device=self.device)[:, None]
        return tuple((torch.where(mask, nh, oh), torch.where(mask, nc, oc))
                     for (nh, nc), (oh, oc) in zip(new, old))

    @torch.no_grad()
    def teacher_logits(self, prepared: List[dict], teacher_hidden, outputs: List[dict],
                       active: Optional[List[bool]] = None):
        """Teacher-forced logits of the installed teacher for the freshly
        sampled actions in ``outputs`` (``sample``'s per-slot dicts);
        returns (per-slot logit dicts, the new teacher hidden: inactive
        slots keep the old carry)."""
        batch = to_device(F.batch_tree(prepared), self.device)
        action_info = to_device(F.batch_tree([o["action_info"] for o in outputs]), self.device)
        sun = to_device(np.stack([np.asarray(o["selected_units_num"]) for o in outputs]), self.device)
        out = self.teacher_model.teacher_logits(
            batch["spatial_info"], batch["entity_info"], batch["scalar_info"],
            batch["entity_num"], teacher_hidden, action_info, sun)
        merged = self._merge_hidden(out["hidden_state"], teacher_hidden, active)
        host = to_host(out["logit"])
        return [_slot_view(host, i) for i in range(self.num_slots)], merged

    def teacher_step(self, prepared: List[dict], outputs: List[dict],
                     active: Optional[List[bool]] = None) -> List[dict]:
        """The teacher forward over the installed teacher weights and the
        per-slot teacher carries (advanced here; inactive slots keep
        theirs). Requires ``teacher_params`` to be installed."""
        if self.teacher_params is None:
            raise RuntimeError("teacher_step: no teacher params installed "
                               "(set_teacher_params / teacher_params constructor argument)")
        per_slot, self.teacher_hidden = self.teacher_logits(
            prepared, self.teacher_hidden, outputs, active)
        return per_slot

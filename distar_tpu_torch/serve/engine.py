"""Engines: the fixed-shape batched forward the gateway flushes into.

Counterpart of ``distar_tpu.serve.engine``. An engine owns ``num_slots``
lanes of recurrent state and exposes the surface the batcher needs:

  * ``forward(prepared, active)`` — one batched step over all slots;
    inactive lanes are padding (their outputs are discarded and their
    hidden state must not advance)
  * ``reset_slot(idx)``           — zero one lane's carry (episode reset)
  * ``set_params(params)``        — install new weights (hot swap)
  * ``teacher_forward(prepared, outputs, active)`` (gated by
    ``has_teacher``) — teacher-forced logits for the freshly sampled
    actions, advancing per-slot teacher carries on ``active`` lanes only
  * ``hidden_for_slot(idx)``      — the lane's current policy carry

``BatchedInferenceEngine`` adapts ``actor.inference.BatchedInference``;
``MockModelEngine`` is a CPU stand-in with observable per-slot dynamics for
the frontend tests and ``bin/serve.py --mock``.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional

import numpy as np


class BatchedInferenceEngine:
    """Serve-side adapter over one ``BatchedInference`` (one player model)."""

    def __init__(self, infer):
        self._infer = infer

    @property
    def num_slots(self) -> int:
        return self._infer.num_slots

    @property
    def device(self):
        return self._infer.device

    @property
    def has_teacher(self) -> bool:
        return self._infer.teacher_params is not None

    def forward(self, prepared: List[dict], active: List[bool]) -> List[dict]:
        return self._infer.sample(prepared, active)

    def teacher_forward(self, prepared: List[dict], outputs: List[dict],
                        active: List[bool]) -> List[dict]:
        return self._infer.teacher_step(prepared, outputs, active)

    def reset_slot(self, idx: int) -> None:
        self._infer.reset_slot(idx)

    def set_params(self, params) -> None:
        self._infer.set_params(params)

    def set_teacher_params(self, params) -> None:
        self._infer.set_teacher_params(params)

    def hidden_for_slot(self, idx: int):
        return self._infer.hidden_for_slot(idx)

    def warmup(self, template_obs: dict, params=None) -> float:
        """One throwaway forward off the serving path on scratch hidden
        state; touches neither the live params nor any slot's carry.
        Returns wall seconds."""
        t0 = time.perf_counter()
        self._infer.warmup(template_obs, params=params)
        return time.perf_counter() - t0


class MockModelEngine:
    """Deterministic mock with real engine semantics, no model.

    Per-slot "hidden state" is a step counter that only advances on active
    lanes — sticky-session and reset bugs show up as wrong counters. Outputs
    echo the serving version (from params) so hot-swap tests can assert
    which weights served each request. ``delay_s`` models device time; the
    sleep releases the GIL like a real device dispatch, so concurrent
    submitters pile up behind it exactly as they would behind a device step.
    """

    def __init__(self, num_slots: int, params: Optional[dict] = None,
                 delay_s: float = 0.0, teacher_params: Optional[dict] = None):
        self.num_slots = num_slots
        self.params = dict(params or {"version": "v0", "bias": 0.0})
        self.delay_s = delay_s
        self.teacher_params = dict(teacher_params) if teacher_params else None
        self.steps = np.zeros(num_slots, dtype=np.int64)
        self.teacher_steps = np.zeros(num_slots, dtype=np.int64)
        self.forward_calls = 0
        self.teacher_calls = 0
        self.warmup_calls = 0
        self._lock = threading.Lock()

    @property
    def has_teacher(self) -> bool:
        return self.teacher_params is not None

    def warmup(self, template_obs: dict, params=None) -> float:
        if self.delay_s:
            time.sleep(self.delay_s)
        with self._lock:
            self.warmup_calls += 1
        return self.delay_s

    def set_params(self, params) -> None:
        with self._lock:
            self.params = dict(params)

    def set_teacher_params(self, params) -> None:
        with self._lock:
            self.teacher_params = dict(params)

    def reset_slot(self, idx: int) -> None:
        with self._lock:
            self.steps[idx] = 0
            self.teacher_steps[idx] = 0

    def hidden_for_slot(self, idx: int):
        with self._lock:
            return {"step": int(self.steps[idx])}

    def _device_time(self) -> None:
        if self.delay_s > 0:
            time.sleep(self.delay_s)

    def forward(self, prepared: List[dict], active: List[bool]) -> List[dict]:
        assert len(prepared) == self.num_slots and len(active) == self.num_slots
        self._device_time()
        with self._lock:
            self.forward_calls += 1
            params = dict(self.params)
            # inactive lanes are padding by contract (their outputs are
            # discarded and must not be consumed): skip their work
            outs: List[dict] = [None] * self.num_slots  # type: ignore[list-item]
            for i in range(self.num_slots):
                if not active[i]:
                    continue
                self.steps[i] += 1
                x = prepared[i].get("x", 0.0)
                outs[i] = {
                    "action": np.asarray(np.sum(x) + params.get("bias", 0.0)),
                    "step": int(self.steps[i]),
                    "version": params.get("version"),
                }
            return outs

    def teacher_forward(self, prepared: List[dict], outputs: List[dict],
                        active: List[bool]) -> List[dict]:
        """Teacher-forced mock: advances the per-slot TEACHER counter on
        active lanes only and echoes the teacher version, so carry semantics
        (reset zeroes it, inactive lanes keep theirs) are assertable."""
        assert len(prepared) == self.num_slots and len(active) == self.num_slots
        if self.teacher_params is None:
            raise RuntimeError("teacher_forward: no teacher params installed")
        self._device_time()
        with self._lock:
            self.teacher_calls += 1
            tparams = dict(self.teacher_params)
            outs: List[dict] = [None] * self.num_slots  # type: ignore[list-item]
            for i in range(self.num_slots):
                if not active[i]:
                    continue
                self.teacher_steps[i] += 1
                outs[i] = {
                    "teacher_step": int(self.teacher_steps[i]),
                    "teacher_version": tparams.get("version"),
                }
            return outs

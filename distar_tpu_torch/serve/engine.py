"""The engine the gateway flushes into.

Counterpart of ``distar_tpu.serve.engine.BatchedInferenceEngine``: the
serve-side adapter over one ``actor.inference.BatchedInference``, exposing
``forward(prepared, active)``, ``reset_slot``, ``set_params``,
``hidden_for_slot`` and ``warmup``.
"""
from __future__ import annotations

import time
from typing import List


class BatchedInferenceEngine:
    def __init__(self, infer):
        self._infer = infer

    @property
    def num_slots(self) -> int:
        return self._infer.num_slots

    @property
    def device(self):
        return self._infer.device

    def forward(self, prepared: List[dict], active: List[bool]) -> List[dict]:
        return self._infer.sample(prepared, active)

    def reset_slot(self, idx: int) -> None:
        self._infer.reset_slot(idx)

    def set_params(self, params) -> None:
        self._infer.set_params(params)

    def hidden_for_slot(self, idx: int):
        return self._infer.hidden_for_slot(idx)

    def warmup(self, template_obs: dict, params=None) -> float:
        """One throwaway forward off the serving path; returns wall seconds."""
        t0 = time.perf_counter()
        self._infer.warmup(template_obs, params=params)
        return time.perf_counter() - t0

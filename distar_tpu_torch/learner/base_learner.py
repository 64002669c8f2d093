"""The learner skeleton: config cascade, optimizer construction, run loop.

Counterpart of the parts of ``distar_tpu.learner.base_learner`` that the SL,
RL and distillation learners use. Checkpoints and the admin save (ROADMAP
Queue 1 item 4), hooks, prefetch, the profiler hooks and the training-
dynamics tree (item 9) of the JAX learner are not ported yet: asking for
one raises ``NotImplementedError``.
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, Iterable, Optional

import torch

from ..actor.inference import resolve_device
from ..parallel import GradClipConfig, build_optimizer
from ..utils import Config, deep_merge_dicts

DEFAULT_LEARNER_CONFIG = Config(
    {
        "learner": {
            "learning_rate": 1e-5,
            "log_freq": 100,
            "max_iterations": 10 ** 9,
            "grad_clip": {"type": "none", "threshold": 1.0},
        },
    }
)


def host_scalars(info: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Every 0-d tensor of ``info`` on the host, in one device -> host copy."""
    device = next(iter(info.values())).device
    values = torch.stack([v.to(device, torch.float32) for v in info.values()]).cpu().tolist()
    return dict(zip(info, values))


class BaseLearner:
    """Subclasses build their state in ``_setup_state`` and take one
    optimisation step per ``_train(batch)``, returning the step's scalars.
    ``_CAP_FN`` is the batch layout's entity cap (``learner/data.py``)."""

    _CAP_FN = None

    def __init__(self, cfg: Optional[dict] = None, device=None):
        self.cfg = deep_merge_dicts(DEFAULT_LEARNER_CONFIG, cfg or {})
        if self.cfg.learner.get("dynamics"):
            raise NotImplementedError("learner.dynamics: the training-dynamics tree is not ported "
                                      "yet (ROADMAP Queue 1 item 9, obs/dynamics.py)")
        self.device = resolve_device(device)
        self.last_iter = 0
        self.last_log: Dict[str, float] = {}
        self._dataloader = None
        self._setup_dataloader()
        self._setup_state()

    def _build_optimizer(self, params: Iterable[torch.Tensor]):
        """learning_rate, betas, eps, weight_decay and the ``grad_clip``
        block of the learner config, through ``parallel.build_optimizer``."""
        lc = self.cfg.learner
        return build_optimizer(
            params,
            learning_rate=lc.learning_rate,
            betas=tuple(lc.get("betas", (0.0, 0.99))),
            eps=lc.get("eps", 1e-5),
            weight_decay=float(lc.get("weight_decay", 0.0) or 0.0),
            clip=GradClipConfig(**lc.grad_clip),
        )

    def _cap(self, batch):
        """``_CAP_FN`` to ``learner.max_entities`` slots where that is set."""
        n = self.cfg.learner.get("max_entities")
        return self._CAP_FN(batch, int(n)) if n else batch

    def checkpoint_path(self) -> str:
        raise NotImplementedError("checkpoints are not ported yet (ROADMAP Queue 1 item 4)")

    def save(self, path: str, sync: bool = False) -> None:
        raise NotImplementedError("checkpoints are not ported yet (ROADMAP Queue 1 item 4)")

    def request_save(self) -> None:
        raise NotImplementedError("the admin save is not ported yet (ROADMAP Queue 1 item 4)")

    def _setup_state(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def _setup_dataloader(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def _train(self, data) -> Dict[str, Any]:  # pragma: no cover - abstract
        raise NotImplementedError

    def run(self, max_iterations: Optional[int] = None) -> None:
        """Train until ``last_iter`` reaches ``max_iterations``, printing one
        JSON line of the step's scalars (no per-parameter norms) every
        ``learner.log_freq`` steps."""
        max_iterations = max_iterations or self.cfg.learner.max_iterations
        log_freq = max(int(self.cfg.learner.log_freq), 1)
        while self.last_iter < max_iterations:
            data = next(self._dataloader)
            t0 = time.perf_counter()
            self.last_log = self._train(data)
            train_s = time.perf_counter() - t0
            self.last_iter += 1
            if self.last_iter % log_freq == 0:
                scalars = {k: v for k, v in self.last_log.items() if "/" not in k}
                print(json.dumps({"learner": type(self).__name__.lower(), "iter": self.last_iter,
                                  "train_time": train_s, **scalars}), flush=True)

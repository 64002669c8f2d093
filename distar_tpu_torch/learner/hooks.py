"""Hooks: the learner's extension points.

Counterpart of ``distar_tpu.learner.hooks``. A hook attaches at one of
``before_run``, ``before_iter``, ``after_iter`` and ``after_run`` with a
priority (lower runs first); at the iteration positions a ``freq`` above 1
runs it only when ``last_iter`` is a multiple of it. The stock set loads a
checkpoint (``learner.load_path``), saves one every ``save_freq`` steps and
at the end of a run, folds each step's scalars into the meters, shows them
every ``log_freq`` steps and exports the metrics registry as JSON lines;
with ``profile_freq`` above 0, ``ProfilerHook`` captures a
``torch.profiler`` trace every ``profile_freq`` steps.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List

POSITIONS = ("before_run", "before_iter", "after_iter", "after_run")


class Hook:
    def __init__(self, name: str, position: str, priority: int = 50, freq: int = 1):
        if position not in POSITIONS:
            raise ValueError(f"hook position {position!r} is not one of {POSITIONS}")
        self.name = name
        self.position = position
        self.priority = priority
        self.freq = freq

    def __call__(self, learner) -> None:  # pragma: no cover - abstract
        raise NotImplementedError


class LambdaHook(Hook):
    def __init__(self, name, position, fn: Callable, priority: int = 50, freq: int = 1):
        super().__init__(name, position, priority, freq)
        self._fn = fn

    def __call__(self, learner) -> None:
        self._fn(learner)


class HookRegistry:
    def __init__(self):
        self._hooks: Dict[str, List[Hook]] = {p: [] for p in POSITIONS}

    def add(self, hook: Hook) -> None:
        self._hooks[hook.position].append(hook)
        self._hooks[hook.position].sort(key=lambda h: h.priority)

    def call(self, position: str, learner) -> None:
        for hook in self._hooks[position]:
            if position in ("before_iter", "after_iter") and hook.freq > 1:
                if learner.last_iter.val % hook.freq != 0:
                    continue
            hook(learner)


class LoadCkptHook(Hook):
    """before_run: restore ``learner.load_path`` where it exists."""

    def __init__(self, priority=20):
        super().__init__("load_ckpt", "before_run", priority)

    def __call__(self, learner) -> None:
        path = learner.cfg.learner.get("load_path", "")
        if path and os.path.exists(path):
            learner.restore(path)
            learner.logger.info(f"loaded checkpoint {path} @ iter {learner.last_iter.val}")


class SaveCkptHook(Hook):
    """after_iter every ``freq`` steps, and after_run: rank 0 saves a
    checkpoint. On a mesh every rank saves: each writes its shards of a
    sharded checkpoint, and rank 0 alone a whole one (``BaseLearner.save``)."""

    def __init__(self, position="after_iter", priority=20, freq=1000):
        super().__init__("save_ckpt", position, priority, freq)

    def __call__(self, learner) -> None:
        if learner.rank != 0 and getattr(learner, "mesh", None) is None:
            return
        path = learner.checkpoint_path()
        learner.save(path)
        if learner.rank == 0:
            learner.logger.info(f"saved checkpoint {path}")


class LogShowHook(Hook):
    """after_iter every ``freq`` steps: the meter table to the text log,
    the meters' averages to the scalar sink."""

    def __init__(self, priority=80, freq=100):
        super().__init__("log_show", "after_iter", priority, freq)

    def __call__(self, learner) -> None:
        if learner.rank != 0:
            return
        it = learner.last_iter.val
        record = learner.variable_record
        learner.logger.info(f"=== iter {it} ===\n{record.get_vars_text()}")
        learner.scalar_sink.add_scalars({k: m.avg for k, m in record.vars().items()}, global_step=it)


class LogReduceHook(Hook):
    """after_iter: the step's scalars into the meters."""

    def __init__(self, priority=10):
        super().__init__("log_reduce", "after_iter", priority)

    def __call__(self, learner) -> None:
        learner.variable_record.update_var(
            {k: float(v) for k, v in learner.log_buffer.items() if _is_scalar(v)})
        learner.log_buffer.clear()


def _is_scalar(v) -> bool:
    try:
        float(v)
        return True
    except (TypeError, ValueError):
        return False


class MetricsExportHook(Hook):
    """after_iter every ``freq`` steps: the metrics registry to
    ``<save_dir>/logs/obs/scalars.jsonl``."""

    def __init__(self, priority=85, freq=100):
        super().__init__("metrics_export", "after_iter", priority, freq)

    def __call__(self, learner) -> None:
        if learner.rank != 0:
            return
        exporter = getattr(learner, "_obs_exporter", None)
        if exporter is None:
            from ..obs import JsonlExporter

            exporter = learner._obs_exporter = JsonlExporter(
                os.path.join(learner.save_dir, "logs", "obs"), registry=learner.metrics)
        exporter.export(step=learner.last_iter.val)


class ProfilerHook(Hook):
    """after_iter: a freq-gated device trace (``obs.ProfilerSession``):
    every ``freq`` iterations start one, stop it ``duration`` iterations
    later. Runs at every iteration (registry freq 1) because the stop edge
    falls between gate points; the start gate is internal. Rank 0 only;
    profiler failures are logged, never fatal, and after
    ``MAX_CONSECUTIVE_FAILURES`` failed starts the hook retires itself."""

    MAX_CONSECUTIVE_FAILURES = 3

    def __init__(self, logdir: str, freq: int = 1000, duration: int = 2,
                 priority: int = 90, profiler=None):
        super().__init__("profiler", "after_iter", priority, freq=1)
        assert freq > 0 and duration > 0
        self._freq = freq
        self._duration = duration
        self._stop_at = None
        self._consecutive_failures = 0
        self.disabled = False
        from ..obs import ProfilerSession

        self.session = ProfilerSession(logdir, profiler=profiler)

    def __call__(self, learner) -> None:
        if learner.rank != 0 or self.disabled:
            return
        it = learner.last_iter.val
        if self.session.active:
            if it >= self._stop_at and self.session.stop():
                learner.logger.info(f"profiler trace captured -> "
                                    f"{self.session.last_profile_path or self.session.logdir}")
        elif it % self._freq == 0:
            if self.session.start():
                self._stop_at = it + self._duration
                self._consecutive_failures = 0
            else:
                self._consecutive_failures += 1
                if self._consecutive_failures >= self.MAX_CONSECUTIVE_FAILURES:
                    self.disabled = True
                    learner.logger.info(
                        f"profiler hook disabled after {self._consecutive_failures} consecutive "
                        f"start failures (logdir {self.session.logdir!r} unwritable?)")


def default_hooks(save_freq: int = 1000, log_freq: int = 100, profile_freq: int = 0,
                  profile_duration: int = 2, profile_logdir: str = "") -> HookRegistry:
    reg = HookRegistry()
    reg.add(LoadCkptHook())
    reg.add(SaveCkptHook(freq=save_freq))
    reg.add(SaveCkptHook(position="after_run"))
    reg.add(LogReduceHook())
    reg.add(LogShowHook(freq=log_freq))
    reg.add(MetricsExportHook(freq=log_freq))
    if profile_freq > 0:
        reg.add(ProfilerHook(profile_logdir, freq=profile_freq, duration=profile_duration))
    return reg

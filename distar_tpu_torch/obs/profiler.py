"""Device-profiler session wrapper + step-phase breakdown publication.

Counterpart of ``distar_tpu.obs.profiler``. ``ProfilerSession`` guards a
``torch.profiler`` capture behind availability checks (profiling is
best-effort telemetry: a missing or broken profiler must never take down
training) and counts sessions in the registry. It writes the capture as a
Chrome trace under ``<logdir>/plugins/profile/<stamp>/<host>.trace.json``,
the layout ``jax.profiler`` writes, so ``last_profile_path`` and the trace
analyser (``obs/traceview.py``) read it the same way. ``record_step_phases``
is the single choke point the learner run loop uses to publish its
data-wait / device-step / host-callback breakdown.
"""
from __future__ import annotations

import logging
import os
import socket
import time
from typing import Dict, Optional

from .registry import MetricsRegistry, get_registry


class TorchProfiler:
    """``start_trace(logdir)`` / ``stop_trace()`` over ``torch.profiler``:
    CPU activity always, CUDA activity where CUDA is available; the trace
    lands in ``<logdir>/plugins/profile/<UTC stamp>/<host>.trace.json``."""

    def __init__(self):
        self._prof = None
        self._logdir = None
        # the summed durations of the last capture's device activities, as
        # torch.profiler's own events read them (None on the CPU)
        self.device_busy_us = None

    def start_trace(self, logdir: str) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        if self._prof is not None:
            raise RuntimeError("a trace is already being captured")
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.__enter__()
        self._prof, self._logdir = prof, logdir

    def stop_trace(self) -> None:
        prof, logdir = self._prof, self._logdir
        if prof is None:
            raise RuntimeError("no trace is being captured")
        self._prof = self._logdir = None
        prof.__exit__(None, None, None)
        self.device_busy_us = None
        if any(str(a).endswith("CUDA") for a in prof.activities):
            # kineto's own event list: cheaper than prof.events()'s tree
            self.device_busy_us = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                                      if str(e.device_type()).endswith("CUDA")) / 1e3
        stamp = time.strftime("%Y_%m_%d_%H_%M_%S", time.gmtime())
        out = os.path.join(logdir, "plugins", "profile", stamp)
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, f"{socket.gethostname()}.trace.json"))


class ProfilerSession:
    """Start/stop wrapper for the device profiler.

    ``profiler`` is injectable (tests pass a stub with ``start_trace`` /
    ``stop_trace``); the default is a ``TorchProfiler``. Failures are never
    fatal but not silent either: each failed start/stop counts
    ``distar_profiler_failures_total{stage=...}``, and a successful stop
    records ``last_profile_path`` — the newest capture dir under the logdir,
    what the admin ``/profile`` route hands to the trace analyser."""

    def __init__(self, logdir: str, profiler=None, registry: Optional[MetricsRegistry] = None):
        self.logdir = logdir
        self.active = False
        self.failures = 0
        self.last_profile_path: Optional[str] = None
        self._profiler = profiler
        self._registry = registry

    def _resolve(self):
        if self._profiler is None:
            self._profiler = TorchProfiler()
        return self._profiler

    def _count_failure(self, stage: str) -> None:
        self.failures += 1
        reg = self._registry or get_registry()
        reg.counter(
            "distar_profiler_failures_total",
            "profiler start/stop failures (best-effort, training continues)",
            stage=stage,
        ).inc()

    def start(self) -> bool:
        if self.active:
            return True
        try:
            # an unwritable logdir fails HERE, typed, instead of throwing a
            # whole captured session away at stop
            os.makedirs(self.logdir, exist_ok=True)
            self._resolve().start_trace(self.logdir)
        except Exception as e:  # best-effort: never kill training over a trace
            logging.warning("profiler start_trace failed: %r", e)
            self._count_failure("start")
            return False
        self.active = True
        reg = self._registry or get_registry()
        reg.counter("distar_profiler_sessions_total", "profiler traces started").inc()
        return True

    def stop(self) -> bool:
        if not self.active:
            return False
        self.active = False
        try:
            self._resolve().stop_trace()
        except Exception as e:
            logging.warning("profiler stop_trace failed: %r", e)
            self._count_failure("stop")
            return False
        self.last_profile_path = self._newest_capture() or self.logdir
        return True

    def _newest_capture(self) -> Optional[str]:
        """Newest session dir under ``<logdir>/plugins/profile/``; None
        when nothing landed."""
        root = os.path.join(self.logdir, "plugins", "profile")
        try:
            stamps = [os.path.join(root, d) for d in os.listdir(root)]
            stamps = [d for d in stamps if os.path.isdir(d)]
            return max(stamps, key=os.path.getmtime) if stamps else None
        except OSError:
            return None


_PHASES = ("data_wait", "device_step", "host_callback")


def record_step_phases(
    phases: Dict[str, float], registry: Optional[MetricsRegistry] = None
) -> None:
    """Publish one train iteration's phase breakdown (seconds) into
    ``distar_learner_step_phase_seconds{phase=...}`` histograms."""
    reg = registry or get_registry()
    for phase, seconds in phases.items():
        reg.histogram(
            "distar_learner_step_phase_seconds",
            "learner step time by phase",
            phase=str(phase),
        ).observe(float(seconds))

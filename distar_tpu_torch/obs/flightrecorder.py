"""Crash flight recorder: bounded event ring + forensic dump on the way down.

Counterpart of ``distar_tpu.obs.flightrecorder``. Long-lived fleet processes
rarely die cleanly; the question after the fact is "what was happening in
the last minute". The recorder keeps a bounded ring of recent structured
events (alert transitions, kept span completions, checkpoint fallbacks,
restarts, breaker openings: anything a subsystem ``record()``s), and a
crash hook (unhandled exception, SIGTERM) dumps a forensic bundle to the
artifact directory: the event ring, a full registry snapshot, the run
config and the interpreter and library versions, as plain JSON that
outlives the process. The bundle's keys are the JAX package's; its
``versions`` name torch, torch's CUDA build and numpy where the JAX
package names jax and numpy.
"""
from __future__ import annotations

import json
import os
import platform
import signal
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, List, Optional

from .registry import MetricsRegistry, get_registry


def _versions() -> Dict[str, str]:
    out = {
        "python": platform.python_version(),
        "platform": platform.platform(),
    }
    for mod in ("torch", "numpy"):
        m = sys.modules.get(mod)  # never import heavyweight deps from a crash path
        v = getattr(m, "__version__", None) if m is not None else None
        if v:
            out[mod] = str(v)
    torch = sys.modules.get("torch")
    cuda = getattr(getattr(torch, "version", None), "cuda", None)
    if cuda:
        out["torch_cuda"] = str(cuda)
    return out


class FlightRecorder:
    """Thread-safe bounded ring of structured events + crash-dump hooks."""

    def __init__(self, maxlen: int = 512):
        assert maxlen > 0
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=maxlen)
        self._seq = 0
        self._hook_installed = False
        self._prev_excepthook = None
        self._prev_sigterm = None
        self._dump_args: Dict[str, Any] = {}
        self._crash_callbacks: List[Any] = []
        self.last_dump_path: Optional[str] = None

    # ------------------------------------------------------- crash callbacks
    def add_crash_callback(self, fn) -> None:
        """Register a cleanup to run whenever a crash bundle is dumped —
        resource reclamation that must happen even on an unclean exit (the
        shm transport unlinks its live rings here so a crashed fleet
        leaves no /dev/shm litter). Idempotent per callable; every failure
        is swallowed (cleanup must never raise over the crash)."""
        with self._lock:
            if fn not in self._crash_callbacks:
                self._crash_callbacks.append(fn)

    def _run_crash_callbacks(self) -> None:
        with self._lock:
            callbacks = list(self._crash_callbacks)
        for fn in callbacks:
            try:
                fn()
            except Exception:
                pass

    # ----------------------------------------------------------------- events
    def record(self, kind: str, **fields) -> dict:
        """Append one structured event; returns it (with ts + seq stamped)."""
        with self._lock:
            self._seq += 1
            event = {"seq": self._seq, "ts": time.time(), "kind": str(kind), **fields}
            self._events.append(event)
        return event

    def events(self, limit: Optional[int] = None, kind: Optional[str] = None) -> List[dict]:
        with self._lock:
            out = list(self._events)
        if kind is not None:
            out = [e for e in out if e.get("kind") == kind]
        return out[-limit:] if limit else out

    # ------------------------------------------------------------------ dumps
    def dump(self, artifact_dir: str, reason: str, config: Optional[dict] = None,
             registry: Optional[MetricsRegistry] = None,
             extra: Optional[dict] = None) -> str:
        """Write the forensic bundle; returns its path. Every failure mode
        short of the filesystem itself is swallowed into the bundle — a crash
        dump must not raise over the crash it is documenting."""
        self._run_crash_callbacks()
        reg = registry or get_registry()
        try:
            snapshot = reg.snapshot()
        except Exception as e:
            snapshot = {"__snapshot_error__": repr(e)}
        bundle = {
            "ts": time.time(),
            "reason": str(reason),
            "pid": os.getpid(),
            "versions": _versions(),
            "config": config if config is not None else self._dump_args.get("config"),
            "events": self.events(),
            "registry_snapshot": snapshot,
        }
        if extra:
            bundle.update(extra)
        os.makedirs(artifact_dir, exist_ok=True)
        fname = f"flight_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"
        path = os.path.join(artifact_dir, fname)
        with open(path, "w") as f:
            json.dump(bundle, f, indent=1, default=str)
        self.last_dump_path = path
        return path

    # ------------------------------------------------------------- crash hook
    def install_crash_hook(self, artifact_dir: str, config: Optional[dict] = None,
                           registry: Optional[MetricsRegistry] = None,
                           handle_sigterm: bool = True) -> None:
        """Chain onto ``sys.excepthook`` (unhandled exception -> bundle, then
        the previous hook runs) and, from the main thread, onto SIGTERM
        (bundle, then the previous disposition). Idempotent per recorder."""
        if self._hook_installed:
            self._dump_args = {"artifact_dir": artifact_dir, "config": config,
                               "registry": registry}
            return
        self._dump_args = {"artifact_dir": artifact_dir, "config": config,
                           "registry": registry}
        self._prev_excepthook = sys.excepthook

        def _excepthook(exc_type, exc, tb):
            try:
                self.record(
                    "crash",
                    error=repr(exc),
                    traceback="".join(traceback.format_exception(exc_type, exc, tb))[-8000:],
                )
                self.dump(
                    self._dump_args["artifact_dir"],
                    reason=f"unhandled:{getattr(exc_type, '__name__', exc_type)}",
                    config=self._dump_args.get("config"),
                    registry=self._dump_args.get("registry"),
                )
            except Exception:
                pass
            prev = self._prev_excepthook or sys.__excepthook__
            prev(exc_type, exc, tb)

        sys.excepthook = _excepthook

        if handle_sigterm:
            def _on_sigterm(signum, frame):
                try:
                    self.record("signal", signum=signum)
                    self.dump(
                        self._dump_args["artifact_dir"],
                        reason=f"signal:{signum}",
                        config=self._dump_args.get("config"),
                        registry=self._dump_args.get("registry"),
                    )
                except Exception:
                    pass
                prev = self._prev_sigterm
                if callable(prev):
                    prev(signum, frame)
                elif prev == signal.SIG_DFL:
                    signal.signal(signal.SIGTERM, signal.SIG_DFL)
                    os.kill(os.getpid(), signal.SIGTERM)

            try:  # only the main thread may set signal handlers
                self._prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
            except ValueError:
                self._prev_sigterm = None
        self._hook_installed = True

    def uninstall_crash_hook(self) -> None:
        if not self._hook_installed:
            return
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
            self._prev_excepthook = None
        if self._prev_sigterm is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            except ValueError:
                pass
            self._prev_sigterm = None
        self._hook_installed = False


_recorder_lock = threading.Lock()
_recorder: Optional[FlightRecorder] = None


def get_flight_recorder() -> FlightRecorder:
    """The process-wide default recorder (created on first use)."""
    global _recorder
    with _recorder_lock:
        if _recorder is None:
            _recorder = FlightRecorder()
        return _recorder


def set_flight_recorder(recorder: Optional[FlightRecorder]) -> Optional[FlightRecorder]:
    """Swap the process default (tests install a fresh one); returns the
    previous recorder."""
    global _recorder
    with _recorder_lock:
        prev = _recorder
        _recorder = recorder
        return prev

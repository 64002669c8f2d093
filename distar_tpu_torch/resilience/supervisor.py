"""Role supervision: restart a crashed role instead of losing the run.

Counterpart of ``distar_tpu.resilience.supervisor``:

* ``Supervisor`` runs named background tasks on watchdog threads; a crash
  is counted, backed off and restarted within a ``RestartPolicy`` (at most
  so many restarts in a sliding window, then give up). Each task gets a
  ``TaskContext`` to poll for a stop or a requested restart.
* ``supervise_call`` supervises the role that owns the calling thread (the
  learner): run, and on a crash call ``on_restart`` (resume from the latest
  checkpoint) and run again under the same budget; the last failure is
  re-raised.
* ``AlertRemediator`` bridges the health layer (``obs/health.py``): a
  firing rule mapped to a task requests a cooperative restart of it,
  closing the detect -> remediate loop.

Every restart and give-up counts in ``distar_resilience_restarts_total`` and
``distar_resilience_task_giveups_total`` (label ``task``) and is recorded as
a flight-recorder event (``task_restart``, ``task_giveup``); a remediation
counts in ``distar_resilience_remediations_total`` (label ``rule``) and
records a ``remediation`` event.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional


def _metrics():
    from ..obs import get_registry

    return get_registry()


def _recorder():
    from ..obs import get_flight_recorder

    return get_flight_recorder()


def _count_restart(task: str, reason: str, restart_no: int) -> None:
    _metrics().counter("distar_resilience_restarts_total", "supervised task restarts",
                       task=task).inc()
    _recorder().record("task_restart", task=task, reason=reason, restart_no=restart_no)


def _count_giveup(task: str, reason: str, restarts: int) -> None:
    _metrics().counter("distar_resilience_task_giveups_total",
                       "supervised tasks abandoned (restart budget exhausted)", task=task).inc()
    _recorder().record("task_giveup", task=task, reason=reason, restarts=restarts)


@dataclass(frozen=True)
class RestartPolicy:
    """At most ``max_restarts`` within ``window_s`` (sliding), with
    exponential backoff between restarts."""

    max_restarts: int = 5
    window_s: float = 300.0
    backoff_base_s: float = 0.5
    backoff_multiplier: float = 2.0
    backoff_max_s: float = 30.0

    def backoff_s(self, restart_no: int) -> float:
        return min(self.backoff_base_s * (self.backoff_multiplier ** restart_no), self.backoff_max_s)


def _budget_ok(window: deque, policy: RestartPolicy) -> bool:
    """Room for one more restart in the sliding window (and take it)."""
    now = time.monotonic()
    while window and now - window[0] > policy.window_s:
        window.popleft()
    if len(window) >= policy.max_restarts:
        return False
    window.append(now)
    return True


class TaskContext:
    """What a supervised target polls: ``should_exit`` (a stop or a restart
    was requested) at its loop boundaries. Returning with a restart pending
    re-enters the target instead of retiring the task."""

    def __init__(self):
        self._stop = threading.Event()
        self._restart = threading.Event()
        self.restart_reason: Optional[str] = None

    @property
    def stop_requested(self) -> bool:
        return self._stop.is_set()

    @property
    def restart_requested(self) -> bool:
        return self._restart.is_set()

    @property
    def should_exit(self) -> bool:
        return self._stop.is_set() or self._restart.is_set()

    def request_stop(self) -> None:
        self._stop.set()

    def request_restart(self, reason: str = "") -> None:
        self.restart_reason = reason or self.restart_reason
        self._restart.set()

    def sleep(self, seconds: float) -> bool:
        """Interruptible sleep; True when the task should exit."""
        return self._stop.wait(seconds) or self._restart.is_set()


class _Task:
    def __init__(self, name, target, policy, on_restart, on_giveup):
        self.name = name
        self.target = target
        self.policy = policy
        self.on_restart = on_restart
        self.on_giveup = on_giveup
        self.ctx = TaskContext()
        self.thread: Optional[threading.Thread] = None
        self.restarts = 0
        self.gave_up = False
        self.finished = False
        self.last_error: Optional[str] = None
        self.restart_times: deque = deque()


class Supervisor:
    """A set of supervised background tasks, one watchdog thread each."""

    def __init__(self, policy: Optional[RestartPolicy] = None):
        self.default_policy = policy or RestartPolicy()
        self._tasks: Dict[str, _Task] = {}
        self._lock = threading.Lock()
        self._started = False

    def add(self, name: str, target: Callable[[TaskContext], None],
            policy: Optional[RestartPolicy] = None,
            on_restart: Optional[Callable[[BaseException], None]] = None,
            on_giveup: Optional[Callable[[BaseException], None]] = None) -> "Supervisor":
        with self._lock:
            if name in self._tasks:
                raise ValueError(f"duplicate task {name!r}")
            task = _Task(name, target, policy or self.default_policy, on_restart, on_giveup)
            self._tasks[name] = task
            if self._started:
                self._spawn(task)
        return self

    def start(self) -> "Supervisor":
        with self._lock:
            if not self._started:
                self._started = True
                for task in self._tasks.values():
                    self._spawn(task)
        return self

    def stop(self, timeout: float = 10.0) -> None:
        with self._lock:
            tasks = list(self._tasks.values())
            self._started = False
        for task in tasks:
            task.ctx.request_stop()
        deadline = time.monotonic() + timeout
        for task in tasks:
            if task.thread is not None:
                task.thread.join(max(0.0, deadline - time.monotonic()))

    def _spawn(self, task: _Task) -> None:
        task.thread = threading.Thread(target=self._run, args=(task,), name=f"supervised-{task.name}",
                                       daemon=True)
        task.thread.start()

    def _run(self, task: _Task) -> None:
        while not task.ctx.stop_requested:
            task.ctx._restart.clear()
            error: Optional[BaseException] = None
            try:
                task.target(task.ctx)
            except BaseException as e:  # noqa: BLE001 - the watchdog records and restarts
                error = e
            if task.ctx.stop_requested:
                break
            if error is None and not task.ctx.restart_requested:
                break  # retired cleanly
            reason = (repr(error) if error is not None
                      else f"remediation:{task.ctx.restart_reason or 'requested'}")
            cause = error if error is not None else RuntimeError(reason)
            task.last_error = reason
            if not _budget_ok(task.restart_times, task.policy):
                task.gave_up = True
                _count_giveup(task.name, reason, task.restarts)
                if task.on_giveup is not None:
                    try:
                        task.on_giveup(cause)
                    except Exception:  # noqa: BLE001 - a callback must not kill the watchdog
                        pass
                break
            restart_no = task.restarts
            task.restarts += 1
            _count_restart(task.name, reason, task.restarts)
            if task.on_restart is not None:
                try:
                    task.on_restart(cause)
                except Exception:  # noqa: BLE001 - a callback must not kill the watchdog
                    pass
            if task.ctx._stop.wait(task.policy.backoff_s(restart_no)):
                break
        task.finished = True

    def restart(self, name: str, reason: str = "") -> bool:
        """Ask a live task to restart cooperatively."""
        with self._lock:
            task = self._tasks.get(name)
        if task is None or task.gave_up or task.finished:
            return False
        task.ctx.request_restart(reason)
        return True

    def status(self) -> Dict[str, dict]:
        with self._lock:
            return {name: {"alive": task.thread.is_alive() if task.thread else False,
                           "restarts": task.restarts, "gave_up": task.gave_up,
                           "last_error": task.last_error}
                    for name, task in self._tasks.items()}

    def join(self, timeout: Optional[float] = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            tasks = list(self._tasks.values())
        for task in tasks:
            if task.thread is not None:
                task.thread.join(None if deadline is None else max(0.0, deadline - time.monotonic()))


def supervise_call(fn: Callable[[], None], op: str = "main",
                   policy: Optional[RestartPolicy] = None,
                   on_restart: Optional[Callable[[BaseException], None]] = None,
                   sleep: Callable[[float], None] = time.sleep) -> None:
    """Run ``fn`` on this thread; on a crash call ``on_restart(error)`` and
    run it again, within ``policy``'s budget. A crash past the budget is
    re-raised, and ``KeyboardInterrupt`` and ``SystemExit`` always are."""
    policy = policy or RestartPolicy()
    window: deque = deque()
    restart_no = 0
    while True:
        try:
            return fn()
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:  # noqa: BLE001 - restarted or re-raised
            if not _budget_ok(window, policy):
                _count_giveup(op, repr(e), restart_no)
                raise
            _count_restart(op, repr(e), restart_no + 1)
            if on_restart is not None:
                on_restart(e)
            sleep(policy.backoff_s(restart_no))
            restart_no += 1


class AlertRemediator:
    """Health alerts into supervised restarts.

    ``mapping`` routes a firing rule name to a supervised task name; when
    the ``HealthEvaluator`` emits a ``firing`` transition for a mapped rule
    the remediator requests a cooperative restart of that task. The
    debounce lives in the rules engine: exactly one firing event per
    incident means exactly one remediation per incident."""

    def __init__(self, supervisor: Supervisor, mapping: Mapping[str, str]):
        self.supervisor = supervisor
        self.mapping = dict(mapping)

    def attach(self, evaluator) -> "AlertRemediator":
        evaluator.add_transition_callback(self.on_event)
        return self

    def on_event(self, event: dict) -> None:
        if event.get("state") != "firing":
            return
        task = self.mapping.get(event.get("rule"))
        if task is None:
            return
        if self.supervisor.restart(task, reason=f"alert:{event.get('rule')}"):
            # rule names are bounded by the declarative rulebook, never by
            # request data
            _metrics().counter(
                "distar_resilience_remediations_total",
                "alert-triggered supervised restarts", rule=event.get("rule"),
            ).inc()
            _recorder().record("remediation", rule=event.get("rule"), task=task)

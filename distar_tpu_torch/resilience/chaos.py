"""Deterministic, seedable fault injector for chaos drills and tests.

Counterpart of ``distar_tpu.resilience.chaos``. Verifying that a fleet heals
itself takes making it sick on purpose. The injector produces the faults a
week-long league run sees (connection drops, delays and resets, role
death, checkpoint truncation and bit flips, NaN losses, poisoned
parameters) from a seeded RNG, so a failing chaos run replays exactly. It
serves as a library and a pytest fixture (``restore()`` undoes every patch
on teardown), and as remediation-drill input: its faults fire the health
rules (``obs/health.py``) whose alerts the ``AlertRemediator`` turns into
supervised restarts.

Every injected fault is logged to ``self.events`` and the flight recorder,
so a post-mortem tells injected faults from organic ones.
"""
from __future__ import annotations

import os
import random
import signal
import threading
import time
from typing import Callable, List, Optional

from .policy import CommError


def _recorder():
    from ..obs import get_flight_recorder

    return get_flight_recorder()


class ChaosInjector:
    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)
        self.seed = seed
        self.events: List[dict] = []
        self._patches: List[tuple] = []
        self._lock = threading.Lock()

    def _log(self, kind: str, **fields) -> None:
        event = {"ts": time.time(), "kind": kind, "seed": self.seed, **fields}
        with self._lock:
            self.events.append(event)
        _recorder().record(f"chaos_{kind}", **fields)

    # ------------------------------------------------------------- callables
    def wrap(self, fn: Callable, op: str = "", drop_p: float = 0.0,
             delay_p: float = 0.0, delay_s: float = 0.05, reset_p: float = 0.0,
             max_faults: Optional[int] = None) -> Callable:
        """Return ``fn`` wrapped with probabilistic faults (seeded, so a
        given seed yields the same fault schedule): ``drop`` raises
        ``CommError`` before the call, ``reset`` raises
        ``ConnectionResetError`` after it (the work happened but the reply
        was lost — the at-least-once case retries must tolerate), ``delay``
        sleeps first. ``max_faults`` bounds total injections."""
        op = op or getattr(fn, "__name__", "call")
        state = {"faults": 0}

        def chaotic(*args, **kwargs):
            budget_left = max_faults is None or state["faults"] < max_faults
            if budget_left and delay_p > 0 and self.rng.random() < delay_p:
                state["faults"] += 1
                self._log("delay", op=op, delay_s=delay_s)
                time.sleep(delay_s)
                budget_left = max_faults is None or state["faults"] < max_faults
            if budget_left and drop_p > 0 and self.rng.random() < drop_p:
                state["faults"] += 1
                self._log("drop", op=op)
                raise CommError(f"chaos: dropped {op}", op=op)
            result = fn(*args, **kwargs)
            budget_left = max_faults is None or state["faults"] < max_faults
            if budget_left and reset_p > 0 and self.rng.random() < reset_p:
                state["faults"] += 1
                self._log("reset", op=op)
                raise ConnectionResetError(f"chaos: reset after {op}")
            return result

        chaotic.__name__ = f"chaotic_{op}"
        return chaotic

    def fail_n_calls(self, fn: Callable, n: int = 1,
                     exc_factory: Optional[Callable[[], BaseException]] = None,
                     op: str = "") -> Callable:
        """Deterministic variant: the first ``n`` invocations raise, the
        rest pass through — the canonical "crash exactly once" fixture."""
        op = op or getattr(fn, "__name__", "call")
        state = {"left": n}

        def flaky(*args, **kwargs):
            if state["left"] > 0:
                state["left"] -= 1
                self._log("fail_call", op=op, remaining=state["left"])
                raise (exc_factory() if exc_factory
                       else CommError(f"chaos: injected failure in {op}", op=op))
            return fn(*args, **kwargs)

        return flaky

    def patch(self, obj, name: str, wrapper: Callable) -> None:
        """Install ``wrapper`` over ``obj.name``, remembering the original
        for ``restore()`` (fixture teardown)."""
        original = getattr(obj, name)
        self._patches.append((obj, name, original))
        setattr(obj, name, wrapper)

    def restore(self) -> None:
        while self._patches:
            obj, name, original = self._patches.pop()
            setattr(obj, name, original)

    # ------------------------------------------------------------------ files
    def truncate(self, path: str, keep_frac: float = 0.5) -> int:
        """Truncate a file to ``keep_frac`` of its size (a writer killed
        mid-write); returns the new size."""
        size = os.path.getsize(path)
        keep = int(size * keep_frac)
        with open(path, "rb+") as f:
            f.truncate(keep)
        self._log("truncate", path=path, old_size=size, new_size=keep)
        return keep

    def bitflip(self, path: str, flips: int = 8) -> List[int]:
        """Flip ``flips`` random bits in place (storage rot / torn sectors);
        returns the flipped byte offsets."""
        with open(path, "rb+") as f:
            data = bytearray(f.read())
            if not data:
                return []
            offsets = [self.rng.randrange(len(data)) for _ in range(flips)]
            for off in offsets:
                data[off] ^= 1 << self.rng.randrange(8)
            f.seek(0)
            f.write(data)
        self._log("bitflip", path=path, offsets=offsets)
        return offsets

    def corrupt_checkpoint(self, path: str, mode: str = "truncate") -> None:
        assert mode in ("truncate", "bitflip"), mode
        if mode == "truncate":
            self.truncate(path)
        else:
            self.bitflip(path)

    # ------------------------------------------------------------------ roles
    def kill_role(self, role, sig: int = signal.SIGTERM, name: str = "") -> None:
        """Kill a role by whatever handle we have: an object with ``stop()``
        (in-process servers — coordinator, serve gateway, replay store), a
        Popen (terminate), or a pid (os.kill). ``name`` tags the event for
        post-mortems ("replay", "coordinator", ...) when the handle's class
        name alone is ambiguous."""
        if hasattr(role, "stop"):
            self._log("kill_role", role=name or type(role).__name__)
            role.stop()
        elif hasattr(role, "terminate"):
            self._log("kill_role", role=name, pid=getattr(role, "pid", None))
            role.terminate()
        else:
            self._log("kill_role", role=name, pid=int(role), signal=int(sig))
            os.kill(int(role), sig)

    def poison_loss(self, learner, n: int = 1, value: float = float("nan")) -> None:
        """Make the next ``n`` learner train steps report a non-finite
        ``total_loss`` (fires the ``learner_loss_nonfinite`` rule without
        touching real numerics). Restored by ``restore()``."""
        original = learner._train
        state = {"left": n}

        def poisoned(data):
            out = original(data)
            if state["left"] > 0:
                state["left"] -= 1
                out = dict(out)
                out["total_loss"] = value
                self._log("nan_loss", remaining=state["left"])
            return out

        self._patches.append((learner, "_train", original))
        learner._train = poisoned

    def poison_module(self, learner, module: str, n: int = 1,
                      value: float = float("nan")) -> None:
        """Write ``value`` into element 0 of the first float parameter of the
        learner model's submodule ``module`` immediately BEFORE each of the
        next ``n`` train steps: a real numeric fault, not a cosmetic log
        edit. The JAX package rebuilds the parameter tree; here the write
        is in place under ``torch.no_grad()`` (the optimizer holds these
        very tensors). Restored by ``restore()`` (the wrapper, not the
        parameter)."""
        original = learner._train
        state = {"left": n}

        def poisoned(data):
            if state["left"] > 0:
                state["left"] -= 1
                import torch

                target = learner.model.get_submodule(module)
                for param in target.parameters():
                    if param.is_floating_point():
                        with torch.no_grad():
                            param.view(-1)[0] = value
                        break
                else:
                    raise ValueError(f"module {module!r} has no float parameters")
                self._log("poison_module", module=module, value=repr(value),
                          remaining=state["left"])
            return original(data)

        self._patches.append((learner, "_train", original))
        learner._train = poisoned

    # ----------------------------------------------------------- connections
    def reset_connection(self, host: str, port: int, count: int = 1,
                         timeout_s: float = 5.0) -> int:
        """Open ``count`` TCP connections to host:port and abort them with
        RST (SO_LINGER 0) — exercises peer read paths against hard resets.
        Returns how many connected."""
        import socket
        import struct

        done = 0
        for _ in range(count):
            try:
                s = socket.create_connection((host, port), timeout=timeout_s)
            except OSError:
                continue
            s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                         struct.pack("ii", 1, 0))
            s.close()
            done += 1
        self._log("reset_connection", host=host, port=port, count=done)
        return done

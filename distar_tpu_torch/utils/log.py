"""Logging and windowed metric meters.

Counterpart of ``distar_tpu.utils.log``: ``AverageMeter`` (a window of the
last values), ``EMAMeter`` (debiased), ``VariableRecord`` (named meters
rendered as a table), ``TextLogger`` (a file and the console), and
``ScalarSink``, which writes TensorBoard event files where tensorboardX is
installed and JSON lines (``scalars.jsonl``) otherwise.
"""
from __future__ import annotations

import json
import logging
import os
import time
from collections import deque
from typing import Dict


class AverageMeter:
    """Moving average over the last ``length`` values."""

    def __init__(self, length: int = 100):
        if length <= 0:
            raise ValueError(f"length must be positive, got {length}")
        self._values: deque = deque(maxlen=length)

    def update(self, value) -> None:
        self._values.append(float(value))

    @property
    def val(self) -> float:
        return self._values[-1] if self._values else 0.0

    @property
    def avg(self) -> float:
        return sum(self._values) / len(self._values) if self._values else 0.0


class EMAMeter:
    """Exponential moving average, debiased as Adam's moments are: after
    ``n`` updates from zero the raw average is divided by ``1 - alpha**n``."""

    def __init__(self, alpha: float = 0.99):
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"alpha must lie in (0, 1), got {alpha}")
        self._alpha = alpha
        self._ema = 0.0
        self._count = 0
        self._last = 0.0

    def update(self, value) -> None:
        value = float(value)
        self._last = value
        self._count += 1
        self._ema = self._alpha * self._ema + (1.0 - self._alpha) * value

    @property
    def val(self) -> float:
        return self._last

    @property
    def count(self) -> int:
        return self._count

    @property
    def avg(self) -> float:
        if self._count == 0:
            return 0.0
        return self._ema / (1.0 - self._alpha ** self._count)


class VariableRecord:
    """Named ``AverageMeter``s, rendered as a table of value and average."""

    def __init__(self, length: int = 100):
        self._length = length
        self._meters: Dict[str, AverageMeter] = {}

    def register_var(self, name: str) -> None:
        self._meters.setdefault(name, AverageMeter(self._length))

    def update_var(self, info: Dict[str, float]) -> None:
        for k, v in info.items():
            self.register_var(k)
            self._meters[k].update(v)

    def get(self, name: str) -> AverageMeter:
        return self._meters[name]

    def vars(self):
        return dict(self._meters)

    def get_vars_text(self) -> str:
        rows = ["{:<40s} {:>12.5f} {:>12.5f}".format(k, m.val, m.avg)
                for k, m in sorted(self._meters.items())]
        return "\n".join(["{:<40s} {:>12s} {:>12s}".format("name", "value", "avg")] + rows)


class TextLogger:
    """A logger writing ``<path>/<name>.log`` and, with ``to_console``,
    standard error."""

    _instances = 0

    def __init__(self, path: str, name: str = "distar_tpu_torch", to_console: bool = True):
        os.makedirs(path, exist_ok=True)
        TextLogger._instances += 1
        self._logger = logging.getLogger(f"{name}.{TextLogger._instances}")
        self._logger.handlers.clear()
        self._logger.setLevel(logging.INFO)
        self._logger.propagate = False
        fmt = logging.Formatter("[%(asctime)s][%(levelname)s] %(message)s")
        handlers = [logging.FileHandler(os.path.join(path, f"{name}.log"))]
        if to_console:
            handlers.append(logging.StreamHandler())
        for h in handlers:
            h.setFormatter(fmt)
            self._logger.addHandler(h)

    def info(self, msg: str) -> None:
        self._logger.info(msg)

    def error(self, msg: str) -> None:
        self._logger.error(msg)


class ScalarSink:
    """Scalars to TensorBoard where tensorboardX is installed, else to
    ``<path>/scalars.jsonl`` (one ``{"ts", "step", "name", "value"}`` a
    line); ``force_jsonl`` takes the JSON lines regardless (the metrics
    exporter, whose readers tail lines)."""

    def __init__(self, path: str, force_jsonl: bool = False):
        os.makedirs(path, exist_ok=True)
        self._tb = None
        self._file = None
        if not force_jsonl:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(path)
            except ImportError:
                pass
        if self._tb is None:
            self._file = open(os.path.join(path, "scalars.jsonl"), "a")

    def add_scalar(self, name: str, value: float, global_step: int) -> None:
        if self._tb is not None:
            self._tb.add_scalar(name, value, global_step)
        elif self._file is not None:
            self._file.write(json.dumps({"ts": time.time(), "step": global_step, "name": name,
                                         "value": float(value)}) + "\n")
            self._file.flush()

    def add_scalars(self, info: Dict[str, float], global_step: int) -> None:
        for k, v in info.items():
            self.add_scalar(k, v, global_step)

    def close(self) -> None:
        """Flush and release the sink (idempotent)."""
        if self._tb is not None:
            self._tb.close()
            self._tb = None
        f, self._file = self._file, None
        if f is not None:
            f.close()


def build_logger(path: str, name: str, to_console: bool = True):
    """(TextLogger, ScalarSink, VariableRecord) of one role."""
    return (TextLogger(path, name, to_console), ScalarSink(os.path.join(path, "scalars")),
            VariableRecord())

"""Live performance attribution: MFU / memory / collective-traffic gauges.

Counterpart of ``distar_tpu.obs.perf``: ``peak_flops`` maps a device name to
its datasheet bf16 peak, ``count_flops`` counts a step's operations,
``memory_report`` reads the CUDA caching allocator, and ``PerfMonitor``
turns them into the live ``distar_perf_*`` gauges the learner run loop
publishes every iteration.

Where the JAX package reads XLA's ``cost_analysis`` off a background
lowering, the port counts once per learner, on a background thread, by
running the step's forward and backward on the ``meta`` device (shapes, no
data, nothing on the card) under ``torch.utils.flop_counter``: matmuls,
convolutions and attention as that module counts them, ``index_add`` as
one add per element added, and each hand-written kernel's own count
(``ops.kernels.masked_attention_flops``, ``scatter_add_flops``), which
equals what its plain version's ops count, so the count is the same under
every kernel string.

Everything here is best-effort telemetry: a failed count or read is
counted in ``distar_perf_analysis_failures_total``, never raised into the
train loop.
"""
from __future__ import annotations

import logging
import math
import threading
from typing import Callable, Dict, Optional

from .registry import MetricsRegistry, get_registry

# peak bf16 matmul throughput per chip, for the MFU estimate: the JAX
# package's TPU table and the H100 SXM's dense bf16 peak
PEAK_FLOPS: Dict[str, float] = {
    "v4": 275e12,
    "v5 lite": 197e12,
    "v5e": 197e12,
    "v5p": 459e12,
    "v5": 459e12,
    "v6 lite": 918e12,
    "v6e": 918e12,
    "h100": 989e12,
}


def peak_flops(device_kind: str) -> Optional[float]:
    """Datasheet bf16 peak for a device name (``torch.cuda.get_device_name``
    or a TPU ``device_kind``; longest matching table entry wins), or None
    for unknown kinds (CPU hosts)."""
    kind = (device_kind or "").lower()
    best = None
    for name, peak in PEAK_FLOPS.items():
        if name in kind and (best is None or len(name) > best[0]):
            best = (len(name), peak)
    return best[1] if best else None


def _index_add_flops(self_shape, dim, index_shape, source_shape, *args, **kwargs) -> int:
    return math.prod(source_shape)


def count_flops(fn: Callable[[], None]) -> float:
    """The operations ``fn`` runs (give it meta tensors): the flop
    counter's matmul, convolution and attention counts, one add per element
    of an ``index_add``, and the hand-written kernels' own counts."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ..ops.kernels import counting_operations

    aten = torch.ops.aten
    custom = {aten.index_add: _index_add_flops, aten.index_add_: _index_add_flops}
    with counting_operations() as own, FlopCounterMode(display=False, custom_mapping=custom) as fc:
        fn()
    return float(fc.get_total_flops() + own.total)


def to_meta(tree):
    """A tree of tensors (dicts, tuples, lists) as empty meta tensors of
    the same shapes and dtypes; numpy arrays become tensors first, other
    leaves stay."""
    import numpy as np
    import torch

    if isinstance(tree, dict):
        return {k: to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_meta(v) for v in tree)
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(np.ascontiguousarray(tree))
    if isinstance(tree, torch.Tensor):
        return torch.empty_like(tree, device="meta")
    return tree


_MEM_FIELDS = (
    ("allocated_bytes.all.current", "allocated_mb"),
    ("allocated_bytes.all.peak", "peak_mb"),
    ("reserved_bytes.all.current", "reserved_mb"),
)


def memory_report(device=None) -> Dict[str, float]:
    """The CUDA caching allocator's ``memory_stats`` as a flat ``*_mb`` dict
    (allocated, peak, reserved; ``total_mb`` = reserved). Empty on the CPU
    or without CUDA: callers merge it with ``row.update(...)``."""
    try:
        import torch

        if device is not None and torch.device(device).type != "cuda":
            return {}
        if not torch.cuda.is_available():
            return {}
        stats = torch.cuda.memory_stats(device)
    except Exception:
        return {}
    out: Dict[str, float] = {}
    for key, field in _MEM_FIELDS:
        if key in stats:
            out[field] = round(stats[key] / 1e6, 1)
    if "reserved_mb" in out:
        out["total_mb"] = out["reserved_mb"]
    return out


def estimate_collective_bytes(mesh, params) -> Dict[str, float]:
    """Analytic per-step collective traffic from a mesh shape and the
    parameters: ring all-reduce of grads over dp costs ``2*(dp-1)/dp`` x
    param bytes, ZeRO-3 fsdp adds an all-gather of params (fwd+bwd, 2x) and
    a reduce-scatter of grads at ``(fsdp-1)/fsdp`` x param bytes each.
    ``mesh`` is None (one device: no collective) or has a ``shape``
    mapping; ``params`` an iterable of tensors or arrays, or a dict tree of
    them."""
    def leaves(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                yield from leaves(v)
        elif isinstance(tree, (tuple, list)):
            for v in tree:
                yield from leaves(v)
        elif hasattr(tree, "shape"):
            yield tree
        elif hasattr(tree, "__iter__"):
            yield from (x for x in tree if hasattr(x, "shape"))

    param_bytes = 0.0
    for x in leaves(params):
        itemsize = getattr(x, "itemsize", None) or getattr(getattr(x, "dtype", None), "itemsize", 4)
        param_bytes += float(math.prod(tuple(x.shape)) * itemsize)
    shape = dict(mesh.shape) if mesh is not None else {}
    dp = int(shape.get("dp", 1))
    fsdp = int(shape.get("fsdp", 1))
    out = {"param_bytes": param_bytes}
    if dp > 1:
        out["grad_allreduce"] = 2.0 * (dp - 1) / dp * param_bytes
    if fsdp > 1:
        frac = (fsdp - 1) / fsdp
        out["fsdp_allgather"] = 2.0 * frac * param_bytes
        out["fsdp_reducescatter"] = frac * param_bytes
    out["total"] = sum(v for k, v in out.items() if k != "param_bytes")
    return out


class PerfMonitor:
    """Per-learner live perf gauges.

    The run loop calls ``on_step`` every iteration (frames/s, step seconds,
    implied TFLOPs, MFU when the device's peak is known); the learner's
    step calls ``note_step`` once with a function that runs the step's
    forward and backward on meta tensors, which is counted on a background
    daemon thread (``count_flops``), so the loop never pays for it. Memory
    gauges sample ``torch.cuda.memory_stats()`` for a CUDA device and
    publish nothing on the CPU.
    """

    def __init__(self, token: str, registry: Optional[MetricsRegistry] = None,
                 aot_compile: bool = False, mem_sample_every: int = 16, device=None):
        self._registry = registry or get_registry()
        self._token = token
        self._aot_compile = aot_compile
        self._mem_sample_every = max(1, int(mem_sample_every))
        self._device = device
        self._lock = threading.Lock()
        self._analysis_started = False
        self._steps_seen = 0
        self.flops_per_step = 0.0
        self.peak: Optional[float] = None
        self.last: Dict[str, float] = {}
        self.analysis: Optional[threading.Thread] = None
        r = self._registry
        self._g_frames = r.gauge("distar_perf_frames_per_s",
                                 "learner throughput, frames per second", token=token)
        self._g_step = r.gauge("distar_perf_step_seconds",
                               "last device-step wall time", token=token)
        self._g_tflops = r.gauge("distar_perf_implied_tflops",
                                 "flops_per_step / step_time", token=token)
        self._g_mfu = r.gauge("distar_perf_mfu",
                              "implied flops share of the chip's bf16 peak", token=token)
        self._g_flops = r.gauge("distar_perf_flops_per_step",
                                "train-step flop count (cost_analysis)", token=token)
        self._c_fail = r.counter("distar_perf_analysis_failures_total",
                                 "background cost/memory analyses that failed", token=token)

    # ------------------------------------------------------- the flop count
    @property
    def counting(self) -> bool:
        """True once ``note_step`` started the count."""
        return self._analysis_started

    def note_step(self, count_fn: Callable[[], None]) -> None:
        """First-iteration hook: count ``count_fn``'s operations (and, with
        ``aot_compile``, publish the allocator's footprint) on a background
        thread, ``analysis``. Idempotent; never raises into the train loop."""
        with self._lock:
            if self._analysis_started:
                return
            self._analysis_started = True
        self.analysis = threading.Thread(target=self._analyze, args=(count_fn,),
                                         name=f"perf-analysis-{self._token}", daemon=True)
        self.analysis.start()

    def _analyze(self, count_fn) -> None:
        try:
            self.peak = self._device_peak()
            flops = count_flops(count_fn)
            if self._aot_compile:
                for kind, mb in memory_report(self._device).items():
                    self._registry.gauge(
                        "distar_perf_step_hbm_mb",
                        "static per-step HBM footprint (memory_analysis)",
                        token=self._token, kind=kind.replace("_mb", ""),
                    ).set(mb)
            if flops:
                self.flops_per_step = flops
                self._g_flops.set(flops)
        except Exception as e:  # analysis is telemetry, never training-fatal
            logging.warning("perf analysis failed: %r", e)
            self._c_fail.inc()

    def _device_peak(self) -> Optional[float]:
        import torch

        dev = torch.device(self._device) if self._device is not None else None
        if dev is None or dev.type != "cuda":
            return None
        return peak_flops(torch.cuda.get_device_name(dev))

    # ------------------------------------------------------------ live side
    def on_step(self, step_time_s: float, frames: float) -> None:
        step_time_s = float(step_time_s)
        if step_time_s <= 0:
            return
        vals = {"step_seconds": step_time_s}
        self._g_step.set(step_time_s)
        if frames:
            vals["frames_per_s"] = frames / step_time_s
            self._g_frames.set(vals["frames_per_s"])
        if self.flops_per_step:
            tflops = self.flops_per_step / step_time_s / 1e12
            vals["implied_tflops"] = tflops
            self._g_tflops.set(tflops)
            if self.peak:
                vals["mfu"] = self.flops_per_step / step_time_s / self.peak
                self._g_mfu.set(vals["mfu"])
        self.last = vals
        self._steps_seen += 1
        if self._steps_seen % self._mem_sample_every == 1:
            self.sample_memory()

    def sample_memory(self) -> None:
        """The CUDA allocator's stats into the HBM gauges (no-op for a CPU
        learner, as the JAX package publishes nothing on a CPU backend)."""
        try:
            import torch

            dev = torch.device(self._device) if self._device is not None else None
            if dev is None or dev.type != "cuda":
                return
            stats = torch.cuda.memory_stats(dev)
            if not stats:
                return
            label = f"gpu:{dev.index if dev.index is not None else torch.cuda.current_device()}"
            in_use = stats.get("allocated_bytes.all.current")
            if in_use is not None:
                self._registry.gauge("distar_perf_hbm_bytes_in_use",
                                     "allocator bytes currently in use", device=label).set(float(in_use))
            peak = stats.get("allocated_bytes.all.peak")
            if peak is not None:
                self._registry.gauge("distar_perf_hbm_peak_bytes",
                                     "allocator high-water mark", device=label).set(float(peak))
        except Exception:
            self._c_fail.inc()

    def set_collectives(self, mesh, params) -> None:
        """Publish the analytic per-step collective estimate for this
        learner's mesh and parameters (nothing with no mesh)."""
        try:
            est = estimate_collective_bytes(mesh, params)
        except Exception:
            self._c_fail.inc()
            return
        self.publish_collectives(est)

    def publish_collectives(self, est: Dict[str, float]) -> None:
        """Publish a per-step collective estimate, bytes by kind (the port
        learner's: ``parallel.spmd.ParamShards.collective_bytes``)."""
        for kind, v in est.items():
            if kind in ("total", "param_bytes"):
                continue
            self._registry.gauge(
                "distar_perf_collective_bytes_per_step",
                "estimated per-step collective traffic from sharding specs",
                token=self._token, kind=kind,
            ).set(v)

    def snapshot(self) -> Dict[str, float]:
        """Last-step view for the admin ``status`` route."""
        out = dict(self.last)
        if self.flops_per_step:
            out["flops_per_step"] = self.flops_per_step
        if self.peak:
            out["peak_flops"] = self.peak
        return out

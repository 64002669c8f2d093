"""What a mesh costs the learner's step, on gloo ranks on the CPU.

    python -m distar_tpu_torch.tools.mesh_cost [--ranks 2] [--steps 5]
        [--meshes dp=2,fsdp=2,tp=2] [--batch-size 4] [--unroll-len 2]

Spawns ``--ranks`` gloo ranks (one torch thread each) and, for each mesh
of ``--meshes`` (``;``-separated ``--mesh`` specs, default dp, fsdp and tp
over all ranks), builds the smoke-model RL learner on it, with the
training-dynamics tree on and then off, and times ``--steps`` steps on one
fixed batch after a warm-up step: the whole step (``_train``), the
optimizer's step inside it, and each unit's parameter collectives
(``parallel.spmd``: the all-gathers before the unit runs, over fsdp and
over tp, and the reduce-scatter of its gradients in the backward). Each
time is the slowest rank's, a median over the steps. Each rank's bytes:
``persistent_bytes``, what it holds between steps (its blocks of the
parameters, mu and nu), and ``peak_bytes``, that plus the most bytes of
gradients and of gathered whole parameters alive at once during a step
(activations are not counted). Prints one ``MESH-COST {json}`` line per
mesh and tree setting.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import time
import weakref
from typing import Dict, List, Optional


class _Meter:
    """The unit collectives' seconds by (unit, kind), and the bytes of
    gathered parameters and gradients alive, with their peak."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self.alive = self.peak = 0

    def hold(self, tensors) -> None:
        for t in tensors:
            n = t.numel() * t.element_size()
            self.alive += n
            weakref.finalize(t, self._drop, n)
        self.peak = max(self.peak, self.alive)

    def _drop(self, n: int) -> None:
        self.alive -= n

    def timed(self, fn, kind: str):
        def wrapper(tensors, axis):
            t0 = time.perf_counter()
            try:
                out = fn(tensors, axis)
            finally:
                key = f"{axis.name or '-'}/{kind}_{axis.axis}"
                self.seconds[key] = self.seconds.get(key, 0.0) + time.perf_counter() - t0
            if kind == "gather":
                self.hold(out)
            return out
        return wrapper


def _timed(obj, name: str, into: List[float], meter: Optional[_Meter] = None) -> None:
    fn = getattr(obj, name)

    def wrapper(*args, **kwargs):
        if meter is not None:  # the optimizer's step: the gradients it is handed
            meter.hold(args[0])
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            into.append(time.perf_counter() - t0)

    setattr(obj, name, wrapper)


def _rank(rank: int, meshes: List[str], batch_size: int, unroll_len: int, steps: int) -> None:
    import torch
    import torch.distributed as dist

    from ..bin.sl_train import SMOKE_MODEL
    from ..learner import RLLearner
    from ..parallel import MeshSpec, make_mesh, set_context_mesh
    from ..parallel import spmd

    meter = _Meter()
    spmd.gather_blocks = meter.timed(spmd.gather_blocks, "gather")
    spmd.reduce_scatter_blocks = meter.timed(spmd.reduce_scatter_blocks, "reduce_scatter")
    for spec in meshes:
        for tree in (True, False):
            mesh = make_mesh(MeshSpec.parse(spec))
            lrn = RLLearner({"learner": {"batch_size": batch_size, "unroll_len": unroll_len,
                                         "prefetch_depth": 0, "log_freq": 10 ** 9,
                                         "dynamics": {"enabled": tree},
                                         # no flop count on a thread beside the timed steps
                                         "perf": {"aot": False}},
                             "model": SMOKE_MODEL}, device="cpu", mesh=mesh)
            opt, shards = lrn.optimizer, spmd.param_shards(lrn.model)
            opt_s: List[float] = []
            _timed(opt, "step", opt_s, meter)
            persistent = sum(t.numel() * t.element_size() for t in opt.params + opt.mu + opt.nu)
            batch = next(lrn._dataloader)
            rows, units, peaks = [], [], []
            for i in range(steps + 1):
                n_opt = len(opt_s)
                meter.seconds, meter.peak = {}, meter.alive
                dist.barrier()
                t0 = time.perf_counter()
                lrn._train(batch)
                step = time.perf_counter() - t0
                if i:  # the first is the warm-up
                    rows.append([step, sum(opt_s[n_opt:])])
                    units.append(dict(meter.seconds))
                    peaks.append(meter.peak)
            keys = sorted({k for u in units for k in u})
            per_unit = torch.tensor([[u.get(k, 0.0) for k in keys] for u in units], dtype=torch.float64)
            worst = torch.cat([torch.tensor(rows, dtype=torch.float64), per_unit], 1)
            dist.all_reduce(worst, op=dist.ReduceOp.MAX)  # the slowest rank's
            held = torch.tensor([[persistent, persistent + max(peaks)]], dtype=torch.float64)
            every = [torch.zeros_like(held) for _ in range(dist.get_world_size())]
            dist.all_gather(every, held)
            if rank == 0:
                med = [statistics.median(col) * 1e3 for col in worst.t().tolist()]
                unit_ms: Dict[str, Dict[str, float]] = {}
                for k, ms in zip(keys, med[2:]):
                    unit, kind = k.split("/")
                    unit_ms.setdefault(unit, {})[kind + "_ms"] = ms
                print("MESH-COST " + json.dumps({
                    "mesh": dict(mesh.shape), "ranks": dist.get_world_size(), "tree": tree,
                    "batch_size": batch_size, "unroll_len": unroll_len, "steps": steps,
                    "params": sum(torch.Size(s).numel() for s in shards.shapes),
                    "split_leaves": sum(bool(d) for d in shards.dims),
                    "step_ms": med[0], "optimizer_ms": med[1],
                    "collective_ms": sum(med[2:]), "unit_ms": unit_ms,
                    "persistent_bytes": [int(r[0][0]) for r in every],
                    "peak_bytes": [int(r[0][1]) for r in every]}), flush=True)
            set_context_mesh(None)


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--meshes", default="", help="';'-separated mesh specs (default dp, fsdp, tp over the ranks)")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--unroll-len", type=int, default=2)
    args = p.parse_args(argv)
    from ..parallel.dist import spawn_ranks

    n = args.ranks
    meshes = [m for m in args.meshes.split(";") if m] or [f"dp={n}", f"dp=1,fsdp={n}", f"dp=1,tp={n}"]
    print(f"mesh_cost: {n} gloo ranks on {os.cpu_count()} CPUs, {args.steps} steps", flush=True)
    codes = spawn_ranks(_rank, n, meshes, args.batch_size, args.unroll_len, args.steps, timeout_s=3600.0)
    if any(c != 0 for c in codes):
        raise SystemExit(f"mesh_cost: rank exit codes {codes}")


if __name__ == "__main__":
    main()

"""What a mesh costs the learner's step, on gloo ranks on the CPU.

    python -m distar_tpu_torch.tools.mesh_cost [--ranks 2] [--steps 5]
        [--meshes dp=2,fsdp=2,tp=2] [--batch-size 4] [--unroll-len 2]

Spawns ``--ranks`` gloo ranks (one torch thread each) and, for each mesh
of ``--meshes`` (``;``-separated ``--mesh`` specs, default dp, fsdp and tp
over all ranks), builds the smoke-model RL learner on it, with the
training-dynamics tree on and then off, and times ``--steps`` steps on one
fixed batch after a warm-up step: the whole step (``_train``), the
optimizer's step inside it, and the ``ShardPlan``'s gathers (the
parameters after the update, inside the optimizer's step, and the update
where the tree reads it). Each time is the slowest rank's, a median over
the steps. Prints one ``MESH-COST {json}`` line per mesh and tree setting.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import time
from typing import List, Optional


def _timed(obj, name: str, into: List[float]) -> None:
    fn = getattr(obj, name)

    def wrapper(*args, **kwargs):
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

    for spec in meshes:
        for tree in (True, False):
            mesh = make_mesh(MeshSpec.parse(spec))
            lrn = RLLearner({"learner": {"batch_size": batch_size, "unroll_len": unroll_len,
                                         "prefetch_depth": 0, "log_freq": 10 ** 9,
                                         "dynamics": {"enabled": tree},
                                         # no flop count on a thread beside the timed steps
                                         "perf": {"aot": False}},
                             "model": SMOKE_MODEL}, device="cpu", mesh=mesh)
            opt, plan = lrn.optimizer, lrn.optimizer.plan
            opt_s: List[float] = []
            gather_s: List[float] = []
            _timed(opt, "step", opt_s)
            if plan is not None:
                _timed(plan, "gather_", gather_s)
            batch = next(lrn._dataloader)
            rows = []
            for i in range(steps + 1):
                n_opt, n_gather = len(opt_s), len(gather_s)
                dist.barrier()
                t0 = time.perf_counter()
                lrn._train(batch)
                step = time.perf_counter() - t0
                if i:  # the first is the warm-up
                    rows.append([step, sum(opt_s[n_opt:]), sum(gather_s[n_gather:])])
            worst = torch.tensor(rows, dtype=torch.float64)
            dist.all_reduce(worst, op=dist.ReduceOp.MAX)  # the slowest rank's
            if rank == 0:
                med = [statistics.median(col) * 1e3 for col in worst.t().tolist()]
                n_params = sum(p.numel() for p in lrn.model.parameters())
                print("MESH-COST " + json.dumps({
                    "mesh": dict(mesh.shape), "ranks": dist.get_world_size(), "tree": tree,
                    "batch_size": batch_size, "unroll_len": unroll_len, "steps": steps,
                    "params": n_params, "split_leaves": sum(bool(d) for d in plan.dims) if plan else 0,
                    "step_ms": med[0], "optimizer_ms": med[1], "gather_ms": med[2]}), flush=True)
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

"""Executed sharded training: mesh spec in, trained steps out.

Counterpart of ``distar_tpu.parallel.executor``: ``run_sharded_training``
builds a live mesh over the ranks of the default process group, trains an
``RLLearner`` on it through the whole path (the meshed step, the
``ShardFeeder``, sharded checkpoints) and returns the JAX report's keys.
``resume`` restores from the save directory's ``latest`` pointer first
(onto any mesh shape); ``kill_after_iter`` saves a durable sharded
generation after that iteration and leaves with ``os._exit(137)``.

``python -m distar_tpu_torch.parallel.executor --mesh dp=1`` runs it on
the card as a world of one (NCCL); ``--host-devices N`` runs it as N gloo
ranks on the CPU (the JAX flag forces N virtual CPU devices in one
process; torch has no such thing) and implies ``--device cpu``. Rank 0
prints one ``REPORT {json}`` line; the exit code is 137 when the kill hook
fired, else the first failing rank's.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional, Union

from .mesh import MeshSpec


def run_sharded_training(
    mesh_spec: Union[str, MeshSpec],
    *,
    iters: int = 2,
    batch_size: Optional[int] = None,
    unroll_len: int = 2,
    model_cfg: Optional[dict] = None,
    experiment_name: str = "sharded_executor",
    save_dir: str = "",
    sharded_ckpt: bool = True,
    save_freq: int = 10 ** 9,
    resume: bool = False,
    kill_after_iter: Optional[int] = None,
    assert_fsdp: bool = False,
    assert_tp: bool = False,
    max_devices: Optional[int] = None,
    device=None,
) -> Dict[str, Any]:
    """Train an RLLearner on a live mesh of ``mesh_spec`` (default model:
    the launchers' smoke model) and return the report (every rank returns
    it; the default process group is formed as a world of one when none
    exists)."""
    import torch.distributed as dist

    from ..bin.sl_train import SMOKE_MODEL
    from ..learner import RLLearner
    from .dist import dist_init
    from .mesh import make_mesh

    if not dist.is_initialized():
        dist_init(method="auto", device=device)
    spec = MeshSpec.parse(mesh_spec)
    if max_devices is None and spec.dp != -1:
        # an explicit spec claims exactly the ranks it names
        max_devices = spec.total()
    world = dist.get_world_size()
    mesh = make_mesh(spec, list(range(world))[:max_devices] if max_devices else None)
    n_dp = mesh.shape["dp"] * mesh.shape["fsdp"]
    B = batch_size if batch_size is not None else max(n_dp, 2)
    cfg = {
        "common": {"experiment_name": experiment_name, **({"save_path": save_dir} if save_dir else {})},
        "learner": {
            "batch_size": B,
            "unroll_len": unroll_len,
            "save_freq": save_freq,
            "log_freq": 10 ** 9,
            "sharded_ckpt": sharded_ckpt,
        },
        "model": model_cfg if model_cfg is not None else SMOKE_MODEL,
    }
    learner = RLLearner(cfg, device=device, mesh=mesh)

    report: Dict[str, Any] = {
        "mesh": dict(learner.mesh.shape),
        "batch_size": B,
        "unroll_len": unroll_len,
        "devices": world,
        "sharded_ckpt": sharded_ckpt,
        "resumed_from": None,
        "start_iter": 0,
    }
    from .spmd import param_shards

    specs = param_shards(learner.model).specs
    if assert_fsdp and not any("fsdp" in s for s in specs):
        raise AssertionError("no param leaf sharded over fsdp")
    if assert_tp:
        from ..model.convert import flax_names

        names = list(flax_names(learner.model).values())
        tp_leaves = [n for n, s in zip(names, specs) if "tp" in s]
        if not tp_leaves:
            raise AssertionError("no param leaf sharded over tp")
        if not any("Attention" in p for p in tp_leaves):
            raise AssertionError(f"no attention weight sharded over tp (tp leaves: {tp_leaves[:5]})")
        report["tp_leaves"] = len(tp_leaves)

    if resume:
        report["resumed_from"] = learner.resume_latest()
        report["start_iter"] = learner.last_iter.val

    # per-iteration step wall time, measured around the learner's _train
    step_times = []
    orig_train = learner._train

    def timed_train(data):
        t0 = time.monotonic()
        out = orig_train(data)  # ends with the step's device -> host log copy
        step_times.append(time.monotonic() - t0)
        return out

    learner._train = timed_train

    if kill_after_iter is not None:
        from ..learner.hooks import LambdaHook

        def _chaos_kill(lrn):
            if lrn.last_iter.val >= kill_after_iter:
                # a durable sharded save, then die as a preempted worker
                lrn.save(lrn.checkpoint_path(), sync=True)
                os._exit(137)

        learner.hooks.add(LambdaHook("executor_chaos_kill", "after_iter", _chaos_kill))

    t0 = time.monotonic()
    learner.run(max_iterations=iters)
    wall_s = time.monotonic() - t0

    feeder = learner._dataloader
    feeder_stats = feeder.stats() if hasattr(feeder, "stats") else {}
    try:
        loss = float(learner.variable_record.get("total_loss").val)
    except KeyError:  # resumed at or past the target: no fresh iteration
        loss = None
    report.update(
        iters=learner.last_iter.val,
        loss=loss,
        wall_s=round(wall_s, 3),
        step_times_s=[round(t, 4) for t in step_times],
        # steady state: the first step pays the warm-up
        step_time_s=(round(min(step_times[1:] or step_times), 4) if step_times else None),
        feeder=feeder_stats,
    )
    if save_freq < 10 ** 9 or kill_after_iter is not None:
        report["checkpoint_dir"] = os.path.join(learner.save_dir, "checkpoints")
    if hasattr(feeder, "close"):
        feeder.close()
    learner.scalar_sink.close()
    return report


def _report_rank(rank: int, kwargs: dict) -> None:
    """One rank of ``--host-devices``: train, and rank 0 prints the report."""
    import json

    report = run_sharded_training(**kwargs)
    if rank == 0:
        print("REPORT " + json.dumps(report), flush=True)


def main_cli(argv=None) -> int:
    """``python -m distar_tpu_torch.parallel.executor --mesh dp=1 ...``:
    prints one ``REPORT {json}`` line."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--mesh", default="dp=-1")
    p.add_argument("--iters", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--unroll-len", type=int, default=2)
    p.add_argument("--host-devices", type=int, default=0,
                   help="run as N gloo ranks on the CPU (implies --device cpu; 0 = one process on "
                        "--device)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--save-dir", default="")
    p.add_argument("--save-freq", type=int, default=10 ** 9)
    p.add_argument("--no-sharded-ckpt", dest="sharded_ckpt", action="store_false")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--kill-after", type=int, default=None)
    p.add_argument("--experiment-name", default="sharded_executor")
    args = p.parse_args(argv)
    kwargs = dict(mesh_spec=args.mesh, iters=args.iters, batch_size=args.batch_size,
                  unroll_len=args.unroll_len, experiment_name=args.experiment_name,
                  save_dir=args.save_dir, sharded_ckpt=args.sharded_ckpt, save_freq=args.save_freq,
                  resume=args.resume, kill_after_iter=args.kill_after,
                  device="cpu" if args.host_devices else args.device)
    if args.host_devices:
        from .dist import spawn_ranks

        codes = spawn_ranks(_report_rank, args.host_devices, kwargs, timeout_s=3600.0)
        if 137 in codes:
            return 137
        return next((c if c is not None else 1 for c in codes if c != 0), 0)
    from .dist import dist_close

    try:
        _report_rank(0, kwargs)
    finally:
        dist_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main_cli())

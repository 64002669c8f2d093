"""Multi-process runtime initialisation.

Counterpart of ``distar_tpu.parallel.dist`` (the reference's
``dist_helper.py:321-344`` NCCL process-group setup): ``dist_init`` forms the
default ``torch.distributed`` process group, NCCL on CUDA (each process on
the card of its local rank) and gloo on the CPU. Methods:

* ``slurm``       — rank and world from ``SLURM_PROCID``/``SLURM_NTASKS``,
                    the head node of ``SLURM_STEP_NODELIST`` at :12355;
* ``explicit``    — ``coordinator_address`` (host:port), world and rank given;
* ``single_node`` — a world of one on a free local port;
* ``auto``        — ``env://`` when ``RANK`` and ``WORLD_SIZE`` are set,
                    SLURM when its variables are, a world of one otherwise.

JAX's ``auto`` catches a failed ``jax.distributed.initialize`` and carries
on as a world of one; here ``auto`` decides from the environment, and a
group that fails to form raises.

``spawn_ranks`` runs a function in N processes that form one gloo group
(``--host-devices N``, the tests; ``device="cuda"`` puts every rank on the
one card, where NCCL refuses two ranks a device): each rank is joined with
its own timeout, and every rank is killed when one fails.
"""
from __future__ import annotations

import os
import socket
from typing import Optional


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dist_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    method: str = "auto",  # auto | slurm | single_node | explicit
    device: Optional[str] = None,
) -> dict:
    """Form the default process group; returns ``{"rank", "world_size",
    "backend"}``. ``device`` picks the backend ("cpu": gloo; default CUDA:
    NCCL, raising where there is none)."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return {"rank": dist.get_rank(), "world_size": dist.get_world_size(),
                "backend": dist.get_backend()}
    cpu = device is not None and str(device).startswith("cpu")
    if not cpu and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' (--device cpu) for a gloo group")
    backend = "gloo" if cpu else "nccl"
    env = os.environ
    if method == "auto":
        if "RANK" in env and "WORLD_SIZE" in env:
            method = "env"
        elif "SLURM_PROCID" in env:
            method = "slurm"
        else:
            method = "single_node"
    if method == "slurm":
        process_id = int(env["SLURM_PROCID"])
        num_processes = int(env["SLURM_NTASKS"])
        if coordinator_address is None:
            nodelist = env.get("SLURM_STEP_NODELIST", "localhost")
            head = nodelist.split(",")[0].split("[")[0]
            coordinator_address = f"{head}:12355"
        init = f"tcp://{coordinator_address}"
    elif method == "explicit":
        if not (coordinator_address and num_processes is not None and process_id is not None):
            raise ValueError("dist_init explicit needs coordinator_address, num_processes and process_id")
        init = f"tcp://{coordinator_address}"
    elif method == "env":
        init, process_id, num_processes = "env://", int(env["RANK"]), int(env["WORLD_SIZE"])
    elif method == "single_node":
        init, process_id, num_processes = f"tcp://127.0.0.1:{free_port()}", 0, 1
    else:
        raise ValueError(f"unknown dist method {method!r} (auto|slurm|single_node|explicit)")
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", env.get("SLURM_LOCALID", process_id % max(torch.cuda.device_count(), 1))))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init, world_size=int(num_processes), rank=int(process_id))
    return {"rank": dist.get_rank(), "world_size": dist.get_world_size(), "backend": backend}


def dist_close() -> None:
    """Destroy the default group (and every subgroup) if one exists."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(fn, rank: int, world: int, addr: str, device: str, args, kwargs):
    import torch

    # one thread a rank: the ranks share the host's cores, and the small
    # CPU ops of a step run slower when OpenMP workers wait on each other
    torch.set_num_threads(1)
    dist_init(method="explicit", coordinator_address=addr, num_processes=world, process_id=rank,
              device="cpu")
    if device != "cpu":
        torch.cuda.set_device(torch.device(device).index or 0)
    try:
        fn(rank, *args, **kwargs)
    finally:
        dist_close()


def spawn_ranks(fn, world: int, *args, timeout_s: float = 300.0, device: str = "cpu", **kwargs) -> list:
    """Run ``fn(rank, *args, **kwargs)`` in ``world`` spawned processes that
    form one gloo group on a free local port, each with ``device`` (a CUDA
    device: the current one of every rank) as its own; returns their exit
    codes. A
    rank that exits non-zero, or is still running at its timeout, gets every
    other rank killed, and the exit codes say so (-9 for a killed rank)."""
    import multiprocessing as mp
    import time

    ctx = mp.get_context("spawn")
    addr = f"127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, addr, str(device), args, kwargs)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        # poll, so a rank that dies while another waits on it in a
        # collective ends the lot at once, not at the deadline
        while time.monotonic() < deadline:
            codes = [p.exitcode for p in procs]
            if all(c is not None for c in codes) or any(c not in (None, 0) for c in codes):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    return [p.exitcode for p in procs]

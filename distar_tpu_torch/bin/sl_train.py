"""Supervised-learning launcher.

    python -m distar_tpu_torch.bin.sl_train --type learner --iters 2 --smoke-model --device cpu
    python -m distar_tpu_torch.bin.sl_train --device cpu --data D --eval-data E --save-path S

Counterpart of ``distar_tpu.bin.sl_train``, on CUDA unless ``--device``
says otherwise. Roles:

  learner      train on a local ``ReplayDataset`` directory (``--data``), on
               trajectories pulled off the coordinator's adapter plane from
               remote replay actors (``--remote``: ``RemoteSLDataloader``
               on the ``sltraj`` token), or, with neither, on the fake
               dataloader (schema-complete random batches); with ``--eval-data`` an ``EVAL {json}`` line of
               held-out metrics every ``--eval-freq`` steps. Unless
               ``--no-supervise``, it first resumes from the experiment's
               ``latest`` checkpoint pointer, and a crash resumes from it
               again and trains on, within ``--restart-max`` restarts in
               ``--restart-window-s``. SIGTERM and SIGINT save a checkpoint
               before the process exits.
  replay_actor decode the replays of ``--replays`` (a list file or a
               directory of ``.SC2Replay`` files; ``--epochs`` passes,
               ``--num-workers`` decoder threads) with the pipeline's
               ``ReplayDecoder`` (``--pipeline``, by default
               ``envs.replay_decoder.ReplayDecoder`` on the SC2 install
               ``SC2PATH`` names) and push both players' trajectories to
               ``--coordinator-addr``, where a ``--remote`` learner pulls
               them; it ends with ``replay_actor done: ...``.
  coordinator  the metadata broker (``comm.CoordinatorServer``), evaluating
               the learner, actor, coordinator and trace rules over what
               the fleet ships; SIGTERM dumps a flight bundle, then stops it.

Fleet health as in ``bin/rl_train.py``, at the JAX launcher's cadences
(sampled every 1 s, evaluated every 2 s), off under ``--no-health``: the
learner samples its registry into a time-series store under the learner
and trace rules, its crash bundles land under ``<save-path>/flight``, and
with ``--remote`` it ships its snapshots to ``--coordinator-addr`` every
5 s.

``--mesh dp=K,fsdp=M,tp=N,sp=S`` trains on a live mesh over the process
group's ranks and turns on sharded checkpoints unless ``--no-sharded-ckpt``;
``--host-devices N`` runs the learner as N gloo ranks on the CPU (implies
``--device cpu``; with the fake dataloader or ``--data`` every rank reads
the same global batches and takes its rows, with ``--remote`` each pulls
its own). Only rank 0 prints.

``--dynamics-every`` is the JAX launcher's (``rl_train._dynamics_cfg``).

``--config`` takes what the JAX launcher's does, a YAML file, and also a JSON
file or an inline JSON object. Its ``model`` block replaces the smoke model
over ``default_model_config()``, as in the JAX launcher; its ``learner``
block cascades over the learner defaults (``save_freq`` among them), and
its ``batch_size`` and ``unroll_len`` stand where ``--batch-size`` and
``--traj-len`` are not given:

    python -m distar_tpu_torch.bin.sl_train --full-model --config \
        '{"model": {"encoder": {"scatter": {"impl": "pallas"}}}, "learner": {"log_freq": 1}}'
"""
from __future__ import annotations

import argparse
import json
from typing import Iterable, Optional, Sequence

from ..learner import SLLearner
from ..learner.hooks import LambdaHook
from ..learner.sl_dataloader import ReplayDataset, SLDataloader
from ..ops import kernels
from ..resilience import RestartPolicy, supervise_call
from ..utils import read_config
from .rl_train import (_close_health, _dynamics_cfg, _init_health, _mesh_from_args, _on_stop_signals,
                       _restore_signals)

# the JAX launchers' smoke model (distar_tpu/bin/rl_train.py SMOKE_MODEL)
SMOKE_MODEL = {
    "encoder": {
        "entity": {"layer_num": 1, "hidden_dim": 32, "output_dim": 16, "head_dim": 8},
        "spatial": {"down_channels": [4, 4, 8], "project_dim": 4, "resblock_num": 1, "fc_dim": 16},
        "scatter": {"output_dim": 4},
        "core_lstm": {"hidden_size": 32, "num_layers": 1},
    },
    "policy": {
        "action_type_head": {"res_dim": 16, "res_num": 1, "gate_dim": 32},
        "delay_head": {"decode_dim": 16},
        "queued_head": {"decode_dim": 16},
        "selected_units_head": {"func_dim": 16},
        "target_unit_head": {"func_dim": 16},
        "location_head": {"res_dim": 8, "res_num": 1, "upsample_dims": [4, 4, 1], "map_skip_dim": 8},
    },
    "value": {"res_dim": 8, "res_num": 1},
}


def build_learner(args, dataloader: Optional[Iterable] = None) -> SLLearner:
    """The SL learner the flags and ``--config`` describe, on ``dataloader``
    where given, else on ``--data``, else on the fake dataloader, with the
    held-out evaluation hook of ``--eval-data``."""
    user_cfg = read_config(args.config) if args.config else {}
    learner_cfg = user_cfg.get("learner", {})
    batch_size = args.batch_size or int(learner_cfg.get("batch_size", 2))
    unroll_len = args.traj_len or int(learner_cfg.get("unroll_len", 8))
    sharded = args.sharded_ckpt
    if sharded is None:
        sharded = learner_cfg.get("sharded_ckpt", bool(args.mesh))
    mesh = _mesh_from_args(args)
    lrn = SLLearner(
        {
            "common": {"experiment_name": args.experiment_name,
                       **({"save_path": args.save_path} if args.save_path else {})},
            "learner": {
                "log_freq": max(args.iters // 4, 1),
                "save_freq": 10 ** 9,
                **learner_cfg,
                "batch_size": batch_size,
                "unroll_len": unroll_len,
                "sharded_ckpt": bool(sharded),
                **_dynamics_cfg(args, learner_cfg),
            },
            "model": user_cfg.get("model", SMOKE_MODEL if args.smoke_model else {}),
        },
        device=args.device,
        mesh=mesh,
    )
    if dataloader is not None:
        lrn.set_dataloader(dataloader)
    elif args.data:
        lrn.set_dataloader(SLDataloader(ReplayDataset(args.data), batch_size, unroll_len))
    elif args.remote:
        from ..comm import Adapter
        from ..learner.replay_actor import RemoteSLDataloader

        host, _, port = args.coordinator_addr.rpartition(":")
        adapter = Adapter(coordinator_addr=(host or "127.0.0.1", int(port)))
        # on several ranks each batch block pulls its own trajectories (its
        # share of the mesh the learner fitted), and a block's tp x sp
        # replicas train on what its first rank pulls
        local = lrn.mesh is not None and lrn.mesh.devices.size > 1
        lrn.set_dataloader(RemoteSLDataloader(adapter, lrn.local_batch_size, unroll_len), local=local)
    if args.eval_data:
        eval_freq = args.eval_freq or max(args.iters // 8, 1)
        eval_batches = max(args.eval_batches, 1)  # 0 would drain an endless sampler
        eval_dataset = ReplayDataset(args.eval_data)  # a bad path fails before training

        def holdout_eval(learner):
            # a fresh seed-2 loader each time: the same held-out windows, so
            # the curve compares
            metrics = learner.evaluate(SLDataloader(eval_dataset, batch_size, unroll_len, seed=2),
                                       max_batches=eval_batches)
            print("EVAL " + json.dumps({"iter": learner.last_iter.val,
                                        **{k: round(v, 4) for k, v in sorted(metrics.items())}}),
                  flush=True)

        lrn.hooks.add(LambdaHook("holdout_eval", "after_iter", holdout_eval, freq=eval_freq))
    return lrn


def learner(args, dataloader: Optional[Iterable] = None) -> SLLearner:
    """Build the learner (``build_learner``), resume it from the latest
    checkpoint unless ``--no-supervise``, serve its admin API on
    ``--admin-port``, train to ``args.iters`` steps under supervision and
    return it."""
    host, _, port = args.coordinator_addr.rpartition(":")
    health = _init_health(args, roles=("learner", "trace"), source="sl_learner",
                          shipper_addr=(host or "127.0.0.1", int(port)) if args.remote else None)
    lrn = build_learner(args, dataloader)
    lead = lrn.rank == 0
    if not args.no_supervise:
        path = lrn.resume_latest()
        skipped = lrn.metrics.snapshot().get("distar_resilience_ckpt_fallbacks_total", 0)
        if lead:
            print(f"sl_train resume: {path or 'cold'} iter {lrn.last_iter.val} skipped {int(skipped)}",
                  flush=True)
    if args.admin_port is not None:
        admin = lrn.start_admin(port=args.admin_port)
        print(f"learner admin on http://{admin.host}:{admin.port}/learner/status", flush=True)
    if args.no_supervise:
        lrn.run(args.iters)
    else:
        def resume(error):
            path = lrn.resume_latest()
            print(f"learner restart after {error!r}: resume={path or 'cold'} iter={lrn.last_iter.val}",
                  flush=True)

        supervise_call(lambda: lrn.run(args.iters), op="learner",
                       policy=RestartPolicy(max_restarts=args.restart_max,
                                            window_s=args.restart_window_s),
                       on_restart=resume)
    _close_health(health)
    log = lrn.last_log
    if lead:
        print(f"sl_train done: {lrn.last_iter.val} iters, loss={log.get('total_loss', float('nan')):.4f}, "
              f"action_type_acc={log.get('action_type_acc', float('nan')):.4f}, "
              f"launches={json.dumps(kernels.launch_counts)}", flush=True)
    return lrn


def _learner_rank(rank: int, argv: list) -> None:
    """One gloo rank of ``--host-devices N``."""
    args = parser().parse_args(argv)
    args.host_devices, args.device = 0, "cpu"
    learner(args).scalar_sink.close()  # its writer thread must not outlive the rank's exit


def replay_actor(args) -> "ReplayActor":
    """Decode ``--replays`` and push the trajectories to the coordinator,
    under supervision unless ``--no-supervise`` (the JAX launcher's
    ``_replay_actor``); returns the finished ``ReplayActor``."""
    import os

    from .. import plugins
    from ..comm import Adapter
    from ..learner.replay_actor import ReplayActor
    from .rl_train import _addr, _restart_policy

    # no replay rules yet: shipping makes decode throughput visible in the
    # coordinator's fleet view
    health = _init_health(args, roles=("trace",), source=f"replay_actor:{os.getpid()}",
                          shipper_addr=_addr(args.coordinator_addr))
    decoder_cls = plugins.load_component(args.pipeline, "ReplayDecoder")
    addr = _addr(args.coordinator_addr)
    done = []

    def run_actor():
        actor = ReplayActor(replays=args.replays, adapter_factory=lambda: Adapter(coordinator_addr=addr),
                            decoder_factory=lambda: decoder_cls(cfg={}), num_workers=args.num_workers,
                            epochs=args.epochs)
        actor.run()
        done.append(actor)

    if args.no_supervise:
        run_actor()
    else:
        supervise_call(run_actor, op="replay_actor", policy=_restart_policy(args))
    _close_health(health)
    actor = done[-1]
    print(f"replay_actor done: pushed={actor.pushed} empty={actor.empty} failed={actor.failed}", flush=True)
    return actor


def coordinator(args) -> None:
    """Serve the coordinator until SIGTERM or SIGINT, under the rulebook of
    the fleet it brokers."""
    import threading

    from ..comm import CoordinatorServer

    done = threading.Event()
    previous = _on_stop_signals(done.set)  # the crash hook chains over it
    health = _init_health(args, roles=("learner", "actor", "coordinator", "trace"), source="coordinator")
    server = CoordinatorServer(port=int(args.coordinator_addr.rsplit(":", 1)[1]))
    server.start()
    print(f"coordinator serving on {server.host}:{server.port}", flush=True)
    try:
        while not done.wait(0.5):
            pass
    finally:
        server.stop()
    _close_health(health)
    _restore_signals(previous)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--type", default="learner", choices=("learner", "replay_actor", "coordinator"))
    p.add_argument("--config", default="",
                   help="YAML or JSON file, or inline JSON: 'model' and 'learner' overrides")
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=None, help="default: the config's, else 2")
    p.add_argument("--traj-len", type=int, default=None, help="default: the config's, else 8")
    p.add_argument("--experiment-name", default="sl_train")
    p.add_argument("--save-path", default="",
                   help="experiment root (default $DISTAR_EXPERIMENTS_ROOT or ./experiments, "
                        "then the experiment name)")
    p.add_argument("--smoke-model", action="store_true", default=True)
    p.add_argument("--full-model", dest="smoke_model", action="store_false",
                   help="default_model_config() at full width and depth")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; raises without CUDA unless 'cpu')")
    p.add_argument("--data", default="", help="local ReplayDataset directory (decoded trajectories)")
    p.add_argument("--eval-data", default="",
                   help="held-out ReplayDataset directory: a no-grad metric pass every --eval-freq steps")
    p.add_argument("--eval-freq", type=int, default=0, help="held-out eval cadence (0: iters / 8)")
    p.add_argument("--eval-batches", type=int, default=8)
    p.add_argument("--admin-port", type=int, default=None,
                   help="serve the learner admin API (status, save_ckpt) on this port")
    p.add_argument("--no-supervise", action="store_true",
                   help="no crash-restart supervision and no resume from the latest checkpoint")
    p.add_argument("--restart-max", type=int, default=5,
                   help="restart budget within --restart-window-s")
    p.add_argument("--restart-window-s", type=float, default=300.0,
                   help="sliding window of the restart budget")
    p.add_argument("--coordinator-addr", default="127.0.0.1:8422")
    p.add_argument("--remote", action="store_true",
                   help="train on trajectories replay actors push to the coordinator at --coordinator-addr")
    p.add_argument("--replays", default="", help="--type replay_actor: replay list file or directory")
    p.add_argument("--num-workers", type=int, default=1, help="--type replay_actor: decoder threads")
    p.add_argument("--epochs", type=int, default=1, help="--type replay_actor: passes over the replays")
    p.add_argument("--pipeline", default="default",
                   help="--type replay_actor: the pipeline whose ReplayDecoder decodes ('default' or "
                        "an importable custom-pipeline module, plugins.py)")
    p.add_argument("--no-health", action="store_true",
                   help="no fleet health: no time-series sampler, rulebook, telemetry shipping or crash "
                        "recorder")
    p.add_argument("--mesh", default="",
                   help="device mesh, e.g. 'dp=2,fsdp=2', over the process group's ranks (implies "
                        "sharded checkpoints)")
    p.add_argument("--host-devices", type=int, default=0,
                   help="run the learner as N gloo ranks on the CPU (implies --device cpu)")
    p.add_argument("--sharded-ckpt", action="store_true", default=None,
                   help="checkpoint as one CRC'd blob per parameter shard + manifest (default: on "
                        "with --mesh)")
    p.add_argument("--no-sharded-ckpt", dest="sharded_ckpt", action="store_false")
    p.add_argument("--dynamics-every", type=int, default=None,
                   help="training-dynamics gauge-export stride (learner dynamics.every_n); 0 turns the "
                        "in-step tree off; default: the learner config's")
    return p


def main(argv: Optional[Sequence[str]] = None) -> Optional[SLLearner]:
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser().parse_args(argv)
    if args.type == "replay_actor":
        replay_actor(args)
        return None
    if args.type == "coordinator":
        coordinator(args)
        return None
    if args.host_devices:
        from ..parallel.dist import spawn_ranks

        ranks_argv = [a for i, a in enumerate(argv) if a != "--host-devices"
                      and not a.startswith("--host-devices=") and (i == 0 or argv[i - 1] != "--host-devices")]
        codes = spawn_ranks(_learner_rank, args.host_devices, ranks_argv, timeout_s=7 * 24 * 3600.0)
        bad = [c for c in codes if c != 0]
        if bad:
            raise SystemExit(bad[0] if bad[0] is not None else 1)
        return None
    return learner(args)


if __name__ == "__main__":
    main()

"""League-RL launcher.

    python -m distar_tpu_torch.bin.rl_train --type all --smoke-model --device cpu --iters 2
    python -m distar_tpu_torch.bin.rl_train --type coordinator --port 8422
    python -m distar_tpu_torch.bin.rl_train --type league --port 8421
    python -m distar_tpu_torch.bin.rl_train --type learner --coordinator-addr H:8422 --league-addr H:8421
    python -m distar_tpu_torch.bin.rl_train --type actor --coordinator-addr H:8422 --league-addr H:8421
    python -m distar_tpu_torch.bin.rl_train --type all --replay --smoke-model --device cpu --iters 2
    python -m distar_tpu_torch.bin.rl_train --type replay --port 0 --replay-spill-dir D
    python -m distar_tpu_torch.bin.rl_train --anakin --env jaxenv --smoke-model --device cpu --iters 2
    python -m distar_tpu_torch.bin.rl_train --type league-run --smoke-model --device cpu --league-actors-per-player 1
    python -m distar_tpu_torch.bin.rl_train --type coordinator --port 8422 --arena-store S
    python -m distar_tpu_torch.bin.rl_train --type coordinator --port 8422 --journal-dir J1
    python -m distar_tpu_torch.bin.rl_train --type coordinator --port 8423 --journal-dir J2 --ha-peers H:8422
    python -m distar_tpu_torch.bin.rl_train --type arena --coordinator-addr H:8422 --arena-ckpt-dir D

Counterpart of ``distar_tpu.bin.rl_train``, on CUDA unless ``--device``
says otherwise. Roles:

  all          one process: a ``League``, an in-process ``Coordinator``, an
               ``Actor`` on the mock env running jobs on a supervised
               thread, and the RL learner on the main thread training on
               the actors' trajectories (``RLDataLoader``) and publishing
               its weights back every 4 iterations (``attach_comm``). Ends
               with ``rl_train done: ...``. With ``--replay`` the
               trajectories go through a replay store instead: one
               ``ReplayServer`` on loopback, ``--replay-shards N`` servers
               (the actor routes by consistent hash, the learner fans in),
               or with ``--replay-fast-path`` the colocated store with no
               server, and the learner samples them (``ReplayDataLoader``).
  coordinator  the metadata broker (``comm.CoordinatorServer``) on ``--port``;
               with ``--journal-dir`` it journals every mutating route
               (``comm/ha.py``), replays the journal when it starts, and
               serves the follower feed on ``--ha-port``: ``--ha-role auto``
               (the default) probes ``--ha-peers`` and joins a live primary
               as its standby, else leads; a standby promotes itself after
               ``--ha-takeover-grace-s`` without the primary. SIGTERM
               journals a last snapshot.
  league       the league's HTTP API (``league.LeagueAPIServer``) on ``--port``.
  learner      the learner against a remote coordinator and league: it
               registers with the league, restores the league's checkpoint
               for its player where one exists, else (unless
               ``--no-supervise``) resumes from its own ``latest`` pointer,
               trains ``--iters`` steps under crash-restart supervision and
               prints ``learner done: N iters``.
  actor        jobs from a remote league, trajectories to the coordinator's
               adapter plane, under crash-restart supervision.
  replay       a replay store (``replay.ReplayServer``) on ``--port``, its
               spill recovered before it serves (``--replay-spill-dir``),
               the HTTP admin surface on ``--metrics-port`` and, with
               ``--coordinator-addr``, registered under the
               ``replay_shard`` token; under crash-restart supervision.
  league-run   the league economy: the control plane (a coordinator hosting
               the ``LeagueService`` and an ``ArenaStore``) in this
               process and one ``league-learner`` subprocess per player of
               ``--league-players``; ends with ``LEAGUE-RUN-DONE {digest}``
               and exits 1 unless every learner exited 0, a snapshot was
               minted and an off-diagonal payoff cell holds games. It
               journals the control plane to ``--journal-dir`` (default
               ``<save-path>/league_journal``; ``none`` runs it
               un-journaled), and with ``--league-actors-per-player N``
               seeds an actor-slot fleet of N members per player
               (``fleet.FleetSupervisor``) that the payoff-driven
               reassigner rebalances once the learners are done.
  league-learner  one league player's learner against ``--coordinator-addr``:
               ``--league-rounds`` matchmade rounds of the fused Anakin
               rollout with the opponent on the away seat, the RL step,
               match reports and checkpoint generations (snapshots are
               minted server-side); refuses an impure first window.
  arena        the arena evaluator: checkpoint generations of
               ``--arena-ckpt-dir`` (role keys ``--arena-roles``) against
               the scripted anchors in jaxenv head-to-heads, scheduled and
               rated by the coordinator's ``ArenaStore`` (``--type
               coordinator --arena-store PATH``, journaled there and
               autosaved every ``--league-autosave-s``).

With ``--replay-addr`` (one ``host:port``, a comma-separated shard fleet,
or ``discover``) the learner samples its batches from the store and the
actor pushes its trajectories there. ``--coordinator-addr`` takes an HA
address list (``h1:p1,h2:p2``): every client of the coordinator follows
leadership across failovers.

``--env jaxenv`` puts the actors on the micro-battle world's host env
(``envs.jaxenv.JaxMicroBattleEnv``, ``--jaxenv-units`` a squad,
``--jaxenv-episode-len`` steps an episode). ``--anakin`` (with ``--env
jaxenv`` or no ``--env``) replaces the actor plane: the learner trains on
``--batch-size`` lanes x ``--traj-len`` steps of the world and the policy
stepped together on the device (``envs.jaxenv.AnakinRunner``), and refuses
to start when its first window is not device-pure.

Fleet health (``_init_health``), in the roles where the JAX launcher runs
it: a registry sampler into the time-series store every
``--health-sample-s``, the default rulebook of the roles the process hosts
evaluated every ``--health-eval-s``, and the crash flight recorder, whose
bundles land under ``<save-path>/flight``; the learner, actor, replay,
arena and league-learner roles also ship their snapshots and kept spans to
``--coordinator-addr`` every ``--telemetry-interval-s``. The coordinator
evaluates the whole rulebook over what the fleet ships and answers
``/healthz``, ``/alerts``, ``/timeseries``, ``/traces`` and
``/trace/<id>``; ``--metrics-port`` serves ``/metrics`` and those routes
on the learner-hosting roles and the actor, and the replay role's admin
surface. In ``--type all`` a firing ``actor_env_starvation`` restarts the
actor's job loop (``AlertRemediator``). ``--no-health`` turns all of it
off.

The coordinator, the league, the replay store, the arena and the actor
exit on SIGTERM or SIGINT; the learner saves a checkpoint first. As in the
JAX package, the coordinator (unless it hosts ``--arena-store``), the
actor, the replay store and the arena dump a flight bundle on SIGTERM
first: each installs its stop handler and then the crash hook, which
chains over it; the learner-hosting roles, whose checkpoint-on-signal
handler stands over the crash hook while they train, and the league,
which runs no fleet health, do not.
``--type league --league-resume PATH`` loads the league's resume file
(either package's) when present and autosaves it every
``--league-autosave-s``.

``--config`` takes a YAML or JSON file or inline JSON: its ``model`` block
replaces the smoke model over ``default_model_config()`` (as in the JAX
launcher), its ``league`` block configures the league, and its ``learner``
block cascades over the learner defaults (as ``bin/sl_train.py``'s does);
``learner.batch_size``/``unroll_len`` and ``actor.env_num``/``traj_len``
stand where ``--batch-size``, ``--traj-len`` and ``--env-num`` are not given.

The learner on a mesh (``parallel/``): ``--mesh dp=K,fsdp=M,tp=N,sp=S``
builds a live mesh over the ranks of the process group for ``--type
learner`` and ``league-learner`` (league-run passes it on) and turns on
sharded checkpoints unless ``--no-sharded-ckpt``; ``--dist-method``
(``single_node``, ``auto``, ``slurm``, ``explicit`` with
``--dist-coordinator-address``, ``--dist-num-processes``,
``--dist-process-id``) forms the group (NCCL on CUDA, gloo with ``--device
cpu``); ``--host-devices N`` runs ``--type learner`` as N gloo ranks on the
CPU (implies ``--device cpu``), each pulling its own rows of every batch.

``--env sc2`` (or ``env.type: sc2``) plays real games through the SC2
client stack (``envs/sc2/``): ``make_sc2_env`` over the config's env block
(``map_name``, ``player_ids`` such as ``[agent, bot7]``, ``races``,
``game_steps_per_episode``, ...), on the install ``SC2PATH`` names, as the
JAX launcher does. ``NOT_PORTED`` names the JAX launcher's flags that raise
``NotImplementedError`` here.

``--dynamics-every N`` sets the learners' training-dynamics gauge-export
stride (``learner.dynamics.every_n``); 0 turns the tree off, as in the JAX
launcher.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import sys
import threading
from typing import Optional, Sequence

from .. import plugins
from ..comm import Adapter, Coordinator, CoordinatorServer
from ..league import League, LeagueAPIServer, RemoteLeague
from ..resilience import AlertRemediator, RestartPolicy, Supervisor, supervise_call
from ..utils import read_config

# role or flag prefix of the JAX launcher -> why it raises here
NOT_PORTED = {
    "--platform": "the JAX backend switch; the port picks its device with --device",
}

ROLES = ("all", "coordinator", "league", "learner", "actor", "replay", "arena", "league-run",
         "league-learner")

#: the rulebook the coordinator evaluates over the whole fleet's telemetry
FLEET_RULE_ROLES = ("learner", "actor", "coordinator", "trace", "serve", "replay", "distill", "arena")


def _user_cfg(args) -> dict:
    return read_config(args.config) if args.config else {}


def _model_cfg(args) -> dict:
    from .sl_train import SMOKE_MODEL

    return _user_cfg(args).get("model", SMOKE_MODEL if args.smoke_model else {})


def _resolve_args(args) -> None:
    """Fill the size flags from the config's learner and actor blocks where
    they are not given (the JAX launcher's cascade)."""
    user_cfg = _user_cfg(args)
    learner_cfg, actor_cfg = user_cfg.get("learner", {}), user_cfg.get("actor", {})
    if args.batch_size is None:
        args.batch_size = int(learner_cfg.get("batch_size", 4))
    if args.traj_len is None:
        args.traj_len = int(learner_cfg.get("unroll_len", actor_cfg.get("traj_len", 4)))
    if args.env_num is None:
        args.env_num = int(actor_cfg.get("env_num", 2))


def _jaxenv_cfgs(args):
    """(EnvConfig, ScenarioConfig) from the --jaxenv-* knobs."""
    from ..envs.jaxenv import EnvConfig, ScenarioConfig

    u = args.jaxenv_units
    return (EnvConfig(units_per_squad=u),
            ScenarioConfig(units_per_squad=u, max_units=u, episode_len=args.jaxenv_episode_len))


def _env_fn(args):
    """The env factory: ``--env`` wins, then the config's ``env.type``: the
    mock env (default), ``sc2``, real games through the client stack
    (``envs.sc2.launcher.make_sc2_env`` over the rest of the config's env
    block; the install is ``SC2PATH``'s), or ``jaxenv``, the micro-battle
    world through its host env on ``--device``."""
    from ..envs import MockEnv

    env_cfg = dict(_user_cfg(args).get("env", {}))
    env_type = args.env or env_cfg.get("type", "mock")
    env_cfg.pop("type", None)
    if env_type == "sc2":
        from ..envs.sc2.launcher import make_sc2_env

        return lambda: make_sc2_env({"env": env_cfg})
    if env_type == "jaxenv":
        from ..envs.jaxenv import JaxMicroBattleEnv

        jcfg, scfg = _jaxenv_cfgs(args)
        return lambda: JaxMicroBattleEnv(jcfg, scfg, device=args.device)
    if env_type != "mock":
        raise SystemExit(f"--env {env_type}: one of mock, sc2, jaxenv")
    return lambda: MockEnv(episode_game_loops=args.episode_game_loops)


def _dynamics_cfg(args, learner: Optional[dict] = None) -> dict:
    """--dynamics-every N -> the learner's training-dynamics block (over
    ``learner``'s): 0 turns the tree off (the overhead A/B's off arm),
    N > 0 sets the gauge-export stride, absent keeps the block."""
    every = getattr(args, "dynamics_every", None)
    if every is None:
        return {}
    block = dict((learner or {}).get("dynamics", {}) or {})
    block.update({"enabled": False} if every <= 0 else {"every_n": every})
    return {"dynamics": block}


def _learner_cfg(args, model_cfg: dict, load_path: str = "") -> dict:
    """The learner config of the flags; ``--mesh`` implies the sharded
    checkpoint layout unless ``--sharded-ckpt``/``--no-sharded-ckpt`` (or
    the config's learner block) says otherwise, as in the JAX launcher."""
    user = _user_cfg(args).get("learner", {})
    sharded = getattr(args, "sharded_ckpt", None)
    if sharded is None:
        sharded = user.get("sharded_ckpt", bool(getattr(args, "mesh", "")))
    return {
        "common": {"experiment_name": args.experiment_name,
                   **({"save_path": args.save_path} if args.save_path else {})},
        "learner": {
            "log_freq": max(args.iters // 4, 1),
            "save_freq": 10 ** 9,
            **user,
            "batch_size": args.batch_size,
            "unroll_len": args.traj_len,
            "sharded_ckpt": bool(sharded),
            **({"load_path": load_path} if load_path else {}),
            **_dynamics_cfg(args, user),
        },
        "model": model_cfg,
    }


def _dist_from_args(args) -> dict:
    """Form the default process group the ``--dist-*`` flags describe
    (``single_node``: a world of one), on ``--device``."""
    from ..parallel.dist import dist_init

    method = getattr(args, "dist_method", "single_node")
    return dist_init(method=method, coordinator_address=getattr(args, "dist_coordinator_address", "") or None,
                     num_processes=getattr(args, "dist_num_processes", None),
                     process_id=getattr(args, "dist_process_id", None), device=args.device)


def _mesh_from_args(args):
    """``--mesh dp=K,fsdp=M,tp=N,sp=S`` -> a live mesh over the ranks of
    the process group (formed by ``_dist_from_args`` if none is); None
    without the flag. A fully given spec claims exactly that many ranks;
    ``MeshConfigError`` when they do not factor."""
    if not getattr(args, "mesh", ""):
        return None
    import torch.distributed as dist

    from ..parallel import MeshSpec, make_mesh

    _dist_from_args(args)
    spec = MeshSpec.parse(args.mesh)
    ranks = list(range(dist.get_world_size()))
    return make_mesh(spec, ranks[:spec.total()] if spec.dp != -1 else None)


def _make_learner(args, model_cfg: dict, load_path: str = "", mesh=None):
    """The RL learner of ``--pipeline`` on ``mesh`` (default: ``--mesh``'s),
    or with ``--distill`` the student tier's ``DistillLearner`` on the same
    batch stream (unsharded, as in the JAX launcher)."""
    cfg = _learner_cfg(args, model_cfg, load_path=load_path)
    if args.distill:
        from ..learner import DistillLearner

        return DistillLearner(cfg, device=args.device)
    mesh = mesh if mesh is not None else _mesh_from_args(args)
    cls = plugins.load_component(args.pipeline, "RLLearner")
    return cls(cfg, device=args.device, **({"mesh": mesh} if mesh is not None else {}))


def _plane_cfg(args) -> dict:
    """The actor's rollout-plane block: per-actor inline inference (default),
    one shared in-process gateway per player (local), or a remote
    ``bin/serve.py`` gateway or fleet (remote, needs ``--plane-addr``)."""
    if args.plane == "remote" and not args.plane_addr:
        raise SystemExit("--plane remote requires --plane-addr host:port "
                         "(or 'h1:p1,h2:p2', or 'discover')")
    if args.plane == "remote" and args.plane_addr == "discover" and not args.coordinator_addr:
        raise SystemExit("--plane-addr discover requires --coordinator-addr "
                         "(gateways register under the serve_gateway token)")
    return {"backend": args.plane, "addr": args.plane_addr, "slots": args.plane_slots,
            "coordinator_addr": args.coordinator_addr or "", "transport": args.transport}


def _restart_policy(args) -> RestartPolicy:
    return RestartPolicy(max_restarts=args.restart_max, window_s=args.restart_window_s)


@dataclasses.dataclass
class Health:
    """What ``_init_health`` stood up for a role: the process's started
    ``FleetHealth`` (its crash hook installed) and, with a coordinator to
    ship to, the ``TelemetryShipper``."""

    fleet: object
    shipper: Optional[object] = None


def _init_health(args, roles, source: str = "local", shipper_addr=None,
                 sigterm_bundle: bool = True) -> Optional[Health]:
    """Fleet health for this process, as the JAX launcher stands it up: the
    registry sampler into a time-series store, the default rulebook of the
    roles it hosts (the coordinator: all of them, over what the fleet
    ships) and the crash flight recorder, whose bundles land under
    ``<save-path>/flight``. With ``shipper_addr`` the process also ships
    its snapshots and kept spans to that coordinator. A role's stop
    handler installed before this call is chained under the crash hook's
    SIGTERM (a bundle, then the handler); with ``sigterm_bundle`` False
    the hook leaves SIGTERM to it. The cadences default as in the JAX
    launcher where a launcher has no flag for them. None under
    ``--no-health``."""
    if getattr(args, "no_health", False):
        return None
    from ..learner.base_learner import experiments_root
    from ..obs import TelemetryShipper, default_rulebook, init_fleet_health

    fleet = init_fleet_health(rules=default_rulebook(roles), source=source,
                              sample_interval_s=getattr(args, "health_sample_s", 1.0),
                              eval_interval_s=getattr(args, "health_eval_s", 2.0))
    root = args.save_path or os.path.join(experiments_root(), args.experiment_name)
    fleet.recorder.install_crash_hook(os.path.join(root, "flight"), config=vars(args),
                                      handle_sigterm=sigterm_bundle)
    shipper = None
    interval_s = getattr(args, "telemetry_interval_s", 5.0)
    if shipper_addr is not None and interval_s > 0:
        shipper = TelemetryShipper(source, coordinator_addr=shipper_addr, interval_s=interval_s).start()
    return Health(fleet, shipper)


def _maybe_serve_metrics(args, coordinator=None):
    """With ``--metrics-port``: a ``CoordinatorServer`` on that port as this
    process's exporter (``/metrics`` and the fleet-health routes; outside
    the broker its POST routes go unused). Returns the server or None."""
    if args.metrics_port is None:
        return None
    server = CoordinatorServer(coordinator=coordinator, port=args.metrics_port)
    server.start()
    print(f"metrics on http://{server.host}:{server.port}/metrics", flush=True)
    return server


def _close_health(health: Optional[Health], metrics=None) -> None:
    """A role's normal return: ship once more, so the coordinator holds the
    role's last counters, then stop shipping, sampling, evaluating and the
    metrics server, and take the crash hook off. A role that raises keeps
    the hook, so its unhandled exception still dumps a bundle."""
    if metrics is not None:
        metrics.stop()
    if health is not None:
        if health.shipper is not None:
            health.shipper.stop()
            try:
                health.shipper.ship_once()
            except Exception:  # as in the shipper's loop: counted, never the role's failure
                from ..obs import get_registry

                get_registry().counter("distar_telemetry_ship_errors_total", "failed telemetry pushes").inc()
        health.fleet.stop()
        health.fleet.recorder.uninstall_crash_hook()


def _on_stop_signals(fn) -> dict:
    """``fn()`` on SIGTERM and SIGINT; returns the handlers it replaced.
    Installed before ``_init_health``, the crash hook chains over it (a
    bundle, then ``fn``)."""
    return {s: signal.signal(s, lambda *_: fn()) for s in (signal.SIGTERM, signal.SIGINT)}


def _restore_signals(previous: dict) -> None:
    for s, handler in previous.items():
        signal.signal(s, handler)


def _run_learner_supervised(args, learner, iters: int) -> None:
    """Train to ``iters`` under ``supervise_call``: a crash resumes from the
    ``latest`` pointer and trains on, within the restart budget."""
    if args.admin_port is not None:
        admin = learner.start_admin(port=args.admin_port)
        print(f"learner admin on http://{admin.host}:{admin.port}/learner/status", flush=True)
    if args.no_supervise:
        learner.run(max_iterations=iters)
        return

    def resume(error):
        path = learner.resume_latest()
        print(f"learner restart after {error!r}: resume={path or 'cold'} "
              f"iter={learner.last_iter.val}", flush=True)

    supervise_call(lambda: learner.run(max_iterations=iters), op="learner",
                   policy=_restart_policy(args), on_restart=resume)


def _table_config(args):
    """Per-player replay-table settings from the flags (the store's table
    factory: every player token gets one of these)."""
    from ..replay import TableConfig

    spi = args.replay_spi
    batch = max(args.batch_size or 1, 1)
    error_buffer = args.replay_error_buffer
    if error_buffer is None and spi > 0:
        # batch-aware slack: the limiter must be able to admit a whole
        # learner batch, or sampler and inserter deadlock trading timeouts
        # (RateLimiter.max_sample_batch)
        error_buffer = max(spi, 1.0) * batch
    return TableConfig(
        max_size=args.replay_max_size,
        sampler=args.replay_sampler,
        samples_per_insert=None if spi <= 0 else spi,
        # 0 = the learner batch size: sampling cannot start below one batch
        min_size_to_sample=max(args.replay_min_size or batch, 1),
        error_buffer=error_buffer,
        max_staleness_s=args.replay_max_staleness_s or None,
    )


def _build_replay_store(args, shard_id: str = "", spill_dir: Optional[str] = None):
    """Store and spill of a serving replay role; recovery runs before it
    serves, so the acknowledged, unsampled trajectories of a crashed
    generation are resident (as encoded payloads, re-served without
    recompression) before the first sample. ``shard_id`` labels a fleet
    member's metrics and stats."""
    from ..replay import ReplayStore, SpillRing

    _table_config(args)  # fail fast on invalid combinations (fifo with spi > 1)
    spill = None
    spill_dir = args.replay_spill_dir if spill_dir is None else spill_dir
    if spill_dir:
        spill = SpillRing(spill_dir, max_items=args.replay_spill_max)
    store = ReplayStore(table_factory=lambda name: _table_config(args),
                        spill=spill, shard_id=shard_id, recover_encoded=True)
    recovered = store.recover()
    if recovered:
        print(f"replay{f' shard {shard_id}' if shard_id else ''}: recovered "
              f"{recovered} acked trajectories from spill", flush=True)
    return store


def _learner_replay_client(args, addrs: str):
    """The learner's sample client: ``inproc`` -> the colocated store, one
    address -> a ``SampleClient``, several -> the shard fleet's fan-in
    (a breaker per shard, stalled shards skipped), ``discover`` -> the
    coordinator's shard map."""
    from ..replay import LocalReplayClient, SampleClient, ShardMap, ShardedSampleClient, is_inproc_addr

    if is_inproc_addr(addrs):
        return LocalReplayClient()
    if addrs.strip().lower() == "discover":
        shard_map = ShardMap.discover(_addr(args.coordinator_addr))
    else:
        shard_map = ShardMap.parse(addrs)
    if len(shard_map) == 1:
        return SampleClient(*_addr(shard_map.addrs[0]), compress=args.replay_compress,
                            transport=args.transport)
    return ShardedSampleClient(shard_map, mode=args.replay_fanin, compress=args.replay_compress,
                               transport=args.transport)


def _replay_loader(args, addrs: str, player_id: str, rows: Optional[int] = None):
    from ..learner.rl_dataloader import ReplayDataLoader

    return ReplayDataLoader(_learner_replay_client(args, addrs), player_id, rows or args.batch_size)


@dataclasses.dataclass
class Loop:
    """The pieces of one in-process league-RL loop (``build_all``);
    ``replay_stores`` and ``replay_servers`` are ``--replay``'s."""

    league: League
    actor: object
    learner: object
    player_id: str
    supervisor: Supervisor
    replay_stores: list = dataclasses.field(default_factory=list)
    replay_servers: list = dataclasses.field(default_factory=list)
    coordinator: Optional[Coordinator] = None


def _build_replay_layout(args):
    """``--replay``'s stores between actor and learner, in one of three
    layouts: one ``ReplayServer`` on loopback (default), ``--replay-shards
    N`` servers (the actor routes by consistent hash, the learner fans in),
    or ``--replay-fast-path``: no server, the colocated store handed to
    both sides (no serialization on push or sample). Returns the stores,
    the servers and the actor's ``replay`` block."""
    from ..replay import ReplayServer, set_local_store

    if args.replay_fast_path:
        if args.replay_shards > 1:
            raise SystemExit("--replay-fast-path is the single colocated store; it cannot combine "
                             "with --replay-shards")
        store = _build_replay_store(args)
        set_local_store(store)
        print("replay store (colocated zero-copy fast path)", flush=True)
        return [store], [], {"enabled": True, "addr": "inproc"}
    stores, servers = [], []
    for i in range(max(args.replay_shards, 1)):
        shard_id = f"s{i}" if args.replay_shards > 1 else ""
        spill_dir = args.replay_spill_dir
        if spill_dir and shard_id:
            spill_dir = os.path.join(spill_dir, shard_id)
        stores.append(_build_replay_store(args, shard_id=shard_id, spill_dir=spill_dir))
        servers.append(ReplayServer(stores[-1], port=0, compress=args.replay_compress,
                                    transport=args.transport).start())
    addrs = ",".join(f"{s.host}:{s.port}" for s in servers)
    print(f"replay store{'s' if len(servers) > 1 else ''} (in-process) on {addrs}", flush=True)
    return stores, servers, {"enabled": True, "addr": addrs, "compress": args.replay_compress,
                             "transport": args.transport}


def build_all(args) -> Loop:
    """League, coordinator, actor (its job loop not started) and learner of
    ``--type all``, wired: the actor pushes trajectories and pulls weights
    through one adapter, the learner reads them through another."""
    from ..actor import Actor
    from ..learner.rl_dataloader import RLDataLoader

    model_cfg = _model_cfg(args)
    league = League(_user_cfg(args))
    co = Coordinator()
    actor_adapter, learner_adapter = Adapter(coordinator=co), Adapter(coordinator=co)
    player_id = list(league.active_players.keys())[0]
    stores, servers, replay_cfg = _build_replay_layout(args) if args.replay else ([], [], {})
    actor = Actor(
        cfg={"actor": {"env_num": args.env_num, "traj_len": args.traj_len,
                       "plane": _plane_cfg(args), **({"replay": replay_cfg} if replay_cfg else {})}},
        league=league, adapter=actor_adapter, model_cfg=model_cfg, env_fn=_env_fn(args),
        device=args.device)
    supervisor = Supervisor(policy=_restart_policy(args))

    def actor_loop(ctx):
        while not ctx.should_exit:
            actor.run_job(episodes=1)

    supervisor.add("actor", actor_loop)
    learner = _make_learner(args, model_cfg)
    if replay_cfg:
        learner.set_dataloader(_replay_loader(args, replay_cfg["addr"], player_id))
    else:
        learner.set_dataloader(RLDataLoader(learner_adapter, player_id, args.batch_size))
    if not args.distill:
        # the student tier publishes through checkpoints, not the weight plane
        learner.attach_comm(learner_adapter, player_id, league=league,
                            send_model_freq=4, send_train_info_freq=4)
    return Loop(league, actor, learner, player_id, supervisor, stores, servers, coordinator=co)


def close_all(loop: Loop) -> None:
    """Stop what ``build_all`` started: the actor's job loop (after its
    job: its thread is in the middle of a flush, and the stores stop pacing
    so a push the limiter holds for a learner that has finished goes
    through), the learner's prefetcher, the replay servers and the
    colocated store's registration."""
    from ..learner.prefetch import DevicePrefetcher

    for store in loop.replay_stores:
        for name in store.tables():
            store.table(name).limiter.release_pacing()
    loop.supervisor.stop(timeout=120)
    if isinstance(loop.learner._dataloader, DevicePrefetcher):
        loop.learner._dataloader.close()
    for server in loop.replay_servers:
        server.stop()
    if loop.replay_stores and not loop.replay_servers:
        from ..replay import set_local_store

        set_local_store(None)


def run_all(args) -> Loop:
    # one process hosts every role, so their whole rulebook applies here
    roles = ("learner", "actor", "coordinator", "trace") + (("replay",) if args.replay else ()) + (
        ("distill",) if args.distill else ())
    health = _init_health(args, roles=roles)
    loop = build_all(args)
    metrics = _maybe_serve_metrics(args, coordinator=loop.coordinator)
    loop.supervisor.start()
    if health is not None and not args.no_supervise:
        # detect -> remediate: a firing env-starvation alert bounces the
        # actor's job loop instead of waiting for a human
        AlertRemediator(loop.supervisor, {"actor_env_starvation": "actor"}).attach(health.fleet.evaluator)
    try:
        _run_learner_supervised(args, loop.learner, args.iters)
    finally:
        close_all(loop)
    _close_health(health, metrics)
    learner = loop.learner
    print(f"rl_train done: {learner.last_iter.val} iters, "
          f"loss={learner.variable_record.get('total_loss').avg:.4f}, "
          f"games={loop.league.all_players[loop.player_id].total_game_count}", flush=True)
    return loop


def build_anakin(args):
    """The learner of ``--anakin`` and its dataloader, wired: an
    ``AnakinRunner`` of ``--batch-size`` lanes x ``--traj-len`` steps on the
    learner's device, fed by the learner's live model. No prefetch: the
    batches are made on the device, and a prefetch thread would run the
    next window with the model the step is updating. Refuses to train when
    the first window is not device-pure (``purity_report``: no host read or
    synchronizing call inside it). Returns (learner, loader, the report)."""
    from ..envs.jaxenv import AnakinDataLoader, AnakinRunner

    learner = _make_learner(args, _model_cfg(args))
    learner.cfg.learner["prefetch_depth"] = 0
    jcfg, scfg = _jaxenv_cfgs(args)
    runner = AnakinRunner(learner.model, batch_size=args.batch_size, unroll_len=args.traj_len,
                          env_cfg=jcfg, scenario_cfg=scfg, device=learner.device)
    loader = AnakinDataLoader(runner, model_provider=lambda: learner.model)
    report = runner.purity_report(learner.model, runner.init_carry())
    print(f"anakin device purity: {report}", flush=True)
    if not report["pure"]:
        raise SystemExit(f"anakin loop is not device-pure: {report['offending']}")
    print(f"anakin: B={runner.B} lanes x T={runner.T} steps ({runner.B * runner.T} env steps/window), "
          f"units_per_squad={jcfg.units_per_squad}, device {runner.device}", flush=True)
    learner.set_dataloader(loader)
    return learner, loader, report


def run_anakin(args):
    health = _init_health(args, roles=("learner", "trace"))
    metrics = _maybe_serve_metrics(args)
    learner, _, _ = build_anakin(args)
    _run_learner_supervised(args, learner, args.iters)
    _close_health(health, metrics)
    print(f"learner done: {learner.last_iter.val} iters, "
          f"loss={learner.variable_record.get('total_loss').avg:.4f}", flush=True)
    return learner


def _addr(s: str):
    """``"host:port"`` -> ``(host, port)``; an HA address list
    (``"h1:p1,h2:p2"``) -> ``(list, None)``, which ``coordinator_request``
    resolves with leadership failover (a list that does not parse raises
    ``ValueError``)."""
    if "," in s:
        from ..comm.ha import format_addrs, parse_addrs

        return format_addrs(parse_addrs(s)), None
    host, _, port = s.rpartition(":")
    return host or "127.0.0.1", int(port)


def _learner_rank(rank: int, argv: list) -> None:
    """One gloo rank of ``--type learner --host-devices N`` (the group is
    formed by ``parallel.dist.spawn_ranks``)."""
    args = parser().parse_known_args(argv)[0]
    _resolve_args(args)
    args.host_devices, args.device = 0, "cpu"
    run_learner(args).scalar_sink.close()  # its writer thread must not outlive the rank's exit


def run_learner(args):
    from ..learner.rl_dataloader import RLDataLoader

    if args.host_devices:
        from ..parallel.dist import spawn_ranks

        argv = list(getattr(args, "argv", []))
        codes = spawn_ranks(_learner_rank, args.host_devices, argv, timeout_s=7 * 24 * 3600.0)
        bad = [c for c in codes if c != 0]
        if bad:
            raise SystemExit(bad[0] if bad[0] is not None else 1)
        return None
    info = _dist_from_args(args) if (args.mesh or args.dist_method != "single_node") else {
        "rank": 0, "world_size": 1}
    mesh = _mesh_from_args(args)
    if mesh is None and info["world_size"] > 1:
        from ..parallel import MeshSpec, make_mesh

        mesh = make_mesh(MeshSpec())  # the JAX learner's default: dp over every rank
    lead = info["rank"] == 0
    league = RemoteLeague(*_addr(args.league_addr)) if args.league_addr else None
    adapter = Adapter(coordinator_addr=_addr(args.coordinator_addr))
    health = _init_health(args, roles=("learner", "trace") + (("distill",) if args.distill else ()),
                          source=f"{'distill' if args.distill else 'learner'}:{args.player_id}:"
                                 f"{info['rank']}",
                          shipper_addr=_addr(args.coordinator_addr))
    metrics = _maybe_serve_metrics(args)
    model_cfg = _model_cfg(args)
    load_path = ""
    if league is not None:
        reply = league.register_learner(args.player_id, rank=info["rank"], world_size=info["world_size"])
        # resume from the league-assigned player checkpoint where it exists
        ckpt = reply.get("checkpoint_path", "")
        if ckpt and os.path.exists(ckpt):
            load_path = ckpt
    learner = _make_learner(args, model_cfg, load_path=load_path, mesh=mesh)
    if not load_path and not args.no_supervise:
        # a restarted learner process picks up its own latest pointer
        path = learner.resume_latest()
        if lead:
            print(f"rl_train resume: {path or 'cold'} iter {learner.last_iter.val}", flush=True)
    # on several ranks each batch block pulls its own rows (the multi-host
    # path): the loaders' batch is the block's share of the mesh the
    # learner fitted, and a block's tp x sp replicas train on what its
    # first rank pulls
    local, rows = info["world_size"] > 1, learner.local_batch_size
    if args.replay_addr:
        # batches from the replay table(s) instead of the pull cache
        learner.set_dataloader(_replay_loader(args, args.replay_addr, args.player_id, rows), local=local)
    else:
        learner.set_dataloader(RLDataLoader(adapter, args.player_id, rows), local=local)
    if not args.distill:
        learner.attach_comm(adapter, args.player_id, league=league)
    _run_learner_supervised(args, learner, args.iters)
    _close_health(health, metrics)
    if lead:
        print(f"learner done: {learner.last_iter.val} iters", flush=True)
    return learner


def run_actor(args) -> None:
    from ..actor import Actor

    # SIGTERM leaves the job loop as SystemExit: the job's finally closes the
    # env pool and the plane's clients, and no restart catches it. Installed
    # before the crash hook, which chains over it: a bundle first, as the
    # JAX actor dumps one
    previous = _on_stop_signals(lambda: sys.exit(0))
    league = RemoteLeague(*_addr(args.league_addr))
    adapter = Adapter(coordinator_addr=_addr(args.coordinator_addr))
    health = _init_health(args, roles=("actor", "trace"), source=f"actor:{os.getpid()}",
                          shipper_addr=_addr(args.coordinator_addr))
    metrics = _maybe_serve_metrics(args)
    actor_cfg = {"env_num": args.env_num, "traj_len": args.traj_len, "plane": _plane_cfg(args)}
    if args.replay_addr:
        replay_addr = args.replay_addr
        if replay_addr.strip().lower() == "discover":
            # the fleet read once at launch from the coordinator's shard
            # registrations (the actor's config carries plain addresses)
            from ..replay import ShardMap

            replay_addr = ",".join(ShardMap.discover(_addr(args.coordinator_addr)).addrs)
            print(f"replay: discovered shard fleet {replay_addr}", flush=True)
        actor_cfg["replay"] = {"enabled": True, "addr": replay_addr, "compress": args.replay_compress,
                               "transport": args.transport}
    actor = Actor(cfg={"actor": actor_cfg}, league=league, adapter=adapter, model_cfg=_model_cfg(args),
                  env_fn=_env_fn(args), device=args.device)
    print(f"actor ready: env_num={args.env_num} traj_len={args.traj_len}", flush=True)

    def job_loop():
        while True:
            actor.run_job(episodes=1)

    try:
        if args.no_supervise:
            job_loop()
        else:
            supervise_call(job_loop, op="actor", policy=_restart_policy(args))
    except SystemExit:
        _close_health(health, metrics)
        raise
    finally:
        _restore_signals(previous)


def _serve_until_signal(server, what: str, done: Optional[threading.Event] = None) -> None:
    """Start ``server``, print where it serves, and stop it on SIGTERM or
    SIGINT; or, with ``done``, when that event is set (its caller installs
    the signal handlers that set it)."""
    server.start()
    print(f"{what} serving on {server.host}:{server.port}", flush=True)
    previous = {}
    if done is None:
        done = threading.Event()
        previous = _on_stop_signals(done.set)
    try:
        while not done.wait(0.5):
            pass
    finally:
        _restore_signals(previous)
        server.stop()


def run_replay(args) -> None:
    """The replay-store role: the framed-TCP data plane on ``--port``, the
    HTTP admin surface (``/replay/stats``, ``/metrics``, ``POST /drain``) on
    ``--metrics-port``, spill recovery on every (re)start under crash-restart
    supervision; with ``--coordinator-addr`` the shard registers under the
    ``replay_shard`` token (lease and heartbeat), so roles started with
    ``--replay-addr discover`` find the fleet. SIGTERM or SIGINT stops it,
    the spill's manifest flushed."""
    from ..replay import ReplayAdminServer, ReplayServer, register_shard
    from ..resilience import TaskContext

    shard_id = args.replay_shard_id or (f":{args.port}" if args.port else "")
    stop = TaskContext()  # set by SIGTERM or SIGINT
    # before the crash hook, which chains over it: SIGTERM dumps a bundle
    # and then stops the store, as the JAX replay role dumps one
    previous = _on_stop_signals(stop.request_stop)
    health = _init_health(args, roles=("replay",), source=f"replay{shard_id}" if shard_id else "replay",
                          shipper_addr=_addr(args.coordinator_addr) if args.coordinator_addr else None)

    def serve_loop(ctx):
        store = _build_replay_store(args, shard_id=shard_id)
        server = ReplayServer(store, port=args.port, compress=args.replay_compress,
                              transport=args.transport).start()
        admin = heartbeat = None
        try:
            if args.metrics_port is not None:
                admin = ReplayAdminServer(store, port=args.metrics_port, server=server).start()
                print(f"replay admin on http://{admin.host}:{admin.port}/replay/stats", flush=True)
            if args.coordinator_addr:
                heartbeat = register_shard(
                    _addr(args.coordinator_addr), server.host, server.port,
                    meta={"admin_port": args.metrics_port},  # as given (0: ephemeral), as in JAX
                    lease_s=args.lease_s or None)
            print(f"replay store serving on {server.host}:{server.port}", flush=True)
            while not ctx.should_exit:
                ctx.sleep(0.5)
        finally:
            if heartbeat is not None:
                heartbeat.stop_event.set()
            server.stop()
            if admin is not None:
                admin.stop()
            if store._spill is not None:
                store._spill.flush()

    try:
        if args.no_supervise:
            serve_loop(stop)
        else:
            supervisor = Supervisor(policy=_restart_policy(args))
            supervisor.add("replay", serve_loop)
            supervisor.start()
            while not stop.sleep(0.5):
                pass
            supervisor.stop(timeout=30)
        _close_health(health)
    finally:
        _restore_signals(previous)


def run_coordinator(args) -> None:
    """The broker; with ``--arena-store PATH`` it hosts the durable
    ``ArenaStore`` (the ``arena_*`` routes and ``/arena/*``): the journal at
    PATH is reloaded first (ratings, payoff and the idempotency keys survive
    a restart), autosaved every ``--league-autosave-s`` and saved once more
    on the way out (SIGTERM or SIGINT). It evaluates the whole rulebook over
    what the fleet ships; SIGTERM dumps a flight bundle first, unless the
    arena store is hosted (the JAX launcher's journaling handler stands
    over the crash hook there)."""
    done = threading.Event()
    previous = _on_stop_signals(done.set)
    health = _init_health(args, roles=FLEET_RULE_ROLES, source="coordinator",
                          sigterm_bundle=not (args.arena_store or args.journal_dir))
    store = None
    if args.arena_store:
        from ..arena import ArenaStore, set_arena_store

        store = ArenaStore(path=args.arena_store)
        if store.maybe_load():
            print(f"arena store resumed from {args.arena_store}", flush=True)
        store.start_autosave(interval_s=args.league_autosave_s or 30.0)
        set_arena_store(store)
    co = Coordinator(default_lease_s=args.lease_s or None)
    server = CoordinatorServer(coordinator=co, port=args.port)
    ha_state = None
    if args.journal_dir:
        # the HA broker: every mutating route journaled, the journal
        # replayed first, the follower feed served; with --ha-peers,
        # leadership by lease and epoch fencing
        from ..comm.ha import HAState

        ha_state = HAState(co, args.journal_dir, advertise=args.ha_advertise or f"127.0.0.1:{server.port}",
                           feed_port=args.ha_port, peers=[p for p in (args.ha_peers or "").split(",") if p],
                           role=args.ha_role, takeover_grace_s=args.ha_takeover_grace_s)
        ha_state.boot()
        server.attach_ha(ha_state)
        print(f"coordinator HA: role={ha_state.role} epoch={ha_state.epoch} journal={args.journal_dir} "
              f"feed=:{ha_state.feed_port}", flush=True)
    try:
        _serve_until_signal(server, "coordinator", done=done)
    finally:
        if store is not None:
            from ..arena import set_arena_store

            store.stop_autosave()
            store.save()
            set_arena_store(None)
            print("arena store journaled on shutdown", flush=True)
        if ha_state is not None:
            ha_state.final_snapshot()
            ha_state.stop()
            print("coordinator journal snapshotted on shutdown", flush=True)
    _close_health(health)
    _restore_signals(previous)


def run_league(args) -> None:
    """The league's HTTP API; with ``--league-resume PATH`` the league is
    picked up from the resume file there (the port's or the JAX
    package's) and journaled to it every ``--league-autosave-s``."""
    league = League(_user_cfg(args))
    if args.league_resume:
        if os.path.exists(args.league_resume):
            league.load_resume(args.league_resume)
            print(f"league resumed from {args.league_resume}", flush=True)
        league.start_autosave(args.league_resume, interval_s=args.league_autosave_s or None)
    try:
        _serve_until_signal(LeagueAPIServer(league, port=args.port), "league")
    finally:
        league.stop_autosave()


def run_arena(args):
    """The arena evaluator: checkpoint generations of ``--arena-ckpt-dir``
    (role keys ``--arena-roles``) play the coordinator-scheduled jaxenv
    head-to-heads on ``--device`` and report under idempotent match keys,
    under crash-restart supervision (the store re-issues an assignment
    until its results are applied). Stops after ``--arena-batches`` (0:
    never) or on SIGTERM or SIGINT, then writes ``--arena-artifact``.
    Returns the evaluator."""
    from ..arena import ArenaEvaluator
    from ..resilience import TaskContext

    roles = tuple(r.strip() for r in args.arena_roles.split(",")) if args.arena_roles else ("",)
    env_cfg, scenario_cfg = _jaxenv_cfgs(args)
    stop = TaskContext()  # set by SIGTERM or SIGINT
    # before the crash hook, which chains over it: SIGTERM dumps a bundle
    # and then stops the evaluator, as the JAX arena role dumps one
    previous = _on_stop_signals(stop.request_stop)
    health = _init_health(args, roles=("arena",), source="arena", shipper_addr=_addr(args.coordinator_addr))

    def serve_loop():
        evaluator = ArenaEvaluator(
            ckpt_dir=args.arena_ckpt_dir, model_cfg=_model_cfg(args),
            coordinator_addr=_addr(args.coordinator_addr), roles=roles,
            episodes=args.arena_episodes, env_cfg=env_cfg, scenario_cfg=scenario_cfg,
            device=args.device)
        print(f"arena evaluator on {args.arena_ckpt_dir} (roles={','.join(r or 'main' for r in roles)}, "
              f"device {evaluator.device})", flush=True)
        try:
            while not stop.should_exit:
                out = evaluator.evaluate_once()
                if out is None:
                    stop.sleep(args.arena_interval_s)
                    continue
                a = out["assignment"]
                print(f"arena: {a['home']} vs {a['away']} r{a['round']} "
                      f"win_rate={out['result']['win_rate']:.3f} applied={out['ack'].get('applied')} "
                      f"duration_s={out['result']['duration_s']:.3f}", flush=True)
                if args.arena_batches and evaluator.batches_done >= args.arena_batches:
                    break
        finally:
            if args.arena_artifact:
                evaluator.write_artifact(args.arena_artifact, ratings=_fetch_arena_ratings(args))
                print(f"arena artifact written to {args.arena_artifact}", flush=True)
        return evaluator

    try:
        if args.no_supervise:
            evaluator = serve_loop()
        else:
            evaluator = supervise_call(serve_loop, op="arena", policy=_restart_policy(args))
        _close_health(health)
        return evaluator
    finally:
        _restore_signals(previous)


def _fetch_arena_ratings(args) -> Optional[dict]:
    """GET /arena/ratings from the coordinator for the artifact ledger;
    None when the store isn't hosted there (artifact stays throughput-only).
    An HA address list is asked from its believed primary on (the JAX
    launcher builds a URL of the list itself, which answers nothing)."""
    import urllib.request

    from ..comm.ha import parse_addrs, targets_for

    addrs = parse_addrs(args.coordinator_addr)
    first = targets_for(addrs).active() if len(addrs) > 1 else addrs[0]
    for host, port in [first] + [a for a in addrs if a != first]:
        try:
            with urllib.request.urlopen(f"http://{host}:{port}/arena/ratings", timeout=10.0) as resp:
                return json.loads(resp.read())
        except Exception:  # noqa: BLE001 - the next address, else no ratings
            continue
    return None


def build_league_learner(args):
    """One league player's learner, its fused rollout and its loop, wired
    (``league/runtime/runner.py``): an ``RLLearner`` saving under its own
    subtree of the save path with ``ckpt_role = --player-id``, an
    ``AnakinRunner(opponent_seat=True)`` on its device seeded from the
    player id, the ``AnakinDataLoader`` whose away seat is the loop's
    opponent slot, and a ``LeagueLearnerLoop`` against the coordinator at
    ``--coordinator-addr``. No prefetch: the batches are made on the device.
    Refuses to train when the first window is not device-pure, as
    ``--anakin`` does. Returns (learner, loader, loop, the purity report)."""
    import zlib

    from ..envs.jaxenv import AnakinDataLoader, AnakinRunner
    from ..league.remote import RemoteLeagueService
    from ..league.runtime.runner import LeagueLearnerLoop
    from ..learner.base_learner import experiments_root

    player_id = args.player_id
    cfg = _learner_cfg(args, _model_cfg(args))
    # isolated checkpoint lineage per league player: a per-player save
    # subtree keeps file names (and logs) collision-free across concurrent
    # learners, and the role-keyed pointer file keeps generations from
    # crossing on resume
    cfg["common"]["save_path"] = os.path.join(
        cfg["common"].get("save_path") or os.path.join(experiments_root(), args.experiment_name),
        player_id)
    cfg["learner"]["ckpt_role"] = player_id
    mesh = _mesh_from_args(args)
    learner = plugins.load_component(args.pipeline, "RLLearner")(
        cfg, device=args.device, **({"mesh": mesh} if mesh is not None else {}))
    learner.cfg.learner["prefetch_depth"] = 0
    jcfg, scfg = _jaxenv_cfgs(args)
    runner = AnakinRunner(learner.model, batch_size=args.batch_size, unroll_len=args.traj_len,
                          env_cfg=jcfg, scenario_cfg=scfg,
                          seed=zlib.crc32(player_id.encode()) & 0x7FFFFFFF,
                          opponent_seat=True, device=learner.device)
    loop = LeagueLearnerLoop(player_id, RemoteLeagueService(args.coordinator_addr), learner, loader=None,
                             rounds=args.league_rounds, iters_per_round=args.league_iters_per_round)
    loader = AnakinDataLoader(runner, model_provider=lambda: learner.model,
                              opponent_provider=loop.opponent_model)
    loop.loader = loader
    learner.set_dataloader(loader)
    report = runner.purity_report(loader._model(), runner.init_carry(), loader._opponent_model())
    print(f"league-learner {player_id} device purity: {report}", flush=True)
    if not report["pure"]:
        raise SystemExit(f"league-learner fused loop is not device-pure: {report['offending']}")
    return learner, loader, loop, report


def run_league_learner(args):
    """One league learner process: register with the coordinator-hosted
    matchmaker, then ``--league-rounds`` matchmade rounds — the fused Anakin
    rollout on ``--device`` with the opponent on the away seat, the RL step,
    match reports under idempotent keys, checkpoint generations in this
    player's role-key lineage, and train-info (snapshot minting happens
    server-side). Under supervision it resumes its lineage on start and on
    a crash. Returns the loop's summary."""
    health = _init_health(args, roles=("learner", "trace"), source=f"league:{args.player_id}",
                          shipper_addr=_addr(args.coordinator_addr))
    metrics = _maybe_serve_metrics(args)
    learner, _, loop, _ = build_league_learner(args)
    if not args.no_supervise:
        learner.resume_latest()  # a supervised restart resumes the lineage

    def run_loop():
        out = loop.run()
        print(f"league-learner {args.player_id} done: {json.dumps(out)}", flush=True)
        return out

    if args.no_supervise:
        out = run_loop()
    else:
        out = supervise_call(run_loop, op=f"league-learner:{args.player_id}", policy=_restart_policy(args),
                             on_restart=lambda e: learner.resume_latest())
    _close_health(health, metrics)
    return out


def _model_flags(args) -> list:
    """The flags that pick this process's model, for a child process."""
    if args.config:
        return ["--config", args.config]
    return ["--smoke-model"] if args.smoke_model else ["--full-model"]


def run_league_run(args) -> dict:
    """The self-play economy launcher: the coordinator (``LeagueService`` +
    ``ArenaStore``) in this process, one ``league-learner`` subprocess per
    player of ``--league-players`` on ``--device`` with this process's
    model flags (docs/league.md quickstart). Returns the digest; exits 1
    unless every learner exited 0, at least one historical snapshot was
    minted from a checkpoint generation, and the payoff matrix has real
    off-diagonal entries. The control plane is journaled to
    ``--journal-dir`` (default ``<save-path>/league_journal``; ``none``:
    un-journaled); ``--league-actors-per-player N`` above 0 seeds each
    player's actor-slot fleet with N members and runs the payoff-driven
    reassigner over them."""
    from ..league.runtime.runner import LeagueRunner
    from ..learner.base_learner import experiments_root

    player_ids = [s.strip() for s in args.league_players.split(",") if s.strip()]
    save_path = args.save_path or os.path.join(experiments_root(), args.experiment_name)
    journal = args.journal_dir
    if not journal:
        journal = os.path.join(save_path, "league_journal")
    elif journal.lower() == "none":
        journal = ""  # the economy un-journaled
    extra = ["--batch-size", str(args.batch_size), "--traj-len", str(args.traj_len),
             "--jaxenv-units", str(args.jaxenv_units), "--jaxenv-episode-len", str(args.jaxenv_episode_len),
             "--experiment-name", args.experiment_name, *_model_flags(args)]
    if args.device:
        extra += ["--device", args.device]
    if args.mesh:
        extra += ["--mesh", args.mesh]
    if args.no_health:
        extra += ["--no-health"]
    if args.no_supervise:
        extra += ["--no-supervise"]
    runner = LeagueRunner(
        player_ids=player_ids, save_path=save_path, journal_dir=journal,
        arena_store_path=os.path.join(save_path, "arena_store.pkl"),
        lease_s=args.lease_s or 30.0,
        # first-round asks sit behind each learner's process start and
        # model build; a short TTL would count those as orphans
        job_ttl_s=600.0,
        learner_argv_extra=extra, rounds=args.league_rounds,
        iters_per_round=args.league_iters_per_round,
        actors_per_player=args.league_actors_per_player,
        reassign=args.league_actors_per_player > 0)
    digest = runner.run(port=args.port)
    print(f"league-run: seconds from spawn to exit {json.dumps(runner.learner_s)}", flush=True)
    if args.league_actors_per_player > 0:
        print(f"league-run: actor fleets held {json.dumps(runner.fleets_held)}, "
              f"left {json.dumps(runner.fleets_left)}", flush=True)
    if not digest.get("ok"):
        raise SystemExit(1)
    return digest


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--type", default="all",
                   help=f"one of {', '.join(ROLES)}")
    p.add_argument("--config", default="",
                   help="YAML or JSON file, or inline JSON: 'model', 'league', 'learner', 'actor', 'env'")
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=None, help="default: the config's, else 4")
    p.add_argument("--traj-len", type=int, default=None, help="default: the config's, else 4")
    p.add_argument("--env-num", type=int, default=None, help="default: the config's, else 2")
    p.add_argument("--episode-game-loops", type=int, default=300)
    p.add_argument("--env", default="", choices=("", "mock", "sc2", "jaxenv"),
                   help="mock (default), sc2 (real games on SC2PATH's install) or jaxenv (the "
                        "micro-battle world's host env); overrides the config's env.type")
    p.add_argument("--anakin", action="store_true",
                   help="train the learner from the jaxenv Anakin loop on the device (implies --env "
                        "jaxenv; replaces the actor plane)")
    p.add_argument("--jaxenv-units", type=int, default=4, help="jaxenv units a squad")
    p.add_argument("--jaxenv-episode-len", type=int, default=32, help="jaxenv env steps until timeout")
    p.add_argument("--experiment-name", default="rl_train")
    p.add_argument("--save-path", default="",
                   help="experiment root (default $DISTAR_EXPERIMENTS_ROOT or ./experiments, "
                        "then the experiment name)")
    p.add_argument("--smoke-model", action="store_true", default=True)
    p.add_argument("--full-model", dest="smoke_model", action="store_false",
                   help="default_model_config() at full width and depth")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; raises without CUDA unless 'cpu')")
    p.add_argument("--mesh", default="",
                   help="learner device mesh, e.g. 'dp=2,fsdp=2' over the process group's ranks "
                        "(--type learner, league-learner; implies sharded checkpoints)")
    p.add_argument("--sharded-ckpt", action="store_true", default=None,
                   help="checkpoint as one CRC'd blob per parameter shard + manifest (default: on "
                        "with --mesh)")
    p.add_argument("--no-sharded-ckpt", dest="sharded_ckpt", action="store_false")
    p.add_argument("--host-devices", type=int, default=0,
                   help="--type learner as N gloo ranks on the CPU (implies --device cpu)")
    p.add_argument("--dist-method", default="single_node",
                   choices=["auto", "slurm", "single_node", "explicit"])
    p.add_argument("--dist-coordinator-address", default="",
                   help="host:port of rank 0's store (explicit mode)")
    p.add_argument("--dist-num-processes", type=int, default=None)
    p.add_argument("--dist-process-id", type=int, default=None)
    p.add_argument("--port", type=int, default=0, help="coordinator and league roles: listen port")
    p.add_argument("--lease-s", type=float, default=0.0,
                   help="coordinator role: default registration lease (0: none)")
    p.add_argument("--journal-dir", default="",
                   help="--type coordinator: write-ahead-journal directory (comm/ha.py): every mutating "
                        "route journaled, replayed on restart, tailed by standbys ('': the in-memory "
                        "broker); --type league-run: default <save-path>/league_journal, 'none' runs the "
                        "economy un-journaled")
    p.add_argument("--ha-role", default="auto", choices=("auto", "primary", "standby"),
                   help="coordinator HA role: auto probes --ha-peers and joins a live primary as its "
                        "standby, else leads")
    p.add_argument("--ha-peers", default="",
                   help="comma list of the peer coordinators' host:port (the other members of the HA set)")
    p.add_argument("--ha-port", type=int, default=0,
                   help="journal follower-feed TCP port (0: ephemeral; peers read it from GET "
                        "/coordinator/ha)")
    p.add_argument("--ha-advertise", default="",
                   help="host:port this coordinator advertises to peers and clients (default "
                        "127.0.0.1:--port)")
    p.add_argument("--ha-takeover-grace-s", type=float, default=3.0,
                   help="a standby promotes after this long without contact from the primary's feed")
    p.add_argument("--league-addr", default="", help="host:port of the league role")
    p.add_argument("--coordinator-addr", default="",
                   help="host:port of the coordinator role (an HA set: 'h1:p1,h2:p2', followed across "
                        "failovers)")
    p.add_argument("--player-id", default="MP0")
    p.add_argument("--pipeline", default="default",
                   help="learner implementation: 'default' or an importable module (plugins.py)")
    p.add_argument("--plane", default="inline", choices=("inline", "local", "remote"),
                   help="where the actor's policy forwards run")
    p.add_argument("--plane-addr", default="",
                   help="--plane remote: host:port of a bin/serve.py gateway, 'h1:p1,h2:p2', "
                        "or 'discover'")
    p.add_argument("--plane-slots", type=int, default=0,
                   help="--plane local: slots of the shared engine (0: two sides of env_num)")
    p.add_argument("--transport", default="auto", choices=("auto", "tcp", "shm"),
                   help="every colocated hop (replay push and sample, --plane remote): shared-memory "
                        "rings to a server on this host (auto, shm), or the socket only (tcp)")
    p.add_argument("--replay", action="store_true",
                   help="--type all: trajectories through an in-process replay store instead of the "
                        "adapter")
    p.add_argument("--replay-addr", default="",
                   help="learner and actor: the replay store's 'host:port', a comma-separated shard "
                        "fleet, or 'discover' (the coordinator's replay_shard registrations)")
    p.add_argument("--replay-shards", type=int, default=1,
                   help="--type all: this many in-process replay shards (consistent-hash routing, "
                        "learner fan-in)")
    p.add_argument("--replay-fast-path", action="store_true",
                   help="--type all: the colocated store handed to actor and learner, no server")
    p.add_argument("--no-replay-compress", dest="replay_compress", action="store_false", default=True,
                   help="no wire compression on replay connections (negotiated per connection)")
    p.add_argument("--replay-fanin", default="round_robin", choices=("round_robin", "weighted"),
                   help="learner fan-in order over a shard fleet: rotation, or fullest shard first")
    p.add_argument("--replay-shard-id", default="",
                   help="--type replay: metrics and stats label of this fleet member (default ':<port>')")
    p.add_argument("--replay-max-size", type=int, default=1024,
                   help="replay: items a table holds (FIFO eviction past it)")
    p.add_argument("--replay-spi", type=float, default=1.0,
                   help="replay: samples-per-insert ratio the rate limiter keeps (<= 0: none)")
    p.add_argument("--replay-min-size", type=int, default=0,
                   help="replay: inserts before sampling starts (0: the learner batch size)")
    p.add_argument("--replay-error-buffer", type=float, default=None,
                   help="replay: the limiter's slack in samples (default max(1, spi) * batch size)")
    p.add_argument("--replay-sampler", default="fifo", choices=("fifo", "uniform", "prioritized"),
                   help="replay: fifo (consume once), uniform, or prioritized (sum tree)")
    p.add_argument("--replay-spill-dir", default="",
                   help="replay: disk-spill directory; acknowledged inserts survive a crash of the store")
    p.add_argument("--replay-spill-max", type=int, default=4096,
                   help="replay: spill ring bound (the oldest dropped past it)")
    p.add_argument("--replay-max-staleness-s", type=float, default=0.0,
                   help="replay: evict items older than this (0: never)")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve GET /metrics and the fleet-health routes on this port (the learner-hosting "
                        "roles and the actor; --type replay: its admin surface, /replay/stats and POST "
                        "/drain too; the coordinator serves them on --port already)")
    p.add_argument("--no-health", action="store_true",
                   help="no fleet health: no time-series sampler, rulebook, telemetry shipping or crash "
                        "recorder")
    p.add_argument("--health-sample-s", type=float, default=1.0, help="registry -> TSDB sampling cadence")
    p.add_argument("--health-eval-s", type=float, default=2.0, help="rulebook evaluation cadence")
    p.add_argument("--telemetry-interval-s", type=float, default=5.0,
                   help="snapshot shipping cadence to --coordinator-addr (learner, actor, replay, arena and "
                        "league-learner roles; 0: none)")
    p.add_argument("--distill", action="store_true",
                   help="train the student tier (DistillLearner) on the same batches")
    p.add_argument("--dynamics-every", type=int, default=None,
                   help="training-dynamics gauge-export stride (learner dynamics.every_n); 0 turns the "
                        "in-step tree off; default: the learner config's")
    p.add_argument("--admin-port", type=int, default=None,
                   help="serve the learner admin API (status, save_ckpt, ...) on this port")
    p.add_argument("--no-supervise", action="store_true",
                   help="no crash-restart supervision and no resume from the latest checkpoint")
    p.add_argument("--restart-max", type=int, default=5)
    p.add_argument("--restart-window-s", type=float, default=300.0)
    p.add_argument("--league-resume", default="",
                   help="--type league: resume file, loaded on start when present (either package's), "
                        "then autosaved")
    p.add_argument("--league-autosave-s", type=float, default=30.0,
                   help="--type league's resume and --type coordinator's arena-store autosave cadence "
                        "(0: the league config's save_resume_freq_s, or 30 s for the arena store)")
    p.add_argument("--league-players", default="MP0,EP0,ME0",
                   help="--type league-run: comma list of active league player ids (prefix picks the "
                        "class: MP main, EP exploiter, ME main exploiter); one learner process each")
    p.add_argument("--league-rounds", type=int, default=2,
                   help="league-run and league-learner: matchmade rounds per learner (each: ask -> train "
                        "-> report -> checkpoint generation -> train-info)")
    p.add_argument("--league-iters-per-round", type=int, default=1, help="optimizer steps per round")
    p.add_argument("--league-actors-per-player", type=int, default=0,
                   help="--type league-run: seed each player's elastic actor-slot fleet with this many "
                        "members and run the payoff-driven reassigner over them (0: no actor fleets; the "
                        "learners roll out on the device)")
    p.add_argument("--arena-ckpt-dir", default="",
                   help="--type arena: checkpoint directory whose CheckpointManager generations form "
                        "the model roster")
    p.add_argument("--arena-roles", default="",
                   help="--type arena: comma-separated CheckpointManager role keys to rate ('' = the "
                        "default lineage, shown as main)")
    p.add_argument("--arena-episodes", type=int, default=8,
                   help="--type arena: episodes per scheduled scenario batch")
    p.add_argument("--arena-batches", type=int, default=0,
                   help="--type arena: stop after N batches (0 = run until SIGTERM)")
    p.add_argument("--arena-interval-s", type=float, default=5.0,
                   help="--type arena: idle sleep when no assignment is available")
    p.add_argument("--arena-artifact", default="",
                   help="--type arena: write the ledger (matches/s and ratings) here on exit")
    p.add_argument("--arena-store", default="",
                   help="--type coordinator: host the durable ArenaStore, journaled at this path; "
                        "enables the arena routes")
    return p


def _refuse_not_ported(args, unknown) -> None:
    for token in [f"--type {args.type}", f"--env {args.env}"] + list(unknown):
        flag = token.split("=", 1)[0]
        for prefix, why in NOT_PORTED.items():
            if flag == prefix or (prefix.endswith("-") and flag.startswith(prefix)):
                raise NotImplementedError(f"{flag}: {why}")
    if unknown:
        raise SystemExit(f"rl_train: unrecognized arguments: {' '.join(unknown)}")


def main(argv: Optional[Sequence[str]] = None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args, unknown = parser().parse_known_args(argv)
    _refuse_not_ported(args, unknown)
    if args.dist_method == "explicit" and not (args.dist_coordinator_address and args.dist_num_processes is not None
                                               and args.dist_process_id is not None):
        raise SystemExit("--dist-method explicit requires --dist-coordinator-address, "
                         "--dist-num-processes and --dist-process-id")
    if args.host_devices:
        if args.type != "learner":
            raise SystemExit("--host-devices runs --type learner as N gloo ranks on the CPU")
        # the ranks' own argv: this one without --host-devices N
        args.argv = [a for i, a in enumerate(argv)
                     if a != "--host-devices" and not a.startswith("--host-devices=")
                     and (i == 0 or argv[i - 1] != "--host-devices")]
    if args.type not in ROLES:
        raise SystemExit(f"rl_train: --type must be one of {', '.join(ROLES)}, got {args.type!r}")
    _resolve_args(args)
    if args.anakin:
        if args.env and args.env != "jaxenv":
            raise SystemExit("--anakin requires --env jaxenv")
        return run_anakin(args)
    if args.type == "all":
        return run_all(args)
    if args.type == "replay":
        return run_replay(args)
    if args.type == "coordinator":
        return run_coordinator(args)
    if args.type == "league":
        return run_league(args)
    if args.type == "league-run":
        return run_league_run(args)
    if args.type == "league-learner":
        if not args.coordinator_addr:
            raise SystemExit("--type league-learner requires --coordinator-addr")
        return run_league_learner(args)
    if args.type == "arena":
        if not (args.coordinator_addr and args.arena_ckpt_dir):
            raise SystemExit("--type arena requires --coordinator-addr and --arena-ckpt-dir")
        return run_arena(args)
    if args.type == "learner":
        if not args.coordinator_addr:
            raise SystemExit("--type learner requires --coordinator-addr (and usually --league-addr)")
        return run_learner(args)
    if not (args.league_addr and args.coordinator_addr):
        raise SystemExit("--type actor requires --league-addr and --coordinator-addr")
    return run_actor(args)


if __name__ == "__main__":
    main()

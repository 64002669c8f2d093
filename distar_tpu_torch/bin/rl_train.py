"""League-RL launcher.

    python -m distar_tpu_torch.bin.rl_train --type all --smoke-model --device cpu --iters 2
    python -m distar_tpu_torch.bin.rl_train --type coordinator --port 8422
    python -m distar_tpu_torch.bin.rl_train --type league --port 8421
    python -m distar_tpu_torch.bin.rl_train --type learner --coordinator-addr H:8422 --league-addr H:8421
    python -m distar_tpu_torch.bin.rl_train --type actor --coordinator-addr H:8422 --league-addr H:8421
    python -m distar_tpu_torch.bin.rl_train --type all --replay --smoke-model --device cpu --iters 2
    python -m distar_tpu_torch.bin.rl_train --type replay --port 0 --replay-spill-dir D

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
  coordinator  the metadata broker (``comm.CoordinatorServer``) on ``--port``.
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

With ``--replay-addr`` (one ``host:port``, a comma-separated shard fleet,
or ``discover``) the learner samples its batches from the store and the
actor pushes its trajectories there.

The coordinator, the league, the replay store and the actor exit on
SIGTERM or SIGINT; the learner saves a checkpoint first.

``--config`` takes a YAML or JSON file or inline JSON: its ``model`` block
replaces the smoke model over ``default_model_config()`` (as in the JAX
launcher), its ``league`` block configures the league, and its ``learner``
block cascades over the learner defaults (as ``bin/sl_train.py``'s does);
``learner.batch_size``/``unroll_len`` and ``actor.env_num``/``traj_len``
stand where ``--batch-size``, ``--traj-len`` and ``--env-num`` are not given.

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP Queue 1
item (``NOT_PORTED``): the arena, league-run and league-learner roles and
their flags, the jaxenv and SC2 envs, Anakin, meshes and
``jax.distributed``, the coordinator's HA, and fleet health and telemetry
(``--metrics-port`` serves only the replay role's admin surface).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import sys
import threading
from typing import Optional, Sequence

from .. import plugins
from ..actor import Actor
from ..comm import Adapter, Coordinator, CoordinatorServer
from ..envs import MockEnv
from ..league import League, LeagueAPIServer, RemoteLeague
from ..learner.prefetch import DevicePrefetcher
from ..learner.rl_dataloader import ReplayDataLoader, RLDataLoader
from ..resilience import RestartPolicy, Supervisor, supervise_call
from ..utils import read_config
from .sl_train import SMOKE_MODEL

_LEAGUE_RUNTIME = ("the coordinator-hosted league runtime is not ported yet "
                   "(ROADMAP Queue 1 item 9, league/runtime/)")
_MESH = "meshes, sharded checkpoints and jax.distributed are not ported yet (ROADMAP Queue 1 item 7)"
_HEALTH = "fleet health, telemetry and the metrics endpoint are not ported yet (ROADMAP Queue 1 item 9)"

# role or flag prefix of the JAX launcher -> why it raises here
NOT_PORTED = {
    "--type arena": "the arena is not ported yet (ROADMAP Queue 1 item 9, arena/)",
    "--type league-run": _LEAGUE_RUNTIME,
    "--type league-learner": _LEAGUE_RUNTIME,
    "--anakin": "Anakin is not ported yet (ROADMAP Queue 1 item 8, envs/jaxenv/)",
    "--jaxenv": "jaxenv is not ported yet (ROADMAP Queue 1 item 8, envs/jaxenv/)",
    "--env jaxenv": "jaxenv is not ported yet (ROADMAP Queue 1 item 8, envs/jaxenv/)",
    "--env sc2": "the SC2 env is not ported yet (ROADMAP Queue 1 item 10, envs/sc2/)",
    "--mesh": _MESH,
    "--host-devices": _MESH,
    "--sharded-ckpt": _MESH,
    "--no-sharded-ckpt": _MESH,
    "--dist-": _MESH,
    "--journal-dir": "the coordinator's HA is not ported yet (ROADMAP Queue 1 item 11, comm/ha.py)",
    "--ha-": "the coordinator's HA is not ported yet (ROADMAP Queue 1 item 11, comm/ha.py)",
    "--arena-": "the arena is not ported yet (ROADMAP Queue 1 item 9, arena/)",
    "--league-": _LEAGUE_RUNTIME,
    "--telemetry-interval-s": _HEALTH,
    "--health-": _HEALTH,
    "--no-health": _HEALTH,
    "--dynamics-every": "the training-dynamics export is not ported yet (ROADMAP Queue 1 item 9)",
    "--platform": "the JAX backend switch; the port picks its device with --device",
}

ROLES = ("all", "coordinator", "league", "learner", "actor", "replay")


def _user_cfg(args) -> dict:
    return read_config(args.config) if args.config else {}


def _model_cfg(args) -> dict:
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


def _env_fn(args):
    """The env factory: the mock env (``--env`` or the config's ``env.type``
    may name only it here)."""
    env_type = args.env or dict(_user_cfg(args).get("env", {})).get("type", "mock")
    if env_type != "mock":
        raise NotImplementedError(f"--env {env_type}: " + NOT_PORTED.get(
            f"--env {env_type}", "only the mock env is ported"))
    return lambda: MockEnv(episode_game_loops=args.episode_game_loops)


def _learner_cfg(args, model_cfg: dict, load_path: str = "") -> dict:
    return {
        "common": {"experiment_name": args.experiment_name,
                   **({"save_path": args.save_path} if args.save_path else {})},
        "learner": {
            "log_freq": max(args.iters // 4, 1),
            "save_freq": 10 ** 9,
            **_user_cfg(args).get("learner", {}),
            "batch_size": args.batch_size,
            "unroll_len": args.traj_len,
            **({"load_path": load_path} if load_path else {}),
        },
        "model": model_cfg,
    }


def _make_learner(args, model_cfg: dict, load_path: str = ""):
    """The RL learner of ``--pipeline``, or with ``--distill`` the student
    tier's ``DistillLearner`` on the same batch stream."""
    cfg = _learner_cfg(args, model_cfg, load_path=load_path)
    if args.distill:
        from ..learner import DistillLearner

        return DistillLearner(cfg, device=args.device)
    return plugins.load_component(args.pipeline, "RLLearner")(cfg, device=args.device)


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


def _replay_loader(args, addrs: str, player_id: str) -> ReplayDataLoader:
    return ReplayDataLoader(_learner_replay_client(args, addrs), player_id, args.batch_size)


@dataclasses.dataclass
class Loop:
    """The pieces of one in-process league-RL loop (``build_all``);
    ``replay_stores`` and ``replay_servers`` are ``--replay``'s."""

    league: League
    actor: Actor
    learner: object
    player_id: str
    supervisor: Supervisor
    replay_stores: list = dataclasses.field(default_factory=list)
    replay_servers: list = dataclasses.field(default_factory=list)


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
    return Loop(league, actor, learner, player_id, supervisor, stores, servers)


def close_all(loop: Loop) -> None:
    """Stop what ``build_all`` started: the actor's job loop (after its
    job: its thread is in the middle of a flush, and the stores stop pacing
    so a push the limiter holds for a learner that has finished goes
    through), the learner's prefetcher, the replay servers and the
    colocated store's registration."""
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
    loop = build_all(args)
    loop.supervisor.start()
    try:
        _run_learner_supervised(args, loop.learner, args.iters)
    finally:
        close_all(loop)
    learner = loop.learner
    print(f"rl_train done: {learner.last_iter.val} iters, "
          f"loss={learner.variable_record.get('total_loss').avg:.4f}, "
          f"games={loop.league.all_players[loop.player_id].total_game_count}", flush=True)
    return loop


def _addr(s: str):
    """``"host:port"`` -> ``(host, port)``."""
    if "," in s:
        raise NotImplementedError(f"{s}: coordinator address lists are the coordinator's HA, "
                                  "not ported yet (ROADMAP Queue 1 item 11)")
    host, _, port = s.rpartition(":")
    return host or "127.0.0.1", int(port)


def run_learner(args):
    league = RemoteLeague(*_addr(args.league_addr)) if args.league_addr else None
    adapter = Adapter(coordinator_addr=_addr(args.coordinator_addr))
    model_cfg = _model_cfg(args)
    load_path = ""
    if league is not None:
        reply = league.register_learner(args.player_id, rank=0, world_size=1)
        # resume from the league-assigned player checkpoint where it exists
        ckpt = reply.get("checkpoint_path", "")
        if ckpt and os.path.exists(ckpt):
            load_path = ckpt
    learner = _make_learner(args, model_cfg, load_path=load_path)
    if not load_path and not args.no_supervise:
        # a restarted learner process picks up its own latest pointer
        path = learner.resume_latest()
        print(f"rl_train resume: {path or 'cold'} iter {learner.last_iter.val}", flush=True)
    if args.replay_addr:
        # batches from the replay table(s) instead of the pull cache
        learner.set_dataloader(_replay_loader(args, args.replay_addr, args.player_id))
    else:
        learner.set_dataloader(RLDataLoader(adapter, args.player_id, args.batch_size))
    if not args.distill:
        learner.attach_comm(adapter, args.player_id, league=league)
    _run_learner_supervised(args, learner, args.iters)
    print(f"learner done: {learner.last_iter.val} iters", flush=True)
    return learner


def run_actor(args) -> None:
    league = RemoteLeague(*_addr(args.league_addr))
    adapter = Adapter(coordinator_addr=_addr(args.coordinator_addr))
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

    # SIGTERM leaves the job loop as SystemExit: the job's finally closes the
    # env pool and the plane's clients, and no restart catches it
    previous = {s: signal.signal(s, lambda *_: sys.exit(0)) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        if args.no_supervise:
            job_loop()
        else:
            supervise_call(job_loop, op="actor", policy=_restart_policy(args))
    finally:
        for s, handler in previous.items():
            signal.signal(s, handler)


def _serve_until_signal(server, what: str) -> None:
    """Start ``server``, print where it serves, and stop it on SIGTERM or
    SIGINT."""
    server.start()
    print(f"{what} serving on {server.host}:{server.port}", flush=True)
    done = threading.Event()
    previous = {s: signal.signal(s, lambda *_: done.set()) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        while not done.wait(0.5):
            pass
    finally:
        for s, handler in previous.items():
            signal.signal(s, handler)
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

    stop = TaskContext()  # set by SIGTERM or SIGINT
    previous = {s: signal.signal(s, lambda *_: stop.request_stop()) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        if args.no_supervise:
            serve_loop(stop)
            return
        supervisor = Supervisor(policy=_restart_policy(args))
        supervisor.add("replay", serve_loop)
        supervisor.start()
        while not stop.sleep(0.5):
            pass
        supervisor.stop(timeout=30)
    finally:
        for s, handler in previous.items():
            signal.signal(s, handler)


def run_coordinator(args) -> None:
    co = Coordinator(default_lease_s=args.lease_s or None)
    _serve_until_signal(CoordinatorServer(coordinator=co, port=args.port), "coordinator")


def run_league(args) -> None:
    _serve_until_signal(LeagueAPIServer(League(_user_cfg(args)), port=args.port), "league")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--type", default="all",
                   help=f"one of {', '.join(ROLES)} (the JAX launcher's arena, league-run "
                        "and league-learner raise NotImplementedError)")
    p.add_argument("--config", default="",
                   help="YAML or JSON file, or inline JSON: 'model', 'league', 'learner', 'actor', 'env'")
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=None, help="default: the config's, else 4")
    p.add_argument("--traj-len", type=int, default=None, help="default: the config's, else 4")
    p.add_argument("--env-num", type=int, default=None, help="default: the config's, else 2")
    p.add_argument("--episode-game-loops", type=int, default=300)
    p.add_argument("--env", default="", help="mock (the only env ported)")
    p.add_argument("--experiment-name", default="rl_train")
    p.add_argument("--save-path", default="",
                   help="experiment root (default $DISTAR_EXPERIMENTS_ROOT or ./experiments, "
                        "then the experiment name)")
    p.add_argument("--smoke-model", action="store_true", default=True)
    p.add_argument("--full-model", dest="smoke_model", action="store_false",
                   help="default_model_config() at full width and depth")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; raises without CUDA unless 'cpu')")
    p.add_argument("--port", type=int, default=0, help="coordinator and league roles: listen port")
    p.add_argument("--lease-s", type=float, default=0.0,
                   help="coordinator role: default registration lease (0: none)")
    p.add_argument("--league-addr", default="", help="host:port of the league role")
    p.add_argument("--coordinator-addr", default="", help="host:port of the coordinator role")
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
                   help="--type replay: the admin surface (/replay/stats, /metrics, POST /drain); "
                        "other roles: " + _HEALTH)
    p.add_argument("--distill", action="store_true",
                   help="train the student tier (DistillLearner) on the same batches")
    p.add_argument("--admin-port", type=int, default=None,
                   help="serve the learner admin API (status, save_ckpt, ...) on this port")
    p.add_argument("--no-supervise", action="store_true",
                   help="no crash-restart supervision and no resume from the latest checkpoint")
    p.add_argument("--restart-max", type=int, default=5)
    p.add_argument("--restart-window-s", type=float, default=300.0)
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
    args, unknown = parser().parse_known_args(argv)
    _refuse_not_ported(args, unknown)
    if args.type not in ROLES:
        raise SystemExit(f"rl_train: --type must be one of {', '.join(ROLES)}, got {args.type!r}")
    if args.metrics_port is not None and args.type != "replay":
        raise NotImplementedError(f"--metrics-port: {_HEALTH}")
    _resolve_args(args)
    if args.type == "all":
        return run_all(args)
    if args.type == "replay":
        return run_replay(args)
    if args.type == "coordinator":
        return run_coordinator(args)
    if args.type == "league":
        return run_league(args)
    if args.type == "learner":
        if not args.coordinator_addr:
            raise SystemExit("--type learner requires --coordinator-addr (and usually --league-addr)")
        return run_learner(args)
    if not (args.league_addr and args.coordinator_addr):
        raise SystemExit("--type actor requires --league-addr and --coordinator-addr")
    return run_actor(args)


if __name__ == "__main__":
    main()

"""SC2 developer tools: replay inspection, map listing, throughput benches.

Counterpart of ``distar_tpu.bin.sc2_tools``.

Role parity with the reference pysc2 tool scripts (reference: distar/pysc2/
bin/replay_info.py, map_list.py, benchmark_observe.py:1-149,
benchmark_replay.py:1-106): one CLI with subcommands instead of a script
per tool. Every subcommand accepts ``--endpoint host:port`` to drive an
already-running SC2 (or the in-process fake server in tests) instead of
launching a binary.

  replay-info        print per-replay metadata (map, duration, players,
                     version) for a path or directory
  map-list           print the map registry (sizes + localized names)
  benchmark-observe  steps a game and measures observe + transform_obs
                     throughput (the actor's per-step CPU cost)
  benchmark-replay   measures two-pass decode throughput in steps/s
"""
from __future__ import annotations

import argparse
import time


def _controller(args):
    from ..envs.sc2.remote_controller import RemoteController

    if args.endpoint:
        host, _, port = args.endpoint.rpartition(":")
        return RemoteController(host or "127.0.0.1", int(port), timeout_seconds=30)
    from ..envs.sc2 import run_configs

    proc = run_configs.get(version=args.version).start(want_rgb=False)
    return proc.controller


def replay_info(args) -> None:
    from ..envs.sc2 import run_configs

    rc = run_configs.get() if not args.endpoint else None
    paths = (
        list(rc.replay_paths(args.replays)) if rc is not None else [args.replays]
    )
    print(f"found {len(paths)} replays")
    c = _controller(args)
    try:
        for path in paths:
            data = None
            if rc is not None:
                data = rc.replay_data(path)
            info = c.replay_info(replay_path=None if data else path, replay_data=data)
            print(f"\n{path}")
            print(f"  map: {info.map_name}")
            print(
                f"  version: {info.game_version} (build {info.base_build}), "
                f"loops: {info.game_duration_loops}"
            )
            for p in info.player_info:
                pi = p.player_info
                print(
                    f"  player {pi.player_id}: race {pi.race_actual} "
                    f"mmr {p.player_mmr} apm {p.player_apm} "
                    f"result {p.player_result.result}"
                )
    finally:
        c.quit()


def map_list(args) -> None:
    from ..envs.sc2 import maps

    for name in sorted(maps.MAPS):
        size = maps.get_map_size(name)
        localized = maps.get_localized_map_name(name)
        print(f"{name:32s} {size[0]}x{size[1]}  {', '.join(localized[:3])}")


def benchmark_observe(args) -> None:
    """Observe+transform throughput over a running game (reference
    benchmark_observe.py measures raw/feature interfaces the same way)."""
    from ..envs.features import ProtoFeatures
    from ..envs.sc2.launcher import Bot, Player, SC2GameLauncher

    kw = {}
    if args.endpoint:
        c = _controller(args)
        kw["controller_factory"] = lambda i: c
    launcher = SC2GameLauncher(
        map_name=args.map,
        # one agent vs a built-in bot: a single controller drives the bench
        players=[Player("zerg"), Bot("zerg", 3)],
        realtime=False,
        version=args.version,
        **kw,
    )
    launcher.ensure_game()
    controller = launcher.controllers[0]
    features = launcher.features[0] if launcher.features else None
    if features is None:
        features = ProtoFeatures(controller.game_info())

    observe_s = transform_s = 0.0
    for i in range(args.steps):
        controller.step(args.step_mul)
        t0 = time.perf_counter()
        obs = controller.observe()
        t1 = time.perf_counter()
        features.transform_obs(obs)
        t2 = time.perf_counter()
        observe_s += t1 - t0
        transform_s += t2 - t1
    n = max(args.steps, 1)
    print(
        f"steps={n} observe={1e3 * observe_s / n:.2f}ms/step "
        f"transform={1e3 * transform_s / n:.2f}ms/step "
        f"throughput={n / (observe_s + transform_s):.1f} obs/s"
    )
    launcher.close()


def benchmark_replay(args) -> None:
    """Two-pass decode throughput (reference benchmark_replay.py:1-106)."""
    from ..envs.replay_decoder import ReplayDecoder

    provider = None
    if args.endpoint:
        host, _, port = args.endpoint.rpartition(":")

        def provider(version):
            from ..envs.sc2.remote_controller import RemoteController

            return RemoteController(host or "127.0.0.1", int(port), timeout_seconds=30)

    dec = ReplayDecoder(
        cfg={"minimum_action_length": args.min_actions,
             "external_endpoint": bool(args.endpoint)},
        controller_provider=provider,
    )
    t0 = time.perf_counter()
    total_steps = 0
    try:
        for path in args.replays:
            traj = dec.run(path, player_index=args.player)
            n = len(traj) if traj else 0
            total_steps += n
            print(f"{path}: {n} steps")
    finally:
        dec.close()
    dt = time.perf_counter() - t0
    print(f"decoded {total_steps} steps in {dt:.1f}s = {total_steps / max(dt, 1e-9):.1f} steps/s")


def main() -> None:
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)

    ri = sub.add_parser("replay-info")
    ri.add_argument("replays", help="replay file or directory")
    ri.add_argument("--endpoint", default="")
    ri.add_argument("--version", default=None)
    ri.set_defaults(fn=replay_info)

    ml = sub.add_parser("map-list")
    ml.set_defaults(fn=map_list)

    bo = sub.add_parser("benchmark-observe")
    bo.add_argument("--map", default="KairosJunction")
    bo.add_argument("--steps", type=int, default=100)
    bo.add_argument("--step-mul", type=int, default=8)
    bo.add_argument("--endpoint", default="")
    bo.add_argument("--version", default=None)
    bo.set_defaults(fn=benchmark_observe)

    br = sub.add_parser("benchmark-replay")
    br.add_argument("replays", nargs="+")
    br.add_argument("--player", type=int, default=0)
    br.add_argument("--min-actions", type=int, default=2)
    br.add_argument("--endpoint", default="")
    br.set_defaults(fn=benchmark_replay)

    args = p.parse_args()
    args.fn(args)


if __name__ == "__main__":
    main()

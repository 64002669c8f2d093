"""Generate strategy-statistics (Z) libraries.

Counterpart of ``distar_tpu.bin.gen_z``.

Role parity with the reference gen_z (reference: distar/bin/gen_z.py —
decodes *winning* replays into building-order + cumulative-stat targets
keyed by map/matchup/born-location). Three sources:

  --replays DIR     decode .SC2Replay files with the two-pass decoder's
                    Z-only pass (envs/replay_decoder.decode_z) — requires
                    the SC2 client (or a fake server via DISTAR_SC2_PORT)
  --input FILE      aggregate episode-summary JSONL records (one episode per
                    line, as emitted by the actor's episode logger)
  --demo            synthetic entries for smoke tests

Usage:
  python -m distar_tpu_torch.bin.gen_z --replays path/to/replays --output my_z.json
  python -m distar_tpu_torch.bin.gen_z --input episodes.jsonl --output my_z.json
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..lib import actions as ACT
from ..lib.z_library import build_z_library, save_z_library


def decode_replay_episodes(replay_dir: str, min_mmr: int = 0, workers: int = 1):
    """Decode every replay-player in ``replay_dir`` into episode summaries
    (the reference's path_queue/worker_loop pipeline, gen_z.py:49-107;
    worker parallelism comes from running several gen_z processes over
    disjoint shards, the replay_actor pattern)."""
    from ..envs.replay_decoder import ReplayDecoder

    del workers
    provider = None
    cfg = {"parse_race": "ZTP"}
    port = os.environ.get("DISTAR_SC2_PORT")
    if port:
        # an already-running SC2 endpoint (or fake_sc2 server) instead of
        # launching binaries; external_endpoint keeps close() from quitting it
        from ..envs.sc2.remote_controller import RemoteController

        provider = lambda version: RemoteController("127.0.0.1", int(port))  # noqa: E731
        cfg["external_endpoint"] = True
    decoder = ReplayDecoder(cfg=cfg, controller_provider=provider)
    episodes = []
    paths = sorted(
        os.path.join(replay_dir, f)
        for f in os.listdir(replay_dir)
        if f.lower().endswith(".sc2replay")
    )
    try:
        for path in paths:
            for player_index in (0, 1):
                ep = decoder.decode_z(path, player_index)
                if ep is None:
                    continue
                if min_mmr and ep.get("mmr", 0) < min_mmr:
                    continue
                episodes.append(ep)
                print(f"gen_z: {path} p{player_index} -> {ep['mix_race']}@{ep['born_location']}")
    finally:
        decoder.close()
    return episodes


def demo_episodes(n: int = 8, seed: int = 0):
    rng = np.random.default_rng(seed)
    eps = []
    for i in range(n):
        n_bo = int(rng.integers(5, 20))
        eps.append(
            {
                "map_name": "KairosJunction",
                "mix_race": "zerg",
                "born_location": int(rng.choice([22, 38 * 160 + 140])),
                "winloss": int(rng.choice([-1, 1])),
                "beginning_order": rng.integers(
                    1, ACT.NUM_BEGINNING_ORDER_ACTIONS, n_bo
                ).tolist(),
                "bo_location": rng.integers(0, 152 * 160, n_bo).tolist(),
                "cumulative_stat": rng.integers(
                    1, ACT.NUM_CUMULATIVE_STAT_ACTIONS, 15
                ).tolist(),
                "game_loop": int(rng.integers(5000, 30000)),
            }
        )
    return eps


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--input", default="", help="episodes JSONL")
    p.add_argument("--replays", default="", help="directory of .SC2Replay files")
    p.add_argument("--output", required=True)
    p.add_argument("--min-winloss", type=int, default=1)
    p.add_argument("--min-mmr", type=int, default=0)
    p.add_argument("--demo", action="store_true")
    args = p.parse_args(argv)

    if args.demo:
        episodes = demo_episodes()
    elif args.replays:
        episodes = decode_replay_episodes(args.replays, min_mmr=args.min_mmr)
    else:
        with open(args.input) as f:
            episodes = [json.loads(line) for line in f if line.strip()]
    lib = build_z_library(episodes, min_winloss=args.min_winloss)
    save_z_library(lib, args.output)
    n = sum(
        len(entries)
        for races in lib.values()
        for locs in races.values()
        for entries in locs.values()
    )
    print(f"gen_z: wrote {n} entries to {args.output}")


if __name__ == "__main__":
    main()

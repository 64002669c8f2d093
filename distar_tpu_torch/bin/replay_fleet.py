"""Replay-fleet ops tool: sharded decode with throughput and memory telemetry.

Counterpart of ``distar_tpu.bin.replay_fleet``. One CLI on top of the
port's ``learner/replay_actor.py`` sharding (SLURM task x worker) that
decodes N replays and reports:

  * decode frames/s (observation steps produced per second)
  * per-replay success/failure counts
  * RSS over time for this process tree (self + SC2 children), with a
    least-squares MB/min slope: the memory-leak verdict

Usage:
  python -m distar_tpu_torch.bin.replay_fleet --replays DIR_OR_LIST [--workers N]
      [--epochs K] [--parse-race ZTP] [--filter-actions] [--fake-decoder]
      [--pipeline default|module]

The decoder is ``plugins.load_component(--pipeline, "ReplayDecoder")``: the
port's ``envs.replay_decoder.ReplayDecoder`` by default, which dials the SC2
install of ``SC2PATH`` (the fake install of ``envs/sc2/fake_sc2.py`` too).
``--fake-decoder`` swaps in a synthetic one (labelled in the report) so the
harness runs on hosts without the game binary. No model runs here, so the
tool takes no ``--device``.
"""
from __future__ import annotations

import argparse
import json
import os
import threading
import time
from typing import Dict, List, Optional


def process_tree_rss_mb(root_pid: Optional[int] = None) -> float:
    """Total RSS (MB) of ``root_pid`` and every descendant, via /proc (SC2
    clients are child processes; their memory is the leak that matters)."""
    root_pid = root_pid if root_pid is not None else os.getpid()
    children: Dict[int, List[int]] = {}
    rss_pages: Dict[int, int] = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        pid = int(entry)
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # field 4 = ppid, field 24 = rss (pages); comm may contain spaces,
        # so split after the closing paren
        after = stat.rpartition(")")[2].split()
        try:
            ppid, rss = int(after[1]), int(after[21])
        except (IndexError, ValueError):
            continue
        children.setdefault(ppid, []).append(pid)
        rss_pages[pid] = rss
    total, stack, seen = 0, [root_pid], set()
    while stack:
        pid = stack.pop()
        if pid in seen:
            continue
        seen.add(pid)
        total += rss_pages.get(pid, 0)
        stack.extend(children.get(pid, []))
    return total * os.sysconf("SC_PAGE_SIZE") / 1e6


class _StatsSink:
    """Adapter-shaped sink: counts trajectories/frames instead of shipping
    them (ReplayActor pushes here)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.trajectories = 0
        self.frames = 0

    def push(self, token, steps, **kwargs) -> None:
        with self.lock:
            self.trajectories += 1
            self.frames += len(steps)


class _RssSampler(threading.Thread):
    def __init__(self, interval_s: float = 5.0):
        super().__init__(daemon=True)
        self.interval_s = interval_s
        self.samples: List[tuple] = []  # (t, rss_mb)
        self._halt = threading.Event()

    def run(self) -> None:
        t0 = time.time()
        while not self._halt.is_set():
            self.samples.append((time.time() - t0, process_tree_rss_mb()))
            self._halt.wait(self.interval_s)
        self.samples.append((time.time() - t0, process_tree_rss_mb()))

    def stop(self) -> None:
        self._halt.set()

    def report(self) -> dict:
        if not self.samples:
            return {}
        ts = [s[0] for s in self.samples]
        rss = [s[1] for s in self.samples]
        out = {
            "start_mb": round(rss[0], 1),
            "peak_mb": round(max(rss), 1),
            "end_mb": round(rss[-1], 1),
            "samples": len(rss),
        }
        # least-squares slope in MB/min — the mem-leak verdict (role of
        # reference mem_leak_check.py's before/after RSS comparison)
        if len(rss) >= 2 and ts[-1] > ts[0]:
            n = len(rss)
            mt, mr = sum(ts) / n, sum(rss) / n
            denom = sum((t - mt) ** 2 for t in ts)
            if denom > 0:
                slope = sum((t - mt) * (r - mr) for t, r in zip(ts, rss)) / denom
                out["slope_mb_per_min"] = round(slope * 60, 2)
        return out


class _FakeDecoder:
    """Synthetic decoder for harness smoke tests (no SC2 binary): emits
    step-dicts at a deterministic rate."""

    def __init__(self, steps_per_replay: int = 64, delay_s: float = 0.0):
        self.steps_per_replay = steps_per_replay
        self.delay_s = delay_s

    def run(self, path, player_idx):
        if self.delay_s:
            time.sleep(self.delay_s)
        if "corrupt" in os.path.basename(path):
            raise ValueError(f"synthetic corrupt replay: {path}")
        return [{"replay": path, "player": player_idx, "i": i} for i in range(self.steps_per_replay)]

    def close(self):
        pass


def run_fleet(
    replays,
    workers: int = 2,
    epochs: int = 1,
    decoder_factory=None,
    rss_interval_s: float = 5.0,
    ntasks: Optional[int] = None,
    proc_id: Optional[int] = None,
    decoder_cfg: Optional[dict] = None,
    pipeline: str = "default",
) -> dict:
    """Decode a replay shard and return the telemetry report (the CLI body,
    callable in-process for tests)."""
    from ..learner.replay_actor import ReplayActor

    fake = decoder_factory is not None
    if decoder_factory is None:
        from .. import plugins

        decoder_cls = plugins.load_component(pipeline, "ReplayDecoder")

        def decoder_factory():
            return decoder_cls(cfg=decoder_cfg or {})

    sink = _StatsSink()
    sampler = _RssSampler(rss_interval_s)
    actor = ReplayActor(
        replays,
        adapter_factory=lambda: sink,
        decoder_factory=decoder_factory,
        num_workers=workers,
        epochs=epochs,
        ntasks=ntasks,
        proc_id=proc_id,
    )
    n_replays = len(actor._paths)
    sampler.start()
    t0 = time.perf_counter()
    actor.run()
    wall = time.perf_counter() - t0
    sampler.stop()
    sampler.join(timeout=5)
    return {
        "metric": "replay-decode frames/s (fleet shard)",
        "value": round(sink.frames / wall, 2) if wall > 0 else 0.0,
        "unit": "frames/s",
        "replays": n_replays,
        "workers": workers,
        "trajectories": sink.trajectories,
        # counted at the source: raising decodes vs legitimately-empty ones
        # (race-filtered players are empty, not failed)
        "failed_decodes": actor.failed,
        "empty_decodes": actor.empty,
        "frames": sink.frames,
        "wall_s": round(wall, 2),
        "rss": sampler.report(),
        "decoder": "fake (harness smoke)" if fake else "sc2",
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--replays", required=True, help="replay dir or list file")
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--parse-race", default="ZTP", help="races to decode (e.g. Z)")
    p.add_argument("--filter-actions", action="store_true",
                   help="de-dupe keyboard-spam actions (reference FilterActions)")
    p.add_argument("--rss-interval", type=float, default=5.0)
    p.add_argument("--ntasks", type=int, default=None, help="override SLURM_NTASKS")
    p.add_argument("--pipeline", default="default",
                   help="decoder implementation: 'default' or an importable "
                        "custom-pipeline module (plugins.py)")
    p.add_argument("--proc-id", type=int, default=None, help="override SLURM_PROCID")
    p.add_argument("--fake-decoder", action="store_true",
                   help="synthetic decoder (no SC2): harness smoke only")
    args = p.parse_args(argv)
    report = run_fleet(
        args.replays,
        workers=args.workers,
        epochs=args.epochs,
        decoder_factory=(lambda: _FakeDecoder()) if args.fake_decoder else None,
        rss_interval_s=args.rss_interval,
        ntasks=args.ntasks,
        proc_id=args.proc_id,
        decoder_cfg={"parse_race": args.parse_race,
                     "filter_action": args.filter_actions},
        pipeline=args.pipeline,
    )
    print(json.dumps(report))


if __name__ == "__main__":
    main()

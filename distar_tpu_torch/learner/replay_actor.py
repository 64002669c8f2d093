"""SL replay actor: sharded replay decode feeding remote SL learners.

Counterpart of ``distar_tpu.learner.replay_actor``. ``ReplayActor`` takes
its ``decoder_factory`` as the JAX one does (the SC2 ``ReplayDecoder`` is
not ported yet, ROADMAP Queue 1 item 10), and pushes over the port's
``Adapter`` on the JAX package's token, so either package's learner pulls
either package's trajectories.

Role parity with the reference ReplayActor (reference: distar/ctools/worker/
actor/replay_actor.py:10-72): the replay list — a file of paths or a
directory — is expanded over shuffled epochs, sharded across cluster tasks
(SLURM_NTASKS × SLURM_PROCID env discovery, :41-45) and across local
workers; each worker decodes both players of each replay through the
two-pass ReplayDecoder and pushes the trajectory step-lists over the
Adapter data plane with backpressure (:31-33). The learner side pulls them
via RemoteSLDataloader.

Workers are threads, not processes: the decode hot path lives inside the
SC2 binary (a separate process per worker already) and the websocket client
releases the GIL on IO, so threads shard as well as the reference's forks
while keeping the Adapter in-process.
"""
from __future__ import annotations

import logging
import os
import random
import threading
import time
from typing import Callable, List, Optional, Sequence, Union

from .sl_dataloader import SLDataloader


def expand_replay_list(
    source: Union[str, Sequence[str]],
    epochs: int = 1,
    seed: int = 233,
    ntasks: Optional[int] = None,
    proc_id: Optional[int] = None,
) -> List[str]:
    """Resolve, epoch-expand, and shard the replay list (reference
    replay_actor.py:44-61)."""
    if isinstance(source, str):
        if os.path.isfile(source):
            with open(source) as f:
                paths = [l.strip() for l in f if l.strip()]
        elif os.path.isdir(source):
            paths = [
                os.path.join(source, p)
                for p in sorted(os.listdir(source))
                if p.lower().endswith(".sc2replay")
            ]
        else:
            raise FileNotFoundError(source)
    else:
        paths = list(source)
    rng = random.Random(seed)
    expanded: List[str] = []
    for _ in range(max(epochs, 1)):
        shuffled = list(paths)
        rng.shuffle(shuffled)
        expanded += shuffled
    ntasks = ntasks if ntasks is not None else int(os.environ.get("SLURM_NTASKS", 1))
    proc_id = proc_id if proc_id is not None else int(os.environ.get("SLURM_PROCID", 0))
    ntasks = max(ntasks, 1)
    per = len(expanded) // ntasks
    if per == 0:
        return expanded if proc_id == 0 else []
    # the last task takes the division remainder — no replay is dropped
    end = (proc_id + 1) * per if proc_id < ntasks - 1 else len(expanded)
    return expanded[proc_id * per: end]


class ReplayActor:
    """Decode a replay shard with N workers, pushing trajectories to the
    data plane."""

    def __init__(
        self,
        replays: Union[str, Sequence[str]],
        adapter_factory: Callable[[], object],
        decoder_factory: Callable[[], object],
        num_workers: int = 1,
        epochs: int = 1,
        token: str = "sltraj",
        seed: int = 233,
        ntasks: Optional[int] = None,
        proc_id: Optional[int] = None,
    ):
        self._paths = expand_replay_list(replays, epochs, seed, ntasks, proc_id)
        self._adapter_factory = adapter_factory
        self._decoder_factory = decoder_factory
        self._num_workers = max(num_workers, 1)
        self._token = token
        self.pushed = 0
        self.failed = 0  # decode attempts that raised
        self.empty = 0   # decodes that produced no steps (e.g. race-filtered)
        self._lock = threading.Lock()
        per = len(self._paths) // self._num_workers
        self._shards = [
            self._paths[i * per: (i + 1) * per] if i < self._num_workers - 1
            else self._paths[i * per:]
            for i in range(self._num_workers)
        ]
        logging.info(
            "replay actor: %d replays, %d workers (%d per worker)",
            len(self._paths), self._num_workers, per,
        )

    def _decode_loop(self, shard: List[str]) -> None:
        adapter = self._adapter_factory()
        decoder = self._decoder_factory()
        try:
            for i, path in enumerate(shard):
                # both players of every replay (reference decode_loop
                # alternates player_idx 0/1)
                for player_idx in (0, 1):
                    try:
                        steps = decoder.run(path, player_idx)
                    except Exception:
                        logging.exception("decode failed: %s p%d", path, player_idx)
                        with self._lock:
                            self.failed += 1
                        continue
                    if not steps:
                        with self._lock:
                            self.empty += 1
                        continue
                    adapter.push(self._token, steps)
                    with self._lock:
                        self.pushed += 1
                if (i + 1) % 100 == 0:
                    logging.info("replay worker: %d/%d decoded", i + 1, len(shard))
        finally:
            if hasattr(decoder, "close"):
                decoder.close()

    def run(self) -> None:
        threads = [
            threading.Thread(target=self._decode_loop, args=(shard,), daemon=True)
            for shard in self._shards if shard
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        logging.info("replay actor job done (%d trajectories pushed)", self.pushed)


class RemoteSLDataloader(SLDataloader):
    """SLDataloader whose trajectories arrive over the Adapter data plane
    instead of a local disk dataset (the reference's remote SLDataloader
    mode, sl_dataloader.py remote branch)."""

    def __init__(
        self,
        adapter,
        batch_size: int,
        unroll_len: int,
        token: str = "sltraj",
        pull_timeout: float = 300.0,
    ):
        self.adapter = adapter
        self.batch_size = batch_size
        self.unroll_len = unroll_len
        self._token = token
        self._pull_timeout = pull_timeout
        self._slots = [[] for _ in range(batch_size)]
        self._fresh = [True] * batch_size

    def _refill(self, slot: int) -> None:
        deadline = time.time() + self._pull_timeout
        while True:
            traj = self.adapter.pull(
                self._token, block=True,
                timeout=max(min(self._pull_timeout, deadline - time.time()), 0.1),
            )
            if traj:
                break
            if time.time() >= deadline:
                raise TimeoutError(
                    f"no SL trajectory arrived on '{self._token}' within "
                    f"{self._pull_timeout}s"
                )
        self._slots[slot] = list(traj)
        self._fresh[slot] = True

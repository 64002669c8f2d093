"""Consistent hashing: ``stable_hash`` and ``HashRing``.

Counterpart of the ring of ``distar_tpu.replay.sharding``: classic
consistent hashing over ``vnodes`` virtual points per node, keyed by a
stable digest (md5, never ``hash()``, which is salted per process), so
every process, machine and run maps a key to the same node, and growing a
ring from N to N+1 nodes remaps about 1/(N+1) of the keys. The serving
fleet's router pins sessions with it. The sharded replay fleet around it
(``ShardMap``, the sharded clients) comes with ROADMAP Queue 1 item 5.
"""
from __future__ import annotations

import bisect
import hashlib
from typing import List, Sequence, Tuple


def stable_hash(key: str) -> int:
    """64-bit digest that is identical across processes, machines and runs
    (the md5 prefix)."""
    return int.from_bytes(hashlib.md5(key.encode("utf-8")).digest()[:8], "big")


class HashRing:
    """Consistent-hash ring over named nodes with virtual points."""

    def __init__(self, nodes: Sequence[str], vnodes: int = 128):
        if not nodes:
            raise ValueError("hash ring needs at least one node")
        self.nodes = list(dict.fromkeys(nodes))  # order-preserving dedupe
        self.vnodes = int(vnodes)
        points: List[Tuple[int, str]] = [
            (stable_hash(f"{node}#{v}"), node) for node in self.nodes for v in range(self.vnodes)
        ]
        points.sort()
        self._hashes = [h for h, _ in points]
        self._owners = [n for _, n in points]

    def lookup(self, key: str) -> str:
        """The owning node of ``key``: the first ring point clockwise of the
        key's hash (wrapping past the top)."""
        i = bisect.bisect_right(self._hashes, stable_hash(key))
        if i == len(self._hashes):
            i = 0
        return self._owners[i]

"""Game-free SC2Replay header parsing.

Counterpart of ``distar_tpu.envs.sc2.replay_header``.

Reads the replay header (protocol version, build, elapsed game loops)
straight out of the .SC2Replay file, WITHOUT launching the game binary.
The reference obtains the same facts via ``RequestReplayInfo`` through a
running SC2 client (distar/agent/default/replay_decoder.py:379-388) — that
needs a binary install; this parser lets version routing
(``run_configs.version_for_build``), replay sharding, and tests run on
machines with no game.

File format (public, documented by Blizzard's s2client-proto / s2protocol):
a .SC2Replay is an MPQ archive whose *user-data* preamble (magic
``MPQ\\x1b``) carries the serialized replay header in Blizzard's
"versioned" tag encoding. The header struct's field 1 is the version
struct {0: flags, 1: major, 2: minor, 3: revision, 4: build, 5: baseBuild},
field 3 is elapsedGameLoops.
"""
from __future__ import annotations

import io
import os
from typing import Any, BinaryIO, Dict, Union


class CorruptReplayError(ValueError):
    pass


class _VersionedReader:
    """Generic reader for Blizzard's self-describing "versioned" encoding.

    Each value is introduced by a one-byte tag:
      0x00 array     vint count, then elements
      0x01 bitblob   vint bit-length, then ceil(n/8) bytes
      0x02 blob      vint byte-length, then bytes
      0x03 choice    vint alternative id, then value
      0x04 optional  u8 exists flag, then value if nonzero
      0x05 struct    vint field count, then (vint field id, value) pairs
      0x06 u8
      0x07 u32 (LE)
      0x08 u64 (LE)
      0x09 vint      zig-zag-style: bit0 of the first byte is the sign,
                     6 value bits, then 7-bit continuation groups
    """

    def __init__(self, data: bytes):
        self._d = data
        self._o = 0

    def _byte(self) -> int:
        if self._o >= len(self._d):
            raise CorruptReplayError("unexpected end of header blob")
        b = self._d[self._o]
        self._o += 1
        return b

    def _bytes(self, n: int) -> bytes:
        if self._o + n > len(self._d):
            raise CorruptReplayError("unexpected end of header blob")
        out = self._d[self._o : self._o + n]
        self._o += n
        return out

    def vint(self) -> int:
        b = self._byte()
        negative = b & 1
        result = (b >> 1) & 0x3F
        shift = 6
        while b & 0x80:
            b = self._byte()
            result |= (b & 0x7F) << shift
            shift += 7
        return -result if negative else result

    def value(self) -> Any:
        tag = self._byte()
        if tag == 0x00:  # array
            n = self.vint()
            return [self.value() for _ in range(n)]
        if tag == 0x01:  # bitblob
            bits = self.vint()
            return self._bytes((bits + 7) // 8)
        if tag == 0x02:  # blob
            return self._bytes(self.vint())
        if tag == 0x03:  # choice
            alt = self.vint()
            return {alt: self.value()}
        if tag == 0x04:  # optional
            return self.value() if self._byte() else None
        if tag == 0x05:  # struct
            n = self.vint()
            out: Dict[int, Any] = {}
            for _ in range(n):
                field = self.vint()  # field id must be read BEFORE the value
                out[field] = self.value()
            return out
        if tag == 0x06:
            return self._byte()
        if tag == 0x07:
            return int.from_bytes(self._bytes(4), "little")
        if tag == 0x08:
            return int.from_bytes(self._bytes(8), "little")
        if tag == 0x09:
            return self.vint()
        raise CorruptReplayError(f"unknown versioned tag 0x{tag:02x}")


def _user_data(data: bytes) -> bytes:
    """Extract the MPQ user-data payload (the serialized replay header)."""
    if data[:4] != b"MPQ\x1b":
        raise CorruptReplayError(
            "not an SC2 replay (missing MPQ user-data magic)"
        )
    # u32 @4: max user data size; u32 @8: archive header offset;
    # u32 @12: used user data size; payload starts at 16
    used = int.from_bytes(data[12:16], "little")
    if used <= 0 or 16 + used > len(data):
        raise CorruptReplayError("corrupt MPQ user-data header")
    return data[16 : 16 + used]


def parse_replay_header(replay: Union[bytes, str, os.PathLike, BinaryIO]) -> Dict[str, Any]:
    """Parse an .SC2Replay header into plain facts.

    Returns dict with keys: signature (str), version (str "a.b.c"),
    build, base_build, elapsed_game_loops, duration_seconds (at 22.4
    game loops / s, the SC2 "faster" speed the ladder uses).
    """
    if isinstance(replay, (str, os.PathLike)):
        with open(replay, "rb") as f:
            data = f.read(4096)
    elif isinstance(replay, bytes):
        data = replay
    else:
        data = replay.read(4096)
    header = _VersionedReader(_user_data(data)).value()
    if not isinstance(header, dict) or 1 not in header:
        raise CorruptReplayError("replay header missing version struct")
    ver = header[1]
    version = f"{ver.get(1, 0)}.{ver.get(2, 0)}.{ver.get(3, 0)}"
    loops = int(header.get(3, 0))
    return {
        "signature": header.get(0, b"").decode("utf-8", "replace"),
        "version": version,
        "build": int(ver.get(4, 0)),
        "base_build": int(ver.get(5, 0)),
        "elapsed_game_loops": loops,
        "duration_seconds": loops / 22.4,
    }

"""SC2 protobuf module resolution.

Counterpart of ``distar_tpu.envs.sc2.proto``. The port's ``_proto_gen/`` is a
byte-identical copy of the JAX package's (a test holds it so): both register
the same descriptors in protobuf's default pool, so the two packages share
message classes in one process, and an edited copy would fail there with a
duplicate-file error.

The framework talks to the game in s2client-proto messages. Two providers:

1. The pip ``s2clientprotocol`` package (the reference's dependency,
   reference: distar/pysc2/lib/protocol.py:29) — byte-compatible with the
   retail binary by construction; preferred when importable.
2. The vendored subset under ``_proto_gen`` (built from ``protos/*.proto``
   by tools/build_protos.sh) — field numbers follow the public schema; keeps
   the full client stack importable and testable in environments without the
   pip package.

Consumers import ``sc_pb``/``raw_pb``/``common_pb``/``Status`` from here and
stay provider-agnostic (both expose the same message/field names).
"""
from __future__ import annotations

import enum

try:  # pragma: no cover - depends on environment
    from s2clientprotocol import common_pb2 as common_pb
    from s2clientprotocol import raw_pb2 as raw_pb
    from s2clientprotocol import sc2api_pb2 as sc_pb
    from s2clientprotocol import score_pb2 as score_pb
    from s2clientprotocol import spatial_pb2 as spatial_pb

    PROVIDER = "s2clientprotocol"
except ImportError:
    from ._proto_gen import common_pb2 as common_pb
    from ._proto_gen import raw_pb2 as raw_pb
    from ._proto_gen import sc2api_pb2 as sc_pb
    from ._proto_gen import score_pb2 as score_pb
    from ._proto_gen import spatial_pb2 as spatial_pb

    PROVIDER = "vendored"

# python enum over the proto Status values (reference protocol.py:42)
Status = enum.Enum("Status", sc_pb.Status.items())

__all__ = ["sc_pb", "raw_pb", "common_pb", "score_pb", "spatial_pb", "Status", "PROVIDER"]

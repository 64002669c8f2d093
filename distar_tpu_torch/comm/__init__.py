"""The data plane: wire format, native shuttle, shared-memory rings,
coordinator, discovery and the actor-learner ``Adapter``.

Counterpart of ``distar_tpu.comm``, with the coordinator's high
availability (``comm/ha.py``: the journal, the warm standby, epoch
fencing and the multi-address client).
"""
from . import shuttle
from .adapter import Adapter
from .coordinator import Coordinator, CoordinatorServer, coordinator_request
from .serializer import dumps, loads
from .shm_ring import ShmError, ShmPeer, ShmPeerDeadError, ShmRing, shm_available
from ..resilience import CommError  # typed transport error raised by this package

__all__ = [
    "Adapter",
    "CommError",
    "Coordinator",
    "CoordinatorServer",
    "coordinator_request",
    "dumps",
    "loads",
    "shuttle",
    "ShmError",
    "ShmPeer",
    "ShmPeerDeadError",
    "ShmRing",
    "shm_available",
]

"""The data plane: wire format, native shuttle, shared-memory rings,
coordinator and discovery.

Counterpart of ``distar_tpu.comm``. The actor-learner ``Adapter``
(``comm/adapter.py``) comes with ROADMAP Queue 1 item 5, the coordinator's
high availability (``comm/ha.py``) with item 11.
"""
from . import shuttle
from .coordinator import Coordinator, CoordinatorServer, coordinator_request
from .serializer import dumps, loads
from .shm_ring import ShmError, ShmPeer, ShmPeerDeadError, ShmRing, shm_available
from ..resilience import CommError  # typed transport error raised by this package

__all__ = [
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

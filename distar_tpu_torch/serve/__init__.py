"""Dynamic-batching inference gateway with a versioned hot-swap registry.

Counterpart of ``distar_tpu.serve``: ad-hoc ``sample_action`` requests
are coalesced into the fixed-shape batch of ``actor.inference.
BatchedInference``.

Pieces:
  * ``MicroBatcher``     — deadline-aware request coalescing
  * ``SessionTable``     — sticky sessions: server-side LSTM carry slots
  * ``ModelRegistry``    — versioned params (checkpoints by default), warm-up
                           off the serving path, atomic swap at a flush
                           boundary
  * ``InferenceGateway`` — ties the above around an engine; admission
                           control, drain-then-stop shutdown, teacher logits
  * ``GatewayMux``       — several player models behind one address
  * ``ServeHTTPServer``  — stdlib HTTP/JSON control + light data plane
  * ``ServeTCPServer`` / ``ServeClient`` — framed-TCP data plane on the
                           ``comm.serializer`` wire format, with
                           shared-memory rings for clients on the same host
  * ``serve.fleet``      — discovery, session-affinity routing and rollout
                           across many gateways

Everything publishes into the process ``obs`` registry (``distar_serve_*``).
"""
from .batcher import MicroBatcher, PendingRequest
from .engine import BatchedInferenceEngine, MockModelEngine
from .errors import (
    CapacityError,
    DeadlineExceededError,
    DrainingError,
    QueueFullError,
    ServeError,
    ShedError,
    UnknownPlayerError,
    UnknownVersionError,
    error_from_wire,
)
from .gateway import InferenceGateway
from .http_frontend import ServeHTTPServer
from .mux import STUDENT_TIER, TEACHER_TIER, GatewayMux, tier_player
from .registry import ModelRegistry
from .sessions import SessionTable
from .tcp_frontend import ServeClient, ServeTCPServer

__all__ = [
    "BatchedInferenceEngine",
    "CapacityError",
    "DeadlineExceededError",
    "DrainingError",
    "GatewayMux",
    "STUDENT_TIER",
    "TEACHER_TIER",
    "tier_player",
    "InferenceGateway",
    "MicroBatcher",
    "MockModelEngine",
    "ModelRegistry",
    "PendingRequest",
    "QueueFullError",
    "ServeClient",
    "ServeError",
    "ServeHTTPServer",
    "ServeTCPServer",
    "SessionTable",
    "ShedError",
    "UnknownPlayerError",
    "UnknownVersionError",
    "error_from_wire",
]

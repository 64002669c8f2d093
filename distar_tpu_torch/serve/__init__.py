"""Dynamic-batching inference gateway with a versioned hot-swap registry.

  * ``MicroBatcher``     — deadline-aware request coalescing
  * ``SessionTable``     — sticky sessions: server-side LSTM carry slots
  * ``ModelRegistry``    — versioned params, warm-up off the serving path,
                           atomic swap at a flush boundary
  * ``InferenceGateway`` — ties the above around an engine
"""
from .batcher import MicroBatcher, PendingRequest
from .engine import BatchedInferenceEngine
from .errors import (
    CapacityError,
    DeadlineExceededError,
    DrainingError,
    QueueFullError,
    ServeError,
    ShedError,
    UnknownVersionError,
    error_from_wire,
)
from .gateway import InferenceGateway
from .registry import ModelRegistry
from .sessions import SessionTable

__all__ = [
    "BatchedInferenceEngine",
    "CapacityError",
    "DeadlineExceededError",
    "DrainingError",
    "InferenceGateway",
    "MicroBatcher",
    "ModelRegistry",
    "PendingRequest",
    "QueueFullError",
    "ServeError",
    "SessionTable",
    "ShedError",
    "UnknownVersionError",
    "error_from_wire",
]

"""Fault tolerance: the retry and circuit-breaker primitive, and role
supervision.

Counterpart of ``distar_tpu.resilience``'s ``policy`` and ``supervisor``
modules; ``AlertRemediator`` and the chaos harness come with ROADMAP Queue
1 item 9.
"""
from .policy import (
    DEFAULT_COMM_POLICY,
    NO_RETRY,
    CircuitBreaker,
    CircuitOpenError,
    CommError,
    FatalError,
    RetryableError,
    RetryPolicy,
    retry_call,
    retryable,
)
from .supervisor import RestartPolicy, Supervisor, TaskContext, supervise_call

__all__ = [
    "DEFAULT_COMM_POLICY",
    "NO_RETRY",
    "CircuitBreaker",
    "CircuitOpenError",
    "CommError",
    "FatalError",
    "RestartPolicy",
    "RetryPolicy",
    "RetryableError",
    "Supervisor",
    "TaskContext",
    "retry_call",
    "retryable",
    "supervise_call",
]

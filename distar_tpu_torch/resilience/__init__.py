"""Fault tolerance: the retry and circuit-breaker primitive.

Counterpart of ``distar_tpu.resilience``'s ``policy`` module; the
supervisor and the chaos harness come with ROADMAP Queue 1 items 5 and 9.
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

__all__ = [
    "DEFAULT_COMM_POLICY",
    "NO_RETRY",
    "CircuitBreaker",
    "CircuitOpenError",
    "CommError",
    "FatalError",
    "RetryPolicy",
    "RetryableError",
    "retry_call",
    "retryable",
]

"""Fault tolerance: the retry and circuit-breaker primitive, role
supervision, alert remediation and the chaos injector.

Counterpart of ``distar_tpu.resilience``.
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
from .supervisor import AlertRemediator, RestartPolicy, Supervisor, TaskContext, supervise_call
from .chaos import ChaosInjector

__all__ = [
    "AlertRemediator",
    "ChaosInjector",
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

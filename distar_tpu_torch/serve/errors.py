"""Typed serve-plane errors (the same taxonomy and wire codes as
``distar_tpu.serve.errors``).

Admission control and deadline enforcement answer with errors a caller can
dispatch on (retry-with-backoff for sheds) instead of blocking or returning
ambiguous empties. Every error maps to a wire dict (``to_wire`` /
``error_from_wire``), so a frontend carries the same taxonomy.
"""
from __future__ import annotations


class ServeError(Exception):
    """Base serve failure. ``code`` is the stable wire identifier."""

    code = "serve_error"
    shed = False  # True for load-shed responses a client should retry later

    def to_wire(self) -> dict:
        return {"code": self.code, "error": str(self), "shed": self.shed}


class ShedError(ServeError):
    """Load shed: the server refused work it could not serve in time.
    Retryable by construction — no request state was created."""

    code = "shed"
    shed = True


class QueueFullError(ShedError):
    """Admission control: the bounded request queue is at capacity."""

    code = "shed_queue_full"


class DeadlineExceededError(ShedError):
    """The request's deadline passed before (or while) being served."""

    code = "shed_deadline"


class CapacityError(ShedError):
    """No session slot free and nothing idle enough to evict."""

    code = "shed_capacity"


class DrainingError(ShedError):
    """The gateway is draining for shutdown; no new admissions."""

    code = "draining"


class BadFrameError(ServeError):
    """The peer sent an unparseable frame (garbage header/codec): the framed
    stream can no longer be trusted and the connection closes after the
    reply."""

    code = "bad_frame"


class BadRequestError(ServeError):
    """The request was not a well-formed op dict, or named an op/surface
    this server does not have. Not retryable: re-sending the same request
    cannot fix it."""

    code = "bad_request"


class RingServiceError(ServeError):
    """The shm ring pump answered for a dispatch bug (``comm/shm_ring.py``
    ``RingService``): the request reached the server but its handler raised
    something untyped."""

    code = "shm_error"


class UnknownVersionError(ServeError):
    """Registry operation referenced a version that was never loaded."""

    code = "unknown_version"


class UnknownPlayerError(ServeError):
    """Request named a player this multiplexed gateway does not serve."""

    code = "unknown_player"


_WIRE_CODES = {
    cls.code: cls
    for cls in (
        ServeError,
        ShedError,
        QueueFullError,
        DeadlineExceededError,
        CapacityError,
        DrainingError,
        BadFrameError,
        BadRequestError,
        RingServiceError,
        UnknownVersionError,
        UnknownPlayerError,
    )
}


def error_from_wire(payload: dict) -> ServeError:
    """Rehydrate a typed error from its wire dict (unknown codes degrade to
    the base ``ServeError`` so old clients survive new server codes)."""
    cls = _WIRE_CODES.get(payload.get("code"), ServeError)
    return cls(payload.get("error", ""))

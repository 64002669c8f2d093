"""Typed replay-plane errors.

Counterpart of ``distar_tpu.replay.errors``, with the same wire dicts, so
either package's client rehydrates either package's server's answers.
Same contract as the serve plane's error taxonomy (serve/errors.py): every
failure a client can dispatch on maps to a stable wire dict
(``to_wire``/``error_from_wire``), so the framed-TCP data plane carries
typed answers instead of ambiguous empties. ``RateLimitTimeout``
additionally subclasses ``resilience.RetryableError``: a store that is
rate-limit-blocked is *pacing* the caller, not failing, so the retry
fabric backs off and re-offers instead of giving up or striking the peer.
"""
from __future__ import annotations

from ..resilience import RetryableError


class ReplayError(Exception):
    """Base replay-store failure. ``code`` is the stable wire identifier."""

    code = "replay_error"

    def to_wire(self) -> dict:
        return {"code": self.code, "error": str(self)}


class UnknownTableError(ReplayError):
    """Operation referenced a table the store doesn't hold (and the store
    was configured without an auto-create factory)."""

    code = "unknown_table"


class InvalidBatchError(ReplayError):
    """The requested sample batch can never be admitted under the table's
    rate-limiter configuration (``batch_size`` exceeds what the
    ``error_buffer`` slack allows even with inserters run to their bound).
    Deliberately NOT retryable: waiting cannot fix a config mismatch, and
    without this check both sides block forever trading timeouts."""

    code = "invalid_batch"


class RateLimitTimeout(ReplayError, RetryableError):
    """The samples-per-insert limiter kept the operation blocked past its
    timeout. Retryable by construction: no state was created, and the
    block is the rate control working — inserters wait for the learner,
    samplers wait for the actors (docs/data_plane.md)."""

    code = "rate_limited"

    def __init__(self, side: str, timeout_s: float, state: dict):
        super().__init__(
            f"{side} blocked > {timeout_s:.1f}s by the rate limiter ({state})"
        )
        self.side = side
        self.state = state


class ItemCorruptError(ReplayError):
    """A spilled item failed its CRC check on recovery."""

    code = "item_corrupt"


class StoreDrainingError(ReplayError):
    """The store is retiring gracefully: new inserts are refused while the
    resident tail drains out to samplers. Deliberately NOT retryable against
    the same shard — waiting cannot un-drain it; sharded clients route the
    key to a survivor instead (and the drained shard leaves the map at the
    next membership refresh)."""

    code = "draining"


class BadFrameError(ReplayError):
    """The peer sent an unparseable frame (garbage header/codec): the framed
    stream can no longer be trusted and the connection closes after the
    reply."""

    code = "bad_frame"


class BadRequestError(ReplayError):
    """The request was not a well-formed op dict, or named an op this store
    does not speak. Not retryable: re-sending the same request cannot fix
    it."""

    code = "bad_request"


class RingServiceError(ReplayError):
    """The shm ring pump answered for a dispatch bug (comm/shm_ring.py
    ``RingService``): the request reached the store but its handler raised
    something untyped."""

    code = "shm_error"


class BadHelloError(ReplayError):
    """The connection's ``hello`` offered preference lists with no
    recognized name at all (garbage codec/transport names — a hostile or
    desynced peer). Deliberately NOT retryable, and never silently
    degraded: a peer that can't even name a real codec must be told so."""

    code = "bad_hello"


_WIRE_CODES = {
    cls.code: cls
    for cls in (ReplayError, UnknownTableError, InvalidBatchError,
                ItemCorruptError, BadHelloError, StoreDrainingError,
                BadFrameError, BadRequestError, RingServiceError)
}


def error_from_wire(payload: dict) -> ReplayError:
    """Rehydrate a typed error from its wire dict. ``rate_limited`` needs
    its own path (the constructor signature differs); unknown codes degrade
    to the base ``ReplayError`` so old clients survive new server codes."""
    code = payload.get("code")
    if code == RateLimitTimeout.code:
        err = RateLimitTimeout(
            payload.get("side", "?"), float(payload.get("timeout_s", 0.0)),
            payload.get("state", {}),
        )
        return err
    cls = _WIRE_CODES.get(code, ReplayError)
    return cls(payload.get("error", ""))

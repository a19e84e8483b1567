"""One error taxonomy for the serving stack.

A copy of ``repro/serve/errors.py`` (pure Python): the same classes, the
same wire status codes.  Every session-layer failure raises a
``SessionError`` subclass carrying a stable wire ``status`` code and
symbolic ``code`` name, while still subclassing the builtin class callers
already catch (``ValueError`` for bad sids/shapes, ``RuntimeError`` for
queued-session and preemption errors).

The class <-> status mapping is the single source of truth for the wire
protocol: the service serializes ``status_of(exc)`` into each error
response, and the client reconstructs the SAME exception class with
``error_for_status`` -- so a caller of the remote client catches
exactly what a caller of the in-process engine catches (the error
parity the network differential harness in ``tests/test_storm.py``
asserts).  Status codes are append-only; renumbering is a wire break.

    0  OK                 (not an exception)
    1  ERR_MALFORMED      ProtocolError        malformed/corrupt frame
    2  ERR_OP             UnknownOpError       unknown/invalid op
    3  ERR_UNKNOWN_SID    UnknownSessionError  sid never handed out
    4  ERR_CLOSED_SID     ClosedSessionError   sid already closed
    5  ERR_QUEUED         QueuedSessionError   session awaiting a slot
    6  ERR_SHAPE          ShapeMismatchError   append tuple-shape error
    7  ERR_RATELIMIT      RateLimitedError     token bucket empty
    8  ERR_BACKPRESSURE   BackpressureError    service queue full
    9  ERR_PREEMPTED      EnginePreempted      engine drained
    10 ERR_INTERNAL       InternalError        unexpected server error

``RateLimitedError`` / ``BackpressureError`` carry ``retry_after_ms``:
the explicit RETRY-AFTER contract -- the service sheds load with a
typed answer instead of buffering unboundedly (docs/serving.md).
"""
from __future__ import annotations

from typing import Dict, Optional, Type

OK = 0
ERR_MALFORMED = 1
ERR_OP = 2
ERR_UNKNOWN_SID = 3
ERR_CLOSED_SID = 4
ERR_QUEUED = 5
ERR_SHAPE = 6
ERR_RATELIMIT = 7
ERR_BACKPRESSURE = 8
ERR_PREEMPTED = 9
ERR_INTERNAL = 10


class SessionError(Exception):
    """Base of the serving error taxonomy.  ``status`` is the wire
    status code (stable, append-only); ``code`` its symbolic name."""

    status: int = ERR_INTERNAL
    code: str = "ERR_INTERNAL"


class ProtocolError(SessionError):
    """A malformed wire frame: bad magic, CRC mismatch, oversized or
    truncated length prefix, undecodable header.  The codec rejects the
    frame BEFORE any engine state is touched; the connection closes
    (after corruption the byte stream has no reliable resync point)."""

    status = ERR_MALFORMED
    code = "ERR_MALFORMED"


class UnknownOpError(SessionError):
    """A well-formed frame naming an op the service does not serve."""

    status = ERR_OP
    code = "ERR_OP"


class UnknownSessionError(SessionError, ValueError):
    """A sid this engine never handed out."""

    status = ERR_UNKNOWN_SID
    code = "ERR_UNKNOWN_SID"


class ClosedSessionError(SessionError, ValueError):
    """A sid that was already closed; closed sids are never reused."""

    status = ERR_CLOSED_SID
    code = "ERR_CLOSED_SID"


class QueuedSessionError(SessionError, RuntimeError):
    """The session exists but is still waiting for a primary slot:
    ``query``/``flush_session`` have nothing to answer from, and
    ``close`` refuses to discard its buffered data."""

    status = ERR_QUEUED
    code = "ERR_QUEUED"


class ShapeMismatchError(SessionError, ValueError):
    """An ``append`` whose tuple shape disagrees with the engine's."""

    status = ERR_SHAPE
    code = "ERR_SHAPE"


class RetryableError(SessionError):
    """Base for load-shedding errors carrying an explicit RETRY-AFTER
    hint -- the client should back off ``retry_after_ms`` and resend."""

    def __init__(self, msg: str, retry_after_ms: float = 0.0):
        super().__init__(msg)
        self.retry_after_ms = float(retry_after_ms)


class RateLimitedError(RetryableError):
    """The tenant's token bucket is empty (per-tenant rate limit)."""

    status = ERR_RATELIMIT
    code = "ERR_RATELIMIT"


class BackpressureError(RetryableError):
    """The service's bounded request/admission queue is full; the
    request was rejected instead of buffered unboundedly."""

    status = ERR_BACKPRESSURE
    code = "ERR_BACKPRESSURE"


class EnginePreempted(SessionError, RuntimeError):
    """The engine drained after a preemption signal: open sessions are
    flushed and checkpointed on disk; ``recover()`` resumes them."""

    status = ERR_PREEMPTED
    code = "ERR_PREEMPTED"


class InternalError(SessionError):
    """An unexpected server-side failure (bug surface, never expected)."""

    status = ERR_INTERNAL
    code = "ERR_INTERNAL"


#: status code -> exception class (the client-side reconstruction map).
EXC_BY_STATUS: Dict[int, Type[SessionError]] = {
    cls.status: cls
    for cls in (InternalError, ProtocolError, UnknownOpError,
                UnknownSessionError, ClosedSessionError, QueuedSessionError,
                ShapeMismatchError, RateLimitedError, BackpressureError,
                EnginePreempted)
}


def status_of(exc: BaseException) -> int:
    """The wire status code for an exception (``ERR_INTERNAL`` for
    anything outside the taxonomy)."""
    if isinstance(exc, SessionError):
        return exc.status
    return ERR_INTERNAL


def error_for_status(status: int, msg: str,
                     retry_after_ms: Optional[float] = None) -> SessionError:
    """Rebuild the taxonomy exception a wire status code encodes -- the
    client raises the SAME class the server caught, so remote and
    in-process callers share one error contract."""
    cls = EXC_BY_STATUS.get(int(status), InternalError)
    if issubclass(cls, RetryableError):
        return cls(msg, retry_after_ms=retry_after_ms or 0.0)
    return cls(msg)

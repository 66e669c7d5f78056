"""HTTP error taxonomy with status codes and log levels (the port's copy
of ``gofr_tpu/http/errors.py``, and the port's one error hierarchy:
``serving/responses.py`` re-exports it, so an error raised by a serving
handler renders the same under ``ChatServer`` and under ``App``).

Mirrors the reference's error set (pkg/gofr/http/errors.go): each error
knows its HTTP status code and the level it should be logged at
(reference handler.go:154-178 maps errors to log levels).  Handlers
raise these; the responder turns them into the error envelope.
"""

from __future__ import annotations

from ..logging.logger import DEBUG, ERROR, INFO, WARN, Level


class HTTPError(Exception):
    """Base class: carries status_code + log_level + reason."""

    status_code: int = 500
    log_level: Level = ERROR

    def __init__(self, message: str = "", *, status_code: int | None = None,
                 details: object = None,
                 headers: dict | None = None) -> None:
        super().__init__(message or self.default_message())
        if status_code is not None:
            self.status_code = status_code
        self.details = details
        #: extra response headers the responder forwards verbatim
        #: (e.g. Retry-After on overload rejections)
        self.headers = dict(headers or {})

    def default_message(self) -> str:
        return "internal server error"

    @property
    def message(self) -> str:
        return str(self)


class ErrorEntityNotFound(HTTPError):
    status_code = 404
    log_level = INFO

    def __init__(self, name: str = "entity", value: str = "") -> None:
        super().__init__(f"No entity found with {name}: {value}" if value
                         else f"No entity found: {name}")


class ErrorEntityAlreadyExists(HTTPError):
    status_code = 409
    log_level = WARN

    def default_message(self) -> str:
        return "entity already exists"


class ErrorInvalidParam(HTTPError):
    status_code = 400
    log_level = INFO

    def __init__(self, *params: str) -> None:
        names = ", ".join(params) or "unknown"
        super().__init__(f"Incorrect value for parameter: {names}")


class ErrorMissingParam(HTTPError):
    status_code = 400
    log_level = INFO

    def __init__(self, *params: str) -> None:
        names = ", ".join(params) or "unknown"
        super().__init__(f"Parameter {names} is required")


class ErrorInvalidRoute(HTTPError):
    status_code = 404
    log_level = DEBUG

    def default_message(self) -> str:
        return "route not registered"


class ErrorMethodNotAllowed(HTTPError):
    status_code = 405
    log_level = DEBUG

    def default_message(self) -> str:
        return "method not allowed"


class ErrorRequestTimeout(HTTPError):
    status_code = 408
    log_level = INFO

    def default_message(self) -> str:
        return "request timed out"


class ErrorClientClosedRequest(HTTPError):
    status_code = 499
    log_level = DEBUG

    def default_message(self) -> str:
        return "client closed request"


class ClientGone(ErrorClientClosedRequest):
    """Raised by a handler that saw its client leave
    (``ctx.client_gone()``) before the answer: the request it asked for
    is cancelled. ``ChatServer`` sends nothing and drops the connection;
    ``App`` answers 499, which no client reads."""


class ErrorPanicRecovery(HTTPError):
    status_code = 500
    log_level = ERROR

    def default_message(self) -> str:
        return "internal server error"


class ErrorServiceUnavailable(HTTPError):
    status_code = 503
    log_level = WARN

    def default_message(self) -> str:
        return "service unavailable"


class ErrorTooManyRequests(HTTPError):
    """Per-tenant rate limit exceeded (token buckets in
    serving/scheduler.py). INFO, not WARN: a tenant hitting its own
    configured limit is the limiter working, not service distress —
    the scheduler WARNs separately when SLO-driven shedding starts."""

    status_code = 429
    log_level = INFO

    def default_message(self) -> str:
        return "too many requests"


def status_and_level_for(err: BaseException) -> tuple[int, Level]:
    """Status + log level for an arbitrary handler exception.

    Mirrors the mapping at reference handler.go:154-178: typed HTTP
    errors carry their own; unknown exceptions are 500/ERROR; objects
    with a ``status_code`` attribute (custom errors) are honored.
    """
    if isinstance(err, HTTPError):
        return err.status_code, err.log_level
    status = getattr(err, "status_code", 500)
    if not isinstance(status, int) or not (100 <= status <= 599):
        status = 500
    # client errors default to INFO (matching the taxonomy above);
    # server errors to ERROR
    level = getattr(err, "log_level", INFO if status < 500 else ERROR)
    return status, level

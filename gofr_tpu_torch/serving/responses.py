"""What a route handler of the port's app returns or raises
(counterpart of ``gofr_tpu/http/response.py`` and
``gofr_tpu/http/errors.py``, the part the serving routes use).

A handler returns a plain value (enveloped as ``{"data": ...}``, 201
for a POST, 200 for a GET), a :class:`Raw` (a bare JSON body, same
statuses), a :class:`File` (bytes with their content type, same
statuses), a :class:`Reply` (bytes with their own status, content type
and headers: an answer proxied from another server) or a
:class:`Stream` (an iterator of server-sent-event chunks, sent
chunked); it raises an :class:`HTTPError`, which answers ``{"error":
{"message", "details"?}}`` with its status and headers.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


class HTTPError(Exception):
    """An error answer: its status, message, optional ``details`` object
    and extra headers (``Retry-After`` on a refused admission)."""

    status_code: int = 500

    def __init__(self, message: str = "", *, status_code: int | None = None,
                 details: Any = None, headers: dict | None = None) -> None:
        super().__init__(message or "internal server error")
        if status_code is not None:
            self.status_code = status_code
        self.details = details
        self.headers = dict(headers or {})


class ErrorInvalidParam(HTTPError):
    status_code = 400

    def __init__(self, *params: str) -> None:
        super().__init__("Incorrect value for parameter: "
                         + (", ".join(params) or "unknown"))


class ErrorMissingParam(HTTPError):
    status_code = 400

    def __init__(self, *params: str) -> None:
        super().__init__(f"Parameter {', '.join(params) or 'unknown'} "
                         "is required")


class ErrorEntityNotFound(HTTPError):
    status_code = 404

    def __init__(self, name: str = "entity", value: str = "") -> None:
        super().__init__(f"No entity found with {name}: {value}" if value
                         else f"No entity found: {name}")


class ErrorServiceUnavailable(HTTPError):
    status_code = 503


class ErrorTooManyRequests(HTTPError):
    status_code = 429


@dataclass
class Raw:
    """A JSON body without the ``{"data": ...}`` envelope."""

    data: Any


@dataclass
class File:
    """Bytes with their content type (``/debug/events``' JSONL)."""

    content: bytes
    content_type: str = "application/octet-stream"


@dataclass
class Reply:
    """Bytes sent as they are, with their status, content type and extra
    headers (the fleet router's mirror of a worker's answer)."""

    status: int
    body: bytes
    content_type: str = "application/json"
    headers: dict = field(default_factory=dict)


@dataclass
class Stream:
    """A streamed answer: ``iterator`` yields ``str`` or ``bytes``
    chunks, each sent as one chunk of a chunked body. An empty chunk is
    sent as nothing: it tells the server to check that the client is
    still connected (a handler yields one while it waits for a token)."""

    iterator: Any
    content_type: str = "text/event-stream"
    #: extra response headers
    headers: dict = field(default_factory=dict)


class ClientGone(Exception):
    """The client closed its connection before the answer: nothing is
    sent, and the request it asked for is cancelled."""

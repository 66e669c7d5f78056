"""Response rendering: status-code policy + the ``{data, error}`` envelope
(the port's copy of ``gofr_tpu/http/responder.py``; it also renders the
port's :class:`~.response.Reply` as it is, and a ``Stream``'s headers).

Mirrors reference pkg/gofr/http/responder.go:17-269:
- POST -> 201, DELETE -> 204 (responder.go:133-146)
- data + error together -> 206 Partial Content (responder.go:197-199)
- Redirect: 302 for GET/HEAD, 303 otherwise (responder.go:99-110)
- typed errors supply their own status (errors.py)
- success envelope ``{"data": ...}``; error envelope
  ``{"error": {"message": ...}}`` (responder.go:248-252)
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, AsyncIterator

from .errors import status_and_level_for
from .response import (File, Partial, Raw, Redirect, Reply, Response,
                       Stream, Template, XML)


@dataclass
class ResponseData:
    status: int = 200
    headers: dict[str, str] = field(default_factory=dict)
    body: bytes = b""
    stream: AsyncIterator | None = None
    content_type: str = "application/json"


def _json_bytes(obj: Any) -> bytes:
    return json.dumps(obj, default=_default).encode()


def _default(obj: Any) -> Any:
    if hasattr(obj, "__dict__"):
        return obj.__dict__
    if hasattr(obj, "_asdict"):
        return obj._asdict()
    if hasattr(obj, "tolist"):  # numpy arrays / tensors in handler results
        return obj.tolist()
    return str(obj)


class Responder:
    """Stateless renderer from handler (result, error) to ResponseData."""

    def respond(self, result: Any, error: BaseException | None,
                method: str = "GET") -> ResponseData:
        method = method.upper()

        if isinstance(result, Partial):
            error = error or result.error
            body = {"data": result.data,
                    "error": self._error_obj(error)}
            return ResponseData(status=206, body=_json_bytes(body))

        if error is not None:
            status, _ = status_and_level_for(error)
            envelope: dict[str, Any] = {"error": self._error_obj(error)}
            return ResponseData(status=status, body=_json_bytes(envelope),
                                headers=dict(getattr(error, "headers",
                                                     None) or {}))

        if isinstance(result, Redirect):
            status = 302 if method in ("GET", "HEAD") else 303
            return ResponseData(status=status, headers={"Location": result.url},
                                body=b"", content_type="text/plain")

        if isinstance(result, File):
            return ResponseData(status=200, body=result.content,
                                content_type=result.content_type)

        if isinstance(result, Template):
            return ResponseData(status=200, body=result.render().encode(),
                                content_type="text/html; charset=utf-8")

        if isinstance(result, XML):
            status = {"POST": 201}.get(method, 200)
            return ResponseData(status=status, body=result.render().encode(),
                                content_type="application/xml; charset=utf-8")

        if isinstance(result, Raw):
            status = {"POST": 201}.get(method, 200)
            return ResponseData(status=status, body=_json_bytes(result.data))

        if isinstance(result, Stream):
            return ResponseData(status=200, stream=result.iterator,
                                headers=dict(result.headers),
                                content_type=result.content_type)

        if isinstance(result, Reply):
            return ResponseData(status=result.status, body=result.body,
                                headers=dict(result.headers),
                                content_type=result.content_type)

        if isinstance(result, ResponseData):
            return result

        # plain data success path
        status = {"POST": 201, "DELETE": 204}.get(method, 200)
        if status == 204 and result is None:
            return ResponseData(status=204, body=b"")
        headers: dict[str, str] = {}
        metadata = None
        if isinstance(result, Response):
            headers = dict(result.headers)
            metadata = result.metadata
            result = result.data
        envelope = {"data": result}
        if metadata:
            envelope["metadata"] = metadata
        return ResponseData(status=status, headers=headers,
                            body=_json_bytes(envelope))

    @staticmethod
    def _error_obj(error: BaseException) -> dict[str, Any]:
        obj: dict[str, Any] = {"message": str(error) or error.__class__.__name__}
        details = getattr(error, "details", None)
        if details is not None:
            obj["details"] = details
        return obj

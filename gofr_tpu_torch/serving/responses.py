"""What a route handler of the port returns or raises: re-exported from
the one hierarchy in :mod:`gofr_tpu_torch.http.errors` and
:mod:`gofr_tpu_torch.http.response`, so a serving handler's answer
renders the same under ``ChatServer`` and under ``App``.

A handler returns a plain value (enveloped as ``{"data": ...}``, 201
for a POST, 200 for a GET), a :class:`Raw` (a bare JSON body, same
statuses), a :class:`File` (bytes with their content type, same
statuses), a :class:`Reply` (bytes with their own status, content type
and headers: an answer proxied from another server) or a
:class:`Stream` (an iterator of server-sent-event chunks, sent
chunked); it raises an :class:`HTTPError`, which answers ``{"error":
{"message", "details"?}}`` with its status and headers.
"""

from ..http.errors import (ClientGone, ErrorEntityNotFound,
                           ErrorInvalidParam, ErrorMissingParam,
                           ErrorServiceUnavailable, ErrorTooManyRequests,
                           HTTPError)
from ..http.response import File, Raw, Reply, Stream

__all__ = ["ClientGone", "ErrorEntityNotFound", "ErrorInvalidParam",
           "ErrorMissingParam", "ErrorServiceUnavailable",
           "ErrorTooManyRequests", "File", "HTTPError", "Raw", "Reply",
           "Stream"]

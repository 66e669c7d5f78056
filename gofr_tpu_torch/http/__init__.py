"""The port's HTTP layer (counterpart of ``gofr_tpu/http/``): errors,
response types, request binding, the responder, the router, the
asyncio HTTP/1.1 server, the standard middleware and auth."""

from .errors import (
    ClientGone,
    ErrorClientClosedRequest,
    ErrorEntityAlreadyExists,
    ErrorEntityNotFound,
    ErrorInvalidParam,
    ErrorInvalidRoute,
    ErrorMethodNotAllowed,
    ErrorMissingParam,
    ErrorPanicRecovery,
    ErrorRequestTimeout,
    ErrorServiceUnavailable,
    ErrorTooManyRequests,
    HTTPError,
)
from .request import HTTPRequest
from .responder import Responder
from .response import (File, Partial, Raw, Redirect, Reply, Response,
                       Stream, Template, XML)
from .router import Route, Router

__all__ = [
    "ClientGone", "ErrorClientClosedRequest", "ErrorEntityAlreadyExists",
    "ErrorEntityNotFound", "ErrorInvalidParam", "ErrorInvalidRoute",
    "ErrorMissingParam", "ErrorMethodNotAllowed", "ErrorPanicRecovery",
    "ErrorRequestTimeout", "ErrorServiceUnavailable",
    "ErrorTooManyRequests", "HTTPError",
    "HTTPRequest", "Responder", "File", "Partial", "Raw", "Redirect",
    "Reply", "Response", "Stream", "Template", "XML", "Route", "Router",
]

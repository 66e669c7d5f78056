"""The standard middleware chain: tracer -> logging -> CORS -> metrics
(the port's copy of ``gofr_tpu/http/middleware.py``).

Mirrors reference pkg/gofr/http/middleware/: request span from the
incoming ``traceparent`` (tracer.go:15-32), structured per-request log
with trace ids and probe-path muting (logger.go:93-175), env-driven
CORS (cors.go:13-60), and the ``app_http_response`` histogram
(metrics.go:22-60). Auth middleware lives in ``auth.py``.
"""

from __future__ import annotations

import time
from typing import TextIO

from ..logging.logger import Logger, current_trace_ids
from .request import HTTPRequest
from .responder import ResponseData
from .server import Handler, Middleware

WELL_KNOWN_PATHS = {"/.well-known/health", "/.well-known/alive", "/favicon.ico"}


class RequestLog:
    """One-line structured request record (reference logger.go:51-66)."""

    def __init__(self, method: str, uri: str, status: int, duration_us: int,
                 ip: str, trace_id: str = "") -> None:
        self.method = method
        self.uri = uri
        self.response = status
        self.response_time = duration_us
        self.ip = ip
        self.trace_id = trace_id

    def pretty_print(self, out: TextIO) -> None:
        color = 32 if self.response < 400 else (33 if self.response < 500 else 31)
        out.write(f"\x1b[{color}m{self.response}\x1b[0m "
                  f"{self.response_time:>8}µs {self.method:<7} {self.uri}")


def tracer_middleware(tracer) -> Middleware:
    def mw(next_handler: Handler) -> Handler:
        async def wrapped(request: HTTPRequest) -> ResponseData:
            span = tracer.start_span(
                f"{request.method} {request.path}",
                traceparent=request.header("traceparent"))
            try:
                response = await next_handler(request)
                span.set_attribute("http.status", response.status)
                if response.status >= 500:
                    span.set_status(f"ERROR: {response.status}")
                # clients correlate support tickets to traces by this
                # header — on every status, errors especially
                response.headers.setdefault("X-Trace-Id", span.trace_id)
                return response
            finally:
                span.end()
        return wrapped
    return mw


def logging_middleware(logger: Logger,
                       tenant_resolver=None) -> Middleware:
    def mw(next_handler: Handler) -> Handler:
        async def wrapped(request: HTTPRequest) -> ResponseData:
            start = time.perf_counter()
            trace = current_trace_ids()
            trace_id = trace[0] if trace else ""
            try:
                response = await next_handler(request)
            except Exception:
                logger.error(RequestLog(
                    request.method, request.path, 500,
                    int((time.perf_counter() - start) * 1e6),
                    request.client_addr, trace_id).__dict__)
                raise
            if request.path not in WELL_KNOWN_PATHS:  # probe muting
                record = RequestLog(
                    request.method, request.path, response.status,
                    int((time.perf_counter() - start) * 1e6),
                    request.client_addr, trace_id)
                # the auth middleware runs INSIDE this one, so by now
                # the principal (if any) is on the request — stamp the
                # resolved tenant label into the request log so one
                # grep answers "who was hitting this route"
                info = getattr(request, "auth_info", None)
                if tenant_resolver is not None and info:
                    record.tenant = tenant_resolver.resolve(info)
                if response.status >= 500:
                    logger.error(record)
                else:
                    logger.info(record)
            return response
        return wrapped
    return mw


def cors_middleware(config) -> Middleware:
    """Env-driven CORS (ACCESS_CONTROL_* keys, reference config.go:29-41)."""
    allow_origin = config.get_or_default("ACCESS_CONTROL_ALLOW_ORIGIN", "*")
    allow_headers = config.get_or_default(
        "ACCESS_CONTROL_ALLOW_HEADERS",
        "Authorization, Content-Type, x-requested-with, origin, true-client-ip, X-Correlation-ID")
    allow_methods = config.get_or_default(
        "ACCESS_CONTROL_ALLOW_METHODS", "GET, POST, PUT, PATCH, DELETE, OPTIONS")
    extra = {}
    for key in ("ACCESS_CONTROL_ALLOW_CREDENTIALS", "ACCESS_CONTROL_MAX_AGE",
                "ACCESS_CONTROL_EXPOSE_HEADERS"):
        value = config.get(key)
        if value:
            header = "-".join(w.capitalize() for w in key.lower().split("_"))
            extra[header] = value

    def apply(headers: dict[str, str]) -> None:
        headers.setdefault("Access-Control-Allow-Origin", allow_origin)
        headers.setdefault("Access-Control-Allow-Headers", allow_headers)
        headers.setdefault("Access-Control-Allow-Methods", allow_methods)
        for k, v in extra.items():
            headers.setdefault(k, v)

    def mw(next_handler: Handler) -> Handler:
        async def wrapped(request: HTTPRequest) -> ResponseData:
            if request.method == "OPTIONS":
                response = ResponseData(status=200, body=b"")
                apply(response.headers)
                return response
            response = await next_handler(request)
            apply(response.headers)
            return response
        return wrapped
    return mw


def metrics_middleware(metrics) -> Middleware:
    """Record app_http_response histogram by path/method/status."""
    def mw(next_handler: Handler) -> Handler:
        async def wrapped(request: HTTPRequest) -> ResponseData:
            start = time.perf_counter()
            response = await next_handler(request)
            # label with the matched route pattern (set by the core
            # handler) so client-controlled paths can't blow up label
            # cardinality; unmatched requests share one label
            pattern = getattr(request, "matched_pattern", None) or "<unmatched>"
            metrics.record_histogram(
                "app_http_response", time.perf_counter() - start,
                path=pattern, method=request.method,
                status=str(response.status))
            return response
        return wrapped
    return mw

"""gRPC client helpers (the port's counterpart of
``gofr_tpu/grpc/client.py``): JSON-codec calls against ``GRPCService``
servers, and the standard health check. Synchronous, as the port's HTTP
client is: one channel per target, unary calls return the decoded reply,
streams are iterators."""

from __future__ import annotations

from typing import Any, Iterator

import grpc

from .health import decode_check_response, encode_check_request, status_name
from .service import _json_deserialize, _json_serialize


class GRPCClient:
    """A channel wrapper, one per target; with a tracer, every call
    carries the active span as ``traceparent`` metadata. ``options`` go
    to ``grpc.insecure_channel``."""

    def __init__(self, target: str, *, tracer: Any = None,
                 options: tuple = ()) -> None:
        self.target = target
        self.tracer = tracer
        self.options = options
        self._channel: grpc.Channel | None = None

    def _chan(self) -> grpc.Channel:
        if self._channel is None:
            self._channel = grpc.insecure_channel(self.target,
                                                  options=self.options)
        return self._channel

    def _metadata(self) -> list[tuple[str, str]]:
        if self.tracer is None:
            return []
        span = self.tracer.current_span()
        if span is None:
            return []
        return [("traceparent", f"00-{span.trace_id}-{span.span_id}-01")]

    def call(self, service: str, method: str, payload: Any = None, *,
             timeout: float | None = None) -> Any:
        rpc = self._chan().unary_unary(
            f"/{service}/{method}",
            request_serializer=_json_serialize,
            response_deserializer=_json_deserialize)
        return rpc(payload if payload is not None else {},
                   timeout=timeout, metadata=self._metadata())

    def stream(self, service: str, method: str, payload: Any = None, *,
               timeout: float | None = None) -> Iterator[Any]:
        rpc = self._chan().unary_stream(
            f"/{service}/{method}",
            request_serializer=_json_serialize,
            response_deserializer=_json_deserialize)
        yield from rpc(payload if payload is not None else {},
                       timeout=timeout, metadata=self._metadata())

    def health_check(self, service: str = "", *,
                     timeout: float | None = None) -> str:
        rpc = self._chan().unary_unary(
            "/grpc.health.v1.Health/Check",
            request_serializer=encode_check_request,
            response_deserializer=decode_check_response)
        return status_name(rpc(service, timeout=timeout))

    def close(self) -> None:
        if self._channel is not None:
            self._channel.close()
            self._channel = None

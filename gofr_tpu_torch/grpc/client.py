"""gRPC client helpers (the port's counterpart of
``gofr_tpu/grpc/client.py``): JSON-codec calls against ``GRPCService``
servers, and the standard health check. One channel per target, as the
port's HTTP client is: unary calls return the decoded reply, streams are
iterators. Called from a thread that runs an event loop (an ``async
def`` handler), ``call``, ``health_check`` and ``close`` return
awaitables and ``stream`` an async iterator, each running the same call
on a worker thread, so a handler written for JAX's ``grpc.aio`` client
(``await client.call(...)``, ``async for m in client.stream(...)``) runs
unchanged and leaves the loop free."""

from __future__ import annotations

import asyncio
from typing import Any, AsyncIterator, Iterator

import grpc

from ..service import awaitable_on_loop
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
        """The decoded reply; on a loop's thread, an awaitable of it."""
        return awaitable_on_loop(self._call, service, method, payload,
                                 timeout)

    def _call(self, service: str, method: str, payload: Any,
              timeout: float | None) -> Any:
        rpc = self._chan().unary_unary(
            f"/{service}/{method}",
            request_serializer=_json_serialize,
            response_deserializer=_json_deserialize)
        return rpc(payload if payload is not None else {},
                   timeout=timeout, metadata=self._metadata())

    def stream(self, service: str, method: str, payload: Any = None, *,
               timeout: float | None = None) -> Any:
        """An iterator of the decoded messages; on a loop's thread, an
        async iterator whose every step waits on a worker thread."""
        rpc = self._chan().unary_stream(
            f"/{service}/{method}",
            request_serializer=_json_serialize,
            response_deserializer=_json_deserialize)
        messages = rpc(payload if payload is not None else {},
                       timeout=timeout, metadata=self._metadata())
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            return iter(messages)
        return _pumped(messages)

    def health_check(self, service: str = "", *,
                     timeout: float | None = None) -> Any:
        """The status's name; on a loop's thread, an awaitable of it."""
        return awaitable_on_loop(self._health_check, service, timeout)

    def _health_check(self, service: str, timeout: float | None) -> str:
        rpc = self._chan().unary_unary(
            "/grpc.health.v1.Health/Check",
            request_serializer=encode_check_request,
            response_deserializer=decode_check_response)
        return status_name(rpc(service, timeout=timeout))

    def close(self) -> Any:
        """Close the channel; on a loop's thread, an awaitable that
        does."""
        return awaitable_on_loop(self._close)

    def _close(self) -> None:
        if self._channel is not None:
            self._channel.close()
            self._channel = None


async def _pumped(messages: Iterator[Any]) -> AsyncIterator[Any]:
    """``messages`` as an async iterator: each ``next`` on a worker
    thread; the stream is cancelled when the iteration stops early."""
    done = object()
    try:
        while True:
            item = await asyncio.to_thread(next, messages, done)
            if item is done:
                return
            yield item
    finally:
        cancel = getattr(messages, "cancel", None)
        if cancel is not None:
            cancel()

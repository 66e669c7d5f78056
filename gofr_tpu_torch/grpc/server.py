"""gRPC server with the framework's observability chain (the port's
counterpart of ``gofr_tpu/grpc/server.py``).

Every RPC gets recovery (a handler's exception answers its
``exc.grpc_status``, else ``INTERNAL``, with the exception's text), one
span (a child of the ``traceparent`` metadata), one log line, and one
``app_grpc_server_duration`` observation (seconds, 5 ms to 10 s, labels
``method`` and ``status``). ``grpc.health.v1.Health`` (``Check`` /
``Watch``) is registered always: ``""`` reads the host's aggregate
health (DOWN answers ``NOT_SERVING``), a registered service
``SERVING``, anything else ``SERVICE_UNKNOWN``. Reflection is registered
only when the host's environment sets ``GRPC_ENABLE_REFLECTION`` to
``"true"``.

The port has no container: the server reads what it needs from the host
it serves beside (a ``ChatServer``): ``tracer``, ``metrics`` (a new
manager when it has none), ``logger``, ``health()``, ``env`` and
``tenant_of``. The port's engine is thread-based, so the server is
grpc's synchronous one on a thread pool (``max_workers``): plain handler
functions and generators run on its threads as they are; a coroutine or
an async generator (the JAX package's style, and :mod:`.protogen`'s
skeletons) runs on an event loop of its own call.
"""

from __future__ import annotations

import asyncio
import dataclasses
import inspect
import os
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator, Mapping

import grpc

from ..metrics import Manager
from ..serving.logger import Logger
from .health import (
    NOT_SERVING,
    SERVING,
    HealthState,
    decode_check_request,
    encode_check_response,
)
from .reflection import DescriptorRegistry, reflection_handler
from .service import (
    CLIENT_STREAM,
    SERVER_STREAM,
    UNARY,
    GRPCService,
    RPCSpec,
)

DEFAULT_GRPC_PORT = 9000
#: 5 ms to 10 s, the JAX server's buckets
_GRPC_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2, 5, 10)
#: seconds between two statuses of a health ``Watch``
WATCH_INTERVAL_S = 1.0


def bind_dataclass(data: Mapping[str, Any], cls: type) -> Any:
    """A dataclass from a mapping: unknown keys are ignored, missing keys
    take the field defaults, a missing required field raises
    ``ValueError``."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name in data:
            kwargs[f.name] = data[f.name]
        elif (f.default is dataclasses.MISSING
              and f.default_factory is dataclasses.MISSING):
            raise ValueError(f"missing required field {f.name!r}")
    return cls(**kwargs)


class RPCContext:
    """One RPC as a handler sees it: the decoded request (``bind``), the
    invocation metadata (``param`` / ``header``, lower-case keys), the
    host (``container``), its tenant, and grpc's own servicer context
    (``grpc_context``: ``is_active``, ``add_callback``)."""

    def __init__(self, payload: Any, metadata: Mapping[str, str],
                 method: str, container: Any, grpc_context: Any) -> None:
        self.payload = payload
        self.metadata = dict(metadata)
        self.method = method
        self.container = container
        self.grpc_context = grpc_context

    def bind(self, target: Any = None) -> Any:
        if isinstance(target, type) and dataclasses.is_dataclass(target) \
                and isinstance(self.payload, Mapping):
            return bind_dataclass(self.payload, target)
        return self.payload

    def param(self, key: str) -> str:
        return self.metadata.get(key.lower(), "")

    def params(self, key: str) -> list[str]:
        value = self.param(key)
        return value.split(",") if value else []

    def header(self, key: str) -> str:
        return self.param(key)

    def host_name(self) -> str:
        return self.metadata.get(":authority", "")

    @property
    def tenant(self) -> str | None:
        """The host's ``tenant_of`` applied to the metadata (None without
        one)."""
        tenant_of = getattr(self.container, "tenant_of", None)
        return tenant_of(self.metadata) if tenant_of is not None else None


def _run_coroutine(result: Any) -> Any:
    return asyncio.run(result) if inspect.isawaitable(result) else result


def _iterate(result: Any) -> Iterator[Any]:
    """The items of a handler's stream: a plain iterator as it is, an
    async generator on an event loop of this call's own."""
    if not hasattr(result, "__anext__"):
        yield from result
        return
    loop = asyncio.new_event_loop()
    try:
        while True:
            try:
                item = loop.run_until_complete(result.__anext__())
            except StopAsyncIteration:
                return
            yield item
    finally:
        try:
            loop.run_until_complete(result.aclose())
        finally:
            loop.close()


class _AsyncRequests:
    """A blocking request iterator as an async one, for async
    client-stream and bidi handlers (each on a loop of its own)."""

    def __init__(self, requests: Any) -> None:
        self._requests = iter(requests)

    def __aiter__(self) -> "_AsyncRequests":
        return self

    async def __anext__(self) -> Any:
        try:
            return next(self._requests)
        except StopIteration:
            raise StopAsyncIteration from None

    def __iter__(self):
        return self._requests


class GRPCServer:
    """``register`` services, then ``start`` (binds ``host:port``; 0 = a
    free port, read back as ``bound_port``) and ``shutdown``."""

    def __init__(self, host_server: Any, *, port: int = DEFAULT_GRPC_PORT,
                 host: str = "0.0.0.0", logger: Any = None,
                 max_workers: int = 32) -> None:
        self.host_server = host_server
        self.host = host
        self.port = port
        self.max_workers = max_workers
        self.logger = logger or getattr(host_server, "logger", None) \
            or Logger()
        if getattr(host_server, "metrics", None) is None:
            host_server.metrics = Manager()
        self.metrics = host_server.metrics
        if self.metrics.get("app_grpc_server_duration") is None:
            self.metrics.new_histogram(
                "app_grpc_server_duration",
                "gRPC server handle time in seconds", buckets=_GRPC_BUCKETS)
        self.health = HealthState()
        self.bound_port: int = port
        self._services: list[GRPCService] = []
        self._descriptors = DescriptorRegistry()
        self._server: grpc.Server | None = None

    # ------------------------------------------------------- registration
    def register(self, service: GRPCService) -> None:
        """Inject the host as ``service.container`` and queue the
        service; it serves from the next ``start``."""
        if not service.name:
            raise ValueError(
                f"{type(service).__name__}.name must be the fully-qualified "
                "gRPC service name")
        service.container = self.host_server
        self._services.append(service)
        self.health.set(service.name, SERVING)

    def register_descriptors(self, fds: bytes) -> None:
        """Feed a protoc-compiled ``FileDescriptorSet`` (protogen's
        ``FILE_DESCRIPTOR_SET``) to reflection."""
        self._descriptors.add_serialized_set(fds)

    # ------------------------------------------------------ observability
    def _observed(self, service: GRPCService, spec: RPCSpec):
        """Recovery, span, log and metric around one RPC."""
        full_method = f"/{service.name}/{spec.name}"
        host = self.host_server
        logger = self.logger
        metrics = self.metrics

        def observe(start: float, status: str) -> None:
            duration = time.perf_counter() - start
            metrics.record_histogram("app_grpc_server_duration", duration,
                                     method=full_method, status=status)
            record = {"method": full_method, "status": status,
                      "duration_us": int(duration * 1e6), "kind": "grpc"}
            (logger.info if status == "OK" else logger.error)(record)

        def begin(payload: Any, grpc_ctx):
            metadata = {k: v for k, v in
                        (grpc_ctx.invocation_metadata() or ())}
            ctx = RPCContext(payload, metadata, full_method, host, grpc_ctx)
            span = host.tracer.start_span(
                full_method, traceparent=metadata.get("traceparent"))
            return ctx, span

        def recover(exc: Exception, start: float, grpc_ctx, span) -> None:
            code = getattr(exc, "grpc_status", grpc.StatusCode.INTERNAL)
            logger.error(f"grpc panic in {full_method}: {exc!r}",
                         stack=traceback.format_exc())
            span.set_status(f"ERROR: {code.name}")
            observe(start, code.name)
            grpc_ctx.abort(code, str(exc) or "internal error")

        def finished(start: float, grpc_ctx) -> None:
            observe(start, "OK" if grpc_ctx.is_active() else "CANCELLED")

        def call_unary(request, grpc_ctx):
            start = time.perf_counter()
            if spec.kind == CLIENT_STREAM:
                request = _AsyncRequests(request)
            ctx, span = begin(request, grpc_ctx)
            try:
                result = _run_coroutine(spec.fn(service, ctx, request))
                finished(start, grpc_ctx)
                return result
            except Exception as exc:  # noqa: BLE001 — recovery
                recover(exc, start, grpc_ctx, span)
            finally:
                span.end()

        def call_stream(request, grpc_ctx):
            start = time.perf_counter()
            if spec.kind != SERVER_STREAM:
                request = _AsyncRequests(request)
            ctx, span = begin(request, grpc_ctx)
            try:
                yield from _iterate(spec.fn(service, ctx, request))
                finished(start, grpc_ctx)
            except Exception as exc:  # noqa: BLE001 — recovery
                recover(exc, start, grpc_ctx, span)
            finally:
                span.end()

        return call_unary if spec.kind in (UNARY, CLIENT_STREAM) \
            else call_stream

    def _handler_for(self, service: GRPCService, spec: RPCSpec):
        behavior = self._observed(service, spec)
        kw = {"request_deserializer": spec.request_deserializer,
              "response_serializer": spec.response_serializer}
        if spec.kind == UNARY:
            return grpc.unary_unary_rpc_method_handler(behavior, **kw)
        if spec.kind == SERVER_STREAM:
            return grpc.unary_stream_rpc_method_handler(behavior, **kw)
        if spec.kind == CLIENT_STREAM:
            return grpc.stream_unary_rpc_method_handler(behavior, **kw)
        return grpc.stream_stream_rpc_method_handler(behavior, **kw)

    # ------------------------------------------------------------- health
    def _health_handlers(self):
        state = self.health
        host = self.host_server

        def check(service_name: str, grpc_ctx) -> int:
            if service_name == "":
                try:
                    return SERVING if host.health()["status"] != "DOWN" \
                        else NOT_SERVING
                except Exception:  # noqa: BLE001 — no health: not serving
                    return NOT_SERVING
            return state.check(service_name)

        def watch(service_name: str, grpc_ctx) -> Iterator[int]:
            yield check(service_name, grpc_ctx)
            # polled, not pushed: the status again every interval
            while grpc_ctx.is_active():
                time.sleep(WATCH_INTERVAL_S)
                yield check(service_name, grpc_ctx)

        kw = {"request_deserializer": decode_check_request,
              "response_serializer": encode_check_response}
        return grpc.method_handlers_generic_handler(
            "grpc.health.v1.Health",
            {"Check": grpc.unary_unary_rpc_method_handler(check, **kw),
             "Watch": grpc.unary_stream_rpc_method_handler(watch, **kw)})

    # ---------------------------------------------------------- lifecycle
    @property
    def started(self) -> bool:
        return self._server is not None

    def start(self) -> None:
        """Bind and serve every registered service, health, and (when
        ``GRPC_ENABLE_REFLECTION`` is ``"true"``) reflection. A failed
        bind raises ``RuntimeError`` naming ``GRPC_PORT``."""
        server = grpc.server(ThreadPoolExecutor(
            max_workers=self.max_workers, thread_name_prefix="grpc"))
        for service in self._services:
            handlers = {spec.name: self._handler_for(service, spec)
                        for spec in service.rpc_specs()}
            server.add_generic_rpc_handlers(
                (grpc.method_handlers_generic_handler(service.name,
                                                      handlers),))
        server.add_generic_rpc_handlers((self._health_handlers(),))
        env = getattr(self.host_server, "env", None)
        env = os.environ if env is None else env
        if env.get("GRPC_ENABLE_REFLECTION", "false").lower() == "true":
            names = [s.name for s in self._services] + [
                "grpc.health.v1.Health",
                "grpc.reflection.v1alpha.ServerReflection",
                "grpc.reflection.v1.ServerReflection"]
            server.add_generic_rpc_handlers(
                tuple(reflection_handler(lambda: sorted(names),
                                         registry=self._descriptors)))
        try:
            bound = server.add_insecure_port(f"{self.host}:{self.port}")
        except RuntimeError:
            bound = 0
        if bound == 0:
            message = (f"port {self.port} is already in use (or cannot "
                       f"bind); set GRPC_PORT to a free port")
            self.logger.error(message)
            raise RuntimeError(message)
        self.bound_port = bound
        server.start()
        self._server = server
        self.logger.info(
            f"gRPC server listening on {self.host}:{self.bound_port}")

    def shutdown(self, grace: float = 5.0) -> None:
        if self._server is not None:
            self._server.stop(grace).wait()
            self._server = None

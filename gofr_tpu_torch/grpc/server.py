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

The server reads what it needs from the host it serves beside (a
``ChatServer`` or an ``App``): ``tracer``, ``metrics`` (a new manager
when it has none), ``logger``, ``health()``, ``env`` and ``tenant_of``.
Services and handlers see the host's container as ``container``, as in
JAX, where the host has one (an ``App``), else the host.

The server is ``grpc.aio``, as JAX's is, on an event loop of its own
thread (so ``start`` and ``shutdown`` are plain calls from any thread):
an RPC holds no thread while it waits. Coroutines and async generators
(the JAX package's style, :mod:`.protogen`'s skeletons, the chat
service) run on that loop; a plain handler function runs on
:attr:`GRPCServer.executor`, a pool with no cap (``handler.handler_pool``),
and a plain generator is pumped there by ``handler.ThreadPump``, which
stops and closes it once the RPC ends. Health ``Check`` reads the host's
health on that pool too, so it never waits behind a generation.
"""

from __future__ import annotations

import asyncio
import contextvars
import dataclasses
import inspect
import os
import threading
import time
import traceback
from typing import Any, AsyncIterator, Mapping

import grpc

from ..handler import ThreadPump, handler_pool
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
    container (``container``: ``GRPCServer.injected``) and its slots
    (``ctx.logger``, ``ctx.sql``, ``ctx.model(name)``, ... as on JAX's
    context), its tenant, grpc's own servicer context
    (``grpc_context``, a ``grpc.aio.ServicerContext``: ``cancelled``,
    ``done``, ``add_done_callback``) and the server's pool
    (``executor``) for blocking work."""

    def __init__(self, payload: Any, metadata: Mapping[str, str],
                 method: str, container: Any, grpc_context: Any,
                 executor: Any = None, tenant_of: Any = None) -> None:
        self.payload = payload
        self.metadata = dict(metadata)
        self.method = method
        self.container = container
        self.grpc_context = grpc_context
        self.executor = executor
        self._tenant_of = tenant_of

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

    def __getattr__(self, name: str) -> Any:
        # the container's slots (logger, metrics, sql, redis, kv, file,
        # pubsub, ...) read straight off it, as JAX's handler context
        # (the framework ``Context``) reads them
        if name.startswith("_"):
            raise AttributeError(name)
        container = self.__dict__.get("container")
        if container is not None and hasattr(container, name):
            return getattr(container, name)
        raise AttributeError(name)

    def model(self, name: str) -> Any:
        return self.container.get_model(name)

    @property
    def tenant(self) -> str | None:
        """The host's ``tenant_of`` applied to the metadata (None without
        one)."""
        tenant_of = self._tenant_of
        return tenant_of(self.metadata) if tenant_of is not None else None


class _Requests:
    """grpc.aio's request stream for a client-stream or bidi handler:
    ``async for`` on the loop, or plain ``for`` from a plain handler on
    a pool thread (each item fetched through the loop)."""

    def __init__(self, requests: Any, loop: asyncio.AbstractEventLoop) -> None:
        self._requests = requests
        self._loop = loop

    def __aiter__(self):
        return self._requests.__aiter__()

    def __iter__(self):
        items = self._requests.__aiter__()
        while True:
            try:
                yield asyncio.run_coroutine_threadsafe(
                    items.__anext__(), self._loop).result()
            except StopAsyncIteration:
                return


async def _off_loop(executor: Any, fn: Any, *args: Any) -> Any:
    """``fn(*args)`` on ``executor``, with this task's context (the RPC's
    span)."""
    ctx = contextvars.copy_context()
    return await asyncio.get_running_loop().run_in_executor(
        executor, ctx.run, fn, *args)


class GRPCServer:
    """``register`` services, then ``start`` (binds ``host:port``; 0 = a
    free port, read back as ``bound_port``) and ``shutdown``."""

    def __init__(self, host_server: Any, *, port: int = DEFAULT_GRPC_PORT,
                 host: str = "0.0.0.0", logger: Any = None) -> None:
        self.host_server = host_server
        #: what a service's ``container`` and an RPC's ``ctx.container``
        #: are: the host's container where it has one (an ``App``'s, as
        #: JAX injects its app's), else the host itself (a ``ChatServer``)
        self.injected = getattr(host_server, "container", None) \
            or host_server
        self.host = host
        self.port = port
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
        #: plain handlers, plain streams and health reads run here
        self.executor = None
        self._services: list[GRPCService] = []
        self._descriptors = DescriptorRegistry()
        self._server: grpc.aio.Server | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------- registration
    def register(self, service: GRPCService) -> None:
        """Inject :attr:`injected` as ``service.container`` and queue
        the service; it serves from the next ``start``."""
        if not service.name:
            raise ValueError(
                f"{type(service).__name__}.name must be the fully-qualified "
                "gRPC service name")
        service.container = self.injected
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
        fn = spec.fn

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
            if spec.kind not in (UNARY, SERVER_STREAM):
                payload = _Requests(payload, asyncio.get_running_loop())
            ctx = RPCContext(payload, metadata, full_method, self.injected,
                             grpc_ctx, self.executor,
                             getattr(host, "tenant_of", None))
            span = host.tracer.start_span(
                full_method, traceparent=metadata.get("traceparent"))
            return ctx, span

        async def recover(exc: Exception, start: float, grpc_ctx,
                          span) -> None:
            code = getattr(exc, "grpc_status", grpc.StatusCode.INTERNAL)
            logger.error(f"grpc panic in {full_method}: {exc!r}",
                         stack=traceback.format_exc())
            span.set_status(f"ERROR: {code.name}")
            observe(start, code.name)
            await grpc_ctx.abort(code, str(exc) or "internal error")

        async def call_unary(request, grpc_ctx):
            start = time.perf_counter()
            ctx, span = begin(request, grpc_ctx)
            try:
                if inspect.iscoroutinefunction(fn):
                    result = await fn(service, ctx, ctx.payload)
                else:
                    result = await _off_loop(self.executor, fn, service, ctx,
                                             ctx.payload)
                    if inspect.isawaitable(result):
                        result = await result
                observe(start, "OK")
                return result
            except asyncio.CancelledError:
                observe(start, "CANCELLED")
                raise
            except Exception as exc:  # noqa: BLE001 — recovery
                await recover(exc, start, grpc_ctx, span)
            finally:
                span.end()

        async def items(ctx) -> AsyncIterator[Any]:
            """The handler's stream: an async generator on the loop, a
            plain one pumped on the pool until the RPC ends."""
            if inspect.isasyncgenfunction(fn) or inspect.isgeneratorfunction(fn):
                result = fn(service, ctx, ctx.payload)
            else:
                result = await _off_loop(self.executor, fn, service, ctx,
                                         ctx.payload)
            if hasattr(result, "__anext__"):
                async for item in result:
                    yield item
                return
            gone = threading.Event()
            pump = ThreadPump(result, gone.is_set, gone.set, self.executor,
                              asyncio.get_running_loop())
            try:
                async for item in pump:
                    yield item
            finally:
                await pump.aclose()

        async def call_stream(request, grpc_ctx):
            start = time.perf_counter()
            ctx, span = begin(request, grpc_ctx)
            try:
                async for item in items(ctx):
                    yield item
                observe(start, "OK")
            except asyncio.CancelledError:
                observe(start, "CANCELLED")
                raise
            except Exception as exc:  # noqa: BLE001 — recovery
                await recover(exc, start, grpc_ctx, span)
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

        def overall() -> int:
            try:
                return SERVING if host.health()["status"] != "DOWN" \
                    else NOT_SERVING
            except Exception:  # noqa: BLE001 — no health: not serving
                return NOT_SERVING

        async def check(service_name: str, grpc_ctx) -> int:
            if service_name == "":
                # the host's health may read the card: off the loop
                return await _off_loop(self.executor, overall)
            return state.check(service_name)

        async def watch(service_name: str, grpc_ctx) -> AsyncIterator[int]:
            yield await check(service_name, grpc_ctx)
            # polled, not pushed: the status again every interval
            while not grpc_ctx.done():
                await asyncio.sleep(WATCH_INTERVAL_S)
                yield await check(service_name, grpc_ctx)

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

    def _call(self, coro, timeout: float | None = None) -> Any:
        assert self._loop is not None
        return asyncio.run_coroutine_threadsafe(coro, self._loop) \
            .result(timeout)

    def start(self) -> None:
        """Bind and serve every registered service, health, and (when
        ``GRPC_ENABLE_REFLECTION`` is ``"true"``) reflection, on a loop
        thread of the server's own. A failed bind raises
        ``RuntimeError`` naming ``GRPC_PORT``."""
        self.executor = handler_pool()
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._loop.run_forever,
                                        name="grpc-loop", daemon=True)
        self._thread.start()
        try:
            self._server = self._call(self._serve())
        except BaseException:
            self._end_loop()
            raise
        self.logger.info(
            f"gRPC server listening on {self.host}:{self.bound_port}")

    async def _serve(self) -> grpc.aio.Server:
        server = grpc.aio.server()
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
        await server.start()
        return server

    def _end_loop(self) -> None:
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
            if self._thread is not None:
                self._thread.join(10)
            if not self._loop.is_running():
                self._loop.close()
            self._loop = self._thread = None
        if self.executor is not None:
            # pumps still in flight end on their own
            self.executor.shutdown(wait=False)
            self.executor = None

    def shutdown(self, grace: float = 5.0) -> None:
        """Stop: RPCs in flight get ``grace`` seconds, then are
        cancelled (a cancelled chat RPC cancels its engine request)."""
        if self._server is not None:
            try:
                self._call(self._server.stop(grace), grace + 10)
            finally:
                self._server = None
                self._end_loop()

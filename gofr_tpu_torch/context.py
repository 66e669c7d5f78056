"""The single handler-facing object: request + container + trace logger
(the port's copy of ``gofr_tpu/context.py``).

Mirrors reference pkg/gofr/context.go:18-38: a ``Context`` embeds the
transport-independent request, the DI container, a trace-correlated
logger, ``trace()`` for user spans (context.go:62), and ``bind``
(context.go:74). The serving additions: ``ctx.model(name)`` returns a
serving engine and ``ctx.tpu`` the device registry (the JAX name, so a
handler written for the JAX app runs unchanged; the port's registry
lists CUDA devices).

Three accessors the port's serving handlers read (``serving/handlers.py``,
``serving/openai_compat.py``), which give the same answers under
``ChatServer``'s context: ``tenant`` (the container's tenant resolver on
the auth principal, as JAX's chat handler computes it),
``client_gone()`` (the client left, or the app's request timeout gave up
on the request) and ``request_timeout_s`` (None: the app bounds a
handler with ``REQUEST_TIMEOUT`` itself, answering 408, and marks the
request gone so its engine request is cancelled). ``headers`` and
``body`` are the request's.

The datasources (``sql``, ``redis``, ``kv``, ``file``; the breadth
stores through the ``__getattr__`` passthrough to the container) and
the websocket surface (``write_message_to_socket``, a coroutine, and
``ws_manager``) are JAX's. ``responder`` and ``terminal`` are JAX's too:
under ``CMDApp`` (``cli/cmd.py``) they are the subcommand's
``CMDResponder`` and the CLI's ``Out``; under ``App`` both are None.
"""

from __future__ import annotations

from typing import Any

from .container.container import Container
from .logging.logger import ContextLogger


class Context:
    def __init__(self, request: Any, container: Container,
                 responder: Any = None, terminal: Any = None) -> None:
        self.request = request
        self.container = container
        self.responder = responder
        self.terminal = terminal
        self.logger = ContextLogger(container.logger)
        self._auth_info: dict[str, Any] = {}
        self._ws_conn: Any = None  # set by the websocket message loop

    # -- request surface (reference context delegates to Request)
    def bind(self, target: Any = None) -> Any:
        return self.request.bind(target)

    def param(self, key: str) -> str:
        return self.request.param(key)

    def params(self, key: str) -> list[str]:
        return self.request.params(key)

    def path_param(self, key: str) -> str:
        return self.request.path_param(key)

    def header(self, key: str) -> str:
        getter = getattr(self.request, "header", None)
        return getter(key) if getter else ""

    def host_name(self) -> str:
        return self.request.host_name()

    @property
    def headers(self) -> dict[str, str]:
        """The request's headers, names lower-cased."""
        return getattr(self.request, "headers", None) or {}

    @property
    def body(self) -> bytes:
        return getattr(self.request, "body", b"") or b""

    # -- serving surface
    @property
    def tenant(self) -> str:
        """The accounting label of the request's auth principal."""
        return self.container.tenant_resolver.resolve(self._auth_info)

    @property
    def request_timeout_s(self) -> None:
        return None

    def client_gone(self) -> bool:
        gone = getattr(self.request, "client_gone", None)
        return bool(gone()) if gone is not None else False

    def mark_gone(self) -> None:
        """Make ``client_gone()`` true (the request timed out)."""
        mark = getattr(self.request, "mark_gone", None)
        if mark is not None:
            mark()

    # -- container surface
    @property
    def config(self):
        return self.container.config

    @property
    def metrics(self):
        return self.container.metrics

    @property
    def sql(self):
        return self.container.sql

    @property
    def redis(self):
        return self.container.redis

    @property
    def kv(self):
        return self.container.kv

    @property
    def file(self):
        return self.container.file

    @property
    def pubsub(self):
        return self.container.pubsub

    @property
    def tpu(self):
        return self.container.tpu

    def __getattr__(self, name: str):
        # breadth datasource slots (mongo, cassandra, dgraph, influxdb,
        # ...) resolve straight off the container, as the reference
        # Context embeds *Container (context.go:18-38)
        if name.startswith("_"):
            raise AttributeError(name)
        container = self.__dict__.get("container")
        if container is not None and hasattr(container, name):
            return getattr(container, name)
        raise AttributeError(name)

    def model(self, name: str) -> Any:
        return self.container.get_model(name)

    def get_http_service(self, name: str) -> Any:
        return self.container.get_http_service(name)

    # -- tracing (reference context.go:62)
    def trace(self, name: str):
        return self.container.tracer.start_span(name)

    def get_correlation_id(self) -> str:
        span = self.container.tracer.current_span()
        return span.trace_id if span else ""

    # -- auth info set by auth middleware (reference context.go:121)
    @property
    def auth_info(self) -> dict[str, Any]:
        return self._auth_info

    def set_auth_info(self, info: dict[str, Any]) -> None:
        self._auth_info = dict(info)

    # -- websocket (reference context.go:81 WriteMessageToSocket)
    async def write_message_to_socket(self, data: Any) -> None:
        if self._ws_conn is None:
            raise RuntimeError("not a websocket context")
        await self._ws_conn.send(data)

    @property
    def ws_manager(self):
        return self.container.ws_manager

    # -- publish convenience
    async def publish(self, topic: str, message: bytes | str | dict) -> None:
        if self.container.pubsub is None:
            raise RuntimeError("no pub/sub client configured")
        await self.container.pubsub.publish(topic, message)

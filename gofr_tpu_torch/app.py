"""The App facade: routing verbs, lifecycle, servers, hooks (the port's
copy of ``gofr_tpu/app.py``).

Mirrors reference pkg/gofr/gofr.go + factory.go + run.go: ``App()``
wires config -> container -> tracer -> HTTP/metrics servers and the
default routes (health/alive/favicon/OpenAPI, factory.go:48-52); route
verbs and their decorator form (rest.go:9-31); ``run()`` installs
signal-driven graceful shutdown and starts every server concurrently
(run.go:15-95, shutdown.go:14-48); ``on_start`` / ``on_shutdown`` hooks
(gofr.go:54-88); ``subscribe`` (gofr.go:249); ``add_cron_job``
(gofr.go:287); ``websocket`` / ``add_ws_service`` (websocket.go:30-98),
``add_rest_handlers`` (rest.go:53) and ``migrate`` (migration.go:29).
``serve_model`` serves an engine of the port; it is wired by
``serving.app.wire_engine``, the same function
``serving.app.build_server`` uses.

How the port runs it:

- plain handlers (every serving handler of the port, the CRUD handlers,
  plain websocket handlers) and plain
  ``Stream`` iterators run on :attr:`App.executor`, a pool of the app's
  own with no cap (``handler.handler_pool``): a generation holds its
  thread to the end, and every other request still gets one and reaches
  the engine's admission. Plain ``on_shutdown`` hooks run there too;
  plain ``on_start`` hooks run on the loop before the servers listen, as
  JAX's do, so a hook may schedule the app's tasks
  (``asyncio.ensure_future``), and the framework's own start hooks
  (the engine's, the agent's) hand their work to the pool. The probes stand
  apart from it: ``/.well-known/alive`` answers on the loop, and health
  and the metrics scrape's device refresh run on a small pool of their
  own (:attr:`App.probe_pool`). The event loop's thread never touches
  ``torch``: only the engines' threads and these do;
- ``REQUEST_TIMEOUT`` (seconds; 0, the default, is no limit) answers
  408 as JAX's app does, and marks the request gone, which cancels its
  engine request;
- ``/.well-known/health`` answers the container's health (the device
  registry under ``checks.tpu``: the CUDA devices by name and every
  served engine's health), with status DOWN and 503 when any check is
  DOWN (JAX's app answers 200 with DEGRADED);
- the metrics port's scrape refreshes the device registry's gauges
  (``app_gpu_device_count``, ``app_gpu_hbm_bytes_used``) on a worker
  thread;
- ``run()`` installs the SIGINT/SIGTERM handlers on the main thread;
  elsewhere (tests, ``chip_smoke.py``) run :meth:`serve` or
  :meth:`start` on a loop in a thread and call :meth:`stop` or
  :meth:`_graceful_stop` on that loop.

- the websocket upgrade is the innermost middleware, as in JAX; ``stop``
  closes every socket (``ws_manager.close_all()``) before the servers
  shut down, which cancels the engine request of a handler still
  streaming to one.

- ``start`` runs the remote log-level poller when ``REMOTE_LOG_URL`` is
  set (``logging/remote.py``) and, unless ``GOFR_TELEMETRY=false``, the
  usage telemetry pings of start and stop (``telemetry.py``), as JAX's
  app does.

``new_cmd`` builds the CLI application (``cli/cmd.CMDApp``): no servers,
the same container, context and handlers, argv in place of HTTP.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import inspect
import json
import signal
import time
from typing import Any, Callable

from .config.env import EnvConfig
from .container.container import Container
from .context import Context
from .handler import build_core_handler, handler_pool
from .http.middleware import (
    cors_middleware,
    logging_middleware,
    metrics_middleware,
    tracer_middleware,
)
from .http.responder import ResponseData
from .http.router import Router
from .http.server import HTTPServer, chain

DEFAULT_HTTP_PORT = 8000
DEFAULT_METRICS_PORT = 2121
DEFAULT_SHUTDOWN_GRACE = 30.0
#: threads of the probes' own pool (health, the metrics refresh)
PROBE_THREADS = 2


class App:
    def __init__(self, config_dir: str = "configs", config=None) -> None:
        self.config = config if config is not None else EnvConfig(config_dir)
        self.container = Container.create(self.config)
        self.logger = self.container.logger
        self.router = Router()
        self._on_start: list[Callable] = []
        self._on_shutdown: list[Callable] = []
        #: zero-arg callables run after the shutdown hooks (a fleet
        #: leader's sweeper stop: ``ControlPlaneLeader.install``)
        self.on_close: list[Callable[[], Any]] = []
        self._subscriptions: dict[str, Callable] = {}
        self._cron = None  # created on first add_cron_job
        self._middlewares: list[Callable] = []
        self._user_middlewares: list[Callable] = []
        self._ws_router: Router | None = None
        self._stop_event: asyncio.Event | None = None
        self._servers: list[HTTPServer] = []
        self._tasks: list[asyncio.Task] = []
        self._shutdown_task: asyncio.Task | None = None
        self.http_server: HTTPServer | None = None
        self.metrics_server: HTTPServer | None = None
        self.grpc_server = None  # created on first register_grpc_service
        #: the pool plain handlers and streams run on (made at start)
        self.executor: concurrent.futures.ThreadPoolExecutor | None = None
        #: health and the metrics refresh's pool (made at start)
        self.probe_pool: concurrent.futures.ThreadPoolExecutor | None = None
        #: the ``ProfilerCapture`` behind ``/debug/profile/*``, when on
        self.profiler = None
        #: the ``ControlPlaneLeader`` of ``serve_fleet_leader``, if any
        self.leader = None
        self._debug_routes_installed = False
        # serving lifecycle registry for the graceful SIGTERM drain:
        # engines drain (admission closed, in-flight work finishes)
        # and fleet agents deregister from their leader BEFORE the
        # shutdown hooks hard-stop everything (_graceful_stop)
        self._engines: list[Any] = []
        self._agents: list[Any] = []

        self.http_port = self.config.get_int("HTTP_PORT", DEFAULT_HTTP_PORT) \
            if hasattr(self.config, "get_int") else DEFAULT_HTTP_PORT
        self.metrics_port = self.config.get_int("METRICS_PORT", DEFAULT_METRICS_PORT) \
            if hasattr(self.config, "get_int") else DEFAULT_METRICS_PORT
        timeout = self.config.get_float("REQUEST_TIMEOUT", 0.0) \
            if hasattr(self.config, "get_float") else 0.0
        self.request_timeout = timeout if timeout > 0 else None
        self.shutdown_grace = self.config.get_float(
            "SHUTDOWN_GRACE_PERIOD", DEFAULT_SHUTDOWN_GRACE) \
            if hasattr(self.config, "get_float") else DEFAULT_SHUTDOWN_GRACE

        self._register_default_routes()

    # -------------------------------------------- what serving planes read
    @property
    def metrics(self):
        return self.container.metrics

    @property
    def tracer(self):
        return self.container.tracer

    @property
    def health_checks(self) -> dict[str, Any]:
        """name -> object with ``health_check()``, under ``checks``."""
        return self.container.extra_health

    @property
    def port(self) -> int:
        """The HTTP server's bound port (0 before :meth:`start`)."""
        return self.http_server.bound_port if self.http_server else 0

    def tenant_of(self, metadata: Any) -> str:
        """The accounting label of an unauthenticated call (gRPC)."""
        return self.container.tenant_resolver.resolve(None)

    def health(self) -> dict:
        """The container's health, DOWN when any check is DOWN."""
        health = self.container.health()
        if any(c.get("status") == "DOWN"
               for c in health["checks"].values()):
            health["status"] = "DOWN"
        return health

    # ------------------------------------------------------------- routes
    def _register_default_routes(self) -> None:
        self.router.add("GET", "/.well-known/health", self._health_handler)
        self.router.add("GET", "/.well-known/alive", self._alive_handler)
        # OpenAPI spec + Swagger UI (reference swagger.go:59-70)
        from .openapi import register as register_openapi
        register_openapi(self)

    @staticmethod
    async def _alive_handler(ctx: Context) -> Any:
        return {"status": "UP"}

    async def _health_handler(self, ctx: Context) -> Any:
        # the checks read the card: off the loop's thread, on the probes'
        # own pool, so a probe never waits behind the handlers
        health = await asyncio.get_running_loop().run_in_executor(
            self.probe_pool, self.health)
        if health["status"] == "DOWN":
            return ResponseData(status=503, body=json.dumps(
                {"data": health}, default=str).encode())
        return health

    def _add_route(self, method: str, pattern: str,
                   handler: Callable | None = None):
        if handler is None:  # decorator form
            def decorator(fn: Callable) -> Callable:
                self.router.add(method, pattern, fn)
                return fn
            return decorator
        self.router.add(method, pattern, handler)
        return handler

    def get(self, pattern: str, handler: Callable | None = None):
        return self._add_route("GET", pattern, handler)

    def post(self, pattern: str, handler: Callable | None = None):
        return self._add_route("POST", pattern, handler)

    def put(self, pattern: str, handler: Callable | None = None):
        return self._add_route("PUT", pattern, handler)

    def patch(self, pattern: str, handler: Callable | None = None):
        return self._add_route("PATCH", pattern, handler)

    def delete(self, pattern: str, handler: Callable | None = None):
        return self._add_route("DELETE", pattern, handler)

    def add_static_files(self, url_prefix: str, directory: str) -> None:
        self.router.add_static(url_prefix, directory)

    def add_rest_handlers(self, entity_cls: type, **kwargs):
        """Auto-CRUD for a dataclass entity (reference rest.go:53)."""
        from .crud import add_rest_handlers
        return add_rest_handlers(self, entity_cls, **kwargs)

    def use_middleware(self, middleware: Callable) -> None:
        """Append a user middleware (runs innermost, after the chain)."""
        self._user_middlewares.append(middleware)

    # -------------------------------------------------------- websockets
    def websocket(self, pattern: str, handler: Callable | None = None):
        """Register a websocket endpoint: the handler runs once per
        inbound message, ``ctx.bind()`` reads the frame (reference
        websocket.go:30-49); a plain handler runs on :attr:`executor`, a
        coroutine on the loop. A plain ``GET`` of the path answers 426."""
        if handler is None:
            def decorator(fn: Callable) -> Callable:
                self.websocket(pattern, fn)
                return fn
            return decorator

        if self._ws_router is None:
            from .websocket.manager import WSManager
            self._ws_router = Router()
            if self.container.ws_manager is None:
                self.container.ws_manager = WSManager()
        self._ws_router.add("WS", pattern, handler)

        async def reject_plain_http(ctx) -> Any:
            from .http.errors import HTTPError
            raise HTTPError("websocket endpoint: upgrade required",
                            status_code=426)
        self.router.add("GET", pattern, reject_plain_http)
        return handler

    def add_ws_service(self, name: str, url: str, *,
                       headers: dict[str, str] | None = None,
                       retry_interval: float = 5.0,
                       on_message: Callable | None = None):
        """Maintain a named outbound websocket connection with
        reconnection (reference websocket.go:52-98)."""
        from .websocket.service import WSService
        service = WSService(name, url, headers=headers,
                            retry_interval=retry_interval,
                            logger=self.logger, on_message=on_message)
        self.container.register_ws_service(name, service)
        self.on_start(service.start)
        self.on_shutdown(service.stop)
        return service

    # ------------------------------------------------------------- auth
    def _install_auth(self, provider, scheme: str) -> None:
        from .http.auth import auth_middleware
        self._middlewares.append(auth_middleware(provider, scheme=scheme))

    def enable_basic_auth(self, **users: str) -> None:
        """Install basic-auth middleware (reference auth.go:16)."""
        from .http.auth import BasicAuthProvider
        self._install_auth(BasicAuthProvider(users), "Basic")

    def enable_basic_auth_with_validator(self, validator: Callable) -> None:
        from .http.auth import BasicAuthProvider
        self._install_auth(BasicAuthProvider(validator=validator), "Basic")

    def enable_api_key_auth(self, *keys: str,
                            key_names: dict[str, str] | None = None) -> None:
        """Install API-key auth. ``key_names`` maps key -> tenant label
        (the accounting identity usage metering reports under); keys
        only ever surface downstream as short fingerprints."""
        from .http.auth import APIKeyAuthProvider
        self._install_auth(APIKeyAuthProvider(list(keys),
                                              key_names=key_names),
                           "ApiKey")

    def enable_api_key_auth_with_validator(self, validator: Callable) -> None:
        from .http.auth import APIKeyAuthProvider
        self._install_auth(APIKeyAuthProvider(validator=validator), "ApiKey")

    def enable_oauth(self, jwks_url: str | None = None, *,
                     refresh_interval: float = 300.0, **kwargs) -> None:
        """Install Bearer-JWT auth against a JWKS endpoint
        (reference auth.go:92)."""
        from .http.auth import OAuthProvider
        kwargs.setdefault("logger", self.logger)
        provider = OAuthProvider(jwks_url,
                                 refresh_interval=refresh_interval, **kwargs)
        self._install_auth(provider, "Bearer")

    # --------------------------------------------------------------- gRPC
    def register_grpc_service(self, service) -> None:
        """Queue a ``gofr_tpu_torch.grpc.GRPCService``; the gRPC server
        (``GRPC_PORT``, default 9000; 0 = a free port; ``grpc.aio`` on a
        loop thread of its own) boots with the app (reference grpc.go:200
        RegisterService). A protogen module's ``FILE_DESCRIPTOR_SET``,
        found on the service's class or a base's module, feeds
        reflection."""
        import sys as _sys
        if self.grpc_server is None:
            from .grpc.server import DEFAULT_GRPC_PORT, GRPCServer
            port = self.config.get_int("GRPC_PORT", DEFAULT_GRPC_PORT) \
                if hasattr(self.config, "get_int") else DEFAULT_GRPC_PORT
            self.grpc_server = GRPCServer(self, port=port, logger=self.logger)
        self.grpc_server.register(service)
        for klass in type(service).__mro__:
            module = _sys.modules.get(klass.__module__)
            fds = getattr(module, "FILE_DESCRIPTOR_SET", None)
            if fds:
                self.grpc_server.register_descriptors(fds)
                break

    # ------------------------------------------------------------ hooks
    def on_start(self, hook: Callable) -> Callable:
        self._on_start.append(hook)
        return hook

    def _on_start_off_loop(self, fn: Callable[[], Any]) -> None:
        """An ``on_start`` hook of the framework's own that runs ``fn``
        on a worker thread (the loop's thread never touches the card)."""
        async def hook() -> None:
            await asyncio.get_running_loop().run_in_executor(
                self.executor, fn)
        self.on_start(hook)

    def on_shutdown(self, hook: Callable) -> Callable:
        self._on_shutdown.append(hook)
        return hook

    def subscribe(self, topic: str, handler: Callable | None = None):
        if handler is None:
            def decorator(fn: Callable) -> Callable:
                self._subscriptions[topic] = fn
                return fn
            return decorator
        self._subscriptions[topic] = handler
        return handler

    def add_cron_job(self, schedule: str, name: str, job: Callable) -> None:
        from .cron import Cron
        if self._cron is None:
            self._cron = Cron(self.container)
        self._cron.add(schedule, name, job)

    def migrate(self, migrations: dict) -> list[int]:
        """Apply the pending versions of ``{version: Migrate(up=fn)}``
        over every configured store (reference migration.go:29); returns
        the versions applied."""
        from .migrations.runner import run as run_migrations
        return run_migrations(self.container, migrations)

    def serve_model(self, name: str, engine, tokenizer=None, *,
                    chat_path: str | None = "/chat",
                    slo=None, scheduler=None) -> None:
        """Wire a serving engine into the app: metrics, logger, tracer,
        SLO tracker (``slo``, an ``SLOConfig``; default objectives) on the
        engine's event ledger, the scheduler policy (``scheduler``, a
        ``SchedulerConfig``), the device registry (``container.tpu``,
        made with the first model), health, the ``/debug/*`` routes
        (with the first model; ``PROFILER_ENABLED`` adds the profile
        routes, capturing into ``PROFILER_DIR``), lifecycle (started
        with the app, drained by SIGTERM, closed at shutdown) and, unless
        ``chat_path`` is None, ``POST <chat_path>``
        (``serving.handlers.make_chat_handler``). A tensor-parallel
        engine (``llama_engine(mesh=)``) is served by its mesh's leader
        rank, whose registry lists that rank's device; a follower rank
        serves no HTTP (it runs ``serving.lockstep.follow``) and is
        refused here."""
        from .device import DeviceRegistry
        from .serving.app import wire_engine
        mesh = getattr(engine, "mesh", None)
        if mesh is not None and mesh.rank != mesh.leader:
            raise ValueError(
                f"rank {mesh.rank} follows the mesh's leader (rank "
                f"{mesh.leader}): it serves no HTTP; run "
                f"serving.lockstep.follow(engine) there")
        if self.container.tpu is None:
            self.container.tpu = DeviceRegistry(
                logger=self.logger, metrics=self.container.metrics,
                device=engine.device,
                rank=mesh.rank if mesh is not None else None)
        wire_engine(engine, name, metrics=self.container.metrics,
                    logger=self.logger, tracer=self.container.tracer,
                    devices=self.container.tpu, slo=slo,
                    scheduler=scheduler)
        self.container.add_model(name, engine)
        self._install_debug_routes(name, engine)
        if chat_path:
            from .serving.handlers import make_chat_handler
            from .serving.tokenizer import ByteTokenizer
            self.post(chat_path,
                      make_chat_handler(engine, tokenizer or ByteTokenizer()))
        self._on_start_off_loop(engine.start)
        self.on_shutdown(engine.close)
        self._engines.append(engine)

    def _install_debug_routes(self, name: str, engine) -> None:
        """The serving debug surface (``serving/debug.py``), registered
        once, for the first served model. The routes ride the normal
        middleware chain, so auth providers guard them too."""
        if self._debug_routes_installed:
            return
        self._debug_routes_installed = True
        from .serving.debug import install_debug_routes
        install_debug_routes(
            self, engine, name,
            profiler=self.config.get_bool("PROFILER_ENABLED", False)
            if hasattr(self.config, "get_bool") else False,
            profile_dir=self.config.get("PROFILER_DIR") or None)

    # ------------------------------------------------------------- fleet
    def serve_fleet_leader(self, *, coordinator: str = "",
                           host_id: str = "leader", router=None,
                           tokenizer=None, **kw):
        """Install a multi-host control-plane LEADER on this app
        (``serving/control_plane.py``): join/heartbeat/topology routes,
        the federated ``/control/fleet/metrics``, ``/debug/fleet``, its
        health under ``checks``, the sweeper running from now until the
        app stops. ``router=RouterConfig(...)`` (or True) also makes the
        leader the fleet's front door (``serving/router.py``:
        ``leader.router``). Returns the leader."""
        from .serving.control_plane import ControlPlaneLeader
        kw.setdefault("metrics", self.container.metrics)
        leader = ControlPlaneLeader(coordinator=coordinator,
                                    host_id=host_id,
                                    logger=self.logger, **kw)
        leader.install(self)
        leader.router = None
        if router is not None and router is not False:
            from .serving.router import FleetRouter, RouterConfig
            if router is True:
                router = RouterConfig()
            fleet_router = FleetRouter(leader, router,
                                       tokenizer=tokenizer,
                                       logger=self.logger,
                                       tracer=self.container.tracer)
            fleet_router.install(self)
            leader.router = fleet_router
        self.leader = leader
        return leader

    def join_fleet(self, leader_url: str, *, host_id: str,
                   engine=None, address: str = "", **kw):
        """Join this app to a serving-group leader as a WORKER: a
        ``WorkerAgent`` heartbeating the engine's health, its flight
        recorder's digest, this container's metrics snapshot (device
        gauges fresh) and the engine's event digest. ``engine=None``
        picks the first served model. An empty ``address`` advertises
        ``ADVERTISE_HOST`` (default 127.0.0.1) and the bound HTTP port.
        Starts with the app, stops with it."""
        from .serving.control_plane import (WorkerAgent,
                                            engine_fleet_sources)
        if engine is None and self.container.models:
            engine = next(iter(self.container.models.values()))
        addr_source: Any = address
        if not address:
            advertise_host = self.config.get("ADVERTISE_HOST") \
                or "127.0.0.1"

            def addr_source() -> str:
                return f"{advertise_host}:{self.port}" if self.port else ""
        sources: dict = {}
        if engine is not None:
            health, summary, _metrics = engine_fleet_sources(engine)
            sources = {"health_source": health,
                       "summary_source": summary}
            kw.setdefault("events", engine.events)
        kw.setdefault("metrics_source", self._metrics_snapshot)
        kw.setdefault("metrics", self.container.metrics)
        agent = WorkerAgent(leader_url, host_id=host_id,
                            address=addr_source,
                            tracer=self.container.tracer,
                            logger=self.logger, **{**sources, **kw})
        self._on_start_off_loop(agent.start)
        self.on_shutdown(agent.stop)
        self._agents.append(agent)
        return agent

    def _metrics_snapshot(self) -> dict:
        if self.container.tpu is not None:
            self.container.tpu.publish_metrics()
        return self.container.metrics.snapshot()

    # ---------------------------------------------------------- lifecycle
    def _build_http_handler(self):
        core = build_core_handler(self.router, self.container,
                                  self.request_timeout, self.executor)
        middlewares = [
            tracer_middleware(self.container.tracer),
            logging_middleware(
                self.logger,
                tenant_resolver=self.container.tenant_resolver),
            cors_middleware(self.config),
            metrics_middleware(self.container.metrics),
        ]
        middlewares.extend(self._middlewares)
        middlewares.extend(self._user_middlewares)
        if self._ws_router is not None:
            # innermost, after auth + user middleware (reference
            # http_server.go:36-41 ordering)
            from .websocket.runtime import make_ws_middleware
            middlewares.append(make_ws_middleware(
                self._ws_router, self.container, self.logger, self.executor))
        return chain(middlewares, core)

    def _build_metrics_handler(self):
        async def metrics_handler(request) -> ResponseData:
            if request.path == "/metrics":
                self.container.metrics.set_gauge(
                    "app_uptime_seconds",
                    round(time.time() - self.container._start_time, 1))
                registry = self.container.tpu
                if registry is not None:
                    # the probe reads the card: off the loop's thread
                    await asyncio.get_running_loop().run_in_executor(
                        self.probe_pool, registry.publish_metrics)
                exporter = getattr(self.container.tracer, "exporter",
                                   None)
                dropped = getattr(exporter, "dropped", None)
                if dropped is not None:
                    m = self.container.metrics
                    if m.get("app_traces_dropped_spans") is None:
                        m.new_gauge(
                            "app_traces_dropped_spans",
                            "spans evicted by the bounded in-memory "
                            "exporter ring (backpressure drops)")
                    m.set_gauge("app_traces_dropped_spans",
                                float(dropped))
                # a scraper asking for OpenMetrics gets the exemplars
                accept = request.header("accept") \
                    if hasattr(request, "header") else ""
                if "application/openmetrics-text" in (accept or ""):
                    text = self.container.metrics.render_openmetrics()
                    ctype = ("application/openmetrics-text; "
                             "version=1.0.0; charset=utf-8")
                else:
                    text = self.container.metrics.render_prometheus()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                return ResponseData(
                    status=200, body=text.encode(), content_type=ctype)
            if request.path == "/.well-known/alive":
                return ResponseData(status=200, body=b'{"status": "UP"}')
            return ResponseData(status=404, body=b"not found",
                                content_type="text/plain")
        return metrics_handler

    async def _call_hook(self, hook: Callable, *args: Any,
                         on_loop: bool = False) -> None:
        """A hook: a coroutine function on the loop; a plain one on a
        worker thread (it may touch the card while requests are served),
        or with ``on_loop`` on the loop, as JAX calls it: an ``on_start``
        hook runs before the servers listen, so nothing waits behind it,
        and it may schedule the app's tasks (``asyncio.ensure_future``)."""
        if inspect.iscoroutinefunction(hook):
            await hook(*args)
            return
        if on_loop:
            result = hook(*args)
        else:
            result = await asyncio.get_running_loop().run_in_executor(
                self.executor, lambda: hook(*args))
        if hasattr(result, "__await__"):
            await result

    async def _run_start_hooks(self) -> bool:
        """Sequential, abort on error (reference gofr.go:54-88)."""
        for hook in self._on_start:
            try:
                try:
                    takes_container = len(inspect.signature(hook).parameters) >= 1
                except (TypeError, ValueError):
                    takes_container = False
                await self._call_hook(
                    hook, *((self.container,) if takes_container else ()),
                    on_loop=True)
            except Exception as exc:
                self.logger.error(f"on_start hook failed: {exc!r}")
                return False
        return True

    async def _start_server(self, server, env_key: str,
                            port: int) -> None:
        """Start a listener with the reference's port-availability
        guard (gofr.go:119-130): an occupied port fails boot with a
        message naming the port AND the env key that moves it."""
        import errno
        try:
            await server.start()
        except OSError as exc:
            if exc.errno == errno.EADDRINUSE:
                message = (f"port {port} is already in use; set "
                           f"{env_key} to a free port")
                self.logger.error(message)
                raise RuntimeError(message) from exc
            raise

    async def start(self) -> None:
        """Boot all servers without blocking (for tests / embedding).
        A failed boot unwinds whatever already started."""
        self._stop_event = asyncio.Event()
        if self.executor is None:
            self.executor = handler_pool()
        if self.probe_pool is None:
            self.probe_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=PROBE_THREADS, thread_name_prefix="app-probe")
        await self.container.connect_async()
        if not await self._run_start_hooks():
            raise RuntimeError("on_start hook failed")
        try:
            await self._start_servers()
        except BaseException:
            try:
                await self.stop()
            except Exception as exc:
                self.logger.warn(f"cleanup after failed boot: {exc!r}")
            raise

    async def _start_servers(self) -> None:
        handler = self._build_http_handler()
        # CERT_FILE + KEY_FILE switch the main listener to TLS
        # (reference pkg/gofr/http_server.go:74-86); the metrics port
        # stays plaintext for scrapers, as in the reference.
        ssl_context = None
        cert_file = self.config.get("CERT_FILE")
        key_file = self.config.get("KEY_FILE")
        if cert_file and key_file:
            from .http.server import make_ssl_context
            try:
                ssl_context = make_ssl_context(cert_file, key_file)
            except (OSError, ValueError) as exc:
                # never degrade to cleartext on a port clients expect
                # to be HTTPS — fail startup, as ListenAndServeTLS does
                self.logger.error(f"TLS config invalid: {exc}")
                raise RuntimeError(
                    f"invalid CERT_FILE/KEY_FILE: {exc}") from exc
        host = self.config.get_or_default("HTTP_HOST", "0.0.0.0")
        self.http_server = HTTPServer(
            handler, host=host, port=self.http_port,
            logger=self.logger, ssl_context=ssl_context)
        await self._start_server(self.http_server, "HTTP_PORT",
                                 self.http_port)
        self._servers.append(self.http_server)

        if self.container.metrics.get("app_uptime_seconds") is None:
            self.container.metrics.new_gauge("app_uptime_seconds",
                                             "seconds since boot")
        self.metrics_server = HTTPServer(
            self._build_metrics_handler(), host=host,
            port=self.metrics_port, logger=self.logger)
        await self._start_server(self.metrics_server, "METRICS_PORT",
                                 self.metrics_port)
        self._servers.append(self.metrics_server)

        if self.grpc_server is not None:
            await asyncio.get_running_loop().run_in_executor(
                self.executor, self.grpc_server.start)

        if self._subscriptions:
            from .pubsub.subscriber import SubscriptionManager
            manager = SubscriptionManager(self.container, self.executor)
            for topic, fn in self._subscriptions.items():
                self._tasks.append(asyncio.ensure_future(
                    manager.start_subscriber(topic, fn)))

        if self._cron is not None:
            self._cron.executor = self.executor
            self._tasks.append(asyncio.ensure_future(self._cron.run()))

        # remote log-level polling (reference container.go:107)
        from .logging.remote import from_config as remote_level_from_config
        updater = remote_level_from_config(self.config, self.logger,
                                           self.container.metrics)
        if updater is not None:
            self._tasks.append(asyncio.ensure_future(updater.run()))

        # usage telemetry, opt-out (reference telemetry.go:13-38)
        from . import telemetry
        if telemetry.enabled(self.config):
            self._tasks.append(asyncio.ensure_future(
                telemetry.ping(self.container, "start")))

        self.logger.info(
            f"{self.container.app_name} up: http={self.http_server.bound_port} "
            f"metrics={self.metrics_server.bound_port}")

    async def stop(self) -> None:
        from . import telemetry
        ping_task: asyncio.Task | None = None
        if telemetry.enabled(self.config):
            # fire-and-forget: the ping gets the duration of the rest of
            # shutdown to complete, never delaying it (telemetry.py)
            ping_task = asyncio.ensure_future(
                telemetry.ping(self.container, "shutdown"))
        for hook in list(self._on_shutdown) + list(self.on_close):
            try:
                await self._call_hook(hook)
            except Exception as exc:
                self.logger.warn(f"shutdown hook: {exc!r}")
        self.on_close.clear()
        for task in self._tasks:
            task.cancel()
        if self.container.ws_manager is not None:
            await self.container.ws_manager.close_all()
        if self.grpc_server is not None and self.grpc_server.started:
            await asyncio.get_running_loop().run_in_executor(
                self.executor, self.grpc_server.shutdown)
        for server in self._servers:
            await server.shutdown()
        self._servers.clear()
        await self.container.close()
        if ping_task is not None and not ping_task.done():
            ping_task.cancel()
        if self.executor is not None:
            # handler threads still in flight end on their own; nothing
            # waits for them here
            self.executor.shutdown(wait=False)
            self.executor = None
        if self.probe_pool is not None:
            self.probe_pool.shutdown(wait=False)
            self.probe_pool = None
        if self._stop_event is not None:
            self._stop_event.set()

    async def serve(self) -> None:
        """start() then block until a stop signal."""
        await self.start()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, self._signal_stop)
            except (NotImplementedError, RuntimeError, ValueError):
                pass  # not the main thread: the caller stops the app
        assert self._stop_event is not None
        await self._stop_event.wait()

    def _signal_stop(self) -> None:
        if getattr(self, "_shutdown_task", None) is not None:
            return  # second signal during grace period: already stopping
        self.logger.info("shutdown signal received")
        # strong reference (so GC can't drop it) kept OUTSIDE self._tasks —
        # stop() cancels everything in _tasks and must not cancel its caller
        self._shutdown_task = asyncio.ensure_future(self._graceful_stop())

    async def _graceful_stop(self) -> None:
        deadline = time.monotonic() + self.shutdown_grace
        try:
            await asyncio.wait_for(self._drain_serving(deadline),
                                   self.shutdown_grace)
        except asyncio.TimeoutError:
            self.logger.error("serving drain timed out; stopping hard")
        except Exception as exc:  # drain is best-effort by contract
            self.logger.warn(f"serving drain failed: {exc!r}")
        try:
            await asyncio.wait_for(
                self.stop(), max(1.0, deadline - time.monotonic()))
        except asyncio.TimeoutError:
            self.logger.error("graceful shutdown timed out; forcing exit")
            if self._stop_event is not None:
                self._stop_event.set()

    async def _drain_serving(self, deadline: float) -> None:
        """SIGTERM drain, in dependency order and inside the grace
        budget: (1) every served engine drains — admission closes (new
        submits get a typed 503 + Retry-After), queued and in-flight
        requests run to completion; (2) fleet agents deregister from
        their leader. Engines drain concurrently on worker threads
        (``Engine.drain`` blocks); half the remaining grace is reserved
        for the hard-stop hooks that follow."""
        drainable = [e for e in self._engines if hasattr(e, "drain")]
        if drainable:
            budget = max(0.5, (deadline - time.monotonic()) * 0.5)
            self.logger.info(
                f"draining {len(drainable)} engine(s), budget "
                f"{budget:.1f}s")
            results = await asyncio.gather(
                *(asyncio.to_thread(e.drain, budget) for e in drainable),
                return_exceptions=True)
            for engine, ok in zip(drainable, results):
                if ok is not True:
                    self.logger.warn(
                        "engine did not drain cleanly",
                        detail=repr(ok) if isinstance(ok, Exception)
                        else "stragglers cut off at the deadline")
        for agent in self._agents:
            if hasattr(agent, "deregister"):
                await asyncio.to_thread(agent.deregister)

    def run(self) -> None:
        """Blocking entry point (reference run.go:15)."""
        try:
            asyncio.run(self.serve())
        except KeyboardInterrupt:
            pass


def new_app(config_dir: str = "configs", config=None) -> App:
    return App(config_dir=config_dir, config=config)


def new_cmd(config_dir: str = "configs", config=None):
    """CLI application factory (reference factory.go:81)."""
    from .cli.cmd import CMDApp
    return CMDApp(config_dir=config_dir, config=config)


__all__ = ["App", "new_app", "new_cmd"]

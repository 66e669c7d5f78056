"""The dependency-injection hub every handler Context carries (the port's
copy of ``gofr_tpu/container/container.py``).

One object holding the logger, config, metrics manager, tracer, tenant
resolver, registered inter-service HTTP clients, the pub/sub client,
the datasources (``sql``, ``redis``, ``kv``, ``file`` and the breadth
slots, each with its ``add_*``), the websocket registry (``ws_manager``,
``ws_services``), the device registry (``tpu``, the JAX name; the port's
registry lists CUDA devices) and the model engines served by this
process. ``Container.create`` wires everything from config the same way
``container.Create`` does (env-driven, reference container.go:92-177):
``DB_DIALECT`` builds ``sql`` (sqlite, or the postgres / mysql / oracle
wire client with ``DB_HOST``), ``REDIS_HOST`` the embedded ``redis`` or,
with ``REDIS_MODE=network``, the RESP2 client, ``TRACE_EXPORTER`` the
console, memory, OTLP (``otlp``, ``jaeger``) or Zipkin exporter, and
``PUBSUB_BACKEND`` the broker client (``KAFKA``, ``GOOGLE``,
``EVENTHUB``, ``NATS``, ``JETSTREAM``, ``MQTT``, ``MEMORY``). A network
store that cannot connect is logged and left ``None``, as in JAX; a
broker client's asynchronous connect waits for ``App.start``
(:meth:`Container.connect_async`). The breadth adders (``add_mongo``,
...) take the caller's store object, as JAX's do.
"""

from __future__ import annotations

import time
from typing import Any

from ..config.env import DictConfig
from ..http.auth import TenantResolver
from ..logging.logger import Logger, level_from_string, new_logger
from ..metrics import Manager as MetricsManager
from ..tracing import ConsoleExporter, InMemoryExporter, Tracer

STATUS_UP = "UP"
STATUS_DOWN = "DOWN"
STATUS_DEGRADED = "DEGRADED"

# 50µs–30s, the reference's datasource latency buckets
# (container/container.go:339-344)
_DATASOURCE_BUCKETS = (0.00005, 0.0001, 0.0005, 0.001, 0.005, 0.01,
                       0.05, 0.1, 0.5, 1, 5, 30)

# stores beyond the core set, each with a generated add_<slot> method
_BREADTH_SLOTS = ("mongo", "elasticsearch", "solr", "couchbase",
                  "cassandra", "scylladb", "clickhouse", "oracle",
                  "dgraph", "arangodb", "surrealdb", "opentsdb",
                  "influxdb", "dbresolver")

# every slot health() aggregates over and close() tears down
_SLOTS = ("sql", "redis", "kv", "file", "pubsub", "tpu") + _BREADTH_SLOTS

class Container:
    def __init__(self, config=None, logger: Logger | None = None) -> None:
        self.config = config if config is not None else DictConfig()
        self.logger = logger if logger is not None else new_logger()
        self.app_name = "gofr-app"
        self.app_version = "dev"
        self.metrics: MetricsManager = MetricsManager(self.logger)
        self.tracer: Tracer = Tracer(service_name=self.app_name)
        # auth principal -> bounded accounting label; shared by the
        # request-log middleware and every serving handler so one
        # request resolves to ONE tenant everywhere
        self.tenant_resolver = TenantResolver()
        self.services: dict[str, Any] = {}   # name -> service client
        self.pubsub: Any = None              # pubsub client
        self.sql: Any = None                 # SQL datasource
        self.redis: Any = None               # redis-shaped store
        self.kv: Any = None                  # key-value store
        self.file: Any = None                # file store
        self.ws_manager: Any = None          # websocket connection manager
        self.ws_services: dict[str, Any] = {}  # name -> outbound WSService
        self.extra_health: dict[str, Any] = {}  # name -> health_check()able
        # breadth datasource slots: _BREADTH_SLOTS is the single
        # definition site (the add_* methods, health() and close())
        for slot in _BREADTH_SLOTS:
            setattr(self, slot, None)
        self.tpu: Any = None                 # the device registry
        self.models: dict[str, Any] = {}     # name -> serving engine
        # stores with async connect (network brokers) wait here until
        # an event loop exists; App.start awaits connect_async()
        self._deferred_connects: list[Any] = []
        self._start_time = time.time()

    # ------------------------------------------------------------ factory
    @classmethod
    def create(cls, config) -> "Container":
        log_level = level_from_string(config.get_or_default("LOG_LEVEL", "INFO"))
        logger = new_logger(level=log_level)
        c = cls(config=config, logger=logger)
        c.app_name = config.get_or_default("APP_NAME", "gofr-app")
        c.app_version = config.get_or_default("APP_VERSION", "dev")

        c.metrics = MetricsManager(logger)
        c.register_framework_metrics()

        ratio = config.get_float("TRACER_RATIO", 1.0) if hasattr(config, "get_float") else 1.0
        exporter_kind = config.get_or_default("TRACE_EXPORTER", "none").lower()
        exporter = None
        if exporter_kind in ("console", "gofr"):
            exporter = ConsoleExporter(logger)
        elif exporter_kind == "memory":
            exporter = InMemoryExporter()
        elif exporter_kind in ("otlp", "jaeger", "zipkin"):
            # network exporters to a real collector by URL (reference
            # otel.go:131-151; jaeger accepts both protocols — use OTLP)
            url = config.get_or_default(
                "TRACER_URL", config.get_or_default(
                    "TRACER_HOST", "localhost"))
            if "://" not in url:
                port = config.get_or_default(
                    "TRACER_PORT", "9411" if exporter_kind == "zipkin"
                    else "4318")
                url = f"http://{url}:{port}"
            from ..tracing.export import OTLPHTTPExporter, ZipkinExporter
            exporter_cls = ZipkinExporter if exporter_kind == "zipkin" \
                else OTLPHTTPExporter
            exporter = exporter_cls(url, service_name=c.app_name,
                                    logger=logger)
        c.tracer = Tracer(service_name=c.app_name, exporter=exporter, ratio=ratio)

        # env-driven datasources (reference container.go:128-174);
        # anything not configured stays None and can be attached later
        # via add_*
        from ..datasource.redis import new_redis
        from ..datasource.sql import new_sql
        c.sql = new_sql(config, logger, c.metrics, c.tracer)
        c.redis = new_redis(config, logger, c.metrics, c.tracer)

        # pub/sub backend switch (reference container.go:132-172 selects
        # KAFKA/GOOGLE/MQTT from PUBSUB_BACKEND; ours: KAFKA/GOOGLE/
        # EVENTHUB/NATS/JETSTREAM/MQTT/MEMORY)
        backend = config.get_or_default("PUBSUB_BACKEND", "").upper()
        if backend == "GOOGLE":
            from ..pubsub.google import GooglePubSubClient
            c.add_pubsub(GooglePubSubClient(
                endpoint=config.get_or_default("PUBSUB_BROKER",
                                               "127.0.0.1:8085"),
                project=config.get_or_default("GOOGLE_PROJECT_ID", "gofr")))
        elif backend == "EVENTHUB":
            from ..pubsub.eventhub import EventHubClient
            c.add_pubsub(EventHubClient(
                namespace=config.get_or_default("PUBSUB_BROKER",
                                                "127.0.0.1:9092"),
                eventhub=config.get_or_default("EVENTHUB_NAME", ""),
                consumer_group=config.get_or_default(
                    "KAFKA_CONSUMER_GROUP", "$Default")))
        elif backend == "KAFKA":
            from ..pubsub.kafka import KafkaClient
            c.add_pubsub(KafkaClient(
                brokers=config.get_or_default("PUBSUB_BROKER",
                                              "127.0.0.1:9092"),
                group_id=config.get_or_default("KAFKA_CONSUMER_GROUP",
                                               c.app_name),
                client_id=c.app_name,
                auto_offset=config.get_or_default(
                    "KAFKA_AUTO_OFFSET", "earliest").lower()))
        elif backend in ("NATS", "JETSTREAM"):
            addr = config.get_or_default("PUBSUB_BROKER", "127.0.0.1:4222")
            addr = addr.split("://", 1)[-1]  # tolerate nats:// scheme
            host, _, port_s = addr.rpartition(":")
            try:
                port = int(port_s)
            except ValueError:
                host, port = addr, 4222  # bare hostname, default port
            if backend == "JETSTREAM":
                from ..pubsub.jetstream import JetStreamClient
                c.add_pubsub(JetStreamClient(host or "127.0.0.1", port,
                                             name=c.app_name))
            else:
                from ..pubsub.nats import NATSClient
                c.add_pubsub(NATSClient(host or "127.0.0.1", port,
                                        name=c.app_name))
        elif backend == "MQTT":
            from ..pubsub.mqtt import MQTTClient
            try:
                qos = int(config.get_or_default("MQTT_QOS", "1"))
            except ValueError:
                qos = 1
            # the client implements QoS 0/1 (QoS 2 would wait for a
            # PUBACK that spec brokers answer with PUBREC)
            qos = min(max(qos, 0), 1)
            try:
                mqtt_port = int(config.get_or_default("MQTT_PORT",
                                                      "1883").strip())
            except ValueError:
                logger.error("invalid MQTT_PORT; using 1883")
                mqtt_port = 1883
            c.add_pubsub(MQTTClient(
                host=config.get_or_default("MQTT_HOST", "127.0.0.1"),
                port=mqtt_port,
                client_id=config.get_or_default("MQTT_CLIENT_ID", c.app_name),
                qos=qos))
        elif backend in ("MEMORY", "INMEMORY"):
            from ..pubsub.inmemory import InMemoryBroker
            c.add_pubsub(InMemoryBroker(logger=logger, metrics=c.metrics))
        return c

    # ------------------------------------------------- framework metrics
    def register_framework_metrics(self) -> None:
        """The standard metric set (reference container.go:252-284)."""
        m = self.metrics
        m.new_gauge("app_info", "static app info")
        m.set_gauge("app_info", 1, app_name=self.app_name, app_version=self.app_version)
        m.new_gauge("app_uptime_seconds", "seconds since boot")
        m.new_histogram("app_http_response", "http response time in seconds")
        m.new_histogram("app_http_service_response",
                        "outbound http client response time in seconds")
        m.new_histogram("app_sql_stats", "sql query time in seconds",
                        buckets=_DATASOURCE_BUCKETS)
        m.new_histogram("app_kv_stats", "kv op time in seconds",
                        buckets=_DATASOURCE_BUCKETS)
        m.new_histogram("app_nats_kv_stats",
                        "NATS JetStream KV op time in seconds",
                        buckets=_DATASOURCE_BUCKETS)
        m.new_histogram("app_redis_stats", "redis op time in seconds",
                        buckets=_DATASOURCE_BUCKETS)
        m.new_histogram("app_file_stats", "file op time in seconds",
                        buckets=_DATASOURCE_BUCKETS)
        m.new_histogram("app_pubsub_publish_latency", "publish time in seconds")
        m.new_counter("app_pubsub_publish_total_count", "messages published")
        m.new_counter("app_pubsub_publish_success_count", "publishes succeeded")
        m.new_counter("app_pubsub_subscribe_total_count", "messages received")
        m.new_counter("app_pubsub_subscribe_success_count", "messages handled")
        # device series (no reference counterpart; JAX's app_tpu_* names
        # with gpu, as the device registry writes them)
        m.new_gauge("app_gpu_hbm_bytes_used", "HBM bytes in use per device")
        m.new_gauge("app_gpu_device_count", "visible GPU devices")
        m.new_histogram("app_gpu_execute_seconds", "device execute wall time",
                        buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                                 0.05, 0.1, 0.25, 0.5, 1, 5))
        latency_buckets = (0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.15,
                           0.25, 0.5, 1, 2, 5)
        m.new_histogram("app_chat_ttft_seconds", "time to first token",
                        buckets=latency_buckets)
        m.new_histogram("app_chat_queue_seconds",
                        "submit -> first slot assignment (admission "
                        "queue wait)", buckets=latency_buckets)
        m.new_histogram("app_chat_e2e_seconds",
                        "submit -> finish wall time",
                        buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1,
                                 2.5, 5, 10, 30, 60))
        m.new_histogram("app_chat_tpot_seconds",
                        "per-request mean inter-token latency",
                        buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01,
                                 0.025, 0.05, 0.1, 0.25, 0.5, 1))
        # fleet (multi-host control plane) series, written by
        # serving/control_plane.py on the leader; zero-valued on hosts
        # that never lead a serving group
        m.new_gauge("app_fleet_world_size",
                    "control-plane serving-group members")
        m.new_gauge("app_fleet_generation",
                    "control-plane membership generation")
        m.new_gauge("app_fleet_pass_skew",
                    "max/median p95 pass duration across hosts "
                    "(1 = balanced)")
        m.new_gauge("app_fleet_occupancy_skew",
                    "max/median mean batch occupancy across hosts")
        m.new_gauge("app_fleet_straggler_ratio",
                    "fraction of hosts whose p95 pass duration exceeds "
                    "straggler_ratio x the fleet median")
        m.new_gauge("app_fleet_goodput_ratio",
                    "fleet-wide useful device time over busy device "
                    "time, summed across member heartbeat goodput "
                    "digests")
        m.new_counter("app_fleet_evictions",
                      "hosts evicted from the serving group "
                      "(by reason label)")
        m.new_counter("app_fleet_heartbeats",
                      "control-plane heartbeats received")
        # leader-HA series (serving/control_plane.py): epoch fencing
        # and worker-driven failover — control-plane cadence only
        m.new_gauge("app_fleet_leader_epoch",
                    "this leader's election epoch (bumps on every "
                    "takeover; workers reject lower-epoch acks)")
        m.new_counter("app_fleet_failovers",
                      "worker failover rounds to a new leader "
                      "(by reason: missed_acks/stale_leader/"
                      "not_leader)")
        m.new_counter("app_fleet_stale_leader_rejects",
                      "control messages refused because they carried "
                      "a higher epoch than this leader holds (a "
                      "revived stale leader being fenced)")
        # output-integrity quarantine series (serving/control_plane.py
        # _vote_integrity): divergence-vote outcomes, control-plane
        # cadence only
        m.new_gauge("app_fleet_quarantined_hosts",
                    "hosts currently quarantined by the integrity "
                    "divergence vote (routed share held at zero until "
                    "they rejoin)")
        m.new_counter("app_fleet_quarantines",
                      "integrity-divergence quarantine actions "
                      "(by action label: quarantine/rejoin)")
        # tenant metering + SLO series, written by the usage ledger /
        # SLO tracker (serving/observability.py) at request retire;
        # tenant-labeled counters SUM across hosts under federation
        m.new_counter("app_tenant_requests",
                      "retired requests by tenant and status "
                      "(ok/error/cancelled)")
        m.new_counter("app_tenant_prompt_tokens",
                      "prompt tokens by tenant")
        m.new_counter("app_tenant_completion_tokens",
                      "generated tokens by tenant")
        m.new_counter("app_tenant_device_seconds",
                      "device busy time attributed to each tenant "
                      "(per-request share of every pass's busy span)")
        m.new_counter("app_tenant_waste_seconds",
                      "per-tenant attributable waste device time by "
                      "cause (preempt_recompute, spec_rejected)")
        m.new_histogram("app_tenant_queue_seconds",
                        "admission queue wait by tenant",
                        buckets=latency_buckets)
        m.new_histogram("app_tenant_e2e_seconds",
                        "submit -> finish wall time by tenant",
                        buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1,
                                 2.5, 5, 10, 30, 60))
        m.new_gauge("app_slo_burn_rate",
                    "error-budget burn rate by window (1 = spending "
                    "the budget at exactly the sustainable pace)")
        m.new_gauge("app_slo_error_budget_remaining",
                    "fraction of the availability error budget left "
                    "over SLOConfig.budget_window_s")
        # admission-scheduler series (serving/scheduler.py): written at
        # admission rejects / starvation preempts / the throttled gauge
        # pass — never from the decode hot loop
        m.new_gauge("app_sched_lane_depth",
                    "queued requests per scheduler lane "
                    "(interactive/background)")
        m.new_gauge("app_sched_tenant_share",
                    "per-tenant fraction of windowed device time "
                    "(the fair-share dequeue signal)")
        m.new_gauge("app_sched_shed_active",
                    "1 while a burn-rate shed episode is active")
        m.new_counter("app_sched_rejections",
                      "admission refusals by cause "
                      "(queue_full/rate_limited/shed) and tenant")
        m.new_counter("app_sched_preemptions",
                      "scheduler-initiated background preemptions to "
                      "unstarve the interactive lane")
        # fleet front-door series (serving/router.py): written by the
        # leader's data-plane router at route/retry/autoscale time —
        # leader-side host work, never on any worker's decode path
        m.new_gauge("app_router_routed_share",
                    "per-host fraction of requests the leader's "
                    "router forwarded")
        m.new_gauge("app_router_cache_hit_ratio",
                    "fraction of routed requests sent to a host whose "
                    "prefix digest covered part of the prompt")
        m.new_counter("app_router_routed",
                      "requests the fleet router forwarded to a "
                      "member (by host label)")
        m.new_counter("app_router_retries",
                      "router failovers to the next-best host on "
                      "typed retryable rejects or connect errors "
                      "(by code label)")
        m.new_counter("app_router_affinity_hits",
                      "requests routed by session affinity")
        m.new_counter("app_router_scale_decisions",
                      "autoscale decisions the router emitted "
                      "(by action label)")
        m.new_counter("app_router_client_aborts",
                      "proxied streams cancelled because the "
                      "downstream client disconnected mid-stream "
                      "(upstream slot released early)")
        # flight-data-recorder series (serving/events.py): written
        # wherever a state transition lands on the event ledger —
        # boundary/exception/control-plane code, never the hot loop
        m.new_counter("app_events_total",
                      "event-ledger records by kind "
                      "(the flight data recorder's emission rate)")
        m.new_counter("app_events_dropped",
                      "event-ledger ring evictions by kind — a "
                      "truncated timeline is visible, never silent")

    # ------------------------------------------------------------- health
    def health(self) -> dict[str, Any]:
        """Aggregate health over every attached capability
        (reference container/health.go:8-98)."""
        details: dict[str, Any] = {
            "name": self.app_name,
            "version": self.app_version,
            "uptime_seconds": round(time.time() - self._start_time, 1),
        }
        statuses: list[str] = []
        checks: dict[str, Any] = {}
        for name in _SLOTS:
            source = getattr(self, name)
            if source is None:
                continue
            checks[name] = self._check_one(source)
            statuses.append(checks[name].get("status", STATUS_DOWN))
        for svc_name, svc in self.services.items():
            checks[f"service:{svc_name}"] = self._check_one(svc)
            statuses.append(checks[f"service:{svc_name}"].get("status", STATUS_DOWN))
        for extra_name, source in self.extra_health.items():
            checks[extra_name] = self._check_one(source)
            statuses.append(checks[extra_name].get("status", STATUS_DOWN))
        status = STATUS_UP
        if any(s != STATUS_UP for s in statuses):
            status = STATUS_DEGRADED
        return {"status": status, "details": details, "checks": checks}

    def _check_one(self, source: Any) -> dict[str, Any]:
        import asyncio
        import inspect
        try:
            check = getattr(source, "health_check", None)
            if check is None:
                return {"status": STATUS_UP}
            result = check()
            if inspect.iscoroutine(result):
                # works from executor threads AND from inside a running
                # loop (async handlers): hop to a throwaway thread
                try:
                    asyncio.get_running_loop()
                except RuntimeError:
                    result = asyncio.run(result)
                else:
                    import concurrent.futures
                    # no `with`: shutdown(wait=True) would join a hung
                    # check and defeat the 10s bound
                    pool = concurrent.futures.ThreadPoolExecutor(1)
                    try:
                        result = pool.submit(asyncio.run, result).result(10)
                    finally:
                        pool.shutdown(wait=False)
            if isinstance(result, dict):
                return result
            return {"status": STATUS_UP if result else STATUS_DOWN}
        except Exception as exc:
            return {"status": STATUS_DOWN, "error": str(exc)}

    # ------------------------------------------------------ registration
    def _provide(self, store: Any) -> Any:
        """use_logger → use_metrics → use_tracer → connect → return,
        the provider wiring order of reference external_db.go."""
        for setter, dep in (("use_logger", self.logger),
                            ("use_metrics", self.metrics),
                            ("use_tracer", self.tracer)):
            fn = getattr(store, setter, None)
            if fn is not None:
                fn(dep)
        connect = getattr(store, "connect", None)
        if connect is not None:
            import inspect
            if inspect.iscoroutinefunction(connect):
                self._deferred_connects.append(store)
            else:
                connect()
        return store

    async def connect_async(self) -> None:
        """Await every deferred (async) connect; failures log and leave
        the store down (health reports it), matching the reference's
        retry-in-background stance rather than failing boot."""
        while self._deferred_connects:
            store = self._deferred_connects.pop(0)
            try:
                await store.connect()
            except Exception as exc:
                self.logger.error(
                    f"connect {type(store).__name__} failed: {exc!r}")

    def add_sql(self, store: Any) -> Any:
        self.sql = self._provide(store)
        return self.sql

    def add_redis(self, store: Any) -> Any:
        self.redis = self._provide(store)
        return self.redis

    def add_kv_store(self, store: Any) -> Any:
        self.kv = self._provide(store)
        return self.kv

    def add_file_store(self, store: Any) -> Any:
        self.file = self._provide(store)
        return self.file

    def add_pubsub(self, client: Any) -> Any:
        self.pubsub = self._provide(client)
        return self.pubsub

    def register_service(self, name: str, service: Any) -> None:
        self.services[name] = service

    def register_health_check(self, name: str, source: Any) -> None:
        """Attach any extra ``health_check()``-bearing component (e.g.
        the serving control plane) to the aggregate health surface."""
        self.extra_health[name] = source

    def register_ws_service(self, name: str, service: Any) -> None:
        self.ws_services[name] = service

    def get_ws_service(self, name: str) -> Any:
        return self.ws_services.get(name)

    def get_http_service(self, name: str) -> Any:
        return self.services.get(name)

    def add_model(self, name: str, engine: Any) -> None:
        self.models[name] = engine

    def get_model(self, name: str) -> Any:
        return self.models.get(name)

    async def close(self) -> None:
        for attr in _SLOTS:
            source = getattr(self, attr)
            closer = getattr(source, "close", None)
            if closer is None:
                continue
            try:
                result = closer()
                if hasattr(result, "__await__"):
                    await result
            except Exception as exc:
                self.logger.warn(f"closing {attr}: {exc}")
        # flush the trace exporter last: the spans of this shutdown are
        # the ones a crash-loop investigation needs
        exporter_close = getattr(getattr(self.tracer, "exporter", None),
                                 "close", None)
        if exporter_close is not None:
            try:
                exporter_close()
            except Exception as exc:
                self.logger.warn(f"closing trace exporter: {exc}")


def _make_adder(slot: str):
    def add(self: Container, store: Any) -> Any:
        setattr(self, slot, self._provide(store))
        return getattr(self, slot)
    add.__name__ = f"add_{slot}"
    add.__doc__ = (f"Attach a {slot} store: use_logger → use_metrics → "
                   f"use_tracer → connect (reference external_db.go).")
    return add


for _slot in _BREADTH_SLOTS:
    setattr(Container, f"add_{_slot}", _make_adder(_slot))
del _slot

"""Datasource layer: instrumented stores behind narrow interfaces (the
port's copy of ``gofr_tpu/datasource/``, its core modules).

Mirrors the reference's datasource tree (pkg/gofr/datasource/*): every
store follows the provider pattern — ``use_logger`` / ``use_metrics`` /
``use_tracer`` then ``connect`` (reference container/datasources.go:346-358)
— and exposes ``health_check`` for the container's aggregate health
(container/health.go:8-98).

Ported backends:
- :mod:`.sql` — sqlite-backed SQL with dialect-aware placeholders,
  query logging, metrics, ORM-lite ``select``.
- :mod:`.redis` — Redis-shaped KV with an in-process backend (the
  miniredis analog SURVEY §4 prescribes for hermetic tests).
- :mod:`.kv` — minimal key-value store interface (badger analog) with
  in-memory and sqlite-file backends.
- :mod:`.file_store` — FileSystem abstraction over the local FS with
  JSON/CSV row readers.
- :mod:`.dbresolver` — SQL primary/replica router with per-replica
  circuit breakers.

- :mod:`.document` — document-store family (Mongo/Elasticsearch/Solr/
  Couchbase-shaped) over one embedded engine.
- :mod:`.columnar` — CQL/columnar family (Cassandra/ScyllaDB/
  Clickhouse/Oracle-shaped) over sqlite.
- :mod:`.graph` — graph family (Dgraph/ArangoDB/SurrealDB-shaped).
- :mod:`.timeseries` — time-series family (OpenTSDB/InfluxDB-shaped).
- :mod:`.object_store` — S3/GCS/Azure-Blob-shaped file stores over one
  embedded object engine.

Network wire clients (each speaks its store's real protocol and ships
a protocol-faithful mini server for hermetic tests; ``new_sql`` /
``new_redis`` pick the SQL and Redis ones from config, the others are
attached with the container's ``add_*``): :mod:`.redis_wire` (RESP2),
:mod:`.postgres_wire` (v3 protocol + SCRAM-SHA-256), :mod:`.mysql_wire`
(v10 handshake + native-password auth + COM_QUERY),
:mod:`.oracle_wire` (TNS transport + O5LOGON-style auth),
:mod:`.cassandra_wire` (CQL native protocol v4, incl. ``ScyllaWire``),
:mod:`.couchbase_wire` (memcached binary KV + N1QL HTTP),
:mod:`.mongo_wire` (OP_MSG), :mod:`.s3_wire` (SigV4),
:mod:`.gcs_wire` (JSON API), :mod:`.azure_blob_wire` (SharedKey),
:mod:`.es_wire`, :mod:`.solr_wire`, :mod:`.clickhouse_wire` (HTTP
interface), :mod:`.influx_wire`, :mod:`.opentsdb_wire`,
:mod:`.arango_wire`, :mod:`.dgraph_wire` (generated DQL),
:mod:`.surreal_wire` (WebSocket JSON-RPC over the port's websocket
layer) and :mod:`.dynamo_wire` (DynamoDB JSON 1.0 + SigV4). The HTTP
Mini servers run the port's HTTP server on a thread of their own
(:mod:`.miniserver`); the JSON clients share :mod:`._http`.

File and KV stores over the wire: :mod:`.ftp` (``FTPFileSystem`` on
stdlib ``ftplib``, the ``SFTPFileSystem`` shim over an injected client,
``MiniFTPServer``), :mod:`.nats_kv` (``NATSKV`` on JetStream buckets
through :mod:`..pubsub.jetstream`) and :mod:`.sftp_wire` (SFTP v3 over
the SSH2 transport of :mod:`.ssh_transport`, which needs
``cryptography``; ``MiniSFTPServer``).
"""

import time
from typing import Any, Protocol


class HealthChecker(Protocol):
    """reference container/datasources.go:360-364."""

    def health_check(self) -> dict[str, Any]: ...


class Provider(Protocol):
    """reference container/datasources.go:346-358."""

    def use_logger(self, logger: Any) -> None: ...

    def use_metrics(self, metrics: Any) -> None: ...

    def use_tracer(self, tracer: Any) -> None: ...

    def connect(self) -> None: ...


class ProviderMixin:
    """The use_logger/use_metrics/use_tracer wiring every store shares."""

    logger: Any = None
    metrics: Any = None
    tracer: Any = None

    def use_logger(self, logger: Any) -> None:
        self.logger = logger

    def use_metrics(self, metrics: Any) -> None:
        self.metrics = metrics

    def use_tracer(self, tracer: Any) -> None:
        self.tracer = tracer


# 50µs–30s, the reference's datasource latency buckets
# (container/container.go:339-344)
DATASOURCE_BUCKETS = (0.00005, 0.0001, 0.0005, 0.001, 0.005, 0.01,
                      0.05, 0.1, 0.5, 1, 5, 30)


class Instrumented(ProviderMixin):
    """Provider + per-op observation: every operation logs a one-line
    QueryLog and records into the store's latency histogram, the way
    every reference datasource does (e.g. sql/db.go:47-60)."""

    #: metric name; subclasses override (registered lazily if missing)
    metric = "app_datasource_stats"
    #: short tag used in the log line ("MONGO", "CQL", ...)
    log_tag = "DS"

    def _observed(self, op: str, detail: str, fn):
        start = time.perf_counter()
        try:
            return fn()
        finally:
            micros = int((time.perf_counter() - start) * 1e6)
            if self.logger is not None:
                self.logger.debug(
                    f"{self.log_tag} {micros:6d}µs {op} {detail}")
            if self.metrics is not None:
                if self.metrics.get(self.metric) is None:
                    # concurrent first ops may race to register; the
                    # loser's MetricsError must not clobber fn's result
                    try:
                        self.metrics.new_histogram(  # gofrlint: allow(metric-hygiene) -- per-datasource name (app_<ds>_stats) is instance config; registered right here before the only write
                            self.metric,
                            f"{self.log_tag} op time in seconds",
                            buckets=DATASOURCE_BUCKETS)
                    except Exception:
                        pass
                self.metrics.record_histogram(self.metric, micros / 1e6,  # gofrlint: allow(metric-hygiene) -- same dynamic per-datasource name, registered four lines up
                                              type=op.lower())

"""Shared helpers of the port's wire-backend tests: a background event loop
for the asyncio Mini servers, a port nothing listens on, the count of open
TCP connections to a port or to a Mini server, a Mini server started for
the length of a ``with`` block, and the two sides' modules by protocol."""

from __future__ import annotations

import asyncio
import contextlib
import importlib
import socket
import threading
import time

#: protocol -> (module of the JAX package, module of the port)
MODULES = {
    "postgres": "datasource.postgres_wire",
    "mysql": "datasource.mysql_wire",
    "oracle": "datasource.oracle_wire",
    "redis": "datasource.redis_wire",
    "kafka": "pubsub.kafka",
    "eventhub": "pubsub.eventhub",
    "nats": "pubsub.nats",
    "jetstream": "pubsub.jetstream",
    "mqtt": "pubsub.mqtt",
    "google": "pubsub.google",
    "mongo": "datasource.mongo_wire",
    "cassandra": "datasource.cassandra_wire",
    "clickhouse": "datasource.clickhouse_wire",
    "es": "datasource.es_wire",
    "solr": "datasource.solr_wire",
    "couchbase": "datasource.couchbase_wire",
    "s3": "datasource.s3_wire",
    "dynamo": "datasource.dynamo_wire",
    "gcs": "datasource.gcs_wire",
    "azure_blob": "datasource.azure_blob_wire",
    "influx": "datasource.influx_wire",
    "opentsdb": "datasource.opentsdb_wire",
    "dgraph": "datasource.dgraph_wire",
    "arango": "datasource.arango_wire",
    "surreal": "datasource.surreal_wire",
    "ftp": "datasource.ftp",
    "nats_kv": "datasource.nats_kv",
    "sftp": "datasource.sftp_wire",
}

#: (client side, server side): the port against itself, then the two
#: cross directions
PAIRS = [("port", "port"), ("port", "jax"), ("jax", "port")]
PAIR_IDS = ["port-port", "port-client-jax-server", "jax-client-port-server"]


def side_module(side: str, protocol: str):
    package = "gofr_tpu_torch" if side == "port" else "gofr_tpu"
    return importlib.import_module(f"{package}.{MODULES[protocol]}")


class Side:
    """One package's names for the in-process parity tests: ``S.Mongo``,
    ``S.Container`` ... resolve on the first of ``modules`` (dotted, under
    the package) that has them."""

    def __init__(self, side: str, modules: tuple) -> None:
        self.name = side
        self.package = "gofr_tpu_torch" if side == "port" else "gofr_tpu"
        self._modules = modules

    def module(self, dotted: str):
        return importlib.import_module(f"{self.package}.{dotted}")

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        for dotted in self._modules:
            module = self.module(dotted)
            if hasattr(module, name):
                return getattr(module, name)
        raise AttributeError(name)


class LoopThread:
    """An asyncio loop on a daemon thread: ``run(coro)`` waits for a
    coroutine on it (the Mini brokers live there while a test's own
    loop, or a thread, drives the clients)."""

    def __init__(self) -> None:
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self.loop.run_forever,
                                        daemon=True, name="wire-loop")
        self._thread.start()

    def run(self, coro, timeout: float = 30.0):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def close(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(5)
        self.loop.close()


def dead_port() -> int:
    """A loopback port with no listener (bound, then released)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def open_connections(port: int) -> int:
    """ESTABLISHED TCP connections with ``port`` at either end, read from
    the kernel's table (both ends of a loopback connection count)."""
    count = 0
    for table in ("/proc/net/tcp", "/proc/net/tcp6"):
        try:
            with open(table) as fh:
                rows = fh.read().splitlines()[1:]
        except OSError:
            continue
        for row in rows:
            fields = row.split()
            local, remote, state = fields[1], fields[2], fields[3]
            if state != "01":   # ESTABLISHED
                continue
            if int(local.rsplit(":", 1)[1], 16) == port or \
                    int(remote.rsplit(":", 1)[1], 16) == port:
                count += 1
    return count


def server_ports(server) -> list:
    """Every port a started Mini server listens on (Couchbase's KV and
    query ports, the others' one)."""
    return [getattr(server, name) for name in ("port", "kv_port",
                                               "query_port")
            if isinstance(getattr(server, name, None), int)]


def server_connections(server) -> int:
    """Open TCP connections to any port of a started Mini server."""
    return sum(open_connections(port) for port in server_ports(server))


@contextlib.contextmanager
def started(server):
    """A Mini server with a synchronous ``start`` / ``close`` (the HTTP
    ones serve from an event loop on a thread of their own), started for
    the ``with`` block and closed after it, also on a raise."""
    server.start()
    try:
        yield server
    finally:
        server.close()


def wait_until(predicate, timeout: float = 10.0, step: float = 0.02) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(step)
    return predicate()


class Pair:
    """The two sides of one protocol for a test: ``Mini*`` names resolve
    on the server side's module, every other name on the client side's;
    ``client`` / ``server`` name the sides."""

    def __init__(self, protocol: str, pair: tuple[str, str]) -> None:
        self.client, self.server = pair
        self._cli = side_module(self.client, protocol)
        self._srv = side_module(self.server, protocol)

    def __getattr__(self, name: str):
        module = self._srv if name.startswith("Mini") else self._cli
        return getattr(module, name)

    def srv(self, name: str):
        """``name`` on the server side's module (a decoder, say, held
        against the client side's encoder)."""
        return getattr(self._srv, name)

    def side(self, module: str):
        """``module`` (dotted, under the package) of the client's side."""
        package = "gofr_tpu_torch" if self.client == "port" else "gofr_tpu"
        return importlib.import_module(f"{package}.{module}")

"""The port's auto-CRUD (``gofr_tpu_torch/crud.py``), migrations
(``gofr_tpu_torch/migrations/``) and env-built datasources against the
JAX package's: the same entity and requests against each package's
``App`` give the same statuses and bodies; the same migrations give the
same ledgers (timestamps aside) in SQL, Redis and KV, and the same
rollback of a failing version; ``Container.create`` builds ``sql`` and
``redis`` from the environment in both, and the port names the wire
module it still lacks for a network dialect or ``REDIS_MODE=network``.
"""

from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass

import pytest

from gofr_tpu.config import DictConfig as JaxConfig
from gofr_tpu.container.container import Container as JaxContainer
from gofr_tpu.datasource.kv import InMemoryKV as JaxKV
from gofr_tpu.migrations import Migrate as JaxMigrate
from gofr_tpu_torch.config import DictConfig
from gofr_tpu_torch.container.container import Container
from gofr_tpu_torch.datasource.kv import InMemoryKV
from gofr_tpu_torch.migrations import Migrate, MigrationError

from .test_torch_websocket import served


@dataclass
class Book:
    id: int
    title: str
    pages: int = 0


def _book_table(ds) -> None:
    ds.sql.exec("CREATE TABLE book (id INTEGER PRIMARY KEY, title TEXT, "
                "pages INTEGER)")


def _call(port: int, method: str, path: str, body=None):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=20)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, json.loads(data) if data else None
    finally:
        conn.close()


CRUD_CALLS = [("POST", "/book", {"id": 1, "title": "dune", "pages": 412}),
              ("POST", "/book", {"id": 2, "title": "emma", "pages": 90}),
              ("GET", "/book", None),
              ("GET", "/book/1", None),
              ("PUT", "/book/1", {"title": "dune messiah", "pages": 256}),
              ("GET", "/book/1", None),
              ("DELETE", "/book/2", None),
              ("GET", "/book/2", None),
              ("PUT", "/book/9", {"title": "none"}),
              ("DELETE", "/book/9", None),
              ("POST", "/book", {"title": "no id"}),
              ("GET", "/book", None)]


def _crud_run(pkg: str, tmp_path) -> list:
    migrate = JaxMigrate if pkg == "jax" else Migrate

    def build(app):
        assert app.migrate({1: migrate(up=_book_table)}) == [1]
        app.add_rest_handlers(Book)

    config = {"DB_DIALECT": "sqlite", "DB_NAME": str(tmp_path / f"{pkg}.db")}
    with served(pkg, build, config) as (port, _):
        return [_call(port, *c) for c in CRUD_CALLS]


def test_crud_statuses_and_bodies_equal_jax(tmp_path):
    port_answers = _crud_run("port", tmp_path)
    assert port_answers == _crud_run("jax", tmp_path)
    assert [s for s, _ in port_answers] == [201, 201, 200, 200, 200, 200,
                                            204, 404, 404, 404, 400, 200]
    assert port_answers[-1][1]["data"] == [
        {"id": 1, "title": "dune messiah", "pages": 256}]


def test_crud_needs_a_dataclass_and_a_database():
    from gofr_tpu_torch.app import App
    app = App(config=DictConfig({"HTTP_PORT": "0", "METRICS_PORT": "0"}))
    with pytest.raises(TypeError):
        app.add_rest_handlers(dict)
    spec = app.add_rest_handlers(Book, table_name="books", rest_path="/lib")
    assert (spec.table, spec.path, spec.primary_key) == ("books", "lib", "id")


# ------------------------------------------------------------ migrations
def _containers(pkg: str):
    if pkg == "jax":
        c = JaxContainer.create(JaxConfig({"DB_DIALECT": "sqlite",
                                           "REDIS_HOST": "localhost"}))
        c.add_kv_store(JaxKV())
    else:
        c = Container.create(DictConfig({"DB_DIALECT": "sqlite",
                                         "REDIS_HOST": "localhost"}))
        c.add_kv_store(InMemoryKV())
    return c


def _v1(ds):
    ds.sql.exec("CREATE TABLE note (id INTEGER PRIMARY KEY, body TEXT)")


def _v2(ds):
    ds.sql.exec("INSERT INTO note (id, body) VALUES (1, 'first')")
    ds.redis.set("greeting", "hello")
    ds.kv.set("config", "on")


def _v3(ds):
    ds.sql.exec("CREATE TABLE doomed (x INTEGER)")
    ds.sql.exec("INSERT INTO note (id, body) VALUES (2, 'never')")
    raise RuntimeError("version 3 fails")


def _ledgers(c) -> dict:
    def stripped(raw):
        entry = json.loads(raw)
        return entry["method"]
    return {
        "sql": [(r["version"], r["method"]) for r in c.sql.query(
            "SELECT version, method FROM gofr_migrations ORDER BY version")],
        "redis": {k: stripped(c.redis.get(k))
                  for k in sorted(c.redis.keys("gofr_migrations:*"))},
        "kv": {k: stripped(c.kv.get(k)) for k in sorted(c.kv.keys())
               if k.startswith("gofr_migrations:")},
        "notes": [dict(r) for r in c.sql.query("SELECT * FROM note")],
        "doomed": [dict(r) for r in c.sql.query(
            "SELECT name FROM sqlite_master WHERE name = 'doomed'")],
        "stores": (c.redis.get("greeting"), c.kv.get("config")),
    }


def _migrations_run(pkg: str) -> dict:
    from gofr_tpu.migrations import run as jax_run
    from gofr_tpu_torch.migrations import run as port_run
    run, migrate = (jax_run, JaxMigrate) if pkg == "jax" \
        else (port_run, Migrate)
    c = _containers(pkg)
    out = {"first": run(c, {1: migrate(up=_v1), 2: migrate(up=_v2)})}
    out["again"] = run(c, {1: migrate(up=_v1), 2: migrate(up=_v2)})
    with pytest.raises(RuntimeError, match="version 3 fails"):
        run(c, {1: migrate(up=_v1), 2: migrate(up=_v2), 3: migrate(up=_v3)})
    out["ledgers"] = _ledgers(c)
    return out


def test_migration_ledgers_and_rollback_equal_jax():
    port = _migrations_run("port")
    assert port == _migrations_run("jax")
    assert port["first"] == [1, 2] and port["again"] == []
    assert port["ledgers"]["sql"] == [(1, "UP"), (2, "UP")]
    assert port["ledgers"]["doomed"] == []


def test_migrations_refuse_bad_input_like_jax():
    from gofr_tpu.migrations import MigrationError as JaxMigrationError
    from gofr_tpu.migrations import run as jax_run
    from gofr_tpu_torch.migrations import run as port_run
    for run, migrate, err, c in (
            (port_run, Migrate, MigrationError, _containers("port")),
            (jax_run, JaxMigrate, JaxMigrationError, _containers("jax"))):
        assert run(c, {}) == []
        with pytest.raises(err, match="invalid migration version"):
            run(c, {0: migrate(up=_v1)})
        with pytest.raises(err, match="no callable 'up'"):
            run(c, {1: object()})
    bare = Container.create(DictConfig({}))
    with pytest.raises(MigrationError, match="no datasource"):
        port_run(bare, {1: Migrate(up=_v1)})


# ------------------------------------------------------------- container
def test_env_datasources_up_in_both_packages(tmp_path):
    env = {"DB_DIALECT": "sqlite", "DB_NAME": str(tmp_path / "h.db"),
           "REDIS_HOST": "localhost"}
    port = Container.create(DictConfig(env))
    jax = JaxContainer.create(JaxConfig(env))
    for c in (port, jax):
        health = c.health()
        assert health["status"] == "UP"
        assert {k: v["status"] for k, v in health["checks"].items()} == \
            {"sql": "UP", "redis": "UP"}
    assert port.health()["checks"]["sql"]["details"] == \
        jax.health()["checks"]["sql"]["details"]


@pytest.mark.parametrize("dialect,module", [
    ("mysql", "datasource/mysql_wire.py"),
    ("postgres", "datasource/postgres_wire.py"),
    ("cockroachdb", "datasource/postgres_wire.py"),
    ("supabase", "datasource/postgres_wire.py"),
    ("oracle", "datasource/oracle_wire.py")])
def test_network_dialects_name_their_wire_module(dialect, module):
    """``DB_DIALECT`` with ``DB_HOST`` builds the client of the wire
    module the dialect names, connected to its Mini server, and the
    auto-CRUD placeholder style follows the dialect."""
    from gofr_tpu_torch.datasource import mysql_wire, oracle_wire, \
        postgres_wire
    server = {"mysql": lambda: mysql_wire.MiniMySQLServer(
                  user="app", password="pw"),
              "oracle": lambda: oracle_wire.MiniOracleServer(
                  users={"app": "pw"})}.get(
        dialect, lambda: postgres_wire.MiniPostgresServer(
            user="app", password="pw"))()
    server.start()
    try:
        c = Container.create(DictConfig({
            "DB_DIALECT": dialect, "DB_HOST": "127.0.0.1",
            "DB_PORT": str(server.port), "DB_USER": "app",
            "DB_PASSWORD": "pw"}))
        assert type(c.sql).__module__ == \
            "gofr_tpu_torch." + module[:-3].replace("/", ".")
        assert c.sql.dialect == ("postgres" if module.startswith(
            "datasource/postgres") else dialect)
        assert c.health()["checks"]["sql"]["status"] == "UP"
        asyncio.run(c.close())
    finally:
        server.close()


def test_network_redis_names_its_wire_module():
    """``REDIS_MODE=network`` builds the RESP2 client of
    ``datasource/redis_wire.py``, which round-trips through its Mini
    server."""
    from gofr_tpu_torch.datasource.redis_wire import MiniRedisServer
    server = MiniRedisServer()
    server.start()
    try:
        c = Container.create(DictConfig({"REDIS_HOST": "127.0.0.1",
                                         "REDIS_PORT": str(server.port),
                                         "REDIS_MODE": "network"}))
        assert type(c.redis).__module__ == \
            "gofr_tpu_torch.datasource.redis_wire"
        c.redis.set("k", "v")
        assert c.redis.get("k") == "v"
        asyncio.run(c.close())
    finally:
        server.close()


def test_breadth_adders_take_the_callers_store():
    """``add_<slot>`` wires a store object as JAX's do (logger, metrics,
    tracer, connect), and the context reaches it by name."""
    from gofr_tpu_torch.context import Context

    class Store:
        connected = False

        def use_logger(self, logger):
            self.logger = logger

        def connect(self):
            self.connected = True

        def health_check(self):
            return {"status": "UP"}

    c = Container.create(DictConfig({}))
    for slot in ("mongo", "cassandra", "dbresolver", "influxdb"):
        store = getattr(c, f"add_{slot}")(Store())
        assert store.connected and store.logger is c.logger
        assert getattr(Context(request=None, container=c), slot) is store
    assert set(c.health()["checks"]) == {"mongo", "cassandra", "dbresolver",
                                         "influxdb"}
    assert set(dir(JaxContainer)) >= {f"add_{s}" for s in (
        "mongo", "cassandra", "dbresolver", "influxdb")}

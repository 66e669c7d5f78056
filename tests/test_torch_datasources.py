"""The port's datasources (``gofr_tpu_torch/datasource/``) against the JAX
package's (``gofr_tpu/datasource/``): the same seeded operations through
each package's store give the same answers — SQL statements, rows,
``select``, placeholders and identifiers per dialect, rollback; a Redis
command sequence; ``InMemoryKV`` / ``FileKV``; ``LocalFileSystem`` and
its JSON / CSV ``RowReader``; ``DBResolver`` routing and breaker state
under a seeded ``random``. Then what the port's threads ask of them: one
SQL connection used from many threads (transactions included) and
concurrent first observations registering a store's histogram.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass

import numpy as np
import pytest

import gofr_tpu.datasource.dbresolver as jax_dbresolver
import gofr_tpu.datasource.file_store as jax_files
import gofr_tpu.datasource.kv as jax_kv
import gofr_tpu.datasource.redis as jax_redis
import gofr_tpu.datasource.sql as jax_sql
import gofr_tpu_torch.datasource.dbresolver as port_dbresolver
import gofr_tpu_torch.datasource.file_store as port_files
import gofr_tpu_torch.datasource.kv as port_kv
import gofr_tpu_torch.datasource.redis as port_redis
import gofr_tpu_torch.datasource.sql as port_sql
from gofr_tpu_torch.datasource import Instrumented
from gofr_tpu_torch.metrics import Manager

SQL_PKGS = {"jax": jax_sql, "port": port_sql}


@dataclass
class Item:
    id: int
    name: str
    price: float = 0.0


def _rows(rows) -> list[dict]:
    return [dict(r) for r in rows]


def _sql_script(mod, seed: int) -> dict:
    """Seeded DDL, inserts, queries, ``select``, an update, a rolled-back
    and a committed transaction; every observable answer."""
    rng = np.random.default_rng(seed)
    db = mod.SQL()
    db.connect()
    out: dict = {}
    db.exec("CREATE TABLE item (id INTEGER PRIMARY KEY, name TEXT, "
            "price REAL)")
    for i in range(12):
        name = "".join(chr(97 + int(c)) for c in rng.integers(0, 26, 6))
        db.exec(f"INSERT INTO item (id, name, price) VALUES "
                f"({db.ph(1)}, {db.ph(2)}, {db.ph(3)})",
                i, name, float(rng.integers(1, 1000)) / 10)
    out["all"] = _rows(db.query("SELECT * FROM item ORDER BY id"))
    cut = float(rng.integers(10, 90))
    out["cheap"] = _rows(db.query(
        "SELECT id, name FROM item WHERE price < ? ORDER BY price", cut))
    out["row"] = dict(db.query_row("SELECT * FROM item WHERE id = ?", 3))
    out["none"] = db.query_row("SELECT * FROM item WHERE id = ?", 99)
    out["select"] = [(e.id, e.name, e.price) for e in
                     db.select(Item, "SELECT * FROM item WHERE id < 5")]
    out["updated"] = db.exec("UPDATE item SET price = price * 2 "
                             "WHERE id % 2 = 0").rowcount
    with pytest.raises(RuntimeError):
        with db.begin() as tx:
            tx.exec("DELETE FROM item WHERE id > 5")
            tx.exec("CREATE TABLE scratch (x INTEGER)")
            raise RuntimeError("roll back")
    out["after_rollback"] = _rows(db.query(
        "SELECT count(*) AS n FROM item"))
    out["scratch_tables"] = _rows(db.query(
        "SELECT name FROM sqlite_master WHERE name = 'scratch'"))
    with db.begin() as tx:
        tx.exec("DELETE FROM item WHERE id > 9")
        out["in_tx"] = _rows(tx.query("SELECT count(*) AS n FROM item"))
    out["after_commit"] = _rows(db.query("SELECT id FROM item ORDER BY id"))
    out["health"] = db.health_check()
    db.close()
    out["closed_health"] = db.health_check()["status"]
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sql_statements_rows_select_and_rollback_equal_jax(seed):
    assert _sql_script(port_sql, seed) == _sql_script(jax_sql, seed)


@pytest.mark.parametrize("dialect", ["sqlite", "mysql", "postgres",
                                     "cockroachdb", "supabase", "oracle"])
def test_placeholders_and_identifiers_equal_jax(dialect):
    for n in range(5):
        assert port_sql.placeholders(dialect, n) == \
            jax_sql.placeholders(dialect, n)
        assert port_sql.placeholder(dialect, n + 1) == \
            jax_sql.placeholder(dialect, n + 1)
    for name in ("item", "_x1", "Item_2"):
        assert port_sql.quote_ident(name) == jax_sql.quote_ident(name)
    for bad in ("1abc", "a;drop", "a b", "", "x-y"):
        for mod in (port_sql, jax_sql):
            with pytest.raises(mod.SQLError):
                mod.quote_ident(bad)


def test_sql_outside_a_transaction_waits_for_it_across_threads():
    """The lock covers statements, whole transactions and the health
    probe: many threads on one connection, each inserting and reading in
    and out of transactions, lose no row and see no foreign one."""
    db = port_sql.SQL()
    db.connect()
    db.exec("CREATE TABLE t (thread INTEGER, n INTEGER)")
    errors: list = []

    def work(k: int) -> None:
        try:
            for n in range(20):
                if n % 4 == 0:
                    with db.begin() as tx:
                        tx.exec("INSERT INTO t VALUES (?, ?)", k, n)
                        rows = tx.query(
                            "SELECT count(*) AS c FROM t WHERE thread = ?", k)
                        assert rows[0]["c"] == n + 1
                else:
                    db.exec("INSERT INTO t VALUES (?, ?)", k, n)
                assert db.health_check()["status"] == "UP"
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    assert db.query_row("SELECT count(*) AS c FROM t")["c"] == 8 * 20
    db.close()


def test_new_sql_builds_sqlite_and_degrades_like_jax(tmp_path):
    from gofr_tpu.config import DictConfig as JaxConfig
    from gofr_tpu_torch.config import DictConfig
    name = str(tmp_path / "app.db")
    for make, mod in ((DictConfig, port_sql), (JaxConfig, jax_sql)):
        assert mod.new_sql(make({})) is None
        db = mod.new_sql(make({"DB_DIALECT": "sqlite", "DB_NAME": name}))
        assert db.health_check()["status"] == "UP"
        db.close()
        assert mod.new_sql(make({"DB_DIALECT": "nosuch"})) is None


# ---------------------------------------------------------------- redis
def _redis_script(mod, seed: int) -> list:
    """A seeded sequence of every command without a clock in its answer
    (``ttl`` is read only as present / absent)."""
    rng = np.random.default_rng(seed)
    r = mod.Redis()
    r.connect()
    keys = [f"k{i}" for i in range(4)]
    out = []
    for _ in range(300):
        op = int(rng.integers(0, 17))
        k = keys[int(rng.integers(0, len(keys)))]
        v = f"v{int(rng.integers(0, 50))}"
        try:
            if op == 0:
                out.append(r.set(k, v))
            elif op == 1:
                out.append(r.get(k))
            elif op == 2:
                out.append(r.delete(k))
            elif op == 3:
                out.append(r.exists(*keys))
            elif op == 4:
                out.append(r.incr(k, int(rng.integers(1, 5))))
            elif op == 5:
                out.append(r.hset(k, v, str(rng.integers(0, 9))))
            elif op == 6:
                out.append(r.hgetall(k))
            elif op == 7:
                out.append(r.hdel(k, v))
            elif op == 8:
                out.append(r.rpush(k, v, v + "x"))
            elif op == 9:
                out.append(r.lpush(k, v))
            elif op == 10:
                out.append(r.lrange(k, 0, -1))
            elif op == 11:
                out.append((r.lpop(k), r.rpop(k), r.llen(k)))
            elif op == 12:
                out.append(r.sadd(k, v, v[:2]))
            elif op == 13:
                out.append((sorted(r.smembers(k)), r.sismember(k, v),
                            r.srem(k, v)))
            elif op == 14:
                out.append(sorted(r.keys("k*")))
            elif op == 15:
                out.append((r.expire(k, 1000), r.ttl(k) > 0))
            else:
                out.append(r.decr(k))
        except Exception as exc:  # noqa: BLE001 — the error is the answer
            out.append(("error", type(exc).__name__, str(exc)))
    out.append(r.flushdb())
    out.append(r.keys())
    out.append(r.health_check()["status"])
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_redis_command_sequence_equals_jax(seed):
    assert _redis_script(port_redis, seed) == _redis_script(jax_redis, seed)


def test_new_redis_is_the_embedded_engine():
    from gofr_tpu_torch.config import DictConfig
    assert port_redis.new_redis(DictConfig({})) is None
    r = port_redis.new_redis(DictConfig({"REDIS_HOST": "localhost"}))
    assert isinstance(r, port_redis.Redis)
    assert r.health_check()["status"] == "UP"


# ------------------------------------------------------------------- kv
def _kv_script(store, seed: int) -> list:
    rng = np.random.default_rng(seed)
    store.connect()
    out = []
    for _ in range(200):
        k = f"key{int(rng.integers(0, 6))}"
        op = int(rng.integers(0, 4))
        try:
            if op == 0:
                out.append(store.set(k, f"value{int(rng.integers(0, 99))}"))
            elif op == 1:
                out.append(store.get(k))
            elif op == 2:
                out.append(store.delete(k))
            else:
                out.append(sorted(store.keys()))
        except Exception as exc:  # noqa: BLE001 — the error is the answer
            out.append(("error", type(exc).__name__))
    out.append(store.health_check()["status"])
    store.close()
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_kv_stores_agree_with_jax_and_each_other(seed, tmp_path):
    got = [_kv_script(port_kv.InMemoryKV(), seed),
           _kv_script(port_kv.FileKV(str(tmp_path / "port.db")), seed),
           _kv_script(jax_kv.InMemoryKV(), seed),
           _kv_script(jax_kv.FileKV(str(tmp_path / "jax.db")), seed)]
    assert got[0] == got[1] == got[2] == got[3]


# ---------------------------------------------------------------- files
def _files_script(mod, root, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    fs = mod.LocalFileSystem(str(root))
    fs.connect()
    rows = [{"id": int(i), "name": f"n{int(rng.integers(0, 99))}",
             "ok": bool(rng.integers(0, 2))} for i in range(6)]
    import json
    fs.mkdir("data")
    fs.create("data/rows.json", json.dumps(rows))
    fs.create("data/rows.jsonl", "\n".join(json.dumps(r) for r in rows))
    csv_text = "id,name\n" + "".join(f"{r['id']},{r['name']}\n" for r in rows)
    fs.create("data/rows.csv", csv_text)
    fs.append("data/rows.csv", "99,tail\n")
    fs.rename("data/rows.jsonl", "data/lines.json")
    out = {
        "json": list(fs.read_rows("data/rows.json")),
        "jsonl": list(fs.read_rows("data/lines.json")),
        "csv": list(fs.read_rows("data/rows.csv")),
        "csv_len": len(fs.read_rows("data/rows.csv")),
        "text": fs.read_text("data/rows.csv"),
        "exists": (fs.exists("data/rows.json"), fs.exists("nope")),
        "dir": sorted((f.name, f.size, f.is_dir)
                      for f in fs.read_dir("data")),
        "glob": sorted(fs.glob("data/*.json")),
        "stat": (fs.stat("data/rows.csv").size,
                 fs.stat("data").is_dir),
    }
    for bad in ("../escape.txt", "/etc/passwd"):
        with pytest.raises(mod.FileError):
            fs.read(bad)
    with pytest.raises(mod.FileError):
        mod.RowReader("x", "yaml")
    fs.remove("data/rows.json")
    fs.remove_all("data")
    out["gone"] = fs.exists("data")
    out["health"] = fs.health_check()["status"]
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_file_store_and_row_readers_equal_jax(seed, tmp_path):
    assert _files_script(port_files, tmp_path / "port", seed) == \
        _files_script(jax_files, tmp_path / "jax", seed)


# ----------------------------------------------------------- dbresolver
class _Target:
    """A primary or replica stand-in: answers its name, fails a query
    whose text the caller marks."""

    def __init__(self, name: str, log: list) -> None:
        self.name = name
        self.log = log

    def query(self, query: str, *args):
        self.log.append((self.name, query))
        if f"fail:{self.name}" in query:
            raise RuntimeError(f"{self.name} down")
        return [{"id": 1, "who": self.name}]

    def exec(self, query: str, *args):
        self.log.append((self.name, query))
        return self.name

    def health_check(self):
        return {"status": "UP"}


def _resolver_script(mod, strategy: str, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    log: list = []
    primary = _Target("primary", log)
    replicas = [_Target(f"r{i}", log) for i in range(3)]
    resolver = mod.DBResolver(primary, replicas, strategy=strategy,
                              breaker_threshold=2,
                              breaker_recovery=3600.0)
    random.seed(seed)
    answers = []
    for _ in range(80):
        op = int(rng.integers(0, 5))
        if op == 0:
            answers.append(resolver.exec("INSERT INTO t VALUES (1)"))
        elif op == 1:
            with mod.primary_reads():
                answers.append(resolver.query("SELECT 1")[0]["who"])
        elif op == 2:
            bad = f"r{int(rng.integers(0, 3))}"
            answers.append(resolver.query(f"SELECT 'fail:{bad}'")[0]["who"])
        else:
            answers.append(resolver.query("SELECT * FROM t")[0]["who"])
    return {"answers": answers, "log": log, "stats": dict(resolver.stats),
            "open": [b.opened_at is not None for b in resolver._breakers],
            "failures": [b.failures for b in resolver._breakers],
            "health": resolver.health_check()["status"]}


@pytest.mark.parametrize("strategy", ["round_robin", "random"])
@pytest.mark.parametrize("seed", [0, 1])
def test_dbresolver_routing_and_breakers_equal_jax(strategy, seed):
    assert _resolver_script(port_dbresolver, strategy, seed) == \
        _resolver_script(jax_dbresolver, strategy, seed)


# ---------------------------------------------------------- instrumented
class _Store(Instrumented):
    metric = "app_test_store_stats"
    log_tag = "TEST"

    def op(self, k: int) -> int:
        return self._observed("GET", str(k), lambda: k * 2)


def test_concurrent_first_observations_register_the_histogram_once():
    """Threads racing to register a store's histogram: every op returns
    its own answer and every sample lands in the one histogram."""
    for _ in range(5):
        store = _Store()
        store.use_metrics(Manager())
        barrier = threading.Barrier(16)
        got: dict = {}

        def work(k: int) -> None:
            barrier.wait()
            got[k] = store.op(k)

        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert got == {k: 2 * k for k in range(16)}
        assert store.metrics.get_histogram_count("app_test_store_stats",
                                                 type="get") == 16

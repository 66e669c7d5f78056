"""Columnar/CQL family: Cassandra-, ScyllaDB-, Clickhouse- and
Oracle-shaped stores over an embedded sqlite engine.

The reference's canonical interfaces live in container/datasources.go
(Cassandra :42 with batch/ctx variants :122-188, Clickhouse :196,
Oracle :210, ScyllaDB :600) and are backed by gocql/clickhouse-go/
go-ora drivers in their own modules. The statement surface of those
interfaces — ``query`` (select into destinations), ``exec`` (mutate),
``batch`` (atomic multi-statement) — is implemented here over sqlite,
whose SQL dialect covers the CQL/SQL subset those drivers speak; a
production deployment swaps the engine for a cluster client behind the
same interface.

The port's copy of ``gofr_tpu/datasource/columnar.py``.
"""

from __future__ import annotations

import re
import sqlite3
import threading
from typing import Any

from . import Instrumented


class ColumnarError(Exception):
    pass


class BatchNotInitialised(ColumnarError):
    def __init__(self, name: str) -> None:
        super().__init__(f"batch {name!r} not initialised; call new_batch")


_CQL_UNSUPPORTED = re.compile(
    r"\b(ALLOW\s+FILTERING|USING\s+TTL\s+\d+)\b", re.IGNORECASE)


class _CQLStore(Instrumented):
    """Cassandra-shaped statement API over sqlite (reference
    container/datasources.go:42-120; batch ops :122-188)."""

    backend_name = "cql"

    def __init__(self, keyspace: str = "default",
                 path: str = ":memory:") -> None:
        self.keyspace = keyspace
        self.path = path
        self._conn: sqlite3.Connection | None = None
        self._lock = threading.RLock()
        self._batches: dict[str, list[tuple[str, tuple]]] = {}

    def connect(self) -> None:
        self._conn = sqlite3.connect(self.path, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        if self.logger is not None:
            self.logger.info(f"connected {self.backend_name}",
                             keyspace=self.keyspace)

    def _require(self) -> sqlite3.Connection:
        if self._conn is None:
            raise ColumnarError(f"{self.backend_name} not connected")
        return self._conn

    @staticmethod
    def _translate(stmt: str) -> str:
        # strip CQL-only clauses sqlite rejects so gocql-style statements run
        return _CQL_UNSUPPORTED.sub("", stmt).strip()

    # -- statement surface
    def query(self, stmt: str, *args: Any) -> list[dict]:
        """SELECT; rows come back as dicts (the reference scans into
        destination structs — dicts are the Python analog)."""
        def op():
            with self._lock:
                cur = self._require().execute(self._translate(stmt), args)
                return [dict(r) for r in cur.fetchall()]
        return self._observed("QUERY", stmt.split(None, 1)[0], op)

    def exec(self, stmt: str, *args: Any) -> None:
        def op():
            with self._lock:
                conn = self._require()
                conn.execute(self._translate(stmt), args)
                conn.commit()
        self._observed("EXEC", stmt.split(None, 1)[0], op)

    # context-variant aliases (reference WithContext methods :122-188)
    query_with_ctx = query
    exec_with_ctx = exec

    # -- batches (reference :146-188)
    def new_batch(self, name: str, _batch_type: int = 0) -> None:
        with self._lock:
            self._batches[name] = []

    def batch_query(self, name: str, stmt: str, *args: Any) -> None:
        with self._lock:
            if name not in self._batches:
                raise BatchNotInitialised(name)
            self._batches[name].append((self._translate(stmt), args))

    def execute_batch(self, name: str) -> None:
        def op():
            with self._lock:
                if name not in self._batches:
                    raise BatchNotInitialised(name)
                stmts = self._batches.pop(name)
                conn = self._require()
                try:
                    for stmt, args in stmts:
                        conn.execute(stmt, args)
                    conn.commit()
                except Exception:
                    conn.rollback()
                    raise
        self._observed("BATCH", name, op)

    def health_check(self) -> dict[str, Any]:
        try:
            with self._lock:
                self._require().execute("SELECT 1")
            return {"status": "UP", "details": {"backend": self.backend_name,
                                                "keyspace": self.keyspace}}
        except Exception as exc:
            return {"status": "DOWN", "error": str(exc)}

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None


class Cassandra(_CQLStore):
    metric = "app_cassandra_stats"
    log_tag = "CQL"
    backend_name = "cassandra"


class ScyllaDB(_CQLStore):
    """Same statement surface as Cassandra (reference
    container/datasources.go:600-635)."""

    metric = "app_scylladb_stats"
    log_tag = "SCYLLA"
    backend_name = "scylladb"


class Clickhouse(_CQLStore):
    """Clickhouse-shaped surface (reference container/datasources.go:196-208):
    exec / select-into / async-insert."""

    metric = "app_clickhouse_stats"
    log_tag = "CH"
    backend_name = "clickhouse"

    def select(self, stmt: str, *args: Any) -> list[dict]:
        return self.query(stmt, *args)

    def async_insert(self, stmt: str, *args: Any) -> None:
        # the embedded engine commits synchronously; the interface point
        # is fire-and-forget semantics, which exec satisfies
        self.exec(stmt, *args)


class Oracle(_CQLStore):
    """Oracle-shaped surface (reference container/datasources.go:210-230),
    including the transactional migration hook the oracle module adds
    (datasource/oracle/migration/migration.go:26). This is the
    embedded-engine variant; :mod:`.oracle_wire` is the network client
    (TNS transport + O5LOGON-style auth) with the same bar as the other
    wire clients."""

    metric = "app_oracle_stats"
    log_tag = "ORA"
    backend_name = "oracle"

    def select(self, stmt: str, *args: Any) -> list[dict]:
        return self.query(stmt, *args)

    def begin(self) -> "OracleTx":
        return OracleTx(self)


class OracleTx:
    """Explicit transaction wrapper used by migrations."""

    def __init__(self, store: Oracle) -> None:
        self._store = store
        self._stmts: list[tuple[str, tuple]] = []

    def exec(self, stmt: str, *args: Any) -> None:
        self._stmts.append((stmt, args))

    def commit(self) -> None:
        name = f"__tx_{id(self)}"
        self._store.new_batch(name)
        for stmt, args in self._stmts:
            self._store.batch_query(name, stmt, *args)
        self._store.execute_batch(name)
        self._stmts.clear()

    def rollback(self) -> None:
        self._stmts.clear()

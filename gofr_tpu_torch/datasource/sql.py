"""Instrumented SQL datasource (the port's copy of
``gofr_tpu/datasource/sql.py``).

The analog of reference ``datasource/sql`` (sql.go:74, db.go:20): a
dialect-aware connection whose every ``query``/``exec`` emits a
structured ``QueryLog`` and an ``app_sql_stats`` histogram sample
(db.go:47-60), plus an ORM-lite ``select`` that maps rows into
dataclasses (db.go:214) and a transaction wrapper (db.go:124).

Backends: sqlite (stdlib, always available), network postgres-family
servers via :class:`~gofr_tpu_torch.datasource.postgres_wire.PostgresWire`
(the v3 wire protocol, ``DB_DIALECT=postgres`` + ``DB_HOST``), network
mysql servers via :class:`~gofr_tpu_torch.datasource.mysql_wire.MySQLWire`
(``DB_DIALECT=mysql`` + ``DB_HOST``) and oracle via
:class:`~gofr_tpu_torch.datasource.oracle_wire.OracleWire` (TNS,
``DB_DIALECT=oracle`` + ``DB_HOST``). All dialects share the query
builder and auto-CRUD (placeholder style, AUTOINCREMENT spelling).
One ``RLock`` serializes every use of the sqlite connection: statements,
whole transactions, the health probe and ``close``, since the port's
plain handlers each run on a thread of their own.
"""

from __future__ import annotations

import contextvars
import re
import sqlite3
import threading
import time
from dataclasses import dataclass, fields, is_dataclass
from typing import Any, Iterator, Sequence

from contextlib import contextmanager

from . import ProviderMixin

# identifies the task/thread context that owns an open transaction, so
# interleaved async handlers on one event-loop thread can't stomp it
_CURRENT_TX: contextvars.ContextVar[object | None] = \
    contextvars.ContextVar("gofr_sql_tx", default=None)

DIALECT_SQLITE = "sqlite"
DIALECT_MYSQL = "mysql"
DIALECT_POSTGRES = "postgres"
DIALECT_COCKROACH = "cockroachdb"
DIALECT_SUPABASE = "supabase"
DIALECT_ORACLE = "oracle"  # network wire client only (oracle_wire)

_DIALECTS = (DIALECT_SQLITE, DIALECT_MYSQL, DIALECT_POSTGRES,
             DIALECT_COCKROACH, DIALECT_SUPABASE)

# dialects whose driver placeholder is $N (postgres family)
_DOLLAR_PLACEHOLDER = (DIALECT_POSTGRES, DIALECT_COCKROACH, DIALECT_SUPABASE)


class SQLError(Exception):
    pass


@dataclass
class QueryLog:
    """One executed statement (reference sql/db.go QueryLog)."""

    query: str
    duration_us: int
    args: tuple = ()

    def pretty_print(self) -> str:
        return f"SQL {self.duration_us:8d}µs {self.query}"


def placeholder(dialect: str, n: int) -> str:
    """The n-th (1-based) bind placeholder for a dialect
    (reference sql/query_builder.go)."""
    if dialect in _DOLLAR_PLACEHOLDER:
        return f"${n}"
    if dialect == DIALECT_ORACLE:
        return f":{n}"
    return "?"


def placeholders(dialect: str, count: int) -> str:
    return ", ".join(placeholder(dialect, i + 1) for i in range(count))


_IDENT_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def quote_ident(name: str) -> str:
    """Validate-and-quote an identifier destined for SQL text.

    Auto-CRUD builds statements from dataclass field names; this is the
    single gate that keeps those from becoming injection vectors.
    """
    if not _IDENT_RE.match(name):
        raise SQLError(f"invalid SQL identifier: {name!r}")
    return name


class Tx:
    """Transaction handle (reference sql/db.go:124)."""

    def __init__(self, db: "SQL") -> None:
        self._db = db

    def query(self, query: str, *args: Any) -> list[sqlite3.Row]:
        return self._db.query(query, *args)

    def query_row(self, query: str, *args: Any) -> sqlite3.Row | None:
        return self._db.query_row(query, *args)

    def exec(self, query: str, *args: Any) -> sqlite3.Cursor:
        # no per-statement commit: begin() commits/rolls back the batch
        return self._db._execute(query, args, commit=False)

    def ph(self, n: int) -> str:
        return self._db.ph(n)

    def select(self, entity_type: type, query: str, *args: Any) -> list[Any]:
        return self._db.select(entity_type, query, *args)


class SQL(ProviderMixin):
    """Connection + instrumentation (reference sql/db.go:20)."""

    def __init__(self, *, dialect: str = DIALECT_SQLITE,
                 database: str = ":memory:") -> None:
        if dialect not in _DIALECTS:
            raise SQLError(f"unsupported dialect {dialect!r}; "
                           f"one of {_DIALECTS}")
        self.dialect = dialect
        self.database = database
        self._conn: sqlite3.Connection | None = None
        # sqlite connections are not thread-safe; handlers run on a
        # thread pool, so serialize at the wrapper
        self._lock = threading.RLock()
        self._tx_token: object | None = None

    def connect(self) -> None:
        if self.dialect != DIALECT_SQLITE:
            raise SQLError(
                f"no driver for dialect {self.dialect!r} in this build; "
                "sqlite is the shipped backend")
        # isolation_level=None -> true autocommit; begin() issues an
        # explicit BEGIN so DDL rides the transaction too (sqlite's
        # legacy implicit-BEGIN mode auto-commits DDL, which would make
        # "transactional migrations" silently non-transactional)
        conn = sqlite3.connect(self.database, check_same_thread=False,
                               isolation_level=None)
        conn.row_factory = sqlite3.Row
        with self._lock:
            self._conn = conn
        if self.logger is not None:
            self.logger.info("connected to SQL",
                             dialect=self.dialect, database=self.database)

    # ----------------------------------------------------- instrumented
    def _observe(self, query: str, args: tuple, start: float) -> None:
        duration_us = int((time.perf_counter() - start) * 1e6)
        if self.logger is not None:
            self.logger.debug(QueryLog(query, duration_us, args).pretty_print())
        if self.metrics is not None:
            self.metrics.record_histogram("app_sql_stats", duration_us / 1e6,
                                          type=query.split(None, 1)[0].lower()
                                          if query.split() else "unknown")

    def ph(self, n: int) -> str:
        """The n-th (1-based) bind placeholder for this dialect."""
        return placeholder(self.dialect, n)

    def _require_conn(self) -> sqlite3.Connection:
        if self._conn is None:
            raise SQLError("SQL not connected; call connect() first")
        return self._conn

    def _guard_tx(self) -> None:
        """Call with the lock held. The RLock is thread-keyed, so it
        can't protect an open transaction from other asyncio tasks
        interleaving on the same loop thread; the context-var token
        closes that hole. Cross-thread callers never see it — they
        block on the lock until the transaction releases it."""
        if (self._tx_token is not None
                and _CURRENT_TX.get() is not self._tx_token):
            raise SQLError(
                "a transaction is open on this connection from another "
                "task; run this statement inside that begin() block or "
                "after it commits")

    def query(self, query: str, *args: Any) -> list[sqlite3.Row]:
        conn = self._require_conn()
        start = time.perf_counter()
        span = self.tracer.start_span(f"sql {query.split(None, 1)[0]}") \
            if self.tracer is not None else None
        try:
            with self._lock:
                self._guard_tx()
                cur = conn.execute(query, args)
                return cur.fetchall()
        finally:
            if span is not None:
                span.end()
            self._observe(query, args, start)

    def query_row(self, query: str, *args: Any) -> sqlite3.Row | None:
        rows = self.query(query, *args)
        return rows[0] if rows else None

    def exec(self, query: str, *args: Any) -> sqlite3.Cursor:
        return self._execute(query, args, commit=True)

    def _execute(self, query: str, args: tuple,
                 commit: bool) -> sqlite3.Cursor:
        conn = self._require_conn()
        start = time.perf_counter()
        try:
            with self._lock:
                if commit:
                    self._guard_tx()
                cur = conn.execute(query, args)
                if commit:
                    conn.commit()
                return cur
        finally:
            self._observe(query, args, start)

    @contextmanager
    def begin(self) -> Iterator[Tx]:
        """Transaction with commit-on-success / rollback-on-raise
        (reference sql/db.go:124, migration/migration.go:68-97)."""
        conn = self._require_conn()
        with self._lock:
            token = object()
            self._tx_token = token
            ctx_token = _CURRENT_TX.set(token)
            conn.execute("BEGIN IMMEDIATE")
            try:
                yield Tx(self)
                conn.execute("COMMIT")
            except BaseException:
                conn.execute("ROLLBACK")
                raise
            finally:
                self._tx_token = None
                _CURRENT_TX.reset(ctx_token)

    # ---------------------------------------------------------- ORM-lite
    def select(self, entity_type: type, query: str, *args: Any) -> list[Any]:
        """Map rows into dataclass instances by field name
        (reference sql/db.go:214 reflection Select)."""
        if not is_dataclass(entity_type):
            raise SQLError("select requires a dataclass type")
        names = [f.name for f in fields(entity_type)]
        out = []
        for row in self.query(query, *args):
            keys = set(row.keys())
            out.append(entity_type(**{n: row[n] for n in names if n in keys}))
        return out

    # ------------------------------------------------------------ health
    def health_check(self) -> dict[str, Any]:
        try:
            with self._lock:
                self._require_conn().execute("SELECT 1")
            return {"status": "UP", "details": {"dialect": self.dialect,
                                                "database": self.database}}
        except Exception as exc:
            return {"status": "DOWN", "error": str(exc)}

    def close(self) -> None:
        with self._lock:
            if self._conn is not None:
                self._conn.close()
                self._conn = None


def new_sql(config: Any, logger: Any = None, metrics: Any = None,
            tracer: Any = None) -> SQL | None:
    """Env-driven constructor (reference sql/sql.go:74): returns None
    when DB_DIALECT is unset. A configured-but-unconnectable database
    logs and degrades instead of failing the whole boot, matching the
    reference's log-and-retry connect loop."""
    dialect = config.get("DB_DIALECT") if config else None
    if not dialect:
        return None
    host = config.get("DB_HOST")
    if dialect == DIALECT_ORACLE and not host:
        # the embedded engine has no oracle mode — surface the actual
        # misconfiguration, not an "unsupported dialect" red herring
        if logger is not None:
            logger.error("SQL disabled: DB_DIALECT=oracle requires "
                         "DB_HOST (the TNS wire client)")
        return None
    if host and (dialect in _DOLLAR_PLACEHOLDER
                 or dialect in (DIALECT_MYSQL, DIALECT_ORACLE)):
        # a network server: dial it over the real wire protocol
        # (reference sql.go:74 does this via lib/pq / go-sql-driver;
        # oracle rides its own wire module, TNS + O5LOGON)
        default_port = {DIALECT_MYSQL: "3306",
                        DIALECT_ORACLE: "1521"}.get(dialect, "5432")
        try:
            port = int(config.get_or_default("DB_PORT",
                                             default_port).strip())
        except ValueError:
            if logger is not None:
                logger.error("SQL disabled: DB_PORT is not an integer")
            return None
        user = config.get_or_default(
            "DB_USER", {DIALECT_MYSQL: "root",
                        DIALECT_ORACLE: "system"}.get(dialect, "postgres"))
        password = config.get_or_default("DB_PASSWORD", "")
        name = config.get_or_default(
            "DB_NAME", {DIALECT_MYSQL: "",
                        DIALECT_ORACLE: "FREEPDB1"}.get(dialect,
                                                        "postgres"))
        if dialect == DIALECT_MYSQL:
            from .mysql_wire import MySQLWire
            db: Any = MySQLWire(host=host, port=port, user=user,
                                password=password, database=name)
        elif dialect == DIALECT_ORACLE:
            from .oracle_wire import OracleWire
            db = OracleWire(host=host, port=port, username=user,
                            password=password, service_name=name)
        else:
            from .postgres_wire import PostgresWire
            db = PostgresWire(host=host, port=port, user=user,
                              password=password, database=name)
        for use, obj in (("use_logger", logger), ("use_metrics", metrics),
                         ("use_tracer", tracer)):
            if obj is not None:
                getattr(db, use)(obj)
        try:
            db.connect()
        except Exception as exc:
            if logger is not None:
                logger.error(f"SQL connect failed: {exc}")
            return None
        return db
    try:
        db = SQL(dialect=dialect,
                 database=config.get_or_default("DB_NAME", ":memory:"))
    except SQLError as exc:
        if logger is not None:
            logger.error(f"SQL disabled: {exc}")
        return None
    if logger is not None:
        db.use_logger(logger)
    if metrics is not None:
        db.use_metrics(metrics)
    if tracer is not None:
        db.use_tracer(tracer)
    try:
        db.connect()
    except SQLError as exc:
        if logger is not None:
            logger.error(f"SQL connect failed: {exc}")
        return None
    return db


def scan_rows(rows: Sequence[sqlite3.Row]) -> list[dict[str, Any]]:
    """Rows → list of dicts (JSON-ready)."""
    return [dict(r) for r in rows]

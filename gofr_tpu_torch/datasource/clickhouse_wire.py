"""ClickHouse network client speaking the HTTP interface, plus a mini
server.

The reference's ClickHouse module is a driver-backed network client
(container/datasources.go:196-208 over clickhouse-go). This client
speaks the database's HTTP interface directly — SQL in the POST body,
``FORMAT JSONEachRow`` result streaming, ``?`` placeholders expanded
to escaped literals client-side (the technique the HTTP interface
requires) — behind the same exec/select/async_insert surface as the
embedded :class:`~gofr_tpu_torch.datasource.columnar.Clickhouse` adapter, so
swapping is a constructor change.

:class:`MiniClickhouseServer` serves the HTTP interface over the
embedded adapter on the framework's HTTP server.

The port's copy of ``gofr_tpu/datasource/clickhouse_wire.py``.
"""

from __future__ import annotations

import json
import re
import urllib.parse
import urllib.request
from typing import Any

from . import Instrumented
from .columnar import Clickhouse, ColumnarError
from .miniserver import ThreadedHTTPMiniServer


class ClickhouseWireError(ColumnarError):
    pass


def _literal(value: Any) -> str:
    """Render one bind value as a ClickHouse SQL literal."""
    if value is None:
        return "NULL"
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, (int, float)):
        return str(value)
    if isinstance(value, bytes):
        value = value.decode("utf-8", "replace")
    text = str(value).replace("\\", "\\\\").replace("'", "\\'")
    return f"'{text}'"


def expand_placeholders(stmt: str, args: tuple) -> str:
    """``?`` -> escaped literals, skipping quoted string literals."""
    out: list[str] = []
    it = iter(args)
    in_string = False
    i = 0
    while i < len(stmt):
        ch = stmt[i]
        if in_string:
            out.append(ch)
            if ch == "\\" and i + 1 < len(stmt):
                out.append(stmt[i + 1])
                i += 1
            elif ch == "'":
                in_string = False
        elif ch == "'":
            in_string = True
            out.append(ch)
        elif ch == "?":
            try:
                out.append(_literal(next(it)))
            except StopIteration:
                raise ClickhouseWireError(
                    "more ? placeholders than arguments") from None
        else:
            out.append(ch)
        i += 1
    leftover = sum(1 for _ in it)
    if leftover:
        raise ClickhouseWireError(f"{leftover} unused bind arguments")
    return "".join(out)


class ClickhouseWire(Instrumented):
    """HTTP-interface client with the embedded adapter's verbs
    (query/select/exec/async_insert)."""

    metric = "app_clickhouse_stats"
    log_tag = "CH"

    def __init__(self, *, endpoint: str = "http://localhost:8123",
                 database: str = "default", username: str = "",
                 password: str = "", timeout_s: float = 30.0) -> None:
        if "://" not in endpoint:
            endpoint = "http://" + endpoint
        self.endpoint = endpoint.rstrip("/")
        self.database = database
        self.username = username
        self.password = password
        self.timeout_s = timeout_s

    def connect(self) -> None:
        if self.logger is not None:
            self.logger.info("connected to clickhouse",
                             endpoint=self.endpoint, database=self.database)

    def close(self) -> None:
        pass  # per-request connections

    def _call(self, sql: str) -> tuple[int, bytes]:
        params = {"database": self.database}
        url = self.endpoint + "/?" + urllib.parse.urlencode(params)
        headers = {"Content-Type": "text/plain"}
        if self.username:
            headers["X-ClickHouse-User"] = self.username
            headers["X-ClickHouse-Key"] = self.password
        req = urllib.request.Request(url, data=sql.encode(), method="POST",
                                     headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as exc:
            return exc.code, exc.read()

    # ----------------------------------------------------- native verbs
    def query(self, stmt: str, *args: Any) -> list[dict]:
        def op():
            sql = expand_placeholders(stmt, args)
            # only a real trailing FORMAT clause counts — 'format' in an
            # identifier or literal must not suppress JSONEachRow
            if not re.search(r"\bformat\s+\w+\s*$", sql,
                             re.IGNORECASE):
                sql += " FORMAT JSONEachRow"
            status, data = self._call(sql)
            if status != 200:
                raise ClickhouseWireError(
                    f"query -> {status}: {data[:200].decode('utf-8', 'replace')}")
            return [json.loads(line) for line in data.splitlines() if line]
        return self._observed("QUERY", stmt.split(None, 1)[0], op)

    def select(self, stmt: str, *args: Any) -> list[dict]:
        return self.query(stmt, *args)

    def exec(self, stmt: str, *args: Any) -> None:
        def op():
            status, data = self._call(expand_placeholders(stmt, args))
            if status != 200:
                raise ClickhouseWireError(
                    f"exec -> {status}: {data[:200].decode('utf-8', 'replace')}")
        self._observed("EXEC", stmt.split(None, 1)[0], op)

    def async_insert(self, stmt: str, *args: Any) -> None:
        # the HTTP interface point is fire-and-forget; exec satisfies it
        self.exec(stmt, *args)

    def health_check(self) -> dict[str, Any]:
        try:
            status, data = self._call("SELECT 1")
            return {"status": "UP" if status == 200 else "DOWN",
                    "details": {"endpoint": self.endpoint,
                                "database": self.database}}
        except Exception as exc:
            return {"status": "DOWN", "error": str(exc)}


# ------------------------------------------------------------- mini server

_FORMAT_SUFFIX = " FORMAT JSONEACHROW"


def _ch_to_sqlite(sql: str) -> str:
    """Translate ClickHouse string-literal escapes (backslash style)
    into sqlite's doubled-quote style, so the mini server lexes
    literals the way real ClickHouse does."""
    out: list[str] = []
    in_string = False
    i = 0
    while i < len(sql):
        ch = sql[i]
        if not in_string:
            out.append(ch)
            if ch == "'":
                in_string = True
        elif ch == "\\" and i + 1 < len(sql):
            nxt = sql[i + 1]
            out.append("''" if nxt == "'" else nxt)
            i += 1
        elif ch == "'":
            in_string = False
            out.append(ch)
        else:
            out.append(ch)
        i += 1
    return "".join(out)


class MiniClickhouseServer(ThreadedHTTPMiniServer):
    """The ClickHouse HTTP interface over the embedded adapter."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        super().__init__(host, port)
        self.store = Clickhouse()
        self.store.connect()

    def handle(self, request) -> tuple[int, bytes, str]:
        sql = (request.body or b"").decode().strip()
        if not sql:
            sql = request.param("query") or ""
        if not sql:
            return 400, b"no query", "text/plain"
        wants_json = sql.upper().endswith(_FORMAT_SUFFIX)
        if wants_json:
            sql = sql[:-len(_FORMAT_SUFFIX)].rstrip()
        sql = _ch_to_sqlite(sql)
        try:
            word = sql.split(None, 1)[0].upper() if sql.split() else ""
            if word in ("SELECT", "WITH", "SHOW"):
                rows = self.store.query(sql)
                body = "\n".join(json.dumps(r) for r in rows)
                return 200, body.encode(), "application/x-ndjson"
            self.store.exec(sql)
            return 200, b"", "text/plain"
        except Exception as exc:
            return 400, f"Code: 62. DB::Exception: {exc}".encode(), \
                "text/plain"

"""SurrealDB network client speaking the WebSocket JSON-RPC protocol,
plus a mini server.

The reference's SurrealDB module is a driver-backed network client
(container/datasources.go:302-344 over surrealdb.go). This client
speaks the database's WS surface directly — RFC 6455 upgrade to
``/rpc`` (the framework's own websocket layer), then JSON-RPC:
``signin`` → ``use`` → ``create``/``select``/``update``/``delete``/
``query`` with request-id-matched responses — behind the same method
surface as the embedded
:class:`~gofr_tpu_torch.datasource.graph.SurrealDB` adapter, so swapping is
a constructor change. ``query`` generates real SurrealQL
(``SELECT * FROM type::table($tb) WHERE field = $field``) with bound
variables.

:class:`MiniSurrealServer` is a framework :class:`~gofr_tpu_torch.app.App`
serving ``/rpc`` over the same websocket runtime — per-connection
signin state, the RPC method set, and the SurrealQL subset the client
emits.

The port's copy of ``gofr_tpu/datasource/surreal_wire.py``.
"""

from __future__ import annotations

import asyncio
import itertools
import re
import threading
from typing import Any

from . import Instrumented
from .graph import GraphEngine, GraphError, SurrealDB


class SurrealWireError(GraphError):
    pass


class SurrealWire(Instrumented):
    """WS JSON-RPC client with the embedded adapter's verbs
    (create/select/update/delete/query)."""

    metric = "app_surrealdb_stats"
    log_tag = "SURREAL"

    def __init__(self, *, endpoint: str = "ws://localhost:8000/rpc",
                 namespace: str = "app", database: str = "app",
                 username: str = "root", password: str = "",
                 timeout_s: float = 30.0) -> None:
        if "://" not in endpoint:
            endpoint = "ws://" + endpoint
        if not endpoint.endswith("/rpc"):
            endpoint = endpoint.rstrip("/") + "/rpc"
        self.endpoint = endpoint
        self.namespace = namespace
        self.database = database
        self.username = username
        self.password = password
        self.timeout_s = timeout_s
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._conn: Any = None
        self._ids = itertools.count(1)
        self._lock = threading.RLock()

    # ------------------------------------------------------------ lifecycle
    def connect(self) -> None:
        if self._loop is not None:
            self.close()
        ready = threading.Event()

        def run() -> None:
            loop = asyncio.new_event_loop()
            self._loop = loop
            asyncio.set_event_loop(loop)
            ready.set()
            try:
                loop.run_forever()
            finally:
                loop.close()  # release the selector fd

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="surreal-wire")
        self._thread.start()
        ready.wait(5)

        try:
            from ..websocket.service import connect as ws_connect
            self._conn = self._run(ws_connect(self.endpoint,
                                              timeout=self.timeout_s))
            if self.username:
                self._rpc("signin", [{"user": self.username,
                                      "pass": self.password}])
            self._rpc("use", [self.namespace, self.database])
        except BaseException:
            # a failed connect must not strand the loop thread — each
            # reconnect attempt would otherwise leak a thread + fd
            self.close()
            raise
        if self.logger is not None:
            self.logger.info("connected to surrealdb",
                             endpoint=self.endpoint, ns=self.namespace,
                             db=self.database)

    def _run(self, coro):
        assert self._loop is not None
        future = asyncio.run_coroutine_threadsafe(coro, self._loop)
        return future.result(self.timeout_s)

    def _rpc(self, method: str, params: list[Any]) -> Any:
        with self._lock:
            if self._conn is None:
                raise SurrealWireError("not connected; call connect() first")
            req_id = next(self._ids)

            async def round_trip():
                await self._conn.send({"id": req_id, "method": method,
                                       "params": params})
                while True:
                    message = await self._conn.recv()
                    if message is None:
                        raise SurrealWireError("connection closed")
                    import json
                    payload = json.loads(message.text())
                    if payload.get("id") == req_id:
                        return payload

            try:
                payload = self._run(round_trip())
            except (OSError, TimeoutError, asyncio.TimeoutError) as exc:
                self.close()  # poisoned stream: unconsumed responses
                raise SurrealWireError(
                    f"connection lost mid-call ({exc})") from exc
        if "error" in payload and payload["error"]:
            err = payload["error"]
            raise SurrealWireError(
                f"{err.get('message', err)} (code {err.get('code')})")
        return payload.get("result")

    def close(self) -> None:
        loop, conn = self._loop, self._conn
        self._conn = None
        self._loop = None
        if loop is not None:
            if conn is not None:
                try:
                    asyncio.run_coroutine_threadsafe(
                        conn.close(), loop).result(2)
                except Exception:
                    pass
            loop.call_soon_threadsafe(loop.stop)
            if self._thread is not None:
                self._thread.join(5)
                self._thread = None

    # ----------------------------------------------------- native verbs
    def create(self, thing: str, data: dict) -> dict:
        return self._observed(
            "CREATE", thing.partition(":")[0],
            lambda: self._rpc("create", [thing, data]))

    def select(self, thing: str) -> list[dict]:
        def op():
            result = self._rpc("select", [thing])
            return result if isinstance(result, list) else [result]
        return self._observed("SELECT", thing.partition(":")[0], op)

    def update(self, thing: str, data: dict) -> dict:
        return self._observed(
            "UPDATE", thing.partition(":")[0],
            lambda: self._rpc("update", [thing, data]))

    def delete(self, thing: str) -> None:
        self._observed("DELETE", thing.partition(":")[0],
                       lambda: self._rpc("delete", [thing]))

    def query(self, table: str, flt: dict | None = None) -> list[dict]:
        """Generates real SurrealQL with bound variables. Field names
        ride in the statement text, so they are validated — values are
        always bound."""
        def op():
            sql = "SELECT * FROM type::table($tb)"
            variables: dict[str, Any] = {"tb": table}
            for i, (key, value) in enumerate(sorted((flt or {}).items())):
                if not re.fullmatch(r"\w+", str(key)):
                    raise SurrealWireError(
                        f"invalid field name {key!r}")
                sql += (" WHERE" if i == 0 else " AND") \
                    + f" {key} = $p{i}"
                variables[f"p{i}"] = value
            result = self._rpc("query", [sql, variables])
            # surreal returns one {status, result} envelope per statement
            first = result[0] if isinstance(result, list) and result else {}
            if first.get("status") not in (None, "OK"):
                raise SurrealWireError(str(first.get("result")))
            return first.get("result", [])
        return self._observed("QUERY", table, op)

    def health_check(self) -> dict[str, Any]:
        try:
            self._rpc("ping", [])
            return {"status": "UP",
                    "details": {"endpoint": self.endpoint,
                                "ns": self.namespace,
                                "db": self.database}}
        except Exception as exc:
            return {"status": "DOWN", "error": str(exc)}


# ------------------------------------------------------------- mini server

_SELECT_RE = re.compile(
    r"SELECT \* FROM type::table\(\$tb\)"
    r"(?P<where>( (?:WHERE|AND) \w+ = \$\w+)*)$")


class MiniSurrealServer:
    """A framework App serving the SurrealDB RPC surface at ``/rpc``
    over the framework's own websocket runtime. Connections must
    ``signin`` (when a password is configured) before data methods."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 username: str = "root", password: str = "") -> None:
        self.host = host
        self.port = port
        self.username = username
        self.password = password
        self.store = SurrealDB(GraphEngine())
        self._app: Any = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None

    # --------------------------------------------------------- dispatch
    def _dispatch(self, conn: Any, method: str,
                  params: list[Any]) -> Any:
        if method == "ping":
            return True
        if method == "signin":
            cred = params[0] if params else {}
            if (isinstance(cred, dict)
                    and cred.get("user") == self.username
                    and cred.get("pass") == self.password):
                # auth state lives on the connection object itself —
                # conn ids are client-supplied (Sec-WebSocket-Key) and
                # therefore forgeable/collidable
                conn._surreal_authed = True
                return "token"
            raise SurrealWireError("invalid credentials")
        if method == "use":  # allowed pre-signin, like real surreal
            return None
        if self.password and not getattr(conn, "_surreal_authed", False):
            raise SurrealWireError("not signed in")
        if method == "create":
            return self.store.create(params[0], params[1])
        if method == "select":
            return self.store.select(params[0])
        if method == "update":
            return self.store.update(params[0], params[1])
        if method == "delete":
            self.store.delete(params[0])
            return None
        if method == "query":
            return self._query(params[0],
                               params[1] if len(params) > 1 else {})
        raise SurrealWireError(f"unknown method {method!r}")

    def _query(self, sql: str, variables: dict) -> list[dict]:
        match = _SELECT_RE.match(sql.strip())
        if not match or "tb" not in variables:
            raise SurrealWireError(f"unsupported SurrealQL: {sql!r}")
        flt = {}
        for cond in re.finditer(r"(\w+) = \$(\w+)", match.group("where")):
            field, var = cond.groups()
            if var not in variables:
                raise SurrealWireError(f"unbound variable ${var}")
            flt[field] = variables[var]
        rows = self.store.query(variables["tb"], flt or None)
        return [{"status": "OK", "result": rows}]

    # -------------------------------------------------------- lifecycle
    def start(self) -> None:
        from ..config import DictConfig
        from ..app import App

        app = App(config=DictConfig({"HTTP_PORT": "0", "METRICS_PORT": "0",
                                     "APP_NAME": "mini-surreal",
                                     "LOG_LEVEL": "ERROR"}))
        outer = self

        @app.websocket("/rpc")
        def rpc(ctx):
            import json
            payload = ctx.bind()
            if not isinstance(payload, dict):
                payload = json.loads(payload)
            req_id = payload.get("id")
            try:
                result = outer._dispatch(ctx._ws_conn,
                                         payload.get("method", ""),
                                         payload.get("params") or [])
                return {"id": req_id, "result": result}
            except GraphError as exc:
                return {"id": req_id,
                        "error": {"code": -32000, "message": str(exc)}}
            except Exception as exc:
                # malformed params must yield a JSON-RPC error, not a
                # dropped reply that stalls the client's recv loop
                return {"id": req_id,
                        "error": {"code": -32602,
                                  "message": f"invalid params: {exc!r}"}}

        self._app = app
        started = threading.Event()
        error: list[BaseException] = []

        def run() -> None:
            loop = asyncio.new_event_loop()
            self._loop = loop
            asyncio.set_event_loop(loop)

            async def main():
                await app.start()
                started.set()  # only after a successful bind
                await app._stop_event.wait()

            try:
                loop.run_until_complete(main())
            except BaseException as exc:  # surfaced to start()
                error.append(exc)
                started.set()  # after the append — start() reads both
            finally:
                loop.close()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="mini-surreal")
        self._thread.start()
        if not started.wait(10):
            raise SurrealWireError("mini surreal server did not start")
        if error:
            raise error[0]
        self.port = app.http_server.bound_port

    def close(self) -> None:
        if self._loop is not None and self._loop.is_running():
            asyncio.run_coroutine_threadsafe(self._app.stop(),
                                             self._loop).result(10)
        if self._thread is not None:
            self._thread.join(10)
            self._thread = None
        self._loop = None

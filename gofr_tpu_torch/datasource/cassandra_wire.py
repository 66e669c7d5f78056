"""Cassandra network client speaking the CQL native protocol v4, plus
a mini server.

The reference's Cassandra module is a driver-backed network client
(container/datasources.go:42-188 over gocql). This client implements
the native protocol itself over a TCP socket: the 9-byte frame header
(version/flags/stream/opcode/length), STARTUP → READY/AUTHENTICATE,
PlainText SASL auth (AUTH_RESPONSE ``\\0user\\0password`` →
AUTH_SUCCESS), QUERY and BATCH opcodes, and RESULT parsing (Void and
Rows kinds with typed column decode: bigint/double/boolean/varchar/
blob). Bind arguments are rendered as CQL literals client-side, which
keeps the frames valid against real Cassandra.

The method surface mirrors the embedded
:class:`~gofr_tpu_torch.datasource.columnar.Cassandra` adapter (query/exec/
new_batch/batch_query/execute_batch/health_check), so swapping is a
constructor change.

:class:`MiniCassandraServer` implements the server half of the same
frames over the embedded adapter — hermetic wire tests, real bytes,
verified auth.

The port's copy of ``gofr_tpu/datasource/cassandra_wire.py``.
"""

from __future__ import annotations

import re
import socket
import socketserver
import struct
import threading
from typing import Any

from . import Instrumented
from .columnar import Cassandra, ColumnarError

REQUEST_VERSION = 0x04
RESPONSE_VERSION = 0x84

OP_ERROR = 0x00
OP_STARTUP = 0x01
OP_READY = 0x02
OP_AUTHENTICATE = 0x03
OP_OPTIONS = 0x05
OP_SUPPORTED = 0x06
OP_QUERY = 0x07
OP_RESULT = 0x08
OP_BATCH = 0x0D
OP_AUTH_RESPONSE = 0x0F
OP_AUTH_SUCCESS = 0x10

RESULT_VOID = 0x0001
RESULT_ROWS = 0x0002

TYPE_BIGINT = 0x0002
TYPE_BLOB = 0x0003
TYPE_BOOLEAN = 0x0004
TYPE_DOUBLE = 0x0007
TYPE_VARCHAR = 0x000D

CONSISTENCY_ONE = 0x0001


class CassandraWireError(ColumnarError):
    """Server ERROR frame, with the protocol error code."""

    def __init__(self, message: str, code: int = 0) -> None:
        super().__init__(message)
        self.code = code


# ----------------------------------------------------------- primitives

def _string(s: str) -> bytes:
    data = s.encode()
    return struct.pack("!H", len(data)) + data


def _long_string(s: str) -> bytes:
    data = s.encode()
    return struct.pack("!I", len(data)) + data


def _string_map(m: dict[str, str]) -> bytes:
    out = [struct.pack("!H", len(m))]
    for k, v in m.items():
        out.append(_string(k))
        out.append(_string(v))
    return b"".join(out)


def _read_string(body: bytes, off: int) -> tuple[str, int]:
    (n,) = struct.unpack_from("!H", body, off)
    off += 2
    return body[off:off + n].decode(), off + n


def _read_long_string(body: bytes, off: int) -> tuple[str, int]:
    (n,) = struct.unpack_from("!I", body, off)
    off += 4
    return body[off:off + n].decode(), off + n


def cql_literal(value: Any) -> str:
    """Render one bind value as a CQL literal."""
    if value is None:
        return "NULL"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (int, float)):
        return str(value)
    if isinstance(value, bytes):
        return "0x" + value.hex()
    return "'" + str(value).replace("'", "''") + "'"


def expand_qmarks(stmt: str, args: tuple) -> str:
    """``?`` bind markers -> CQL literals, skipping quoted literals."""
    out: list[str] = []
    it = iter(args)
    in_string = False
    i = 0
    while i < len(stmt):
        ch = stmt[i]
        if in_string:
            out.append(ch)
            if ch == "'":
                # '' is an escaped quote inside the literal
                if i + 1 < len(stmt) and stmt[i + 1] == "'":
                    out.append("'")
                    i += 1
                else:
                    in_string = False
        elif ch == "'":
            in_string = True
            out.append(ch)
        elif ch == "?":
            try:
                out.append(cql_literal(next(it)))
            except StopIteration:
                raise CassandraWireError(
                    "more ? markers than arguments") from None
        else:
            out.append(ch)
        i += 1
    leftover = sum(1 for _ in it)
    if leftover:
        raise CassandraWireError(f"{leftover} unused bind arguments")
    return "".join(out)


class _FrameSocket:
    """Framed read/write over a blocking socket."""

    def __init__(self, sock: socket.socket) -> None:
        self._sock = sock
        self._buf = b""

    def _exactly(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise CassandraWireError("connection closed")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def send(self, version: int, opcode: int, body: bytes,
             stream: int = 0) -> None:
        header = struct.pack("!BBhBI", version, 0, stream, opcode, len(body))
        self._sock.sendall(header + body)

    def recv(self) -> tuple[int, int, bytes]:
        """-> (opcode, stream, body)."""
        header = self._exactly(9)
        _version, _flags, stream, opcode, length = struct.unpack(
            "!BBhBI", header)
        return opcode, stream, self._exactly(length)


# ---------------------------------------------------------------- client

class CassandraWire(Instrumented):
    """CQL native-protocol client with the embedded adapter's verbs."""

    metric = "app_cassandra_stats"
    log_tag = "CQL"

    def __init__(self, *, host: str = "localhost", port: int = 9042,
                 keyspace: str = "default", username: str = "",
                 password: str = "", timeout_s: float = 30.0) -> None:
        self.host = host
        self.port = port
        self.keyspace = keyspace
        self.username = username
        self.password = password
        self.timeout_s = timeout_s
        self._frames: _FrameSocket | None = None
        self._sock: socket.socket | None = None
        self._lock = threading.RLock()
        self._batches: dict[str, list[str]] = {}

    def connect(self) -> None:
        if self._sock is not None:
            self.close()
        sock = socket.create_connection((self.host, self.port),
                                        timeout=self.timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        self._frames = _FrameSocket(sock)
        try:
            self._frames.send(REQUEST_VERSION, OP_STARTUP,
                              _string_map({"CQL_VERSION": "3.0.0"}))
            opcode, _, body = self._frames.recv()
            if opcode == OP_AUTHENTICATE:
                token = b"\x00" + self.username.encode() \
                    + b"\x00" + self.password.encode()
                self._frames.send(
                    REQUEST_VERSION, OP_AUTH_RESPONSE,
                    struct.pack("!i", len(token)) + token)
                opcode, _, body = self._frames.recv()
                if opcode != OP_AUTH_SUCCESS:
                    raise self._as_error(opcode, body)
            elif opcode != OP_READY:
                raise self._as_error(opcode, body)
        except BaseException:
            sock.close()
            self._sock = None
            self._frames = None
            raise
        if self.logger is not None:
            self.logger.info("connected to cassandra", host=self.host,
                             port=self.port, keyspace=self.keyspace)

    @staticmethod
    def _as_error(opcode: int, body: bytes) -> CassandraWireError:
        if opcode == OP_ERROR:
            (code,) = struct.unpack_from("!I", body, 0)
            message, _ = _read_string(body, 4)
            return CassandraWireError(message, code=code)
        return CassandraWireError(f"unexpected opcode {opcode:#x}")

    def _require(self) -> _FrameSocket:
        if self._frames is None:
            raise CassandraWireError("not connected; call connect() first")
        return self._frames

    def _round_trip(self, opcode: int, body: bytes) -> tuple[int, bytes]:
        frames = self._require()
        with self._lock:
            try:
                frames.send(REQUEST_VERSION, opcode, body)
                got, _, payload = frames.recv()
            except (OSError, TimeoutError) as exc:
                # a partial frame poisons the stream — the next recv
                # would pair with THIS request's late response
                self.close()
                raise CassandraWireError(
                    f"connection lost mid-request ({exc}); "
                    "reconnect required") from exc
        if got == OP_ERROR:
            raise self._as_error(got, payload)
        return got, payload

    def _run(self, cql: str) -> list[dict]:
        body = _long_string(cql) + struct.pack("!HB", CONSISTENCY_ONE, 0)
        opcode, payload = self._round_trip(OP_QUERY, body)
        if opcode != OP_RESULT:
            raise CassandraWireError(f"unexpected opcode {opcode:#x}")
        return _parse_result(payload)

    # ----------------------------------------------------- native verbs
    def query(self, stmt: str, *args: Any) -> list[dict]:
        return self._observed(
            "QUERY", stmt.split(None, 1)[0],
            lambda: self._run(expand_qmarks(stmt, args)))

    def exec(self, stmt: str, *args: Any) -> None:
        self._observed("EXEC", stmt.split(None, 1)[0],
                       lambda: self._run(expand_qmarks(stmt, args)))

    query_with_ctx = query
    exec_with_ctx = exec

    # -- batches (protocol BATCH opcode, one frame for the whole set)
    def new_batch(self, name: str, _batch_type: int = 0) -> None:
        with self._lock:
            self._batches[name] = []

    def batch_query(self, name: str, stmt: str, *args: Any) -> None:
        with self._lock:
            if name not in self._batches:
                raise ColumnarError(f"batch {name!r} not initialised")
            self._batches[name].append(expand_qmarks(stmt, args))

    def execute_batch(self, name: str) -> None:
        def op():
            with self._lock:
                if name not in self._batches:
                    raise ColumnarError(f"batch {name!r} not initialised")
                stmts = self._batches.pop(name)
            parts = [struct.pack("!BH", 0, len(stmts))]  # logged batch
            for cql in stmts:
                parts.append(b"\x00")  # kind 0: query string
                parts.append(_long_string(cql))
                parts.append(struct.pack("!H", 0))  # no values
            parts.append(struct.pack("!HB", CONSISTENCY_ONE, 0))
            opcode, payload = self._round_trip(OP_BATCH, b"".join(parts))
            if opcode != OP_RESULT:
                raise CassandraWireError(f"unexpected opcode {opcode:#x}")
        self._observed("BATCH", name, op)

    def health_check(self) -> dict[str, Any]:
        try:
            self._run("SELECT 1")
            return {"status": "UP",
                    "details": {"host": self.host, "port": self.port,
                                "keyspace": self.keyspace}}
        except Exception as exc:
            return {"status": "DOWN", "error": str(exc)}

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None
            self._frames = None


class ScyllaWire(CassandraWire):
    """ScyllaDB speaks the same CQL native protocol (reference
    container/datasources.go:600-635 keeps a separate surface; only
    the metrics identity differs here)."""

    metric = "app_scylladb_stats"
    log_tag = "SCYLLA"


def _parse_result(payload: bytes) -> list[dict]:
    (kind,) = struct.unpack_from("!I", payload, 0)
    if kind != RESULT_ROWS:
        return []
    off = 4
    (flags,) = struct.unpack_from("!I", payload, off)
    off += 4
    (col_count,) = struct.unpack_from("!I", payload, off)
    off += 4
    global_spec = bool(flags & 0x0001)
    if global_spec:
        _, off = _read_string(payload, off)  # keyspace
        _, off = _read_string(payload, off)  # table
    columns: list[tuple[str, int]] = []
    for _ in range(col_count):
        if not global_spec:
            _, off = _read_string(payload, off)
            _, off = _read_string(payload, off)
        name, off = _read_string(payload, off)
        (type_id,) = struct.unpack_from("!H", payload, off)
        off += 2
        columns.append((name, type_id))
    (row_count,) = struct.unpack_from("!I", payload, off)
    off += 4
    rows = []
    for _ in range(row_count):
        row: dict[str, Any] = {}
        for name, type_id in columns:
            (length,) = struct.unpack_from("!i", payload, off)
            off += 4
            if length == -1:
                row[name] = None
            else:
                row[name] = _decode_value(payload[off:off + length], type_id)
                off += length
        rows.append(row)
    return rows


def _decode_value(data: bytes, type_id: int) -> Any:
    if type_id == TYPE_BIGINT:
        return struct.unpack("!q", data)[0]
    if type_id == TYPE_DOUBLE:
        return struct.unpack("!d", data)[0]
    if type_id == TYPE_BOOLEAN:
        return data != b"\x00"
    if type_id == TYPE_BLOB:
        return data
    return data.decode()


def _encode_value(value: Any) -> tuple[int, bytes]:
    """-> (type_id, encoded bytes) for one column value."""
    if isinstance(value, bool):
        return TYPE_BOOLEAN, (b"\x01" if value else b"\x00")
    if isinstance(value, int):
        return TYPE_BIGINT, struct.pack("!q", value)
    if isinstance(value, float):
        return TYPE_DOUBLE, struct.pack("!d", value)
    if isinstance(value, bytes):
        return TYPE_BLOB, value
    return TYPE_VARCHAR, str(value).encode()


# ------------------------------------------------------------ mini server

# CQL spells blobs 0xBEEF; sqlite spells them X'BEEF' — translate
# outside string literals only
_CQL_BLOB_RE = re.compile(r"'(?:[^']|'')*'|\b0x([0-9a-fA-F]+)\b")


def _cql_to_sqlite(cql: str) -> str:
    def sub(match: "re.Match[str]") -> str:
        if match.group(1) is None:  # a quoted literal
            return match.group(0)
        return f"X'{match.group(1)}'"
    return _CQL_BLOB_RE.sub(sub, cql)


class _CQLHandler(socketserver.BaseRequestHandler):
    @property
    def mini(self) -> "MiniCassandraServer":
        return self.server.mini  # type: ignore[attr-defined]

    def handle(self) -> None:
        frames = _FrameSocket(self.request)
        try:
            if not self._startup(frames):
                return
            while True:
                opcode, stream, body = frames.recv()
                if opcode == OP_OPTIONS:
                    frames.send(RESPONSE_VERSION, OP_SUPPORTED,
                                _string_map({}), stream)
                elif opcode == OP_QUERY:
                    cql, off = _read_long_string(body, 0)
                    self._run_and_reply(frames, stream, [cql])
                elif opcode == OP_BATCH:
                    off = 1  # batch type
                    (n,) = struct.unpack_from("!H", body, off)
                    off += 2
                    stmts = []
                    for _ in range(n):
                        off += 1  # kind byte (0: query string)
                        cql, off = _read_long_string(body, off)
                        (nvals,) = struct.unpack_from("!H", body, off)
                        off += 2  # no values supported in batches
                        stmts.append(cql)
                    self._run_and_reply(frames, stream, stmts,
                                        batch=True)
                else:
                    self._error(frames, stream, 0x000A,
                                f"unsupported opcode {opcode:#x}")
        except (CassandraWireError, ConnectionError, OSError):
            return

    def _startup(self, frames: _FrameSocket) -> bool:
        opcode, stream, _body = frames.recv()
        if opcode == OP_OPTIONS:  # driver probing before startup
            frames.send(RESPONSE_VERSION, OP_SUPPORTED, _string_map({}),
                        stream)
            opcode, stream, _body = frames.recv()
        if opcode != OP_STARTUP:
            return False
        if not self.mini.password:
            frames.send(RESPONSE_VERSION, OP_READY, b"", stream)
            return True
        frames.send(
            RESPONSE_VERSION, OP_AUTHENTICATE,
            _string("org.apache.cassandra.auth.PasswordAuthenticator"),
            stream)
        opcode, stream, body = frames.recv()
        if opcode != OP_AUTH_RESPONSE:
            return False
        (n,) = struct.unpack_from("!i", body, 0)
        token = body[4:4 + n] if n > 0 else b""
        parts = token.split(b"\x00")
        ok = (len(parts) == 3
              and parts[1].decode() == self.mini.user
              and parts[2].decode() == self.mini.password)
        if not ok:
            self._error(frames, stream, 0x0100, "bad credentials")
            return False
        frames.send(RESPONSE_VERSION, OP_AUTH_SUCCESS,
                    struct.pack("!i", -1), stream)
        return True

    def _error(self, frames: _FrameSocket, stream: int, code: int,
               message: str) -> None:
        frames.send(RESPONSE_VERSION, OP_ERROR,
                    struct.pack("!I", code) + _string(message), stream)

    def _run_and_reply(self, frames: _FrameSocket, stream: int,
                       stmts: list[str], batch: bool = False) -> None:
        try:
            rows: list[dict] = []
            stmts = [_cql_to_sqlite(s) for s in stmts]
            if batch:
                name = f"_wire_{id(stmts):x}"
                self.mini.store.new_batch(name)
                for cql in stmts:
                    self.mini.store.batch_query(name, cql)
                self.mini.store.execute_batch(name)
            else:
                word = stmts[0].split(None, 1)[0].upper() \
                    if stmts[0].split() else ""
                if word == "SELECT":
                    rows = self.mini.store.query(stmts[0])
                else:
                    self.mini.store.exec(stmts[0])
                    frames.send(RESPONSE_VERSION, OP_RESULT,
                                struct.pack("!I", RESULT_VOID), stream)
                    return
        except Exception as exc:
            self._error(frames, stream, 0x2000, str(exc))
            return
        if batch:
            frames.send(RESPONSE_VERSION, OP_RESULT,
                        struct.pack("!I", RESULT_VOID), stream)
            return
        frames.send(RESPONSE_VERSION, OP_RESULT,
                    _encode_rows(rows, self.mini.keyspace), stream)


def _encode_rows(rows: list[dict], keyspace: str) -> bytes:
    columns = list(rows[0].keys()) if rows else []
    # a column's wire type must hold for EVERY value in it — sqlite
    # allows mixed types, so columns that mix degrade to varchar
    types = []
    for name in columns:
        seen = {_encode_value(r[name])[0] for r in rows
                if r[name] is not None}
        types.append(seen.pop() if len(seen) == 1 else TYPE_VARCHAR)
    parts = [struct.pack("!I", RESULT_ROWS),
             struct.pack("!I", 0x0001),  # global_tables_spec
             struct.pack("!I", len(columns)),
             _string(keyspace), _string("t")]
    for name, type_id in zip(columns, types):
        parts.append(_string(name) + struct.pack("!H", type_id))
    parts.append(struct.pack("!I", len(rows)))
    for row in rows:
        for name, type_id in zip(columns, types):
            value = row[name]
            if value is None:
                parts.append(struct.pack("!i", -1))
            else:
                natural, data = _encode_value(value)
                if natural != type_id:  # mixed column: send as text
                    data = str(value).encode()
                parts.append(struct.pack("!i", len(data)) + data)
    return b"".join(parts)


class MiniCassandraServer:
    """Server half of the CQL native protocol over the embedded
    :class:`~gofr_tpu_torch.datasource.columnar.Cassandra` adapter. With a
    ``password`` set it demands the PlainText SASL exchange and
    verifies it, like a PasswordAuthenticator-configured cluster."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 keyspace: str = "default", user: str = "cassandra",
                 password: str = "") -> None:
        self.host = host
        self.port = port
        self.keyspace = keyspace
        self.user = user
        self.password = password
        self.store = Cassandra(keyspace=keyspace)
        self.store.connect()
        self._server: socketserver.ThreadingTCPServer | None = None
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        class TCP(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = TCP((self.host, self.port), _CQLHandler)
        self._server.mini = self  # the handler reads this back
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="mini-cassandra")
        self._thread.start()

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        self.store.close()

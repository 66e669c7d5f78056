"""PostgreSQL network client speaking the v3 frontend/backend wire
protocol, plus a protocol-faithful mini server.

The reference's SQL datasource dials postgres through database/sql +
lib/pq (sql.go:22-35, sql.go:74); this client implements the protocol
itself over a TCP socket: startup, password authentication (cleartext,
MD5, and SCRAM-SHA-256 per RFC 7677), the simple query cycle
('Q' -> RowDescription/DataRow/CommandComplete), and the extended
query cycle (Parse/Bind/Describe/Execute/Sync) for ``$N``-parameterized
statements. The method surface mirrors :class:`~gofr_tpu_torch.datasource.sql.SQL`
(query/query_row/exec/select/begin/health_check) so handlers and
auto-CRUD swap between sqlite and a network postgres by constructor.

:class:`MiniPostgresServer` implements the backend half of the same
wire protocol over an embedded sqlite engine — STARTUP, the same three
auth exchanges (verifying real MD5 digests and SCRAM proofs), both
query cycles — so tests exercise genuine protocol bytes end-to-end
with no postgres installation.

The port's copy of ``gofr_tpu/datasource/postgres_wire.py``.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import os
import re
import secrets
import socket
import socketserver
import sqlite3
import struct
import threading
import time
from typing import Any, Iterator

from contextlib import contextmanager

from . import ProviderMixin
from .sql import QueryLog, SQLError

PROTOCOL_V3 = 196608  # 3.0
SSL_REQUEST = 80877103

# type OIDs we speak (text format)
OID_BOOL = 16
OID_BYTEA = 17
OID_INT8 = 20
OID_INT4 = 23
OID_TEXT = 25
OID_FLOAT8 = 701


class PostgresError(SQLError):
    """Server-reported error (ErrorResponse), with sqlstate."""

    def __init__(self, message: str, sqlstate: str = "") -> None:
        super().__init__(message)
        self.sqlstate = sqlstate


# -------------------------------------------------------------- wire enc

def _cstr(s: str) -> bytes:
    return s.encode() + b"\0"


def _msg(kind: bytes, payload: bytes) -> bytes:
    return kind + struct.pack("!I", len(payload) + 4) + payload


class _Reader:
    """Exact-read wrapper over a blocking socket."""

    def __init__(self, sock: socket.socket) -> None:
        self._sock = sock
        self._buf = b""

    def exactly(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise PostgresError("connection closed by server")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def message(self) -> tuple[bytes, bytes]:
        kind = self.exactly(1)
        (length,) = struct.unpack("!I", self.exactly(4))
        return kind, self.exactly(length - 4)


def _parse_error(payload: bytes) -> PostgresError:
    fields: dict[bytes, str] = {}
    for part in payload.split(b"\0"):
        if part:
            fields[part[:1]] = part[1:].decode("utf-8", "replace")
    return PostgresError(fields.get(b"M", "unknown error"),
                         sqlstate=fields.get(b"C", ""))


# ------------------------------------------------------------- SCRAM

def _scram_salted_password(password: str, salt: bytes, iters: int) -> bytes:
    return hashlib.pbkdf2_hmac("sha256", password.encode(), salt, iters)


def _hmac256(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def _scram_keys(salted: bytes) -> tuple[bytes, bytes, bytes]:
    """-> (client_key, stored_key, server_key)."""
    client_key = hmac.new(salted, b"Client Key", hashlib.sha256).digest()
    stored_key = hashlib.sha256(client_key).digest()
    server_key = hmac.new(salted, b"Server Key", hashlib.sha256).digest()
    return client_key, stored_key, server_key


# -------------------------------------------------------------- row type

class PGRow(dict):
    """A result row: mapping access plus ``keys()`` — the subset of
    ``sqlite3.Row``'s surface the framework relies on (scan_rows,
    auto-CRUD, ORM-lite select)."""

    __slots__ = ()


# ---------------------------------------------------------------- client

class PostgresWire(ProviderMixin):
    """v3-protocol postgres client behind the SQL datasource surface."""

    dialect = "postgres"

    def __init__(self, *, host: str = "localhost", port: int = 5432,
                 user: str = "postgres", password: str = "",
                 database: str = "postgres",
                 timeout_s: float = 30.0) -> None:
        self.host = host
        self.port = port
        self.user = user
        self.password = password
        self.database = database
        self.timeout_s = timeout_s
        self._sock: socket.socket | None = None
        self._reader: _Reader | None = None
        self._lock = threading.RLock()
        self.server_params: dict[str, str] = {}

    # ------------------------------------------------------------ startup
    def connect(self) -> None:
        if self._sock is not None:  # reconnect: drop the old socket
            self.close()
        sock = socket.create_connection((self.host, self.port),
                                        timeout=self.timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        self._reader = _Reader(sock)
        try:
            params = b"".join([_cstr("user"), _cstr(self.user),
                               _cstr("database"),
                               _cstr(self.database)]) + b"\0"
            payload = struct.pack("!I", PROTOCOL_V3) + params
            sock.sendall(struct.pack("!I", len(payload) + 4) + payload)
            self._authenticate()
            # drain ParameterStatus/BackendKeyData to ReadyForQuery
            while True:
                kind, body = self._reader.message()
                if kind == b"S":
                    key, _, val = body.rstrip(b"\0").partition(b"\0")
                    self.server_params[key.decode()] = val.decode()
                elif kind == b"Z":
                    break
                elif kind == b"E":
                    raise _parse_error(body)
        except BaseException:
            # don't leak the fd when the handshake/auth fails — the
            # container's log-and-retry connect loop would otherwise
            # leak one socket per attempt
            sock.close()
            self._sock = None
            self._reader = None
            raise
        if self.logger is not None:
            self.logger.info("connected to postgres",
                             host=self.host, port=self.port,
                             database=self.database)

    def _authenticate(self) -> None:
        assert self._sock is not None and self._reader is not None
        while True:
            kind, body = self._reader.message()
            if kind == b"E":
                raise _parse_error(body)
            if kind != b"R":
                raise PostgresError(f"unexpected auth message {kind!r}")
            (code,) = struct.unpack("!I", body[:4])
            if code == 0:  # AuthenticationOk
                return
            if code == 3:  # cleartext
                self._sock.sendall(_msg(b"p", _cstr(self.password)))
            elif code == 5:  # MD5: md5(md5(password+user)+salt)
                salt = body[4:8]
                inner = hashlib.md5(
                    (self.password + self.user).encode()).hexdigest()
                digest = hashlib.md5(
                    inner.encode() + salt).hexdigest()
                self._sock.sendall(_msg(b"p", _cstr("md5" + digest)))
            elif code == 10:  # SASL: pick SCRAM-SHA-256
                mechs = [m for m in body[4:].split(b"\0") if m]
                if b"SCRAM-SHA-256" not in mechs:
                    raise PostgresError(
                        f"server offers no supported SASL mechanism: {mechs}")
                self._scram()
            else:
                raise PostgresError(f"unsupported auth method {code}")

    def _scram(self) -> None:
        assert self._sock is not None and self._reader is not None
        cnonce = base64.b64encode(secrets.token_bytes(18)).decode()
        first_bare = f"n={self.user},r={cnonce}"
        client_first = "n,," + first_bare
        init = (_cstr("SCRAM-SHA-256")
                + struct.pack("!I", len(client_first))
                + client_first.encode())
        self._sock.sendall(_msg(b"p", init))

        kind, body = self._reader.message()
        if kind == b"E":
            raise _parse_error(body)
        (code,) = struct.unpack("!I", body[:4])
        if code != 11:
            raise PostgresError("expected SASLContinue")
        server_first = body[4:].decode()
        attrs = dict(kv.split("=", 1) for kv in server_first.split(","))
        nonce, salt = attrs["r"], base64.b64decode(attrs["s"])
        iters = int(attrs["i"])
        if not nonce.startswith(cnonce):
            raise PostgresError("server nonce does not extend client nonce")

        salted = _scram_salted_password(self.password, salt, iters)
        client_key, stored_key, server_key = _scram_keys(salted)
        final_wo_proof = f"c=biws,r={nonce}"
        auth_msg = f"{first_bare},{server_first},{final_wo_proof}"
        signature = _hmac256(stored_key, auth_msg)
        proof = bytes(a ^ b for a, b in zip(client_key, signature))
        final = f"{final_wo_proof},p={base64.b64encode(proof).decode()}"
        self._sock.sendall(_msg(b"p", final.encode()))

        kind, body = self._reader.message()
        if kind == b"E":
            raise _parse_error(body)
        (code,) = struct.unpack("!I", body[:4])
        if code != 12:
            raise PostgresError("expected SASLFinal")
        verifier = dict(kv.split("=", 1)
                        for kv in body[4:].decode().split(","))
        expect = base64.b64encode(_hmac256(server_key, auth_msg)).decode()
        if not hmac.compare_digest(verifier.get("v", ""), expect):
            raise PostgresError("server SCRAM signature invalid "
                                "(possible man-in-the-middle)")

    # ----------------------------------------------------- instrumented
    def _observe(self, query: str, args: tuple, start: float) -> None:
        duration_us = int((time.perf_counter() - start) * 1e6)
        if self.logger is not None:
            self.logger.debug(
                QueryLog(query, duration_us, args).pretty_print())
        if self.metrics is not None:
            word = query.split(None, 1)[0].lower() if query.split() else "?"
            self.metrics.record_histogram("app_sql_stats",
                                          duration_us / 1e6, type=word)

    def ph(self, n: int) -> str:
        return f"${n}"

    def _require(self) -> tuple[socket.socket, _Reader]:
        if self._sock is None or self._reader is None:
            raise PostgresError("not connected; call connect() first")
        return self._sock, self._reader

    # ------------------------------------------------------- query cycles
    def _simple_query(self, query: str) -> tuple[list[PGRow], str]:
        sock, reader = self._require()
        sock.sendall(_msg(b"Q", _cstr(query)))
        return self._collect(reader)

    def _extended_query(self, query: str,
                        args: tuple) -> tuple[list[PGRow], str]:
        sock, reader = self._require()
        out = _msg(b"P", _cstr("") + _cstr(query) + struct.pack("!H", 0))
        bind = [_cstr(""), _cstr(""),
                # one format code applying to every param: 0 = text
                struct.pack("!H", 1), struct.pack("!h", 0),
                struct.pack("!H", len(args))]
        for a in args:
            if a is None:
                bind.append(struct.pack("!i", -1))
            else:
                if isinstance(a, bytes):  # postgres hex form, still text
                    data = b"\\x" + a.hex().encode()
                else:
                    data = _encode_text_param(a).encode()
                bind.append(struct.pack("!i", len(data)) + data)
        bind.append(struct.pack("!H", 0))  # result formats: default text
        out += _msg(b"B", b"".join(bind))
        out += _msg(b"D", b"P" + _cstr(""))
        out += _msg(b"E", _cstr("") + struct.pack("!I", 0))
        out += _msg(b"S", b"")
        sock.sendall(out)
        return self._collect(reader)

    def _collect(self, reader: _Reader) -> tuple[list[PGRow], str]:
        """Consume one cycle's responses up to ReadyForQuery."""
        columns: list[tuple[str, int]] = []
        rows: list[PGRow] = []
        tag = ""
        error: PostgresError | None = None
        while True:
            kind, body = reader.message()
            if kind == b"T":
                columns = _parse_row_description(body)
            elif kind == b"D":
                rows.append(_parse_data_row(body, columns))
            elif kind == b"C":
                tag = body.rstrip(b"\0").decode()
            elif kind == b"E":
                error = _parse_error(body)
            elif kind == b"Z":
                if error is not None:
                    raise error
                return rows, tag
            # '1' ParseComplete, '2' BindComplete, 'n' NoData,
            # 'S' ParameterStatus, 'N' NoticeResponse: skip

    # --------------------------------------------------- public surface
    def _cycle(self, query: str, args: tuple) -> tuple[list[PGRow], str]:
        """One query cycle; a mid-cycle I/O failure poisons the stream
        (unconsumed response bytes would pair with the NEXT request),
        so the connection is torn down rather than kept."""
        try:
            return (self._extended_query(query, args) if args
                    else self._simple_query(query))
        except (OSError, TimeoutError) as exc:
            self.close()
            raise PostgresError(
                f"connection lost mid-query ({exc}); reconnect required"
            ) from exc

    def query(self, query: str, *args: Any) -> list[PGRow]:
        start = time.perf_counter()
        span = (self.tracer.start_span(f"sql {query.split(None, 1)[0]}")
                if self.tracer is not None else None)
        try:
            with self._lock:
                rows, _ = self._cycle(query, args)
                return rows
        finally:
            if span is not None:
                span.end()
            self._observe(query, args, start)

    def query_row(self, query: str, *args: Any) -> PGRow | None:
        rows = self.query(query, *args)
        return rows[0] if rows else None

    def exec(self, query: str, *args: Any) -> "PGResult":
        start = time.perf_counter()
        span = (self.tracer.start_span(f"sql {query.split(None, 1)[0]}")
                if self.tracer is not None else None)
        try:
            with self._lock:
                _, tag = self._cycle(query, args)
                return PGResult(tag)
        finally:
            if span is not None:
                span.end()
            self._observe(query, args, start)

    @contextmanager
    def begin(self) -> Iterator["PostgresWire"]:
        """BEGIN/COMMIT with rollback-on-raise, mirroring SQL.begin."""
        with self._lock:
            self._cycle("BEGIN", ())
            try:
                yield self
                self._cycle("COMMIT", ())
            except BaseException:
                if self._sock is not None:  # skip if the link just died
                    self._cycle("ROLLBACK", ())
                raise

    def select(self, entity_type: type, query: str, *args: Any) -> list[Any]:
        from dataclasses import fields, is_dataclass
        if not is_dataclass(entity_type):
            raise SQLError("select requires a dataclass type")
        names = [f.name for f in fields(entity_type)]
        return [entity_type(**{n: row[n] for n in names if n in row})
                for row in self.query(query, *args)]

    def health_check(self) -> dict[str, Any]:
        try:
            self.query("SELECT 1")
            return {"status": "UP",
                    "details": {"host": self.host, "port": self.port,
                                "database": self.database}}
        except Exception as exc:
            return {"status": "DOWN", "error": str(exc)}

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.sendall(_msg(b"X", b""))
            except OSError:
                pass
            self._sock.close()
            self._sock = None
            self._reader = None


class PGResult:
    """Command outcome: rowcount parsed from the CommandComplete tag
    ("INSERT 0 3" / "UPDATE 2" / "DELETE 1" / "SELECT 4")."""

    def __init__(self, tag: str) -> None:
        self.tag = tag
        parts = tag.split()
        self.rowcount = int(parts[-1]) if parts and parts[-1].isdigit() else 0


def _encode_text_param(value: Any) -> str:
    if isinstance(value, bool):
        return "t" if value else "f"
    return str(value)


def _parse_row_description(body: bytes) -> list[tuple[str, int]]:
    (nfields,) = struct.unpack("!H", body[:2])
    out = []
    off = 2
    for _ in range(nfields):
        end = body.index(b"\0", off)
        name = body[off:end].decode()
        off = end + 1
        _table, _attn, oid, _typlen, _typmod, _fmt = struct.unpack(
            "!IhIhih", body[off:off + 18])
        off += 18
        out.append((name, oid))
    return out


def _decode_text_value(data: bytes, oid: int) -> Any:
    text = data.decode()
    try:
        if oid in (OID_INT8, OID_INT4):
            return int(text)
        if oid == OID_FLOAT8:
            return float(text)
    except ValueError:
        # a mixed-type sqlite column behind the mini server; real
        # postgres can't produce this, degrade to the text
        return text
    if oid == OID_BOOL:
        return text == "t"
    if oid == OID_BYTEA:
        return bytes.fromhex(text[2:]) if text.startswith("\\x") else data
    return text


def _parse_data_row(body: bytes,
                    columns: list[tuple[str, int]]) -> PGRow:
    (nfields,) = struct.unpack("!H", body[:2])
    row = PGRow()
    off = 2
    for i in range(nfields):
        (length,) = struct.unpack("!i", body[off:off + 4])
        off += 4
        name, oid = columns[i] if i < len(columns) else (f"col{i}", OID_TEXT)
        if length == -1:
            row[name] = None
        else:
            row[name] = _decode_text_value(body[off:off + length], oid)
            off += length
    return row


# ------------------------------------------------------------ mini server

def _oid_for(value: Any) -> int:
    if isinstance(value, bool):
        return OID_BOOL
    if isinstance(value, int):
        return OID_INT8
    if isinstance(value, float):
        return OID_FLOAT8
    if isinstance(value, bytes):
        return OID_BYTEA
    return OID_TEXT


def _render_value(value: Any) -> bytes:
    if isinstance(value, bool):
        return b"t" if value else b"f"
    if isinstance(value, bytes):
        return b"\\x" + value.hex().encode()
    return str(value).encode()


# matches a quoted SQL literal (with '' escapes) OR a $N placeholder —
# literals win, so "$15" inside a string stays text
_DOLLAR_RE = re.compile(r"'(?:[^']|'')*'|\$(\d+)")


def _dollar_to_qmark(query: str) -> tuple[str, list[int]]:
    """``$N`` -> ``?`` with the 1-based order of appearance, leaving
    dollar-digit sequences inside string literals untouched."""
    order: list[int] = []

    def sub(match) -> str:
        if match.group(1) is None:  # a quoted literal, not a param
            return match.group(0)
        order.append(int(match.group(1)))
        return "?"

    return _DOLLAR_RE.sub(sub, query), order


class _PGHandler(socketserver.BaseRequestHandler):
    @property
    def mini(self) -> "MiniPostgresServer":
        return self.server.mini  # type: ignore[attr-defined]

    def handle(self) -> None:  # noqa: C901 — one protocol loop
        sock = self.request
        # a reply is several small messages: without NODELAY, Nagle holds
        # each after the first until the client's delayed ACK (~40 ms)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        reader = _Reader(sock)
        self.conn = self.mini.new_conn()
        self.state = _ConnState()
        try:
            if not self._startup(sock, reader):
                return
            self._ready(sock)
            statements: dict[str, str] = {}
            portals: dict[str, tuple[str, list[Any]]] = {}
            failed = False  # extended-cycle error: skip until Sync
            while True:
                kind, body = reader.message()
                if kind == b"X":
                    return
                if kind == b"Q":
                    self._simple(sock, body.rstrip(b"\0").decode())
                elif kind == b"S":
                    failed = False
                    self._ready(sock)
                elif failed:
                    continue
                elif kind == b"P":
                    name, _, rest = body.partition(b"\0")
                    query = rest.split(b"\0", 1)[0].decode()
                    statements[name.decode()] = query
                    sock.sendall(_msg(b"1", b""))
                elif kind == b"B":
                    failed = not self._bind(sock, body, statements, portals)
                elif kind == b"D":
                    pass  # RowDescription is sent with Execute's rows
                elif kind == b"E":
                    portal = body.split(b"\0", 1)[0].decode()
                    failed = not self._execute(sock, portals.get(portal))
        except (PostgresError, ConnectionError, OSError):
            return
        finally:
            # a client that vanished mid-transaction must not hold the
            # server-wide tx lock or leave the tx open
            if self.state.in_tx:
                try:
                    self.conn.execute("ROLLBACK")
                except sqlite3.Error:
                    pass
                self.mini.release_tx(self.state)
            self.conn.close()

    # ------------------------------------------------------------ startup
    def _startup(self, sock, reader: _Reader) -> bool:
        (length,) = struct.unpack("!I", reader.exactly(4))
        body = reader.exactly(length - 4)
        (code,) = struct.unpack("!I", body[:4])
        if code == SSL_REQUEST:
            sock.sendall(b"N")  # no TLS on the mini server
            return self._startup(sock, reader)
        if code != PROTOCOL_V3:
            return False
        fields = body[4:].split(b"\0")
        params = {fields[i].decode(): fields[i + 1].decode()
                  for i in range(0, len(fields) - 1, 2) if fields[i]}
        if params.get("user") != self.mini.user:
            self._error(sock, "28000", "role does not exist")
            return False
        if not self._auth(sock, reader):
            self._error(sock, "28P01", "password authentication failed")
            return False
        sock.sendall(_msg(b"R", struct.pack("!I", 0)))
        for key, val in (("server_version", "16.0-mini"),
                         ("client_encoding", "UTF8")):
            sock.sendall(_msg(b"S", _cstr(key) + _cstr(val)))
        sock.sendall(_msg(b"K", struct.pack("!II", os.getpid() & 0xffff,
                                            0x5eed)))
        return True

    def _auth(self, sock, reader: _Reader) -> bool:
        mode = self.mini.auth
        password = self.mini.password
        if mode == "trust":
            return True
        if mode == "password":
            sock.sendall(_msg(b"R", struct.pack("!I", 3)))
            kind, body = reader.message()
            return (kind == b"p"
                    and body.rstrip(b"\0").decode() == password)
        if mode == "md5":
            salt = secrets.token_bytes(4)
            sock.sendall(_msg(b"R", struct.pack("!I", 5) + salt))
            kind, body = reader.message()
            if kind != b"p":
                return False
            inner = hashlib.md5(
                (password + self.mini.user).encode()).hexdigest()
            expect = "md5" + hashlib.md5(inner.encode() + salt).hexdigest()
            return hmac.compare_digest(body.rstrip(b"\0").decode(), expect)
        if mode == "scram-sha-256":
            return self._auth_scram(sock, reader)
        return False

    def _auth_scram(self, sock, reader: _Reader) -> bool:
        sock.sendall(_msg(b"R", struct.pack("!I", 10)
                          + _cstr("SCRAM-SHA-256") + b"\0"))
        kind, body = reader.message()
        if kind != b"p":
            return False
        mech, _, rest = body.partition(b"\0")
        if mech != b"SCRAM-SHA-256":
            return False
        (rlen,) = struct.unpack("!I", rest[:4])
        client_first = rest[4:4 + rlen].decode()
        first_bare = client_first.split(",", 2)[2]
        cattrs = dict(kv.split("=", 1) for kv in first_bare.split(","))
        cnonce = cattrs["r"]

        salt = secrets.token_bytes(16)
        iters = 4096
        snonce = cnonce + base64.b64encode(secrets.token_bytes(12)).decode()
        server_first = (f"r={snonce},s={base64.b64encode(salt).decode()},"
                        f"i={iters}")
        sock.sendall(_msg(b"R", struct.pack("!I", 11)
                          + server_first.encode()))

        kind, body = reader.message()
        if kind != b"p":
            return False
        client_final = body.decode()
        fattrs = dict(kv.split("=", 1) for kv in client_final.split(","))
        if fattrs.get("r") != snonce:
            return False
        proof = base64.b64decode(fattrs["p"])
        final_wo_proof = client_final.rsplit(",p=", 1)[0]
        auth_msg = f"{first_bare},{server_first},{final_wo_proof}"

        salted = _scram_salted_password(self.mini.password, salt, iters)
        client_key, stored_key, server_key = _scram_keys(salted)
        signature = _hmac256(stored_key, auth_msg)
        expect_proof = bytes(a ^ b for a, b in zip(client_key, signature))
        if not hmac.compare_digest(proof, expect_proof):
            return False
        verifier = base64.b64encode(
            _hmac256(server_key, auth_msg)).decode()
        sock.sendall(_msg(b"R", struct.pack("!I", 12)
                          + f"v={verifier}".encode()))
        return True

    # ------------------------------------------------------------- cycles
    def _ready(self, sock, status: bytes = b"I") -> None:
        sock.sendall(_msg(b"Z", status))

    def _error(self, sock, sqlstate: str, message: str) -> None:
        payload = (b"S" + _cstr("ERROR") + b"C" + _cstr(sqlstate)
                   + b"M" + _cstr(message) + b"\0")
        sock.sendall(_msg(b"E", payload))

    def _simple(self, sock, query: str) -> None:
        try:
            rows, columns, tag = self.mini.run_sql(
                self.conn, self.state, query, [])
        except sqlite3.Error as exc:
            self._error(sock, "42601", str(exc))
            self._ready(sock)
            return
        self._send_rows(sock, rows, columns, tag)
        self._ready(sock)

    def _bind(self, sock, body: bytes, statements: dict[str, str],
              portals: dict[str, tuple[str, list[Any]]]) -> bool:
        off = body.index(b"\0")
        portal = body[:off].decode()
        off += 1
        end = body.index(b"\0", off)
        stmt = body[off:end].decode()
        off = end + 1
        (nfmt,) = struct.unpack("!H", body[off:off + 2])
        off += 2
        fmts = struct.unpack(f"!{nfmt}h", body[off:off + 2 * nfmt])
        off += 2 * nfmt
        (nparams,) = struct.unpack("!H", body[off:off + 2])
        off += 2
        params: list[Any] = []
        for i in range(nparams):
            (length,) = struct.unpack("!i", body[off:off + 4])
            off += 4
            if length == -1:
                params.append(None)
                continue
            data = body[off:off + length]
            off += length
            fmt = fmts[i] if i < nfmt else (fmts[0] if nfmt else 0)
            params.append(data if fmt == 1 else _sql_coerce(data.decode()))
        if stmt not in statements:
            self._error(sock, "26000", f"unknown statement {stmt!r}")
            return False
        portals[portal] = (statements[stmt], params)
        sock.sendall(_msg(b"2", b""))
        return True

    def _execute(self, sock,
                 bound: tuple[str, list[Any]] | None) -> bool:
        if bound is None:
            self._error(sock, "34000", "unknown portal")
            return False
        query, params = bound
        try:
            rows, columns, tag = self.mini.run_sql(
                self.conn, self.state, query, params)
        except sqlite3.Error as exc:
            self._error(sock, "42601", str(exc))
            return False
        self._send_rows(sock, rows, columns, tag)
        return True

    def _send_rows(self, sock, rows: list[tuple],
                   columns: list[str], tag: str) -> None:
        if columns:
            desc = [struct.pack("!H", len(columns))]
            for i, name in enumerate(columns):
                # first non-null value decides the OID — a NULL in row
                # 0 must not turn a numeric column into text
                sample = next((row[i] for row in rows
                               if row[i] is not None), None)
                oid = _oid_for(sample) if sample is not None else OID_TEXT
                desc.append(_cstr(name)
                            + struct.pack("!IhIhih", 0, 0, oid, -1, -1, 0))
            sock.sendall(_msg(b"T", b"".join(desc)))
            for row in rows:
                parts = [struct.pack("!H", len(row))]
                for val in row:
                    if val is None:
                        parts.append(struct.pack("!i", -1))
                    else:
                        data = _render_value(val)
                        parts.append(struct.pack("!i", len(data)) + data)
                sock.sendall(_msg(b"D", b"".join(parts)))
        sock.sendall(_msg(b"C", _cstr(tag)))


def _sql_coerce(text: str) -> Any:
    """Text-format parameter -> a Python value sqlite compares sanely.

    Real postgres casts by the statement's inferred parameter types;
    the mini server approximates with value-shape detection.
    """
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        pass
    if text in ("t", "true", "f", "false"):
        return text in ("t", "true")
    if text.startswith("\\x"):
        try:
            return bytes.fromhex(text[2:])
        except ValueError:
            pass
    return text


class _ConnState:
    """Per-client-connection transaction state."""

    __slots__ = ("in_tx",)

    def __init__(self) -> None:
        self.in_tx = False


class MiniPostgresServer:
    """Backend half of the v3 protocol over an embedded sqlite engine.

    ``auth`` selects the exchange the server demands: ``trust``,
    ``password``, ``md5``, or ``scram-sha-256`` — each verified for
    real, so a wrong secret fails exactly like production postgres.

    Each client connection gets its own sqlite connection onto one
    shared-cache in-memory database, and an open wire-level BEGIN holds
    a server-wide transaction lock until COMMIT/ROLLBACK — so one
    client's transaction neither sees nor swallows another client's
    statements, matching postgres's per-connection transactions.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 user: str = "postgres", password: str = "secret",
                 auth: str = "md5") -> None:
        self.host = host
        self.port = port
        self.user = user
        self.password = password
        self.auth = auth
        self._db_uri = (f"file:minipg_{os.getpid()}_{id(self):x}"
                        "?mode=memory&cache=shared")
        # the anchor connection keeps the shared in-memory DB alive
        self._anchor = self.new_conn()
        self._tx_lock = threading.RLock()
        self._server: socketserver.ThreadingTCPServer | None = None
        self._thread: threading.Thread | None = None

    def new_conn(self) -> sqlite3.Connection:
        # true autocommit: the wire-level BEGIN/COMMIT/ROLLBACK coming
        # from clients manage transactions explicitly, like postgres
        return sqlite3.connect(self._db_uri, uri=True,
                               check_same_thread=False,
                               isolation_level=None)

    def release_tx(self, state: _ConnState) -> None:
        if state.in_tx:
            state.in_tx = False
            self._tx_lock.release()

    def run_sql(self, conn: sqlite3.Connection, state: _ConnState,
                query: str,
                params: list[Any]) -> tuple[list[tuple], list[str], str]:
        qmark, order = _dollar_to_qmark(query)
        bad = [i for i in order if not 1 <= i <= len(params)]
        if bad:
            # surfaces as an ErrorResponse, not a torn connection
            raise sqlite3.OperationalError(
                f"there is no parameter ${bad[0]}")
        args = [params[i - 1] for i in order] if order else params
        word = query.split(None, 1)[0].upper() if query.split() else ""
        if word == "BEGIN" and not state.in_tx:
            self._tx_lock.acquire()
            state.in_tx = True
            try:
                conn.execute(qmark, args)
            except BaseException:
                self.release_tx(state)
                raise
            return [], [], "BEGIN"
        if word in ("COMMIT", "ROLLBACK", "END") and state.in_tx:
            try:
                cur = conn.execute(qmark, args)
                cur.fetchall()
            finally:
                self.release_tx(state)
            return [], [], "COMMIT" if word == "END" else word
        if state.in_tx:  # this connection already holds the lock
            cur = conn.execute(qmark, args)
            rows = [tuple(r) for r in cur.fetchall()]
        else:
            with self._tx_lock:
                cur = conn.execute(qmark, args)
                rows = [tuple(r) for r in cur.fetchall()]
        columns = ([d[0] for d in cur.description]
                   if cur.description else [])
        if word == "SELECT" or columns:
            tag = f"SELECT {len(rows)}"
        elif word == "INSERT":
            tag = f"INSERT 0 {cur.rowcount if cur.rowcount > 0 else 0}"
        elif word in ("UPDATE", "DELETE"):
            tag = f"{word} {cur.rowcount if cur.rowcount > 0 else 0}"
        else:
            tag = word or "OK"
        return rows, columns, tag

    def start(self) -> None:
        class TCP(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = TCP((self.host, self.port), _PGHandler)
        self._server.mini = self  # the handler reads this back
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True,
                                        name="mini-postgres")
        self._thread.start()

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        self._anchor.close()

"""MySQL network client speaking the client/server protocol, plus a
mini server.

The reference's SQL datasource dials mysql through database/sql +
go-sql-driver (sql.go:22-35); this client implements the protocol
itself: 3-byte-length + sequence packet framing, the v10 initial
handshake, ``mysql_native_password`` challenge-response auth
(``SHA1(pw) XOR SHA1(scramble + SHA1(SHA1(pw)))``), and the COM_QUERY
text protocol — OK / ERR / result-set packets with length-encoded
columns and NULLs. ``?`` placeholders are expanded to escaped literals
client-side (the text-protocol technique), and the method surface
mirrors :class:`~gofr_tpu_torch.datasource.sql.SQL`
(query/query_row/exec/select/begin/health_check), selected by
``DB_DIALECT=mysql`` + ``DB_HOST``.

:class:`MiniMySQLServer` implements the server half over sqlite —
real handshake bytes, verified auth (wrong password → ERR 1045), the
same result-set encoding mysqld produces.

The port's copy of ``gofr_tpu/datasource/mysql_wire.py``.
"""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
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

CAP_LONG_PASSWORD = 0x0001
CAP_PROTOCOL_41 = 0x0200
CAP_SECURE_CONNECTION = 0x8000
CAP_PLUGIN_AUTH = 0x80000

_CAPS = CAP_LONG_PASSWORD | CAP_PROTOCOL_41 | CAP_SECURE_CONNECTION \
    | CAP_PLUGIN_AUTH

COM_QUIT = 0x01
COM_QUERY = 0x03
COM_PING = 0x0E

TYPE_DOUBLE = 0x05
TYPE_LONGLONG = 0x08
TYPE_BLOB = 0xFC
TYPE_VAR_STRING = 0xFD


class MySQLError(SQLError):
    def __init__(self, message: str, code: int = 0,
                 sqlstate: str = "") -> None:
        super().__init__(message)
        self.code = code
        self.sqlstate = sqlstate


# ------------------------------------------------------------- primitives

def lenenc(n: int) -> bytes:
    if n < 0xFB:
        return bytes([n])
    if n < 1 << 16:
        return b"\xfc" + struct.pack("<H", n)
    if n < 1 << 24:
        return b"\xfd" + struct.pack("<I", n)[:3]
    return b"\xfe" + struct.pack("<Q", n)


def read_lenenc(data: bytes, off: int) -> tuple[int | None, int]:
    first = data[off]
    off += 1
    if first < 0xFB:
        return first, off
    if first == 0xFB:
        return None, off  # NULL
    if first == 0xFC:
        return struct.unpack_from("<H", data, off)[0], off + 2
    if first == 0xFD:
        return int.from_bytes(data[off:off + 3], "little"), off + 3
    return struct.unpack_from("<Q", data, off)[0], off + 8


def native_password_scramble(password: str, scramble: bytes) -> bytes:
    if not password:
        return b""
    h1 = hashlib.sha1(password.encode()).digest()
    h2 = hashlib.sha1(h1).digest()
    h3 = hashlib.sha1(scramble + h2).digest()
    return bytes(a ^ b for a, b in zip(h1, h3))


def escape_literal(value: Any) -> str:
    if value is None:
        return "NULL"
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, (int, float)):
        return str(value)
    if isinstance(value, bytes):
        return "x'" + value.hex() + "'"
    text = str(value)
    for ch, esc in (("\\", "\\\\"), ("'", "\\'"), ("\0", "\\0"),
                    ("\n", "\\n"), ("\r", "\\r"), ("\x1a", "\\Z")):
        text = text.replace(ch, esc)
    return f"'{text}'"


def expand_qmarks(stmt: str, args: tuple) -> str:
    """``?`` -> escaped literals, skipping string literals, backtick
    identifiers, and ``--``/``#``/``/* */`` comments."""
    out: list[str] = []
    it = iter(args)
    quote: str | None = None  # ' " or ` while inside one
    i = 0
    while i < len(stmt):
        ch = stmt[i]
        if quote is not None:
            out.append(ch)
            if ch == "\\" and quote != "`" and i + 1 < len(stmt):
                out.append(stmt[i + 1])
                i += 1
            elif ch == quote:
                quote = None
        elif ch in ("'", '"', "`"):
            quote = ch
            out.append(ch)
        elif ch == "#" or (stmt[i:i + 2] == "--"
                           and (i + 2 >= len(stmt)
                                or stmt[i + 2] in " \t\n")):
            end = stmt.find("\n", i)
            end = len(stmt) if end == -1 else end
            out.append(stmt[i:end])
            i = end
            continue
        elif stmt[i:i + 2] == "/*":
            end = stmt.find("*/", i + 2)
            end = len(stmt) if end == -1 else end + 2
            out.append(stmt[i:end])
            i = end
            continue
        elif ch == "?":
            try:
                out.append(escape_literal(next(it)))
            except StopIteration:
                raise MySQLError("more ? placeholders than arguments") \
                    from None
        else:
            out.append(ch)
        i += 1
    leftover = sum(1 for _ in it)
    if leftover:
        raise MySQLError(f"{leftover} unused bind arguments")
    return "".join(out)


class _Packets:
    """MySQL packet framing: 3-byte length + sequence id."""

    def __init__(self, sock: socket.socket) -> None:
        self._sock = sock
        self._buf = b""
        self.seq = 0

    def _exactly(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise MySQLError("connection closed")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def recv(self) -> bytes:
        out = b""
        while True:  # 0xFFFFFF-length packets continue in the next one
            header = self._exactly(4)
            length = int.from_bytes(header[:3], "little")
            self.seq = header[3] + 1
            out += self._exactly(length)
            if length < 0xFFFFFF:
                return out

    def send(self, payload: bytes) -> None:
        while True:  # split >=16MB payloads per the protocol
            chunk, payload = payload[:0xFFFFFF], payload[0xFFFFFF:]
            self._sock.sendall(len(chunk).to_bytes(3, "little")
                               + bytes([self.seq & 0xFF]) + chunk)
            self.seq += 1
            if len(chunk) < 0xFFFFFF:
                return

    def reset(self) -> None:
        self.seq = 0


class MySQLRow(dict):
    """Mapping row with ``keys()`` — the sqlite3.Row subset callers use."""

    __slots__ = ()


# ---------------------------------------------------------------- client

class MySQLWire(ProviderMixin):
    """Text-protocol mysql client behind the SQL datasource surface."""

    dialect = "mysql"

    def __init__(self, *, host: str = "localhost", port: int = 3306,
                 user: str = "root", password: str = "",
                 database: str = "", timeout_s: float = 30.0) -> None:
        self.host = host
        self.port = port
        self.user = user
        self.password = password
        self.database = database
        self.timeout_s = timeout_s
        self._sock: socket.socket | None = None
        self._packets: _Packets | None = None
        self._lock = threading.RLock()
        self.server_version = ""

    # ------------------------------------------------------------ connect
    def connect(self) -> None:
        if self._sock is not None:
            self.close()
        sock = socket.create_connection((self.host, self.port),
                                        timeout=self.timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        packets = _Packets(sock)
        try:
            greeting = packets.recv()
            if greeting[:1] == b"\xff":
                raise self._err(greeting)
            if greeting[0] != 10:
                raise MySQLError(
                    f"unsupported protocol version {greeting[0]}")
            off = 1
            end = greeting.index(b"\0", off)
            self.server_version = greeting[off:end].decode()
            off = end + 1 + 4  # thread id
            scramble = greeting[off:off + 8]
            off += 8 + 1  # filler
            off += 2 + 1 + 2 + 2  # caps low, charset, status, caps high
            auth_len = greeting[off]
            off += 1 + 10  # reserved
            tail = max(13, auth_len - 8) if auth_len else 13
            part2 = greeting[off:off + tail]
            if part2.endswith(b"\0"):  # exactly the one terminator —
                part2 = part2[:-1]      # scramble bytes may BE 0x00
            scramble = (scramble + part2)[:20]

            token = native_password_scramble(self.password, scramble)
            caps = _CAPS | (0x08 if self.database else 0)  # CONNECT_WITH_DB
            response = struct.pack("<IIB23x", caps, 1 << 24, 0x21)
            response += self.user.encode() + b"\0"
            response += bytes([len(token)]) + token
            if self.database:
                response += self.database.encode() + b"\0"
            response += b"mysql_native_password\0"
            packets.send(response)
            reply = packets.recv()
            if reply[:1] == b"\xfe" and len(reply) > 1:
                # AuthSwitchRequest (mysql 8 defaults to
                # caching_sha2_password): switch back to
                # mysql_native_password when offered, else fail clearly
                end = reply.index(b"\0", 1)
                plugin = reply[1:end].decode()
                if plugin != "mysql_native_password":
                    raise MySQLError(
                        f"server requires auth plugin {plugin!r}; only "
                        "mysql_native_password is supported")
                new_scramble = reply[end + 1:]
                if new_scramble.endswith(b"\0"):
                    new_scramble = new_scramble[:-1]
                new_scramble = new_scramble[:20]
                packets.send(native_password_scramble(
                    self.password, new_scramble))
                reply = packets.recv()
            if reply[:1] == b"\xff":
                raise self._err(reply)
            if reply[:1] != b"\x00":
                raise MySQLError(
                    f"unexpected auth reply {reply[:1].hex()}")
            self._packets = packets
        except BaseException:
            sock.close()
            self._sock = None
            self._packets = None
            raise
        if self.logger is not None:
            self.logger.info("connected to mysql", host=self.host,
                             port=self.port, database=self.database)

    @staticmethod
    def _err(payload: bytes) -> MySQLError:
        code = struct.unpack_from("<H", payload, 1)[0]
        off = 3
        sqlstate = ""
        if payload[off:off + 1] == b"#":
            sqlstate = payload[off + 1:off + 6].decode()
            off += 6
        return MySQLError(payload[off:].decode("utf-8", "replace"),
                          code=code, sqlstate=sqlstate)

    def close(self) -> None:
        if self._sock is not None:
            try:
                if self._packets is not None:
                    self._packets.reset()
                    self._packets.send(bytes([COM_QUIT]))
            except OSError:
                pass
            self._sock.close()
            self._sock = None
            self._packets = None

    # ------------------------------------------------------------- query
    def _com_query(self, sql: str) -> tuple[list[MySQLRow], int]:
        """-> (rows, affected)."""
        if self._packets is None:
            raise MySQLError("not connected; call connect() first")
        packets = self._packets
        try:
            packets.reset()
            packets.send(bytes([COM_QUERY]) + sql.encode())
            first = packets.recv()
            if first[:1] == b"\xff":
                raise self._err(first)
            if first[:1] == b"\x00":  # OK packet
                affected, off = read_lenenc(first, 1)
                return [], affected or 0
            ncols, _ = read_lenenc(first, 0)
            columns = []
            for _ in range(ncols or 0):
                columns.append(self._column_def(packets.recv()))
            payload = packets.recv()  # EOF closing the column block
            if not (payload[:1] == b"\xfe" and len(payload) < 9):
                raise MySQLError("expected EOF after column definitions")
            rows: list[MySQLRow] = []
            while True:
                payload = packets.recv()
                if payload[:1] == b"\xfe" and len(payload) < 9:  # EOF
                    return rows, 0
                if payload[:1] == b"\xff":
                    raise self._err(payload)
                row = MySQLRow()
                off = 0
                for name, type_id in columns:
                    value, off = self._read_value(payload, off, type_id)
                    row[name] = value
                rows.append(row)
        except (OSError, TimeoutError) as exc:
            self.close()  # poisoned stream: replies would misalign
            raise MySQLError(
                f"connection lost mid-query ({exc})") from exc
        except MySQLError as exc:
            # server ERR packets (code != 0) leave the stream aligned;
            # structural errors (code 0) mean unread packets remain
            if exc.code == 0:
                self.close()
            raise
        except (struct.error, IndexError) as exc:
            self.close()
            raise MySQLError(f"malformed packet ({exc})") from exc

    @staticmethod
    def _column_def(payload: bytes) -> tuple[str, int]:
        """-> (name, type byte) from a column-definition packet."""
        off = 0
        for _ in range(4):  # catalog, schema, table, org_table
            n, off = read_lenenc(payload, off)
            off += n or 0
        n, off = read_lenenc(payload, off)
        name = payload[off:off + (n or 0)].decode()
        off += n or 0
        n, off = read_lenenc(payload, off)  # org_name
        off += n or 0
        off += 1 + 2 + 4  # fixed-len marker, charset, column length
        type_id = payload[off] if off < len(payload) else TYPE_VAR_STRING
        return name, type_id

    @staticmethod
    def _read_value(payload: bytes, off: int,
                    type_id: int) -> tuple[Any, int]:
        n, off = read_lenenc(payload, off)
        if n is None:
            return None, off
        raw = payload[off:off + n]
        off += n
        try:
            if type_id in (TYPE_LONGLONG, 0x01, 0x02, 0x03, 0x09):
                return int(raw), off
            if type_id in (TYPE_DOUBLE, 0x04, 0x00):  # double/float/dec
                return float(raw), off
            if type_id == TYPE_BLOB:
                return bytes(raw), off
        except ValueError:
            pass  # mixed-type sqlite column behind the mini server
        return raw.decode("utf-8", "surrogateescape"), off

    # --------------------------------------------------- public surface
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
        return "?"

    def query(self, query: str, *args: Any) -> list[MySQLRow]:
        start = time.perf_counter()
        span = (self.tracer.start_span(f"sql {query.split(None, 1)[0]}")
                if self.tracer is not None else None)
        try:
            with self._lock:
                rows, _ = self._com_query(expand_qmarks(query, args))
                return rows
        finally:
            if span is not None:
                span.end()
            self._observe(query, args, start)

    def query_row(self, query: str, *args: Any) -> MySQLRow | None:
        rows = self.query(query, *args)
        return rows[0] if rows else None

    def exec(self, query: str, *args: Any) -> "MySQLResult":
        start = time.perf_counter()
        span = (self.tracer.start_span(f"sql {query.split(None, 1)[0]}")
                if self.tracer is not None else None)
        try:
            with self._lock:
                _, affected = self._com_query(expand_qmarks(query, args))
                return MySQLResult(affected)
        finally:
            if span is not None:
                span.end()
            self._observe(query, args, start)

    @contextmanager
    def begin(self) -> Iterator["MySQLWire"]:
        with self._lock:
            self._com_query("BEGIN")
            try:
                yield self
                self._com_query("COMMIT")
            except BaseException:
                if self._sock is not None:
                    self._com_query("ROLLBACK")
                raise

    def select(self, entity_type: type, query: str, *args: Any) -> list[Any]:
        from dataclasses import fields, is_dataclass
        if not is_dataclass(entity_type):
            raise SQLError("select requires a dataclass type")
        out = []
        for row in self.query(query, *args):
            kwargs = {}
            for f in fields(entity_type):
                if f.name in row and row[f.name] is not None:
                    value = row[f.name]
                    if f.type in (int, "int"):
                        value = int(value)
                    elif f.type in (float, "float"):
                        value = float(value)
                    kwargs[f.name] = value
            out.append(entity_type(**kwargs))
        return out

    def health_check(self) -> dict[str, Any]:
        try:
            self.query("SELECT 1")
            return {"status": "UP",
                    "details": {"host": self.host, "port": self.port,
                                "database": self.database,
                                "server": self.server_version}}
        except Exception as exc:
            return {"status": "DOWN", "error": str(exc)}


class MySQLResult:
    def __init__(self, rowcount: int) -> None:
        self.rowcount = rowcount


# ------------------------------------------------------------ mini server

_BACKSLASH_MAP = {"n": "\n", "r": "\r", "t": "\t", "0": "\0",
                  "Z": "\x1a", "\\": "\\", "'": "'", '"': '"',
                  "%": "\\%", "_": "\\_"}


def _mysql_to_sqlite(sql: str) -> str:
    """Translate MySQL string-literal syntax (backslash escapes,
    double-quoted strings) into sqlite's, the way mysqld's lexer would
    read it."""
    out: list[str] = []
    quote: str | None = None
    i = 0
    while i < len(sql):
        ch = sql[i]
        if quote is None:
            if ch in ("'", '"'):
                quote = ch
                out.append("'")  # double-quoted strings become single
            else:
                out.append(ch)
        elif ch == "\\" and i + 1 < len(sql):
            mapped = _BACKSLASH_MAP.get(sql[i + 1], sql[i + 1])
            out.append("''" if mapped == "'" else mapped)
            i += 1
        elif ch == quote:
            # '' / "" is an escaped delimiter inside the literal
            if i + 1 < len(sql) and sql[i + 1] == quote:
                out.append("''" if quote == "'" else quote)
                i += 1
            else:
                quote = None
                out.append("'")
        elif ch == "'":
            out.append("''")  # ' inside a "..." literal
        else:
            out.append(ch)
        i += 1
    return "".join(out)


class _MySQLHandler(socketserver.BaseRequestHandler):
    @property
    def mini(self) -> "MiniMySQLServer":
        return self.server.mini  # type: ignore[attr-defined]

    def handle(self) -> None:
        import os
        # a result set is several small packets: without NODELAY, Nagle
        # holds each after the first until the client's delayed ACK
        self.request.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        packets = _Packets(self.request)
        try:
            # real mysqld salts avoid NUL (it terminates the field)
            scramble = bytes(b % 255 + 1 for b in os.urandom(20))
            greeting = bytes([10]) + b"8.0-mini\0" \
                + struct.pack("<I", 1) + scramble[:8] + b"\0" \
                + struct.pack("<H", _CAPS & 0xFFFF) + bytes([0x21]) \
                + struct.pack("<H", 2) \
                + struct.pack("<H", (_CAPS >> 16) & 0xFFFF) \
                + bytes([21]) + b"\0" * 10 + scramble[8:] + b"\0" \
                + b"mysql_native_password\0"
            packets.send(greeting)
            response = packets.recv()
            off = 4 + 4 + 1 + 23
            end = response.index(b"\0", off)
            user = response[off:end].decode()
            off = end + 1
            token_len = response[off]
            token = response[off + 1:off + 1 + token_len]
            expect = native_password_scramble(
                self.mini.password, scramble)
            if user != self.mini.user or not hmac_mod.compare_digest(
                    token, expect):
                packets.send(
                    b"\xff" + struct.pack("<H", 1045) + b"#28000"
                    + b"Access denied")
                return
            packets.send(b"\x00\x00\x00" + struct.pack("<HH", 2, 0))

            conn = self.mini.new_conn()
            try:
                while True:
                    packets.reset()
                    command = packets.recv()
                    if not command or command[0] == COM_QUIT:
                        return
                    if command[0] == COM_PING:
                        packets.send(b"\x00\x00\x00"
                                     + struct.pack("<HH", 2, 0))
                        continue
                    if command[0] != COM_QUERY:
                        packets.send(
                            b"\xff" + struct.pack("<H", 1047) + b"#08S01"
                            + b"unsupported command")
                        continue
                    self._query(packets, conn, command[1:].decode())
            finally:
                conn.close()
        except (MySQLError, ConnectionError, OSError):
            return

    def _query(self, packets: _Packets, conn: sqlite3.Connection,
               sql: str) -> None:
        try:
            with self.mini.lock:
                cur = conn.execute(_mysql_to_sqlite(sql))
                rows = cur.fetchall()
        except sqlite3.Error as exc:
            packets.send(b"\xff" + struct.pack("<H", 1064) + b"#42000"
                         + str(exc).encode())
            return
        if cur.description is None:
            affected = cur.rowcount if cur.rowcount > 0 else 0
            packets.send(b"\x00" + lenenc(affected) + lenenc(0)
                         + struct.pack("<HH", 2, 0))
            return
        names = [d[0] for d in cur.description]
        packets.send(lenenc(len(names)))
        for idx, name in enumerate(names):
            sample = next((row[idx] for row in rows
                           if row[idx] is not None), None)
            if isinstance(sample, int) and not isinstance(sample, bool):
                type_id = TYPE_LONGLONG
            elif isinstance(sample, float):
                type_id = TYPE_DOUBLE
            elif isinstance(sample, bytes):
                type_id = TYPE_BLOB
            else:
                type_id = TYPE_VAR_STRING
            payload = b""
            for field in ("def", "", "t", "t"):
                payload += lenenc(len(field)) + field.encode()
            payload += lenenc(len(name)) + name.encode()
            payload += lenenc(len(name)) + name.encode()
            payload += bytes([0x0C]) + struct.pack("<H", 0x21) \
                + struct.pack("<I", 1024) + bytes([type_id]) \
                + struct.pack("<H", 0) + bytes([0, 0, 0])
            packets.send(payload)
        packets.send(b"\xfe" + struct.pack("<HH", 0, 2))  # EOF
        for row in rows:
            payload = b""
            for value in row:
                if value is None:
                    payload += b"\xfb"
                else:
                    if isinstance(value, bytes):
                        data = value
                    else:
                        data = str(value).encode()
                    payload += lenenc(len(data)) + data
            packets.send(payload)
        packets.send(b"\xfe" + struct.pack("<HH", 0, 2))  # EOF


class MiniMySQLServer:
    """Server half of the mysql protocol over a shared-cache sqlite
    database (one connection per client, like
    :class:`~gofr_tpu_torch.datasource.postgres_wire.MiniPostgresServer`)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 user: str = "root", password: str = "secret") -> None:
        import os
        self.host = host
        self.port = port
        self.user = user
        self.password = password
        self._db_uri = (f"file:minimysql_{os.getpid()}_{id(self):x}"
                        "?mode=memory&cache=shared")
        self._anchor = self.new_conn()
        self.lock = threading.RLock()
        self._server: socketserver.ThreadingTCPServer | None = None
        self._thread: threading.Thread | None = None

    def new_conn(self) -> sqlite3.Connection:
        return sqlite3.connect(self._db_uri, uri=True,
                               check_same_thread=False,
                               isolation_level=None)

    def start(self) -> None:
        class TCP(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = TCP((self.host, self.port), _MySQLHandler)
        self._server.mini = self  # the handler reads this back
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="mini-mysql")
        self._thread.start()

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        self._anchor.close()

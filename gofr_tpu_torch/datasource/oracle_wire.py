"""Oracle wire client — TNS transport + O5LOGON-style auth.

The reference's oracle module wraps ``database/sql`` + the godror
driver (reference pkg/gofr/datasource/oracle/oracle.go:74-145,
interface.go:5-16); the driver speaks Oracle's TNS/TTC protocol. This
module implements the wire layers whose formats are publicly
documented, to the same bar as the repo's other wire clients:

- **TNS packet layer** (the Transparent Network Substrate framing
  every Oracle connection uses): 8-byte header ``!HHBBH`` =
  packet length, checksum, packet type, flags, header checksum;
  CONNECT (0x01, carrying the ``(DESCRIPTION=...)`` connect
  descriptor), ACCEPT (0x02), REFUSE (0x04, ORA- error payload),
  DATA (0x06, 2-byte data flags), MARKER (0x0C, break/reset pairs),
  RESEND (0x0B).
- **O5LOGON-shaped auth** (the 11g+ challenge-response): the server
  sends ``AUTH_VFR_DATA`` (password salt) and ``AUTH_SESSKEY`` — a
  random session half AES-192-CBC-encrypted under a key derived from
  the password verifier ``SHA1(password || salt)``; the client
  decrypts it, generates its own half, returns it encrypted the same
  way, and both sides derive the combined key that encrypts
  ``AUTH_PASSWORD``. A wrong password fails to decrypt and the server
  refuses with ORA-01017.
- **Statement layer**: Oracle's inner TTC RPC encoding is proprietary
  and undocumented; statements + ``:1``-style binds ride DATA packets
  in a compact length-prefixed form documented here (`_wire_fields`),
  with ORA-coded errors and DUAL supported by the mini server's
  engine. The framing above it is byte-faithful TNS.

Interface parity with the reference Connection/Txn (interface.go):
``select``/``exec``/``ping``/``begin``/``commit``/``rollback``, plus
the provider pattern and per-op stats every repo datasource records.

The port's copy of ``gofr_tpu/datasource/oracle_wire.py``. Its
AES-192-CBC is written in the module (``_aes_cbc``, FIPS-197), so the
port needs no crypto package; the bytes on the wire are the same.
"""

from __future__ import annotations

import hashlib
import os
import socket
import struct
import threading
import time
from contextlib import contextmanager
from dataclasses import fields as dc_fields, is_dataclass
from typing import Any, Iterator

from . import Instrumented

# ------------------------------------------------------------- TNS layer

TNS_CONNECT = 1
TNS_ACCEPT = 2
TNS_REFUSE = 4
TNS_DATA = 6
TNS_RESEND = 11
TNS_MARKER = 12

TNS_VERSION = 314          # 0x013A, the 11g+ wire version
DATA_FLAG_EOF = 0x0040

MARKER_BREAK = 1
MARKER_RESET = 2


class OracleError(Exception):
    def __init__(self, message: str, code: int = 0) -> None:
        super().__init__(message)
        self.code = code                      # ORA-xxxxx number


class _Stream:
    """Fragmentation-safe reader (the byte-dribble torture contract)."""

    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock

    def exactly(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise OracleError("connection closed mid-packet", 3113)
            buf += chunk
        return buf


def send_packet(sock: socket.socket, ptype: int, payload: bytes) -> None:
    header = struct.pack("!HHBBH", 8 + len(payload), 0, ptype, 0, 0)
    sock.sendall(header + payload)


def recv_packet(stream: _Stream) -> tuple[int, bytes]:
    header = stream.exactly(8)
    length, _csum, ptype, _flags, _hcsum = struct.unpack("!HHBBH", header)
    if not 8 <= length <= 0xFFFF:
        raise OracleError(f"TNS packet length {length} out of bounds", 12592)
    return ptype, stream.exactly(length - 8)


def send_data(sock: socket.socket, payload: bytes, flags: int = 0) -> None:
    send_packet(sock, TNS_DATA, struct.pack("!H", flags) + payload)


def send_marker(sock: socket.socket, kind: int) -> None:
    # marker packets are 3 data bytes: type 1, zero, marker kind
    send_packet(sock, TNS_MARKER, bytes([1, 0, kind]))


# --------------------------------------------------- statement wire form

def _wire_fields(pairs: list[tuple[str, bytes]]) -> bytes:
    """Length-prefixed key/value fields riding a DATA packet."""
    out = b""
    for key, value in pairs:
        kb = key.encode()
        out += struct.pack("!HI", len(kb), len(value)) + kb + value
    return out


def _parse_fields(payload: bytes) -> list[tuple[str, bytes]]:
    out = []
    off = 0
    while off < len(payload):
        if off + 6 > len(payload):
            raise OracleError("truncated field header", 3137)
        klen, vlen = struct.unpack_from("!HI", payload, off)
        off += 6
        if off + klen + vlen > len(payload):
            raise OracleError("truncated field payload", 3137)
        key = payload[off:off + klen].decode()
        off += klen
        out.append((key, payload[off:off + vlen]))
        off += vlen
    return out


# ------------------------------------------------------------ auth crypto

def _pad16(b: bytes) -> bytes:
    pad = 16 - len(b) % 16
    return b + bytes([pad]) * pad


def _unpad16(b: bytes) -> bytes:
    if not b or b[-1] > 16:
        raise OracleError("bad padding", 1017)
    return b[:-b[-1]]


def _xtime(a: int) -> int:
    a <<= 1
    return a ^ 0x11B if a & 0x100 else a


def _gmul(a: int, b: int) -> int:
    out = 0
    while b:
        if b & 1:
            out ^= a
        a, b = _xtime(a), b >> 1
    return out


def _make_sbox() -> tuple[bytes, bytes]:
    """FIPS-197 §5.1.1: the multiplicative inverse in GF(2^8), then the
    affine map."""
    sbox = bytearray(256)
    for x in range(256):
        inv = next((y for y in range(1, 256) if _gmul(x, y) == 1), 0)
        v = inv
        for shift in (1, 2, 3, 4):
            v ^= ((inv << shift) | (inv >> (8 - shift))) & 0xFF
        sbox[x] = v ^ 0x63
    inv_sbox = bytearray(256)
    for x, v in enumerate(sbox):
        inv_sbox[v] = x
    return bytes(sbox), bytes(inv_sbox)


_SBOX, _INV_SBOX = _make_sbox()


def _expand_key(key: bytes) -> list[list[int]]:
    """FIPS-197 §5.2: the round keys, one 16-byte list per round."""
    nk = len(key) // 4
    rounds = nk + 6
    words = [list(key[4 * i:4 * i + 4]) for i in range(nk)]
    rcon = 1
    for i in range(nk, 4 * (rounds + 1)):
        t = list(words[-1])
        if i % nk == 0:
            t = [_SBOX[b] for b in t[1:] + t[:1]]
            t[0] ^= rcon
            rcon = _xtime(rcon)
        elif nk > 6 and i % nk == 4:
            t = [_SBOX[b] for b in t]
        words.append([a ^ b for a, b in zip(words[i - nk], t)])
    return [sum(words[4 * r:4 * r + 4], []) for r in range(rounds + 1)]


def _mix(col: list[int], m: tuple[int, int, int, int]) -> list[int]:
    return [_gmul(col[0], m[(0 - r) % 4]) ^ _gmul(col[1], m[(1 - r) % 4])
            ^ _gmul(col[2], m[(2 - r) % 4]) ^ _gmul(col[3], m[(3 - r) % 4])
            for r in range(4)]


_MIX, _INV_MIX = (2, 3, 1, 1), (14, 11, 13, 9)


def _encrypt_block(rk: list[list[int]], block: bytes) -> bytes:
    s = [a ^ b for a, b in zip(block, rk[0])]
    for r in range(1, len(rk)):
        s = [_SBOX[b] for b in s]
        # ShiftRows: row i of column c comes from column c + i
        s = [s[(4 * (c + i) + i) % 16] for c in range(4) for i in range(4)]
        if r < len(rk) - 1:
            s = sum((_mix(s[4 * c:4 * c + 4], _MIX) for c in range(4)), [])
        s = [a ^ b for a, b in zip(s, rk[r])]
    return bytes(s)


def _decrypt_block(rk: list[list[int]], block: bytes) -> bytes:
    s = [a ^ b for a, b in zip(block, rk[-1])]
    for r in range(len(rk) - 2, -1, -1):
        s = [s[(4 * (c - i) + i) % 16] for c in range(4) for i in range(4)]
        s = [_INV_SBOX[b] for b in s]
        s = [a ^ b for a, b in zip(s, rk[r])]
        if r > 0:
            s = sum((_mix(s[4 * c:4 * c + 4], _INV_MIX) for c in range(4)),
                    [])
    return bytes(s)


def _aes_cbc(key24: bytes, data: bytes, *, encrypt: bool) -> bytes:
    """AES-CBC under a zero IV over whole 16-byte blocks (no padding),
    as ``cryptography``'s ``Cipher(AES(key), CBC(b"\\0" * 16))`` does."""
    if len(data) % 16:
        raise ValueError("AES-CBC data must be a multiple of 16 bytes")
    rk = _expand_key(key24)
    prev = bytes(16)
    out = bytearray()
    for i in range(0, len(data), 16):
        block = data[i:i + 16]
        if encrypt:
            prev = _encrypt_block(rk, bytes(a ^ b for a, b in
                                            zip(block, prev)))
            out += prev
        else:
            out += bytes(a ^ b for a, b in
                         zip(_decrypt_block(rk, block), prev))
            prev = block
    return bytes(out)


def _verifier(password: str, salt: bytes) -> bytes:
    """11g-style password verifier: SHA1(password || salt), zero-padded
    to the AES-192 key width."""
    return (hashlib.sha1(password.encode() + salt).digest()
            + b"\x00" * 4)[:24]


def _combined_key(server_half: bytes, client_half: bytes) -> bytes:
    mixed = hashlib.sha1(server_half[:16] + client_half[:16]).digest()
    return (mixed + b"\x00" * 8)[:24]


# ---------------------------------------------------------------- client

class OracleRow(dict):
    __getattr__ = dict.get


class OracleWire(Instrumented):
    """Reference Connection/Txn surface over the TNS transport."""

    metric = "app_oracle_stats"
    log_tag = "ORACLE"
    dialect = "oracle"  # query-builder/auto-CRUD placeholder selection

    def __init__(self, *, host: str = "127.0.0.1", port: int = 1521,
                 service_name: str = "FREEPDB1", username: str = "",
                 password: str = "", timeout_s: float = 10.0) -> None:
        self.host = host
        self.port = port
        self.service_name = service_name
        self.username = username
        self.password = password
        self.timeout_s = timeout_s
        self._sock: socket.socket | None = None
        self._stream: _Stream | None = None
        self._lock = threading.RLock()

    # ------------------------------------------------------------ session
    def connect(self) -> None:
        with self._lock:
            if self._sock is not None:
                self.close()
            sock = socket.create_connection((self.host, self.port),
                                            timeout=self.timeout_s)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            stream = _Stream(sock)
            try:
                self._handshake(sock, stream)
                self._authenticate(sock, stream)
            except BaseException:
                sock.close()
                raise
            self._sock, self._stream = sock, stream
            if self.logger is not None:
                self.logger.info(
                    f"oracle connected {self.host}:{self.port}"
                    f"/{self.service_name}")

    def _handshake(self, sock: socket.socket, stream: _Stream) -> None:
        descriptor = (
            f"(DESCRIPTION=(ADDRESS=(PROTOCOL=TCP)(HOST={self.host})"
            f"(PORT={self.port}))(CONNECT_DATA="
            f"(SERVICE_NAME={self.service_name})(CID=(PROGRAM=gofr_tpu)"
            f"(USER={self.username}))))").encode()
        # CONNECT body: version, lowest compatible version, service
        # options, SDU, TDU, then the descriptor's length + offset
        # (relative to packet start, header included: 8 + 24)
        body = struct.pack("!HHHHHHHH", TNS_VERSION, 300, 0, 8192, 32767,
                           len(descriptor), 32, 0) + b"\x00" * 8 \
            + descriptor
        send_packet(sock, TNS_CONNECT, body)
        ptype, payload = recv_packet(stream)
        if ptype == TNS_RESEND:               # protocol-legal: try again
            send_packet(sock, TNS_CONNECT, body)
            ptype, payload = recv_packet(stream)
        if ptype == TNS_REFUSE:
            raise OracleError(self._refusal(payload), 12514)
        if ptype != TNS_ACCEPT:
            raise OracleError(f"expected ACCEPT, got type {ptype}", 12537)
        (version,) = struct.unpack_from("!H", payload, 0)
        if version > TNS_VERSION:
            raise OracleError(f"server TNS version {version} too new",
                              12516)

    @staticmethod
    def _refusal(payload: bytes) -> str:
        # REFUSE: user reason, system reason, data length, data
        if len(payload) >= 4:
            (dlen,) = struct.unpack_from("!H", payload, 2)
            return payload[4:4 + dlen].decode("latin-1") or "refused"
        return "connection refused"

    def _authenticate(self, sock: socket.socket, stream: _Stream) -> None:
        send_data(sock, _wire_fields([
            ("FUNCTION", b"AUTH_PHASE1"),
            ("AUTH_TERMINAL", b"gofr"),
            ("AUTH_USER", self.username.encode())]))
        reply = dict(self._read_reply(stream, sock))
        salt = bytes.fromhex(reply["AUTH_VFR_DATA"].decode())
        enc_server_key = bytes.fromhex(reply["AUTH_SESSKEY"].decode())

        verifier = _verifier(self.password, salt)
        server_half = _aes_cbc(verifier, enc_server_key, encrypt=False)
        client_half = os.urandom(32)
        combo = _combined_key(server_half, client_half)
        send_data(sock, _wire_fields([
            ("FUNCTION", b"AUTH_PHASE2"),
            ("AUTH_USER", self.username.encode()),
            ("AUTH_SESSKEY", _aes_cbc(verifier, client_half,
                                      encrypt=True).hex().encode()),
            ("AUTH_PASSWORD", _aes_cbc(
                combo, _pad16(self.password.encode()),
                encrypt=True).hex().encode())]))
        reply = dict(self._read_reply(stream, sock))
        if reply.get("STATUS") != b"AUTH_SUCCESS":
            raise OracleError("ORA-01017: invalid username/password; "
                              "logon denied", 1017)

    def _read_reply(self, stream: _Stream,
                    sock: socket.socket) -> list[tuple[str, bytes]]:
        while True:
            ptype, payload = recv_packet(stream)
            if ptype == TNS_MARKER:
                # server break: acknowledge with a reset marker and
                # read on — the error arrives as a DATA reply
                send_marker(sock, MARKER_RESET)
                continue
            if ptype == TNS_REFUSE:
                raise OracleError(self._refusal(payload), 3113)
            if ptype != TNS_DATA:
                raise OracleError(f"unexpected TNS type {ptype}", 3137)
            fields = _parse_fields(payload[2:])
            named = dict(fields)
            if "ORA_ERROR" in named:
                code_s, _, msg = named["ORA_ERROR"].decode().partition(":")
                raise OracleError(msg.strip() or f"ORA-{code_s}",
                                  int(code_s or 0))
            return fields

    # ---------------------------------------------------------- execution
    def _require(self) -> tuple[socket.socket, _Stream]:
        if self._sock is None or self._stream is None:
            raise OracleError("not connected", 3114)
        return self._sock, self._stream

    def _roundtrip(self, op: str, query: str,
                   args: tuple) -> list[tuple[str, bytes]]:
        def go():
            with self._lock:
                sock, stream = self._require()
                pairs = [("FUNCTION", b"EXEC"), ("SQL", query.encode())]
                for arg in args:
                    if arg is None:
                        pairs.append(("BIND_NULL", b""))
                    else:
                        pairs.append(("BIND", str(arg).encode()))
                send_data(sock, _wire_fields(pairs))
                return self._read_reply(stream, sock)
        # Instrumented._observed: QueryLog line + lazily-registered
        # app_oracle_stats histogram, same as every other store
        return self._observed(op.upper(), query, go)

    def ph(self, n: int) -> str:
        return f":{n}"                        # Oracle bind placeholder

    def query(self, query: str, *args: Any) -> list[OracleRow]:
        fields = self._roundtrip("select", query, args)
        cols: list[str] = []
        rows: list[OracleRow] = []
        for key, value in fields:
            if key == "COL":
                cols.append(value.decode())
            elif key == "ROW":
                cells = _parse_fields(value)
                rows.append(OracleRow(
                    {c: (None if k == "NULL" else v.decode())
                     for c, (k, v) in zip(cols, cells)}))
        return rows

    def query_row(self, query: str, *args: Any) -> OracleRow | None:
        rows = self.query(query, *args)
        return rows[0] if rows else None

    def exec(self, query: str, *args: Any) -> int:
        fields = dict(self._roundtrip("exec", query, args))
        return int(fields.get("AFFECTED", b"0") or 0)

    def select(self, entity_type: type, query: str, *args: Any) -> list[Any]:
        """reference interface.go Select: rows into typed entities."""
        if not is_dataclass(entity_type):
            raise OracleError("select requires a dataclass type")
        names = [f.name for f in dc_fields(entity_type)]
        out = []
        for row in self.query(query, *args):
            kw = {}
            for name in names:
                v = row.get(name, row.get(name.upper()))
                kw[name] = v
            out.append(entity_type(**kw))
        return out

    def ping(self) -> None:
        self.query("SELECT 1 FROM DUAL")

    # ------------------------------------------------------- transactions
    @contextmanager
    def begin(self) -> Iterator["OracleWire"]:
        """reference Txn: commit on clean exit, rollback on error."""
        self.exec("BEGIN")
        try:
            yield self
        except BaseException:
            self.exec("ROLLBACK")
            raise
        else:
            self.exec("COMMIT")

    def commit(self) -> None:
        self.exec("COMMIT")

    def rollback(self) -> None:
        self.exec("ROLLBACK")

    # -------------------------------------------------------------- admin
    def health_check(self) -> dict[str, Any]:
        try:
            if self._sock is None:
                self.connect()
            self.ping()
            return {"status": "UP",
                    "details": {"host": f"{self.host}:{self.port}",
                                "service": self.service_name}}
        except Exception as exc:
            return {"status": "DOWN", "error": str(exc)}

    def close(self) -> None:
        with self._lock:
            sock, self._sock, self._stream = self._sock, None, None
            if sock is not None:
                try:
                    send_data(sock, b"", flags=DATA_FLAG_EOF)
                except OSError:
                    pass
                sock.close()


# ------------------------------------------------------------ mini server

class MiniOracleServer:
    """Protocol-faithful hermetic server: TNS framing, RESEND on first
    connect (the classic Oracle listener behaviour), O5LOGON-style
    challenge-response, markers, ORA-coded errors; statements execute
    on an embedded engine with Oracle affordances (DUAL, :n binds)."""

    def __init__(self, *, service_name: str = "FREEPDB1",
                 users: dict[str, str] | None = None,
                 resend_first: bool = True) -> None:
        import sqlite3
        self.service_name = service_name
        self.users = users or {}
        self.resend_first = resend_first
        self.port = 0
        self._db = sqlite3.connect(":memory:", check_same_thread=False)
        self._db_lock = threading.Lock()
        self._server_sock: socket.socket | None = None
        self._threads: list[threading.Thread] = []
        self._closing = False

    def start(self) -> None:
        self._server_sock = socket.socket()
        self._server_sock.setsockopt(socket.SOL_SOCKET,
                                     socket.SO_REUSEADDR, 1)
        self._server_sock.bind(("127.0.0.1", 0))
        self._server_sock.listen(16)
        self.port = self._server_sock.getsockname()[1]
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._server_sock.accept()
            except OSError:
                return
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    # ------------------------------------------------------- per-session
    def _serve(self, sock: socket.socket) -> None:
        stream = _Stream(sock)
        try:
            if not self._tns_accept(sock, stream):
                return
            user = self._auth(sock, stream)
            if user is None:
                return
            self._statement_loop(sock, stream)
        except (OracleError, OSError, struct.error):
            pass
        finally:
            sock.close()

    def _tns_accept(self, sock: socket.socket, stream: _Stream) -> bool:
        ptype, payload = recv_packet(stream)
        if ptype != TNS_CONNECT:
            return False
        if self.resend_first:
            # real listeners answer a large CONNECT with RESEND once
            send_packet(sock, TNS_RESEND, b"")
            ptype, payload = recv_packet(stream)
            if ptype != TNS_CONNECT:
                return False
        (version,) = struct.unpack_from("!H", payload, 0)
        descriptor = payload[24:].decode("latin-1")
        if f"(SERVICE_NAME={self.service_name})" not in descriptor:
            msg = (f"ORA-12514: listener does not currently know of "
                   f"service requested")
            send_packet(sock, TNS_REFUSE,
                        struct.pack("!BBH", 34, 0, len(msg))
                        + msg.encode())
            return False
        send_packet(sock, TNS_ACCEPT,
                    struct.pack("!HHHH", min(version, TNS_VERSION), 0,
                                8192, 32767))
        return True

    def _auth(self, sock: socket.socket, stream: _Stream) -> str | None:
        fields = dict(self._read_data(stream))
        user = fields.get("AUTH_USER", b"").decode()
        salt = os.urandom(10)
        server_half = os.urandom(32)
        password = self.users.get(user)
        # unknown user: hand out a throwaway verifier anyway — the
        # failure surfaces after phase 2, not as a user oracle
        verifier = _verifier(password if password is not None
                             else os.urandom(8).hex(), salt)
        send_data(sock, _wire_fields([
            ("AUTH_VFR_DATA", salt.hex().encode()),
            ("AUTH_SESSKEY", _aes_cbc(verifier, server_half,
                                      encrypt=True).hex().encode())]))

        fields = dict(self._read_data(stream))
        try:
            client_half = _aes_cbc(
                verifier, bytes.fromhex(fields["AUTH_SESSKEY"].decode()),
                encrypt=False)
            combo = _combined_key(server_half, client_half)
            got = _unpad16(_aes_cbc(
                combo, bytes.fromhex(fields["AUTH_PASSWORD"].decode()),
                encrypt=False)).decode()
        except (KeyError, ValueError, OracleError):
            got = None
        if password is None or got != password:
            send_data(sock, _wire_fields([
                ("ORA_ERROR", b"1017: ORA-01017: invalid username/"
                              b"password; logon denied")]))
            return None
        send_data(sock, _wire_fields([("STATUS", b"AUTH_SUCCESS")]))
        return user

    def _read_data(self, stream: _Stream) -> list[tuple[str, bytes]]:
        while True:
            ptype, payload = recv_packet(stream)
            if ptype == TNS_MARKER:
                continue
            if ptype != TNS_DATA:
                raise OracleError("expected DATA", 3137)
            (flags,) = struct.unpack_from("!H", payload, 0)
            if flags & DATA_FLAG_EOF:
                raise OracleError("client disconnected", 3113)
            return _parse_fields(payload[2:])

    # -------------------------------------------------------- statements
    def _statement_loop(self, sock: socket.socket,
                        stream: _Stream) -> None:
        in_txn = False
        while True:
            fields = self._read_data(stream)
            named = dict(fields)
            sql = named.get("SQL", b"").decode()
            binds = [None if k == "BIND_NULL" else v.decode()
                     for k, v in fields if k in ("BIND", "BIND_NULL")]
            try:
                reply, in_txn = self._execute(sql, binds, in_txn)
            except OracleError as exc:
                # real servers send a break marker, then the error
                send_marker(sock, MARKER_BREAK)
                reply = [("ORA_ERROR",
                          f"{exc.code}: {exc}".encode())]
            send_data(sock, _wire_fields(reply))

    def _execute(self, sql: str, binds: list[str],
                 in_txn: bool) -> tuple[list[tuple[str, bytes]], bool]:
        import sqlite3
        bare = sql.strip().rstrip(";")
        upper = bare.upper()
        with self._db_lock:
            if upper == "BEGIN":
                return [("AFFECTED", b"0")], True
            if upper in ("COMMIT", "ROLLBACK"):
                if in_txn or True:
                    (self._db.commit if upper == "COMMIT"
                     else self._db.rollback)()
                return [("AFFECTED", b"0")], False
            # Oracle affordances over the embedded engine
            stmt = bare
            if upper.endswith("FROM DUAL"):
                stmt = bare[:-len("FROM DUAL") - 1].rstrip()
            for i in range(len(binds), 0, -1):
                stmt = stmt.replace(f":{i}", "?")
            try:
                cur = self._db.execute(stmt, binds)
            except sqlite3.Error as exc:
                raise OracleError(f"ORA-00900: {exc}", 900) from exc
            if cur.description is not None:
                out: list[tuple[str, bytes]] = [
                    ("COL", d[0].upper().encode())
                    for d in cur.description]
                for row in cur.fetchall():
                    cells = [("NULL", b"") if v is None
                             else ("VAL", str(v).encode()) for v in row]
                    out.append(("ROW", _wire_fields(cells)))
                return out, in_txn
            if not in_txn:
                self._db.commit()
            return [("AFFECTED", str(cur.rowcount).encode())], in_txn

    def close(self) -> None:
        self._closing = True
        if self._server_sock is not None:
            try:
                self._server_sock.close()
            except OSError:
                pass

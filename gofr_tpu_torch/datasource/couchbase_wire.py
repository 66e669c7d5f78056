"""Couchbase network client speaking the memcached binary protocol for
KV and the N1QL query service over HTTP, plus a mini server for both.

The reference's Couchbase module is a driver-backed network client
(container/datasources.go:748-788 over gocb). Couchbase's data plane
is the memcached binary protocol (24-byte header frames; GET/SET/ADD/
DELETE opcodes, SASL PLAIN auth, SELECT_BUCKET) and its query plane is
the N1QL REST service — this client implements both from the
specification. ``query`` generates real N1QL
(``SELECT d.* FROM `bucket` d WHERE d.`k` = $k``) with named
arguments. The method surface mirrors the embedded
:class:`~gofr_tpu_torch.datasource.document.Couchbase` adapter
(get/upsert/insert/remove/query).

:class:`MiniCouchbaseServer` runs the binary-protocol TCP listener and
the query-service HTTP listener over one embedded adapter — verified
SASL PLAIN, real frames, one shared dataset across both planes.

The port's copy of ``gofr_tpu/datasource/couchbase_wire.py``.
"""

from __future__ import annotations

import json
import re
import socket
import socketserver
import struct
import threading
from typing import Any

from . import Instrumented
from ._http import json_call
from .document import Couchbase, DocumentEngine, DocumentError, \
    DocumentNotFound
from .miniserver import ThreadedHTTPMiniServer

MAGIC_REQUEST = 0x80
MAGIC_RESPONSE = 0x81

OP_GET = 0x00
OP_SET = 0x01
OP_ADD = 0x02
OP_DELETE = 0x04
OP_SASL_LIST = 0x20
OP_SASL_AUTH = 0x21
OP_SELECT_BUCKET = 0x89

STATUS_OK = 0x0000
STATUS_NOT_FOUND = 0x0001
STATUS_EXISTS = 0x0002
STATUS_AUTH_ERROR = 0x0020


class CouchbaseWireError(DocumentError):
    """Non-OK binary status or query-service error."""

    def __init__(self, message: str, status: int = 0) -> None:
        super().__init__(message)
        self.status = status


def pack_frame(magic: int, opcode: int, key: bytes = b"",
               extras: bytes = b"", value: bytes = b"",
               status: int = 0, opaque: int = 0, cas: int = 0) -> bytes:
    total = len(extras) + len(key) + len(value)
    header = struct.pack("!BBHBBHIIQ", magic, opcode, len(key),
                         len(extras), 0, status, total, opaque, cas)
    return header + extras + key + value


class _BinarySocket:
    """Framed read/write of memcached binary packets."""

    def __init__(self, sock: socket.socket) -> None:
        self._sock = sock
        self._buf = b""

    def _exactly(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise CouchbaseWireError("connection closed")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def send(self, frame: bytes) -> None:
        self._sock.sendall(frame)

    def recv(self) -> tuple[int, int, bytes, bytes, bytes]:
        """-> (opcode, status, extras, key, value)."""
        header = self._exactly(24)
        (_magic, opcode, key_len, extras_len, _dt, status, total,
         _opaque, _cas) = struct.unpack("!BBHBBHIIQ", header)
        body = self._exactly(total)
        extras = body[:extras_len]
        key = body[extras_len:extras_len + key_len]
        value = body[extras_len + key_len:]
        return opcode, status, extras, key, value


class CouchbaseWire(Instrumented):
    """Binary-protocol KV + N1QL-over-HTTP client with the embedded
    adapter's verbs."""

    metric = "app_couchbase_stats"
    log_tag = "CB"

    def __init__(self, *, host: str = "localhost", kv_port: int = 11210,
                 query_endpoint: str = "http://localhost:8093",
                 username: str = "", password: str = "",
                 timeout_s: float = 30.0) -> None:
        self.host = host
        self.kv_port = kv_port
        if "://" not in query_endpoint:
            query_endpoint = "http://" + query_endpoint
        self.query_endpoint = query_endpoint.rstrip("/")
        self.username = username
        self.password = password
        self.timeout_s = timeout_s
        self._sock: socket.socket | None = None
        self._frames: _BinarySocket | None = None
        self._bucket = ""
        self._lock = threading.RLock()

    # ------------------------------------------------------------ connect
    def connect(self) -> None:
        if self._sock is not None:
            self.close()
        sock = socket.create_connection((self.host, self.kv_port),
                                        timeout=self.timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        self._frames = _BinarySocket(sock)
        try:
            if self.username:
                token = (b"\x00" + self.username.encode()
                         + b"\x00" + self.password.encode())
                _, status, _, _, value = self._round(
                    OP_SASL_AUTH, key=b"PLAIN", value=token)
                if status != STATUS_OK:
                    raise CouchbaseWireError(
                        f"SASL auth failed: {value.decode('utf-8', 'replace')}",
                        status=status)
        except BaseException:
            sock.close()
            self._sock = None
            self._frames = None
            raise
        if self.logger is not None:
            self.logger.info("connected to couchbase", host=self.host,
                             kv_port=self.kv_port)

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None
            self._frames = None
            self._bucket = ""

    def _round(self, opcode: int, key: bytes = b"", extras: bytes = b"",
               value: bytes = b"") -> tuple[int, int, bytes, bytes, bytes]:
        if self._frames is None:
            raise CouchbaseWireError("not connected; call connect() first")
        with self._lock:
            try:
                self._frames.send(pack_frame(MAGIC_REQUEST, opcode, key,
                                             extras, value))
                return self._frames.recv()
            except (OSError, TimeoutError) as exc:
                self.close()  # partial frame poisons the stream
                raise CouchbaseWireError(
                    f"connection lost mid-request ({exc})") from exc

    def _select_bucket(self, bucket: str) -> None:
        if bucket == self._bucket:
            return
        _, status, _, _, _ = self._round(OP_SELECT_BUCKET,
                                         key=bucket.encode())
        if status != STATUS_OK:
            raise CouchbaseWireError(f"select bucket {bucket!r} failed",
                                     status=status)
        self._bucket = bucket

    # ----------------------------------------------------- native verbs
    def get(self, bucket: str, key: str) -> dict:
        def op():
            # one lock scope for select+op: another thread's bucket
            # switch must not land between them (server-side bucket
            # state is per-connection)
            with self._lock:
                self._select_bucket(bucket)
                _, status, _, _, value = self._round(OP_GET,
                                                     key=key.encode())
            if status == STATUS_NOT_FOUND:
                raise DocumentNotFound(f"{bucket}/{key}")
            if status != STATUS_OK:
                raise CouchbaseWireError(f"get -> {status:#06x}",
                                         status=status)
            return json.loads(value)
        return self._observed("GET", bucket, op)

    def _store(self, opcode: int, bucket: str, key: str,
               document: dict) -> int:
        with self._lock:  # select+op atomically, see get()
            self._select_bucket(bucket)
            extras = struct.pack("!II", 0, 0)  # flags, expiry
            _, status, _, _, _ = self._round(
                opcode, key=key.encode(), extras=extras,
                value=json.dumps(document).encode())
        return status

    def upsert(self, bucket: str, key: str, document: dict) -> None:
        def op():
            status = self._store(OP_SET, bucket, key, document)
            if status != STATUS_OK:
                raise CouchbaseWireError(f"upsert -> {status:#06x}",
                                         status=status)
        self._observed("UPSERT", bucket, op)

    def insert(self, bucket: str, key: str, document: dict) -> None:
        def op():
            status = self._store(OP_ADD, bucket, key, document)
            if status == STATUS_EXISTS:
                raise DocumentError(f"duplicate id {key!r} in {bucket}")
            if status != STATUS_OK:
                raise CouchbaseWireError(f"insert -> {status:#06x}",
                                         status=status)
        self._observed("INSERT", bucket, op)

    def remove(self, bucket: str, key: str) -> None:
        def op():
            with self._lock:  # select+op atomically, see get()
                self._select_bucket(bucket)
                _, status, _, _, _ = self._round(OP_DELETE,
                                                 key=key.encode())
            if status == STATUS_NOT_FOUND:
                raise DocumentNotFound(f"{bucket}/{key}")
            if status != STATUS_OK:
                raise CouchbaseWireError(f"remove -> {status:#06x}",
                                         status=status)
        self._observed("REMOVE", bucket, op)

    def query(self, bucket: str, flt: dict | None = None) -> list[dict]:
        """Generates real N1QL with named arguments, POSTed to the
        query service (the gocb Cluster.Query path)."""
        def op():
            # identifiers ride in the statement text: validate them;
            # values are always parameterized
            if not re.fullmatch(r"[\w.-]+", bucket):
                raise CouchbaseWireError(f"invalid bucket name {bucket!r}")
            statement = f"SELECT d.* FROM `{bucket}` d"
            args: dict[str, Any] = {}
            for i, (key, value) in enumerate(sorted((flt or {}).items())):
                if not re.fullmatch(r"\w+", str(key)):
                    raise CouchbaseWireError(
                        f"invalid field name {key!r}")
                statement += (" WHERE" if i == 0 else " AND") \
                    + f" d.`{key}` = $p{i}"
                args[f"p{i}"] = value
            body = {"statement": statement, **{f"${k}": v
                                               for k, v in args.items()}}
            status, data = json_call(self.query_endpoint, "POST",
                                     "/query/service", body=body,
                                     timeout_s=self.timeout_s)
            if status != 200 or (isinstance(data, dict)
                                 and data.get("status") != "success"):
                raise CouchbaseWireError(f"query -> {status}: {data}")
            return data.get("results", [])
        return self._observed("QUERY", bucket, op)

    def health_check(self) -> dict[str, Any]:
        try:
            _, status, _, _, value = self._round(OP_SASL_LIST)
            return {"status": "UP" if status == STATUS_OK else "DOWN",
                    "details": {"host": self.host, "kv_port": self.kv_port,
                                "mechs": value.decode("utf-8", "replace")}}
        except Exception as exc:
            return {"status": "DOWN", "error": str(exc)}


# ------------------------------------------------------------ mini server

class _KVHandler(socketserver.BaseRequestHandler):
    @property
    def mini(self) -> "MiniCouchbaseServer":
        return self.server.mini  # type: ignore[attr-defined]

    def handle(self) -> None:
        frames = _BinarySocket(self.request)
        authed = not self.mini.password
        bucket = ""
        try:
            while True:
                opcode, _, extras, key, value = frames.recv()

                def reply(status: int = STATUS_OK, *, out: bytes = b"",
                          rx: bytes = b"") -> None:
                    frames.send(pack_frame(MAGIC_RESPONSE, opcode,
                                           extras=rx, value=out,
                                           status=status))

                if opcode == OP_SASL_LIST:
                    reply(out=b"PLAIN")
                elif opcode == OP_SASL_AUTH:
                    parts = value.split(b"\x00")
                    ok = (key == b"PLAIN" and len(parts) == 3
                          and parts[1].decode() == self.mini.username
                          and parts[2].decode() == self.mini.password)
                    authed = authed or ok
                    reply(STATUS_OK if ok else STATUS_AUTH_ERROR,
                          out=b"" if ok else b"Auth failure")
                elif not authed:
                    reply(STATUS_AUTH_ERROR, out=b"not authenticated")
                elif opcode == OP_SELECT_BUCKET:
                    bucket = key.decode()
                    reply()
                elif opcode == OP_GET:
                    try:
                        doc = self.mini.store.get(bucket, key.decode())
                    except DocumentNotFound:
                        reply(STATUS_NOT_FOUND, out=b"Not found")
                        continue
                    doc = {k: v for k, v in doc.items() if k != "_id"}
                    reply(out=json.dumps(doc).encode(),
                          rx=struct.pack("!I", 0))
                elif opcode in (OP_SET, OP_ADD):
                    doc = json.loads(value)
                    if opcode == OP_ADD:
                        try:
                            self.mini.store.insert(bucket, key.decode(),
                                                   doc)
                        except DocumentError:
                            reply(STATUS_EXISTS, out=b"Exists")
                            continue
                    else:
                        self.mini.store.upsert(bucket, key.decode(), doc)
                    reply()
                elif opcode == OP_DELETE:
                    try:
                        self.mini.store.remove(bucket, key.decode())
                    except DocumentNotFound:
                        reply(STATUS_NOT_FOUND, out=b"Not found")
                        continue
                    reply()
                else:
                    reply(0x0081, out=b"unknown command")
        except (CouchbaseWireError, ConnectionError, OSError):
            return


_N1QL_RE = re.compile(
    r"SELECT d\.\* FROM `(?P<bucket>[^`]+)` d"
    r"(?P<where>( (?:WHERE|AND) d\.`\w+` = \$\w+)*)$")


class _QueryServer(ThreadedHTTPMiniServer):
    def __init__(self, mini: "MiniCouchbaseServer") -> None:
        super().__init__()
        self.mini = mini

    def handle(self, request) -> tuple[int, bytes, str]:
        if request.path != "/query/service" or request.method != "POST":
            return 404, b'{"status": "fatal"}', "application/json"
        body = json.loads(request.body)
        match = _N1QL_RE.match(body.get("statement", "").strip())
        if not match:
            return 400, json.dumps(
                {"status": "fatal",
                 "errors": [{"msg": "unsupported N1QL"}]}).encode(), \
                "application/json"
        flt = {}
        for cond in re.finditer(r"d\.`(\w+)` = \$(\w+)",
                                match.group("where")):
            field, var = cond.groups()
            if f"${var}" not in body:
                return 400, json.dumps(
                    {"status": "fatal",
                     "errors": [{"msg": f"unbound ${var}"}]}).encode(), \
                    "application/json"
            flt[field] = body[f"${var}"]
        rows = self.mini.store.query(match.group("bucket"), flt or None)
        rows = [{k: v for k, v in r.items() if k != "_id"} for r in rows]
        return 200, json.dumps(
            {"status": "success", "results": rows}).encode(), \
            "application/json"


class MiniCouchbaseServer:
    """Binary-protocol KV listener + N1QL query-service listener over
    one embedded adapter. SASL PLAIN is verified when a password is
    configured."""

    def __init__(self, host: str = "127.0.0.1", *, username: str = "",
                 password: str = "") -> None:
        self.host = host
        self.username = username
        self.password = password
        self.store = Couchbase(DocumentEngine())
        self.kv_port = 0
        self.query_port = 0
        self._server: socketserver.ThreadingTCPServer | None = None
        self._thread: threading.Thread | None = None
        self._query = _QueryServer(self)

    def start(self) -> None:
        class TCP(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = TCP((self.host, 0), _KVHandler)
        self._server.mini = self  # the handler reads this back
        self.kv_port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="mini-couchbase")
        self._thread.start()
        self._query.start()
        self.query_port = self._query.port

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        self._query.close()

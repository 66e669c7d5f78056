"""MongoDB wire-protocol client: BSON + OP_MSG from first principles,
plus a mini server.

The reference's Mongo module is a driver-backed network client
(container/datasources.go:232 declares the interface;
datasource/mongo implements it over mongo-go-driver). This is that
client for real network deployments: BSON encoding/decoding and the
modern OP_MSG framing (opcode 2013, the only op modern servers speak)
written directly on a TCP socket — no driver dependency — behind the
same command surface as the embedded
:class:`~gofr_tpu_torch.datasource.document.Mongo` adapter, so swapping is a
constructor change.

Commands speak the standard database-command documents: ``insert``,
``find`` (cursor firstBatch), ``update`` (``$set``), ``delete``,
``count``, ``drop``, ``ping``.

:class:`MiniMongoServer` is the hermetic stand-in: a threaded OP_MSG
server delegating semantics to the embedded
:class:`~gofr_tpu_torch.datasource.document.DocumentEngine`, so wire-client
tests exercise real BSON bytes over a real socket.

The port's copy of ``gofr_tpu/datasource/mongo_wire.py``.
"""

from __future__ import annotations

import datetime as _dt
import os
import socket
import struct
import threading
import time
from typing import Any

from . import Instrumented
from .document import DocumentEngine

OP_MSG = 2013


class MongoWireError(Exception):
    pass


# ------------------------------------------------------------------ BSON

def _cstring(s: str) -> bytes:
    return s.encode() + b"\x00"


class ObjectId:
    """12-byte Mongo object id (4B time, 5B random, 3B counter)."""

    _counter = int.from_bytes(os.urandom(3), "big")
    _random = os.urandom(5)
    _lock = threading.Lock()

    def __init__(self, raw: bytes | None = None) -> None:
        if raw is None:
            with ObjectId._lock:
                ObjectId._counter = (ObjectId._counter + 1) % (1 << 24)
                counter = ObjectId._counter
            raw = (struct.pack(">I", int(time.time())) + ObjectId._random
                   + counter.to_bytes(3, "big"))
        if len(raw) != 12:
            raise MongoWireError("ObjectId must be 12 bytes")
        self.raw = raw

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, ObjectId) and self.raw == other.raw

    def __hash__(self) -> int:
        return hash(self.raw)

    def __str__(self) -> str:
        return self.raw.hex()

    def __repr__(self) -> str:
        return f"ObjectId('{self.raw.hex()}')"


def encode_bson(doc: dict) -> bytes:
    out = bytearray()
    for key, value in doc.items():
        out += _encode_element(str(key), value)
    return struct.pack("<i", len(out) + 5) + bytes(out) + b"\x00"


def _encode_element(key: str, value: Any) -> bytes:
    name = _cstring(key)
    if isinstance(value, bool):          # before int: bool is int's child
        return b"\x08" + name + (b"\x01" if value else b"\x00")
    if isinstance(value, float):
        return b"\x01" + name + struct.pack("<d", value)
    if isinstance(value, str):
        raw = value.encode()
        return b"\x02" + name + struct.pack("<i", len(raw) + 1) + raw + b"\x00"
    if isinstance(value, dict):
        return b"\x03" + name + encode_bson(value)
    if isinstance(value, (list, tuple)):
        return b"\x04" + name + encode_bson(
            {str(i): v for i, v in enumerate(value)})
    if isinstance(value, bytes):
        return (b"\x05" + name + struct.pack("<i", len(value)) + b"\x00"
                + value)
    if isinstance(value, ObjectId):
        return b"\x07" + name + value.raw
    if isinstance(value, _dt.datetime):
        ms = int(value.timestamp() * 1000)
        return b"\x09" + name + struct.pack("<q", ms)
    if value is None:
        return b"\x0a" + name
    if isinstance(value, int):
        if -(1 << 31) <= value < (1 << 31):
            return b"\x10" + name + struct.pack("<i", value)
        return b"\x12" + name + struct.pack("<q", value)
    raise MongoWireError(f"cannot BSON-encode {type(value).__name__}")


def decode_bson(data: bytes, pos: int = 0) -> tuple[dict, int]:
    """-> (document, next position)."""
    size = struct.unpack_from("<i", data, pos)[0]
    end = pos + size - 1               # final 0x00
    pos += 4
    doc: dict = {}
    while pos < end:
        etype = data[pos]
        pos += 1
        nul = data.index(b"\x00", pos)
        key = data[pos:nul].decode()
        pos = nul + 1
        if etype == 0x01:
            doc[key] = struct.unpack_from("<d", data, pos)[0]
            pos += 8
        elif etype == 0x02:
            n = struct.unpack_from("<i", data, pos)[0]
            doc[key] = data[pos + 4:pos + 4 + n - 1].decode()
            pos += 4 + n
        elif etype == 0x03:
            doc[key], pos = decode_bson(data, pos)
        elif etype == 0x04:
            sub, pos = decode_bson(data, pos)
            doc[key] = [sub[k] for k in sorted(sub, key=int)]
        elif etype == 0x05:
            n = struct.unpack_from("<i", data, pos)[0]
            doc[key] = data[pos + 5:pos + 5 + n]
            pos += 5 + n
        elif etype == 0x07:
            doc[key] = ObjectId(data[pos:pos + 12])
            pos += 12
        elif etype == 0x08:
            doc[key] = data[pos] == 1
            pos += 1
        elif etype == 0x09:
            ms = struct.unpack_from("<q", data, pos)[0]
            doc[key] = _dt.datetime.fromtimestamp(
                ms / 1000, tz=_dt.timezone.utc)
            pos += 8
        elif etype == 0x0A:
            doc[key] = None
        elif etype == 0x10:
            doc[key] = struct.unpack_from("<i", data, pos)[0]
            pos += 4
        elif etype == 0x12:
            doc[key] = struct.unpack_from("<q", data, pos)[0]
            pos += 8
        else:
            raise MongoWireError(f"unsupported BSON type 0x{etype:02x}")
    return doc, end + 1


# ---------------------------------------------------------------- OP_MSG

def encode_op_msg(request_id: int, body: dict,
                  response_to: int = 0) -> bytes:
    payload = struct.pack("<I", 0) + b"\x00" + encode_bson(body)
    header = struct.pack("<iiii", 16 + len(payload), request_id,
                         response_to, OP_MSG)
    return header + payload


def decode_op_msg(frame: bytes) -> tuple[int, int, dict]:
    """Full frame (incl. header) -> (request_id, response_to, body)."""
    _length, request_id, response_to, opcode = struct.unpack_from(
        "<iiii", frame, 0)
    if opcode != OP_MSG:
        raise MongoWireError(f"unsupported opcode {opcode}")
    # flagBits (4) + section kind byte (1)
    if frame[20] != 0:
        raise MongoWireError("only kind-0 sections supported")
    body, _ = decode_bson(frame, 21)
    return request_id, response_to, body


def _read_frame(sock: socket.socket, buf: bytearray) -> bytes | None:
    while len(buf) < 4:
        chunk = sock.recv(65536)
        if not chunk:
            return None
        buf += chunk
    size = struct.unpack_from("<i", buf, 0)[0]
    while len(buf) < size:
        chunk = sock.recv(65536)
        if not chunk:
            return None
        buf += chunk
    frame = bytes(buf[:size])
    del buf[:size]
    return frame


# ----------------------------------------------------------------- client

class MongoWire(Instrumented):
    """Network Mongo client with the embedded adapter's surface.
    Shares the embedded adapter's metric series (``app_mongo_stats``,
    ``type=<command>``) so swapping engines never renames a series."""

    metric = "app_mongo_stats"
    log_tag = "MONGO"

    def __init__(self, *, host: str = "localhost", port: int = 27017,
                 database: str = "gofr", timeout_s: float = 10.0) -> None:
        self.host, self.port, self.database = host, port, database
        self.timeout_s = timeout_s
        self._sock: socket.socket | None = None
        self._buf = bytearray()
        self._req_ids = iter(range(1, 1 << 31))
        self._lock = threading.RLock()

    def connect(self) -> None:
        with self._lock:
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=self.timeout_s)
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if self.logger is not None:
            self.logger.info("connected to Mongo",
                             addr=f"{self.host}:{self.port}")

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
            self._sock = None
            self._buf.clear()

    def command(self, body: dict) -> dict:
        """One OP_MSG round-trip; raises on {ok: 0} replies AND on
        per-document writeErrors (real servers report failed writes
        with ok: 1 + writeErrors — swallowing them is silent data
        loss)."""
        label = next(iter(body), "?")

        def op() -> dict:
            with self._lock:
                if self._sock is None:
                    self.connect()
                assert self._sock is not None
                full = {**body, "$db": self.database}
                try:
                    self._sock.sendall(
                        encode_op_msg(next(self._req_ids), full))
                    frame = _read_frame(self._sock, self._buf)
                except OSError:
                    self.close()
                    raise
                if frame is None:
                    self.close()
                    raise MongoWireError("connection closed")
                _, _, reply = decode_op_msg(frame)
            if not reply.get("ok"):
                raise MongoWireError(
                    str(reply.get("errmsg", "command failed")))
            if reply.get("writeErrors"):
                raise MongoWireError(str(reply["writeErrors"]))
            return reply
        return self._observed(label, self.database, op)

    # -------------------------------------------------- command surface
    def insert_one(self, collection: str, document: dict) -> Any:
        doc = dict(document)
        doc.setdefault("_id", ObjectId())
        self.command({"insert": collection, "documents": [doc]})
        return doc["_id"]

    def insert_many(self, collection: str, documents: Any) -> list:
        docs = [dict(d) for d in documents]
        for d in docs:
            d.setdefault("_id", ObjectId())
        self.command({"insert": collection, "documents": docs})
        return [d["_id"] for d in docs]

    def find(self, collection: str, flt: dict | None = None,
             limit: int | None = None) -> list[dict]:
        body: dict = {"find": collection, "filter": flt or {}}
        if limit:
            body["limit"] = int(limit)
        reply = self.command(body)
        return reply.get("cursor", {}).get("firstBatch", [])

    def find_one(self, collection: str, flt: dict | None = None
                 ) -> dict | None:
        rows = self.find(collection, flt, limit=1)
        return rows[0] if rows else None

    def update_many(self, collection: str, flt: dict, update: dict) -> int:
        if not any(k.startswith("$") for k in update):
            update = {"$set": update}
        reply = self.command({
            "update": collection,
            "updates": [{"q": flt, "u": update, "multi": True}]})
        return int(reply.get("nModified", reply.get("n", 0)))

    def delete_many(self, collection: str, flt: dict) -> int:
        reply = self.command({
            "delete": collection,
            "deletes": [{"q": flt, "limit": 0}]})
        return int(reply.get("n", 0))

    def count_documents(self, collection: str,
                        flt: dict | None = None) -> int:
        reply = self.command({"count": collection, "query": flt or {}})
        return int(reply.get("n", 0))

    def drop(self, collection: str) -> None:
        self.command({"drop": collection})

    def health_check(self) -> dict[str, Any]:
        try:
            self.command({"ping": 1})
            return {"status": "UP",
                    "details": {"addr": f"{self.host}:{self.port}",
                                "database": self.database}}
        except Exception as exc:
            return {"status": "DOWN", "error": str(exc)}


# ------------------------------------------------------------ mini server

class MiniMongoServer:
    """Threaded OP_MSG server over the embedded DocumentEngine."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self.host = host
        self.port = port
        self.engine = DocumentEngine()
        self._server: socket.socket | None = None
        self._conns: list[socket.socket] = []
        self._running = False
        self._lock = threading.Lock()

    def start(self) -> None:
        self._server = socket.create_server((self.host, self.port))
        self.port = self._server.getsockname()[1]
        self._running = True
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="mini-mongo").start()

    def _accept_loop(self) -> None:
        assert self._server is not None
        while self._running:
            try:
                conn, _ = self._server.accept()
            except OSError:
                break
            self._conns.append(conn)
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        buf = bytearray()
        try:
            while True:
                frame = _read_frame(conn, buf)
                if frame is None:
                    break
                request_id, _, body = decode_op_msg(frame)
                try:
                    with self._lock:
                        reply = self._execute(body)
                except Exception as exc:
                    reply = {"ok": 0.0, "errmsg": str(exc)}
                conn.sendall(encode_op_msg(0, reply,
                                           response_to=request_id))
        except (OSError, MongoWireError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _execute(self, body: dict) -> dict:
        e = self.engine
        if "ping" in body:
            return {"ok": 1.0}
        if "insert" in body:
            coll = body["insert"]
            for doc in body.get("documents", []):
                e.insert(coll, doc)       # honors a client-sent _id
            return {"ok": 1.0, "n": len(body.get("documents", []))}
        if "find" in body:
            coll = body["find"]
            rows = e.find(coll, body.get("filter") or None,
                          limit=body.get("limit") or None)
            return {"ok": 1.0, "cursor": {
                "firstBatch": rows, "id": 0,
                "ns": f"db.{coll}"}}
        if "update" in body:
            coll = body["update"]
            n = 0
            for upd in body.get("updates", []):
                changes = upd.get("u", {}).get("$set", {})
                n += e.update(coll, upd.get("q") or {}, changes)
            return {"ok": 1.0, "n": n, "nModified": n}
        if "delete" in body:
            coll = body["delete"]
            n = 0
            for d in body.get("deletes", []):
                n += e.delete(coll, d.get("q") or {})
            return {"ok": 1.0, "n": n}
        if "count" in body:
            coll = body["count"]
            flt = body.get("query") or {}
            if flt:
                return {"ok": 1.0, "n": len(e.find(coll, flt))}
            return {"ok": 1.0, "n": e.count(coll)}
        if "drop" in body:
            e.drop(body["drop"])
            return {"ok": 1.0}
        return {"ok": 0.0, "errmsg": f"unknown command {next(iter(body))}"}

    def close(self) -> None:
        self._running = False
        if self._server is not None:
            try:
                self._server.close()
            except OSError:
                pass
        for conn in self._conns:
            try:
                conn.close()
            except OSError:
                pass
        self._conns.clear()

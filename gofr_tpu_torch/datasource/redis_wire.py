"""Network Redis client speaking RESP2 over TCP, plus a mini server.

The reference connects to a real Redis over the network
(reference pkg/gofr/datasource/redis/redis.go:43) and hooks every
command for logging/metrics (hook.go:17). :class:`RedisWire` is that
client for this framework: the same command surface as the embedded
:class:`~gofr_tpu_torch.datasource.redis.Redis` (so swapping is the
constructor change redis.py's docstring promises — ``new_redis`` picks
by ``REDIS_MODE``), every call timed into ``app_redis_stats`` through
the shared ProviderMixin hook, RESP2 framing written and parsed from
first principles.

:class:`MiniRedisServer` is miniredis itself (SURVEY §4): a threaded
RESP2 server delegating command semantics to the embedded engine, so
wire-client tests run the real bytes over a real socket with zero
external infrastructure.

The port's copy of ``gofr_tpu/datasource/redis_wire.py``.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Any

from . import ProviderMixin
from .redis import Redis, RedisError


class RESP2Error(RedisError):
    pass


# ---------------------------------------------------------------- framing

def encode_command(*args: Any) -> bytes:
    """Client request: RESP2 array of bulk strings."""
    out = [b"*%d\r\n" % len(args)]
    for a in args:
        if isinstance(a, bytes):
            b = a
        elif isinstance(a, bool):
            b = b"1" if a else b"0"
        else:
            b = str(a).encode()
        out.append(b"$%d\r\n%s\r\n" % (len(b), b))
    return b"".join(out)


def encode_reply(value: Any) -> bytes:
    """Server reply encoding for the types the engine returns."""
    if value is None:
        return b"$-1\r\n"
    if isinstance(value, bool):
        return b":%d\r\n" % int(value)
    if isinstance(value, int):
        return b":%d\r\n" % value
    if isinstance(value, float):
        if value == int(value):
            return b":%d\r\n" % int(value)
        b = repr(value).encode()
        return b"$%d\r\n%s\r\n" % (len(b), b)
    if isinstance(value, RedisError):
        return b"-ERR %s\r\n" % str(value).encode()
    if isinstance(value, bytes):
        return b"$%d\r\n%s\r\n" % (len(value), value)
    if isinstance(value, str):
        b = value.encode()
        return b"$%d\r\n%s\r\n" % (len(b), b)
    if isinstance(value, dict):  # HGETALL: flat field/value array
        flat: list[Any] = []
        for k, v in value.items():
            flat.extend((k, v))
        return encode_reply(flat)
    if isinstance(value, (list, tuple, set, frozenset)):
        items = sorted(value, key=str) if isinstance(
            value, (set, frozenset)) else list(value)
        return b"*%d\r\n" % len(items) + b"".join(
            encode_reply(v) for v in items)
    return encode_reply(str(value))


class _SocketReader:
    """Buffered line/exact reads over a blocking socket."""

    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock
        self.buf = b""

    def read_line(self) -> bytes:
        while b"\r\n" not in self.buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise RESP2Error("connection closed")
            self.buf += chunk
        line, self.buf = self.buf.split(b"\r\n", 1)
        return line

    def read_exact(self, n: int) -> bytes:
        while len(self.buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise RESP2Error("connection closed")
            self.buf += chunk
        out, self.buf = self.buf[:n], self.buf[n:]
        return out


def decode_reply(reader: _SocketReader) -> Any:
    """One RESP2 value: +simple -error :int $bulk *array."""
    line = reader.read_line()
    kind, rest = line[:1], line[1:]
    if kind == b"+":
        return rest.decode()
    if kind == b"-":
        raise RESP2Error(rest.decode())
    if kind == b":":
        return int(rest)
    if kind == b"$":
        n = int(rest)
        if n < 0:
            return None
        data = reader.read_exact(n)
        reader.read_exact(2)  # \r\n
        return data.decode("utf-8", "replace")
    if kind == b"*":
        n = int(rest)
        if n < 0:
            return None
        return [decode_reply(reader) for _ in range(n)]
    raise RESP2Error(f"bad reply type {line[:1]!r}")


# ----------------------------------------------------------------- client

class RedisWire(ProviderMixin):
    """RESP2 network client with the framework Redis command surface.

    Values travel as strings (Redis semantics); numeric replies come
    back as ints. One connection, guarded by a lock — handlers across
    threads share it safely; a dead socket reconnects on next use.
    """

    def __init__(self, *, host: str = "localhost", port: int = 6379,
                 timeout_s: float = 5.0) -> None:
        self.host, self.port = host, port
        self.timeout_s = timeout_s
        self._sock: socket.socket | None = None
        self._reader: _SocketReader | None = None
        self._lock = threading.RLock()
        self._connected = False

    def connect(self) -> None:
        with self._lock:
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=self.timeout_s)
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._reader = _SocketReader(self._sock)
            self._connected = True
        if self.logger is not None:
            self.logger.info("connected to Redis",
                             addr=f"{self.host}:{self.port}")

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
            self._sock = None
            self._reader = None
            self._connected = False

    def execute(self, *args: Any, _label: str | None = None) -> Any:
        """One command round-trip under the observability hook.
        ``_label`` overrides the metric/log label when the wire command
        differs from the surface method (INCRBY for incr, …)."""
        label = _label or " ".join(str(a) for a in args[:2])

        def op():
            with self._lock:
                if self._sock is None:
                    self.connect()
                assert self._sock is not None and self._reader is not None
                try:
                    self._sock.sendall(encode_command(*args))
                    return decode_reply(self._reader)
                except (OSError, RESP2Error) as exc:
                    if isinstance(exc, RESP2Error) and self._connected \
                            and "connection closed" not in str(exc):
                        raise  # server-side -ERR: connection is fine
                    self.close()
                    raise
        return self._observed(label, op)

    def _observed(self, command: str, fn):
        # identical labels/log shape to the embedded client's hook
        # (redis.py::_observed) so REDIS_MODE swaps don't rename any
        # app_redis_stats series that dashboards key on
        start = time.perf_counter()
        try:
            return fn()
        finally:
            elapsed = time.perf_counter() - start
            if self.metrics is not None:
                self.metrics.record_histogram(
                    "app_redis_stats", elapsed,
                    type=command.split(" ")[0].lower())
            if self.logger is not None:
                self.logger.debug("REDIS", command=command,
                                  duration_ms=round(elapsed * 1e3, 3))

    # --------------------------------------------------------- commands
    def set(self, key, value, ex: float | None = None) -> bool:
        args = ["SET", key, value] + (["EX", int(ex)] if ex else [])
        return self.execute(*args) == "OK"

    def setex(self, key, seconds, value) -> bool:
        return self.execute("SETEX", key, int(seconds), value) == "OK"

    def get(self, key): return self.execute("GET", key)
    def delete(self, *keys): return self.execute("DEL", *keys)
    def exists(self, *keys): return self.execute("EXISTS", *keys)

    def expire(self, key, seconds) -> bool:
        return bool(self.execute("EXPIRE", key, int(seconds)))

    def ttl(self, key): return self.execute("TTL", key)

    def incr(self, key, by: int = 1):
        return self.execute("INCRBY", key, by, _label=f"INCR {key}")

    def decr(self, key, by: int = 1):
        return self.execute("DECRBY", key, by, _label=f"DECR {key}")

    def hset(self, key, field, value):
        return self.execute("HSET", key, field, value)

    def hget(self, key, field): return self.execute("HGET", key, field)

    def hgetall(self, key) -> dict:
        flat = self.execute("HGETALL", key) or []
        return dict(zip(flat[::2], flat[1::2]))

    def hdel(self, key, *fs): return self.execute("HDEL", key, *fs)
    def lpush(self, key, *vs): return self.execute("LPUSH", key, *vs)
    def rpush(self, key, *vs): return self.execute("RPUSH", key, *vs)

    def lrange(self, key, start, stop) -> list:
        return self.execute("LRANGE", key, start, stop) or []

    def llen(self, key): return self.execute("LLEN", key)
    def lpop(self, key): return self.execute("LPOP", key)
    def rpop(self, key): return self.execute("RPOP", key)
    def sadd(self, key, *ms): return self.execute("SADD", key, *ms)
    def srem(self, key, *ms): return self.execute("SREM", key, *ms)

    def smembers(self, key) -> set:
        return set(self.execute("SMEMBERS", key) or [])

    def sismember(self, key, member) -> bool:
        return bool(self.execute("SISMEMBER", key, member))

    def keys(self, pattern: str = "*") -> list:
        return self.execute("KEYS", pattern) or []

    def flushdb(self) -> bool:
        return self.execute("FLUSHDB") == "OK"

    def ping(self) -> bool:
        return self.execute("PING") in ("PONG", True)

    def health_check(self) -> dict[str, Any]:
        try:
            self.ping()
            return {"status": "UP",
                    "details": {"addr": f"{self.host}:{self.port}",
                                "mode": "network"}}
        except Exception as exc:
            return {"status": "DOWN", "error": str(exc)}


# ------------------------------------------------------------ mini server

class MiniRedisServer:
    """Threaded RESP2 server over the embedded engine — miniredis."""

    #: command name -> (engine method, encoder of the raw args)
    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self.host = host
        self.port = port
        self.engine = Redis(host="embedded", port=0)
        self.engine.connect()
        self._server: socket.socket | None = None
        self._threads: list[threading.Thread] = []
        self._conns: list[socket.socket] = []
        self._running = False

    def start(self) -> None:
        self._server = socket.create_server((self.host, self.port))
        self.port = self._server.getsockname()[1]
        self._running = True
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name="mini-redis")
        t.start()
        self._threads.append(t)

    def _accept_loop(self) -> None:
        assert self._server is not None
        while self._running:
            try:
                conn, _ = self._server.accept()
            except OSError:
                break
            self._conns.append(conn)
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _serve(self, conn: socket.socket) -> None:
        reader = _SocketReader(conn)
        try:
            while True:
                args = self._read_command(reader)
                if args is None:
                    break
                try:
                    reply = self._execute(args)
                except RedisError as exc:
                    reply = exc
                except Exception as exc:  # malformed args: error, not crash
                    reply = RedisError(str(exc))
                conn.sendall(encode_reply(reply)
                             if not isinstance(reply, _Simple)
                             else b"+%s\r\n" % reply.text.encode())
        except (RESP2Error, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _read_command(self, reader: _SocketReader) -> list[str] | None:
        try:
            line = reader.read_line()
        except RESP2Error:
            return None
        if not line.startswith(b"*"):
            raise RESP2Error(f"expected array, got {line[:1]!r}")
        n = int(line[1:])
        args = []
        for _ in range(n):
            header = reader.read_line()
            size = int(header[1:])
            args.append(reader.read_exact(size).decode())
            reader.read_exact(2)
        return args

    def _execute(self, args: list[str]) -> Any:
        cmd, rest = args[0].upper(), args[1:]
        e = self.engine
        if cmd == "PING":
            return _Simple("PONG")
        if cmd == "SET":
            ex = None
            if len(rest) >= 4 and rest[2].upper() == "EX":
                ex = float(rest[3])
            e.set(rest[0], rest[1], ex=ex)
            return _Simple("OK")
        if cmd == "SETEX":
            e.setex(rest[0], float(rest[1]), rest[2])
            return _Simple("OK")
        if cmd == "FLUSHDB":
            e.flushdb()
            return _Simple("OK")
        if cmd == "INCRBY":
            return e.incr(rest[0], int(rest[1]))
        if cmd == "DECRBY":
            return e.decr(rest[0], int(rest[1]))
        if cmd == "INCR":
            return e.incr(rest[0])
        if cmd == "DECR":
            return e.decr(rest[0])
        if cmd == "EXPIRE":
            return e.expire(rest[0], float(rest[1]))
        if cmd == "TTL":
            return int(e.ttl(rest[0]))
        if cmd == "LRANGE":
            return e.lrange(rest[0], int(rest[1]), int(rest[2]))
        simple = {
            "GET": e.get, "DEL": e.delete, "EXISTS": e.exists,
            "HSET": e.hset, "HGET": e.hget, "HGETALL": e.hgetall,
            "HDEL": e.hdel, "LPUSH": e.lpush, "RPUSH": e.rpush,
            "LLEN": e.llen, "LPOP": e.lpop, "RPOP": e.rpop,
            "SADD": e.sadd, "SREM": e.srem, "SMEMBERS": e.smembers,
            "SISMEMBER": e.sismember, "KEYS": e.keys,
        }.get(cmd)
        if simple is None:
            raise RedisError(f"unknown command '{cmd}'")
        return simple(*rest)

    def close(self) -> None:
        self._running = False
        if self._server is not None:
            try:
                self._server.close()
            except OSError:
                pass
        for conn in self._conns:  # live connections too, not just the
            try:                  # listener — clients must see the drop
                conn.close()
            except OSError:
                pass
        self._conns.clear()


class _Simple:
    """Marker for RESP2 simple-string replies (+OK vs $2 OK)."""

    def __init__(self, text: str) -> None:
        self.text = text

"""Redis-shaped datasource with an in-process backend (the port's copy
of ``gofr_tpu/datasource/redis.py``; ``REDIS_MODE=network`` selects the
RESP2 client, ``redis_wire.py``).

The analog of reference ``datasource/redis`` (redis.go:43, hook.go:17):
a Redis-command surface whose every operation is logged + timed into
``app_redis_stats``. Because this image ships no redis driver, the
default backend is an in-process store with real expiry semantics —
the "miniredis" role SURVEY §4 assigns for hermetic tests — behind the
same interface a real driver would implement, so swapping in a network
client is a constructor change, not an API change.

Commands cover the surface the reference's handler docs exercise:
get/set/setex/del/exists/expire/ttl/incr/decr/hset/hget/hgetall/hdel/
lpush/rpush/lrange/llen/lpop/rpop/sadd/srem/smembers/sismember/keys/
flushdb/ping.
"""

from __future__ import annotations

import fnmatch
import threading
import time
from typing import Any

from . import ProviderMixin


class RedisError(Exception):
    pass


class _Entry:
    __slots__ = ("value", "expires_at")

    def __init__(self, value: Any, expires_at: float | None = None) -> None:
        self.value = value
        self.expires_at = expires_at

    def expired(self, now: float) -> bool:
        return self.expires_at is not None and now >= self.expires_at


class Redis(ProviderMixin):
    """In-process Redis-command store with observability hooks."""

    def __init__(self, *, host: str = "localhost", port: int = 6379) -> None:
        self.host, self.port = host, port
        self._data: dict[str, _Entry] = {}
        self._lock = threading.RLock()
        self._connected = False

    def connect(self) -> None:
        self._connected = True
        if self.logger is not None:
            self.logger.info("connected to Redis",
                             addr=f"{self.host}:{self.port}")

    # ------------------------------------------------- instrumented core
    def _observed(self, command: str, fn, *args):
        """Run one command under the logging/metrics hook
        (reference redis/hook.go:17)."""
        if not self._connected:
            raise RedisError("redis not connected; call connect() first")
        start = time.perf_counter()
        try:
            with self._lock:
                # per-key lazy expiry happens in _live(); a full sweep
                # here would make every O(1) op O(total keys)
                return fn(*args)
        finally:
            micros = int((time.perf_counter() - start) * 1e6)
            if self.logger is not None:
                self.logger.debug(f"REDIS {micros:6d}µs {command}")
            if self.metrics is not None:
                self.metrics.record_histogram("app_redis_stats", micros / 1e6,
                                              type=command.split()[0].lower())

    def _sweep(self) -> None:
        now = time.monotonic()
        dead = [k for k, e in self._data.items() if e.expired(now)]
        for k in dead:
            del self._data[k]

    def _live(self, key: str) -> _Entry | None:
        e = self._data.get(key)
        if e is None or e.expired(time.monotonic()):
            self._data.pop(key, None)
            return None
        return e

    # ------------------------------------------------------------ string
    def set(self, key: str, value: Any, ex: float | None = None) -> bool:
        if ex is not None and ex <= 0:
            # real redis rejects SET ... EX 0 rather than storing forever
            raise RedisError("invalid expire time in 'set' command")

        def op():
            expires = time.monotonic() + ex if ex is not None else None
            self._data[key] = _Entry(value, expires)
            return True
        return self._observed(f"SET {key}", op)

    def setex(self, key: str, seconds: float, value: Any) -> bool:
        return self.set(key, value, ex=seconds)

    def get(self, key: str) -> Any:
        def op():
            e = self._live(key)
            return None if e is None else e.value
        return self._observed(f"GET {key}", op)

    def delete(self, *keys: str) -> int:
        def op():
            n = 0
            for k in keys:
                if self._live(k) is not None:
                    del self._data[k]
                    n += 1
            return n
        return self._observed(f"DEL {' '.join(keys)}", op)

    def exists(self, *keys: str) -> int:
        def op():
            return sum(1 for k in keys if self._live(k) is not None)
        return self._observed(f"EXISTS {' '.join(keys)}", op)

    def expire(self, key: str, seconds: float) -> bool:
        def op():
            e = self._live(key)
            if e is None:
                return False
            e.expires_at = time.monotonic() + seconds
            return True
        return self._observed(f"EXPIRE {key}", op)

    def ttl(self, key: str) -> float:
        """-2 missing, -1 no expiry (redis semantics)."""
        def op():
            e = self._live(key)
            if e is None:
                return -2
            if e.expires_at is None:
                return -1
            return max(0.0, e.expires_at - time.monotonic())
        return self._observed(f"TTL {key}", op)

    def _incr_by(self, key: str, delta: int) -> int:
        e = self._live(key)
        current = 0 if e is None else int(e.value)
        current += delta
        if e is None:
            self._data[key] = _Entry(current)
        else:
            e.value = current
        return current

    def incr(self, key: str, by: int = 1) -> int:
        return self._observed(f"INCR {key}", self._incr_by, key, by)

    def decr(self, key: str, by: int = 1) -> int:
        return self._observed(f"DECR {key}", self._incr_by, key, -by)

    # -------------------------------------------------------------- hash
    def _hash(self, key: str, create: bool = False) -> dict | None:
        e = self._live(key)
        if e is None:
            if not create:
                return None
            e = _Entry({})
            self._data[key] = e
        if not isinstance(e.value, dict):
            raise RedisError("WRONGTYPE not a hash")
        return e.value

    def hset(self, key: str, field: str, value: Any) -> int:
        def op():
            h = self._hash(key, create=True)
            fresh = field not in h
            h[field] = value
            return int(fresh)
        return self._observed(f"HSET {key} {field}", op)

    def hget(self, key: str, field: str) -> Any:
        def op():
            h = self._hash(key)
            return None if h is None else h.get(field)
        return self._observed(f"HGET {key} {field}", op)

    def hgetall(self, key: str) -> dict:
        def op():
            h = self._hash(key)
            return {} if h is None else dict(h)
        return self._observed(f"HGETALL {key}", op)

    def hdel(self, key: str, *fs: str) -> int:
        def op():
            h = self._hash(key)
            if h is None:
                return 0
            return sum(1 for f in fs if h.pop(f, None) is not None)
        return self._observed(f"HDEL {key}", op)

    # -------------------------------------------------------------- list
    def _list(self, key: str, create: bool = False) -> list | None:
        e = self._live(key)
        if e is None:
            if not create:
                return None
            e = _Entry([])
            self._data[key] = e
        if not isinstance(e.value, list):
            raise RedisError("WRONGTYPE not a list")
        return e.value

    def lpush(self, key: str, *values: Any) -> int:
        def op():
            lst = self._list(key, create=True)
            for v in values:
                lst.insert(0, v)
            return len(lst)
        return self._observed(f"LPUSH {key}", op)

    def rpush(self, key: str, *values: Any) -> int:
        def op():
            lst = self._list(key, create=True)
            lst.extend(values)
            return len(lst)
        return self._observed(f"RPUSH {key}", op)

    def lrange(self, key: str, start: int, stop: int) -> list:
        def op():
            lst = self._list(key)
            if lst is None:
                return []
            stop_ = len(lst) if stop == -1 else stop + 1
            return lst[start:stop_]
        return self._observed(f"LRANGE {key}", op)

    def llen(self, key: str) -> int:
        def op():
            lst = self._list(key)
            return 0 if lst is None else len(lst)
        return self._observed(f"LLEN {key}", op)

    def lpop(self, key: str) -> Any:
        def op():
            lst = self._list(key)
            return lst.pop(0) if lst else None
        return self._observed(f"LPOP {key}", op)

    def rpop(self, key: str) -> Any:
        def op():
            lst = self._list(key)
            return lst.pop() if lst else None
        return self._observed(f"RPOP {key}", op)

    # --------------------------------------------------------------- set
    def _set(self, key: str, create: bool = False) -> set | None:
        e = self._live(key)
        if e is None:
            if not create:
                return None
            e = _Entry(set())
            self._data[key] = e
        if not isinstance(e.value, set):
            raise RedisError("WRONGTYPE not a set")
        return e.value

    def sadd(self, key: str, *members: Any) -> int:
        def op():
            s = self._set(key, create=True)
            before = len(s)
            s.update(members)
            return len(s) - before
        return self._observed(f"SADD {key}", op)

    def srem(self, key: str, *members: Any) -> int:
        def op():
            s = self._set(key)
            if s is None:
                return 0
            before = len(s)
            s.difference_update(members)
            return before - len(s)
        return self._observed(f"SREM {key}", op)

    def smembers(self, key: str) -> set:
        def op():
            s = self._set(key)
            return set() if s is None else set(s)
        return self._observed(f"SMEMBERS {key}", op)

    def sismember(self, key: str, member: Any) -> bool:
        def op():
            s = self._set(key)
            return s is not None and member in s
        return self._observed(f"SISMEMBER {key}", op)

    # ------------------------------------------------------------- admin
    def keys(self, pattern: str = "*") -> list[str]:
        def op():
            self._sweep()  # keys() reads _data wholesale, so expire first
            return [k for k in self._data if fnmatch.fnmatchcase(k, pattern)]
        return self._observed(f"KEYS {pattern}", op)

    def flushdb(self) -> bool:
        def op():
            self._data.clear()
            return True
        return self._observed("FLUSHDB", op)

    def ping(self) -> bool:
        return self._observed("PING", lambda: True)

    def health_check(self) -> dict[str, Any]:
        try:
            self.ping()
            return {"status": "UP",
                    "details": {"addr": f"{self.host}:{self.port}",
                                "keys": len(self._data)}}
        except Exception as exc:
            return {"status": "DOWN", "error": str(exc)}

    def close(self) -> None:
        self._connected = False


def new_redis(config: Any, logger: Any = None, metrics: Any = None,
              tracer: Any = None):
    """Env-driven constructor (reference redis/redis.go:43): None when
    REDIS_HOST unset. ``REDIS_MODE=network`` selects the RESP2 wire
    client (:class:`~gofr_tpu_torch.datasource.redis_wire.RedisWire`) — the
    promised constructor swap; the default stays the embedded engine so
    apps run hermetically without a server."""
    host = config.get("REDIS_HOST") if config else None
    if not host:
        return None
    mode = config.get_or_default("REDIS_MODE", "embedded").lower()
    if mode == "network":
        from .redis_wire import RedisWire
        r: Any = RedisWire(host=host,
                           port=int(config.get_or_default("REDIS_PORT",
                                                          "6379")))
    else:
        r = Redis(host=host,
                  port=int(config.get_or_default("REDIS_PORT", "6379")))
    if logger is not None:
        r.use_logger(logger)
    if metrics is not None:
        r.use_metrics(metrics)
    if tracer is not None:
        r.use_tracer(tracer)
    try:
        r.connect()
    except OSError as exc:
        # a briefly-down server must not crash app boot: health reports
        # DOWN and the wire client redials lazily on first use
        if logger is not None:
            logger.error(f"redis connect failed (will retry on use): {exc}")
    return r

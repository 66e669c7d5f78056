"""Key-value store interface + embedded backends (the port's copy of
``gofr_tpu/datasource/kv.py``).

The analog of reference ``datasource/kv-store`` (badger/dynamodb/nats
modules behind the container's ``KVStore`` interface,
container/datasources.go:366-378): ``get``/``set``/``delete`` plus
health. Two embedded backends ship — in-memory (tests, caches) and
sqlite-file (the badger-analog: a persistent single-file store).
Every op records into ``app_kv_stats``.
"""

from __future__ import annotations

import sqlite3
import threading
import time
from typing import Any

from . import ProviderMixin


class KVError(Exception):
    pass


class KeyNotFound(KVError):
    def __init__(self, key: str) -> None:
        super().__init__(f"key not found: {key}")
        self.key = key


class _Instrumented(ProviderMixin):
    def _observed(self, op: str, key: str, fn):
        start = time.perf_counter()
        try:
            return fn()
        finally:
            micros = int((time.perf_counter() - start) * 1e6)
            if self.logger is not None:
                self.logger.debug(f"KV {micros:6d}µs {op} {key}")
            if self.metrics is not None:
                self.metrics.record_histogram("app_kv_stats", micros / 1e6,
                                              type=op.lower())


class InMemoryKV(_Instrumented):
    """Dict-backed store — the mock/test backend."""

    def __init__(self) -> None:
        self._data: dict[str, str] = {}
        self._lock = threading.RLock()

    def connect(self) -> None:
        pass

    def get(self, key: str) -> str:
        def op():
            with self._lock:
                if key not in self._data:
                    raise KeyNotFound(key)
                return self._data[key]
        return self._observed("GET", key, op)

    def set(self, key: str, value: str) -> None:
        def op():
            with self._lock:
                self._data[key] = value
        return self._observed("SET", key, op)

    def delete(self, key: str) -> None:
        def op():
            with self._lock:
                self._data.pop(key, None)
        return self._observed("DELETE", key, op)

    def keys(self) -> list[str]:
        with self._lock:
            return sorted(self._data)

    def health_check(self) -> dict[str, Any]:
        return {"status": "UP", "details": {"backend": "memory",
                                             "keys": len(self._data)}}

    def close(self) -> None:
        pass


class FileKV(_Instrumented):
    """Single-file persistent store (badger analog) over sqlite."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._conn: sqlite3.Connection | None = None
        self._lock = threading.RLock()

    def connect(self) -> None:
        self._conn = sqlite3.connect(self.path, check_same_thread=False)
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS kv (k TEXT PRIMARY KEY, v TEXT)")
        self._conn.commit()
        if self.logger is not None:
            self.logger.info("opened KV store", path=self.path)

    def _require(self) -> sqlite3.Connection:
        if self._conn is None:
            raise KVError("KV store not connected")
        return self._conn

    def get(self, key: str) -> str:
        def op():
            with self._lock:
                row = self._require().execute(
                    "SELECT v FROM kv WHERE k = ?", (key,)).fetchone()
            if row is None:
                raise KeyNotFound(key)
            return row[0]
        return self._observed("GET", key, op)

    def set(self, key: str, value: str) -> None:
        def op():
            with self._lock:
                conn = self._require()
                conn.execute(
                    "INSERT INTO kv (k, v) VALUES (?, ?) "
                    "ON CONFLICT(k) DO UPDATE SET v = excluded.v",
                    (key, value))
                conn.commit()
        return self._observed("SET", key, op)

    def delete(self, key: str) -> None:
        def op():
            with self._lock:
                conn = self._require()
                conn.execute("DELETE FROM kv WHERE k = ?", (key,))
                conn.commit()
        return self._observed("DELETE", key, op)

    def keys(self) -> list[str]:
        with self._lock:
            rows = self._require().execute(
                "SELECT k FROM kv ORDER BY k").fetchall()
        return [r[0] for r in rows]

    def health_check(self) -> dict[str, Any]:
        try:
            with self._lock:
                n = self._require().execute(
                    "SELECT COUNT(*) FROM kv").fetchone()[0]
            return {"status": "UP", "details": {"backend": "file",
                                                 "path": self.path,
                                                 "keys": n}}
        except Exception as exc:
            return {"status": "DOWN", "error": str(exc)}

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

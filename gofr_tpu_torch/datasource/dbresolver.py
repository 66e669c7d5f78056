"""SQL primary/replica resolver (the port's copy of
``gofr_tpu/datasource/dbresolver.py``).

The analog of reference ``datasource/dbresolver`` (resolver.go:21-50):
reads route to replicas under a selection strategy, writes always hit
the primary, each replica carries its own circuit breaker so a sick
replica drops out of rotation and probes back in, and a context switch
(``primary_reads``) pins reads to the primary for read-after-write
consistency. Per-target counters mirror the reference's atomic stats.
"""

from __future__ import annotations

import contextvars
import itertools
import random
import threading
import time
from contextlib import contextmanager
from typing import Any, Iterator, Sequence

STRATEGY_ROUND_ROBIN = "round_robin"
STRATEGY_RANDOM = "random"

_FORCE_PRIMARY: contextvars.ContextVar[bool] = \
    contextvars.ContextVar("gofr_dbresolver_primary", default=False)

_WRITE_PREFIXES = ("insert", "update", "delete", "create", "drop",
                   "alter", "replace", "truncate", "pragma")


@contextmanager
def primary_reads() -> Iterator[None]:
    """Pin reads inside the block to the primary (reference
    dbresolver PrimaryRoutes context keys)."""
    token = _FORCE_PRIMARY.set(True)
    try:
        yield
    finally:
        _FORCE_PRIMARY.reset(token)


class _ReplicaBreaker:
    """Per-replica circuit breaker (reference dbresolver/resolver.go:21-50):
    opens after ``threshold`` consecutive failures, half-opens after
    ``recovery_interval`` seconds to let one probe through."""

    def __init__(self, threshold: int = 3,
                 recovery_interval: float = 10.0) -> None:
        self.threshold = threshold
        self.recovery_interval = recovery_interval
        self.failures = 0
        self.opened_at: float | None = None
        self._lock = threading.Lock()

    def available(self) -> bool:
        with self._lock:
            if self.opened_at is None:
                return True
            if time.monotonic() - self.opened_at >= self.recovery_interval:
                return True  # half-open: admit a probe
            return False

    def record(self, ok: bool) -> None:
        with self._lock:
            if ok:
                self.failures = 0
                self.opened_at = None
            else:
                self.failures += 1
                if self.failures >= self.threshold:
                    self.opened_at = time.monotonic()


class DBResolver:
    """Routes `query`/`exec` over a primary + replicas, quacking like
    :class:`..sql.SQL` so it drops into the
    container's ``sql`` slot unchanged."""

    def __init__(self, primary: Any, replicas: Sequence[Any] = (),
                 *, strategy: str = STRATEGY_ROUND_ROBIN,
                 breaker_threshold: int = 3,
                 breaker_recovery: float = 10.0) -> None:
        if strategy not in (STRATEGY_ROUND_ROBIN, STRATEGY_RANDOM):
            raise ValueError(f"unknown strategy {strategy!r}")
        self.primary = primary
        self.replicas = list(replicas)
        self.strategy = strategy
        self._rr = itertools.count()
        self._breakers = [
            _ReplicaBreaker(breaker_threshold, breaker_recovery)
            for _ in self.replicas]
        self.stats = {"primary_reads": 0, "replica_reads": 0,
                      "writes": 0, "replica_failovers": 0}
        self._stats_lock = threading.Lock()

    # ------------------------------------------------------ provider API
    def use_logger(self, logger: Any) -> None:
        for db in (self.primary, *self.replicas):
            db.use_logger(logger)

    def use_metrics(self, metrics: Any) -> None:
        for db in (self.primary, *self.replicas):
            db.use_metrics(metrics)

    def use_tracer(self, tracer: Any) -> None:
        for db in (self.primary, *self.replicas):
            db.use_tracer(tracer)

    def connect(self) -> None:
        for db in (self.primary, *self.replicas):
            db.connect()

    # ---------------------------------------------------------- routing
    def _bump(self, key: str) -> None:
        with self._stats_lock:
            self.stats[key] += 1

    def _pick_replica(self) -> int | None:
        live = [i for i, b in enumerate(self._breakers) if b.available()]
        if not live:
            return None
        if self.strategy == STRATEGY_RANDOM:
            return random.choice(live)
        return live[next(self._rr) % len(live)]

    def _is_write(self, query: str) -> bool:
        head = query.lstrip().split(None, 1)
        return bool(head) and head[0].lower() in _WRITE_PREFIXES

    def query(self, query: str, *args: Any) -> Any:
        if self._is_write(query) or not self.replicas \
                or _FORCE_PRIMARY.get():
            self._bump("primary_reads")
            return self.primary.query(query, *args)
        idx = self._pick_replica()
        if idx is None:
            # every replica's breaker is open: fall back to primary
            self._bump("replica_failovers")
            self._bump("primary_reads")
            return self.primary.query(query, *args)
        try:
            rows = self.replicas[idx].query(query, *args)
            self._breakers[idx].record(True)
            self._bump("replica_reads")
            return rows
        except Exception:
            self._breakers[idx].record(False)
            self._bump("replica_failovers")
            self._bump("primary_reads")
            return self.primary.query(query, *args)

    def query_row(self, query: str, *args: Any) -> Any:
        rows = self.query(query, *args)
        return rows[0] if rows else None

    def exec(self, query: str, *args: Any) -> Any:
        self._bump("writes")
        return self.primary.exec(query, *args)

    def select(self, entity_type: type, query: str, *args: Any) -> Any:
        # route through the resolver, then map on the primary's helper
        # semantics (all SQL backends share the dataclass mapping)
        rows = self.query(query, *args)
        from dataclasses import fields, is_dataclass
        if not is_dataclass(entity_type):
            from .sql import SQLError
            raise SQLError("select requires a dataclass type")
        names = [f.name for f in fields(entity_type)]
        return [entity_type(**{n: row[n] for n in names
                               if n in set(row.keys())})
                for row in rows]

    def begin(self):
        # transactions are writes by definition
        self._bump("writes")
        return self.primary.begin()

    # ------------------------------------------------------------ health
    def health_check(self) -> dict[str, Any]:
        primary_health = self.primary.health_check()
        replicas = [db.health_check() for db in self.replicas]
        status = primary_health.get("status", "DOWN")
        if status == "UP" and any(r.get("status") != "UP"
                                  for r in replicas):
            status = "DEGRADED"
        return {"status": status, "primary": primary_health,
                "replicas": replicas, "stats": dict(self.stats)}

    def close(self) -> None:
        for db in (self.primary, *self.replicas):
            db.close()

"""Time-series family: OpenTSDB- and InfluxDB-shaped stores over one
embedded series engine.

Reference interfaces: OpenTSDB container/datasources.go:501-598 (put
datapoints, query with aggregators, annotations), InfluxDB :797-839
(write points to bucket/measurement, query, bucket admin). Adapters
share :class:`SeriesEngine`, an embedded tagged-series store with range
queries and aggregation; production deployments swap the engine for a
network client behind the same interface.

The port's copy of ``gofr_tpu/datasource/timeseries.py``.
"""

from __future__ import annotations

import bisect
import threading
from typing import Any

from . import Instrumented


class TimeseriesError(Exception):
    pass


_AGGREGATORS = {
    "sum": sum,
    "avg": lambda vs: sum(vs) / len(vs),
    "max": max,
    "min": min,
    "count": len,
    "last": lambda vs: vs[-1],
}


class SeriesEngine:
    """metric + sorted (ts, value, tags) points, range-queryable."""

    def __init__(self) -> None:
        # metric -> sorted list of (ts, value, tags)
        self._series: dict[str, list[tuple[float, float, dict]]] = {}
        self._lock = threading.RLock()

    def put(self, metric: str, ts: float, value: float,
            tags: dict | None = None) -> None:
        with self._lock:
            points = self._series.setdefault(metric, [])
            bisect.insort(points, (float(ts), float(value), tags or {}),
                          key=lambda p: p[0])

    def query(self, metric: str, start: float | None = None,
              end: float | None = None,
              tags: dict | None = None) -> list[tuple[float, float, dict]]:
        with self._lock:
            points = list(self._series.get(metric, []))
        return [p for p in points
                if (start is None or p[0] >= start)
                and (end is None or p[0] <= end)
                and (not tags or all(p[2].get(k) == v
                                     for k, v in tags.items()))]

    def aggregate(self, metric: str, aggregator: str,
                  start: float | None = None, end: float | None = None,
                  tags: dict | None = None) -> float | None:
        if aggregator not in _AGGREGATORS:
            raise TimeseriesError(f"unknown aggregator {aggregator!r}")
        values = [v for _, v, _ in self.query(metric, start, end, tags)]
        return _AGGREGATORS[aggregator](values) if values else None

    def metrics(self) -> list[str]:
        with self._lock:
            return sorted(self._series)

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {"metrics": len(self._series),
                    "points": sum(len(v) for v in self._series.values())}


class _SeriesStore(Instrumented):
    backend_name = "timeseries"

    def __init__(self, engine: SeriesEngine | None = None) -> None:
        self.engine = engine if engine is not None else SeriesEngine()

    def connect(self) -> None:
        if self.logger is not None:
            self.logger.debug(f"connected {self.backend_name} store")

    def health_check(self) -> dict[str, Any]:
        return {"status": "UP", "details": {"backend": self.backend_name,
                                            **self.engine.stats()}}

    def close(self) -> None:
        pass


class OpenTSDB(_SeriesStore):
    """OpenTSDB-shaped surface (reference container/datasources.go:501-598):
    put datapoints, query with aggregator, annotations."""

    metric = "app_opentsdb_stats"
    log_tag = "TSDB"
    backend_name = "opentsdb"

    def __init__(self, engine: SeriesEngine | None = None) -> None:
        super().__init__(engine)
        self._annotations: list[dict] = []

    def put_data_points(self, datapoints: list[dict]) -> int:
        """Each point: {"metric", "timestamp", "value", "tags"?}."""
        def op():
            for p in datapoints:
                self.engine.put(p["metric"], p["timestamp"], p["value"],
                                p.get("tags"))
            return len(datapoints)
        return self._observed("PUT", f"{len(datapoints)} pts", op)

    def query(self, metric: str, aggregator: str = "sum",
              start: float | None = None, end: float | None = None,
              tags: dict | None = None) -> dict:
        def op():
            points = self.engine.query(metric, start, end, tags)
            value = self.engine.aggregate(metric, aggregator, start, end, tags)
            return {"metric": metric, "aggregator": aggregator,
                    "dps": {str(int(ts)): v for ts, v, _ in points},
                    "value": value}
        return self._observed("QUERY", metric, op)

    def put_annotation(self, annotation: dict) -> None:
        self._observed("ANNOTATE", annotation.get("description", "")[:30],
                       lambda: self._annotations.append(dict(annotation)))

    def query_annotations(self, start: float, end: float) -> list[dict]:
        return [a for a in self._annotations
                if start <= a.get("startTime", 0) <= end]


class InfluxDB(_SeriesStore):
    """InfluxDB-shaped surface (reference container/datasources.go:797-839):
    buckets of measurements; write points, query, bucket admin."""

    metric = "app_influxdb_stats"
    log_tag = "INFLUX"
    backend_name = "influxdb"

    def __init__(self, engine: SeriesEngine | None = None) -> None:
        super().__init__(engine)
        self._buckets: set[str] = set()

    @staticmethod
    def _key(bucket: str, measurement: str) -> str:
        return f"{bucket}/{measurement}"

    def create_bucket(self, bucket: str) -> None:
        self._observed("CREATE_BUCKET", bucket,
                       lambda: self._buckets.add(bucket))

    def delete_bucket(self, bucket: str) -> None:
        self._observed("DELETE_BUCKET", bucket,
                       lambda: self._buckets.discard(bucket))

    def list_buckets(self) -> list[str]:
        return sorted(self._buckets)

    def write_point(self, bucket: str, measurement: str, ts: float,
                    fields: dict[str, float],
                    tags: dict | None = None) -> None:
        def op():
            self._buckets.add(bucket)
            for field, value in fields.items():
                self.engine.put(self._key(bucket, measurement), ts, value,
                                dict(tags or {}, _field=field))
        self._observed("WRITE", f"{bucket}/{measurement}", op)

    def query(self, bucket: str, measurement: str, field: str,
              start: float | None = None, end: float | None = None,
              tags: dict | None = None) -> list[tuple[float, float]]:
        def op():
            points = self.engine.query(self._key(bucket, measurement),
                                       start, end,
                                       dict(tags or {}, _field=field))
            return [(ts, v) for ts, v, _ in points]
        return self._observed("QUERY", f"{bucket}/{measurement}", op)

    def aggregate(self, bucket: str, measurement: str, field: str,
                  aggregator: str = "avg", **kw: Any) -> float | None:
        return self.engine.aggregate(self._key(bucket, measurement),
                                     aggregator,
                                     tags={"_field": field}, **kw)

    def health_check(self) -> dict[str, Any]:
        health = super().health_check()
        health["details"]["buckets"] = len(self._buckets)
        return health

"""Metrics manager with Prometheus text exposition (the port's copy of
``gofr_tpu/metrics/registry.py``, same names and output).

``new_counter / new_up_down_counter / new_histogram / new_gauge`` to
register, ``increment_counter / add_counter / delta_up_down_counter /
record_histogram / set_gauge`` to write: label-aware and thread-safe,
rendered on scrape by :meth:`Manager.render_prometheus` (or
:meth:`Manager.render_openmetrics`, which adds exemplars and ``# EOF``)
on the app's metrics port. The same calls render the same bytes as the
JAX package's manager.

Left out: the fleet federation (``snapshot``, ``merge_snapshots``,
``render_federated``). An exemplar's trace id comes from the caller
(``exemplar_trace_id=``): the port has no request-scoped logging
context to read one from.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Iterable, Mapping

DEFAULT_BUCKETS = (0.001, 0.003, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 0.75, 1, 2, 3, 5, 10, 30)


class MetricsError(Exception):
    pass


def _labels_key(labels: Mapping[str, str]) -> tuple[tuple[str, str], ...]:
    return tuple(sorted(labels.items()))


def _fmt_labels(key: tuple[tuple[str, str], ...]) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in key)
    return "{" + inner + "}"


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, description: str) -> None:
        self.name = name
        self.description = description
        self._values: dict[tuple[tuple[str, str], ...], float] = {}
        self._lock = threading.Lock()

    def _bump(self, delta: float, labels: Mapping[str, str]) -> None:
        key = _labels_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + delta

    def _set(self, value: float, labels: Mapping[str, str]) -> None:
        key = _labels_key(labels)
        with self._lock:
            self._values[key] = value

    def get(self, **labels: str) -> float:
        return self._values.get(_labels_key(labels), 0.0)

    def render(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.description}"
        yield f"# TYPE {self.name} {self.kind}"
        with self._lock:
            items = list(self._values.items())
        for key, value in items:
            yield f"{self.name}{_fmt_labels(key)} {_fmt_value(value)}"


class Counter(_Metric):
    kind = "counter"


class UpDownCounter(_Metric):
    kind = "gauge"  # prometheus has no updown type; exposed as gauge


class Gauge(_Metric):
    kind = "gauge"


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, description: str,
                 buckets: Iterable[float] = DEFAULT_BUCKETS) -> None:
        super().__init__(name, description)
        self.buckets = tuple(sorted(buckets))
        # labelset -> (bucket_counts, sum, count)
        self._hist: dict[tuple[tuple[str, str], ...], tuple[list[int], float, int]] = {}
        # labelset -> per-bucket latest exemplar (trace_id, value, ts);
        # index len(buckets) is the +Inf bucket. Rendered only on the
        # OpenMetrics path, so the Prometheus text is the same with
        # exemplars or without
        self._exemplars: dict[tuple[tuple[str, str], ...],
                              list[tuple[str, float, float] | None]] = {}

    def record(self, value: float, labels: Mapping[str, str],
               trace_id: str | None = None) -> None:
        """Record an observation; ``trace_id`` (the caller's, e.g. the
        retired request's) is kept as its bucket's exemplar."""
        key = _labels_key(labels)
        with self._lock:
            counts, total, n = self._hist.get(key, ([0] * len(self.buckets), 0.0, 0))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            self._hist[key] = (counts, total + value, n + 1)
            if trace_id:
                ex = self._exemplars.get(key)
                if ex is None:
                    ex = [None] * (len(self.buckets) + 1)
                    self._exemplars[key] = ex
                idx = next((i for i, b in enumerate(self.buckets)
                            if value <= b), len(self.buckets))
                ex[idx] = (trace_id, value, time.time())

    def get_count(self, **labels: str) -> int:
        with self._lock:
            entry = self._hist.get(_labels_key(labels))
            return entry[2] if entry else 0

    def render(self) -> Iterable[str]:
        yield from self._render(exemplars=False)

    def render_openmetrics(self) -> Iterable[str]:
        """The same exposition with OpenMetrics exemplars on bucket
        lines: ``name_bucket{le="..."} 7 # {trace_id="..."} 0.093 <ts>``."""
        yield from self._render(exemplars=True)

    def _render(self, exemplars: bool) -> Iterable[str]:
        yield f"# HELP {self.name} {self.description}"
        yield f"# TYPE {self.name} histogram"
        with self._lock:
            items = [(k, ([*c], s, n)) for k, (c, s, n) in self._hist.items()]
            ex = {k: list(v) for k, v in self._exemplars.items()} \
                if exemplars else {}

        def tail(key: tuple, idx: int) -> str:
            e = ex.get(key)
            if not e or e[idx] is None:
                return ""
            trace_id, value, ts = e[idx]
            return (f' # {{trace_id="{_escape(trace_id)}"}} '
                    f"{_fmt_value(value)} {round(ts, 3)}")

        for key, (counts, total, n) in items:
            for i, (bucket, count) in enumerate(zip(self.buckets, counts)):
                bkey = key + (("le", _fmt_value(float(bucket))),)
                yield (f"{self.name}_bucket"
                       f"{_fmt_labels(tuple(sorted(bkey)))} {count}"
                       + tail(key, i))
            inf_key = key + (("le", "+Inf"),)
            yield (f"{self.name}_bucket"
                   f"{_fmt_labels(tuple(sorted(inf_key)))} {n}"
                   + tail(key, len(self.buckets)))
            yield f"{self.name}_sum{_fmt_labels(key)} {_fmt_value(total)}"
            yield f"{self.name}_count{_fmt_labels(key)} {n}"


class Manager:
    """Register-then-write metrics facade. A write to a name that is not
    registered as that kind is dropped (and logged, with a logger)."""

    def __init__(self, logger=None) -> None:
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()
        self._logger = logger

    def _register(self, metric: _Metric) -> None:
        with self._lock:
            if metric.name in self._metrics:
                raise MetricsError(f"metric {metric.name!r} already registered")
            self._metrics[metric.name] = metric

    # -- registration
    def new_counter(self, name: str, description: str) -> Counter:
        m = Counter(name, description)
        self._register(m)
        return m

    def new_up_down_counter(self, name: str, description: str) -> UpDownCounter:
        m = UpDownCounter(name, description)
        self._register(m)
        return m

    def new_histogram(self, name: str, description: str,
                      buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        m = Histogram(name, description, buckets)
        self._register(m)
        return m

    def new_gauge(self, name: str, description: str) -> Gauge:
        m = Gauge(name, description)
        self._register(m)
        return m

    # -- writes
    def _lookup(self, name: str, kind: type) -> _Metric | None:
        m = self._metrics.get(name)
        if m is None or not isinstance(m, kind):
            if self._logger is not None:
                self._logger.error(f"metric {name!r} not registered as {kind.__name__}")
            return None
        return m

    def increment_counter(self, name: str, **labels: str) -> None:
        m = self._lookup(name, Counter)
        if m is not None:
            m._bump(1.0, labels)

    def add_counter(self, name: str, value: float, **labels: str) -> None:
        m = self._lookup(name, Counter)
        if m is not None:
            m._bump(value, labels)

    def delta_up_down_counter(self, name: str, delta: float, **labels: str) -> None:
        m = self._lookup(name, UpDownCounter)
        if m is not None:
            m._bump(delta, labels)

    def record_histogram(self, name: str, value: float, *,
                         exemplar_trace_id: str | None = None,
                         **labels: str) -> None:
        m = self._lookup(name, Histogram)
        if m is not None:
            m.record(value, labels, trace_id=exemplar_trace_id)

    def set_gauge(self, name: str, value: float, **labels: str) -> None:
        m = self._lookup(name, Gauge)
        if m is not None:
            m._set(value, labels)

    def get(self, name: str) -> _Metric | None:
        return self._metrics.get(name)

    def get_histogram_count(self, name: str, **labels: str) -> int:
        m = self._lookup(name, Histogram)
        return 0 if m is None else m.get_count(**labels)

    # -- scrape
    def render_prometheus(self, prefix: str | None = None) -> str:
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        lines: list[str] = []
        for m in metrics:
            if prefix is not None and not m.name.startswith(prefix):
                continue
            lines.extend(m.render())
        return "\n".join(lines) + "\n" if lines else ""

    def render_openmetrics(self, prefix: str | None = None) -> str:
        """The ``application/openmetrics-text`` exposition: the families
        and samples of :meth:`render_prometheus`, exemplars on histogram
        bucket lines, and the ``# EOF`` terminator."""
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        lines: list[str] = []
        for m in metrics:
            if prefix is not None and not m.name.startswith(prefix):
                continue
            if isinstance(m, Histogram):
                lines.extend(m.render_openmetrics())
            else:
                lines.extend(m.render())
        lines.append("# EOF")
        return "\n".join(lines) + "\n"

"""Metrics manager with Prometheus text exposition (the port's copy of
``gofr_tpu/metrics/registry.py``, same names and output).

``new_counter / new_up_down_counter / new_histogram / new_gauge`` to
register, ``increment_counter / add_counter / delta_up_down_counter /
record_histogram / set_gauge`` to write: label-aware and thread-safe,
rendered on scrape by :meth:`Manager.render_prometheus` (or
:meth:`Manager.render_openmetrics`, which adds exemplars and ``# EOF``)
on the app's metrics port. The same calls render the same bytes as the
JAX package's manager.

Fleet federation: :meth:`Manager.snapshot` is the JSON-safe dump a
worker attaches to its control-plane heartbeat, :func:`merge_snapshots`
folds per-host snapshots into one fleet view (counters summed, gauges
kept per host, histograms merged when their buckets agree) and
:func:`render_federated` renders them as one Prometheus exposition with
``host`` / ``rank`` labels (the leader's ``GET /control/fleet/metrics``);
both give the JAX package's bytes for the same writes.

An exemplar's trace id comes from the caller (``exemplar_trace_id=``):
the port has no request-scoped logging context to read one from.
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

    def snapshot(self) -> dict:
        """JSON-safe dump: kind, help text, and every labeled series."""
        with self._lock:
            series = [{"labels": dict(k), "value": v}
                      for k, v in self._values.items()]
        return {"kind": self.kind, "help": self.description,
                "series": series}

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

    def snapshot(self) -> dict:
        out = super().snapshot()
        # rendered as a gauge, but deltas add across hosts:
        # merge_snapshots sums these instead of keeping them per host
        out["updown"] = True
        return out


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

    def get_sum(self, **labels: str) -> float:
        with self._lock:
            entry = self._hist.get(_labels_key(labels))
            return entry[1] if entry else 0.0

    def snapshot(self) -> dict:
        with self._lock:
            series = [{"labels": dict(k), "counts": list(c),
                       "sum": s, "count": n}
                      for k, (c, s, n) in self._hist.items()]
        return {"kind": "histogram", "help": self.description,
                "buckets": list(self.buckets), "series": series}

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

    # -- federation
    def snapshot(self) -> dict:
        """Structured dump of every registered metric: the payload a
        worker attaches to its control-plane heartbeat. Host-side reads
        under each metric's lock; JSON-serializable as it is."""
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        return {"v": 1, "metrics": {m.name: m.snapshot() for m in metrics}}


def merge_snapshots(per_host: Mapping[str, Mapping]) -> dict:
    """Aggregate per-host ``Manager.snapshot()`` payloads into one fleet
    view: counters (and up/down counters) SUM across hosts per identical
    labelset, gauges KEEP per host (a ``host`` label is added),
    histograms MERGE bucket counts and sums per labelset when the bucket
    layouts agree (mismatched layouts stay per host under a ``host``
    label, never mixed)."""
    families: dict[str, dict] = {}
    for host in sorted(per_host):
        snap = per_host[host] or {}
        for name, fam in (snap.get("metrics") or {}).items():
            kind = fam.get("kind", "untyped")
            tgt = families.setdefault(name, {
                "kind": kind, "help": fam.get("help", ""),
                "_sums": {}, "_hists": {}, "_per_host": [],
                "buckets": fam.get("buckets")})
            for s in fam.get("series", ()):
                labels = dict(s.get("labels") or {})
                key = _labels_key(labels)
                if kind == "counter" or (kind == "gauge"
                                         and "counts" not in s
                                         and fam.get("updown")):
                    tgt["_sums"][key] = (tgt["_sums"].get(key, 0.0)
                                         + float(s.get("value", 0.0)))
                elif kind == "histogram":
                    if fam.get("buckets") != tgt["buckets"]:
                        tgt["_per_host"].append(
                            {**s, "labels": {**labels, "host": host}})
                        continue
                    counts, total, n = tgt["_hists"].get(
                        key, ([0] * len(tgt["buckets"] or ()), 0.0, 0))
                    merged = [a + b for a, b in
                              zip(counts, s.get("counts", ()))]
                    tgt["_hists"][key] = (merged,
                                          total + float(s.get("sum", 0.0)),
                                          n + int(s.get("count", 0)))
                else:  # gauge / untyped: which host matters
                    tgt["_per_host"].append(
                        {**s, "labels": {**labels, "host": host}})
    out: dict[str, dict] = {}
    for name, fam in families.items():
        series: list[dict] = []
        series.extend({"labels": dict(k), "value": v}
                      for k, v in fam["_sums"].items())
        series.extend({"labels": dict(k), "counts": c, "sum": s,
                       "count": n}
                      for k, (c, s, n) in fam["_hists"].items())
        series.extend(fam["_per_host"])
        entry = {"kind": fam["kind"], "help": fam["help"],
                 "series": series}
        if fam["kind"] == "histogram":
            entry["buckets"] = fam["buckets"]
        out[name] = entry
    return {"v": 1, "metrics": out}


def render_federated(per_host: Mapping[str, Mapping],
                     extra_labels: Mapping[str, Mapping[str, str]]
                     | None = None) -> str:
    """Render per-host snapshots as ONE Prometheus exposition: each
    family's HELP / TYPE once, every sample with the caller's extra
    labels for its host (``{"host": ..., "rank": ...}``). The leader's
    ``GET /control/fleet/metrics``; summing a counter over its ``host``
    label gives the fleet total."""
    names: dict[str, dict] = {}
    for host in per_host:
        for name, fam in ((per_host[host] or {}).get("metrics")
                          or {}).items():
            names.setdefault(name, fam)
    lines: list[str] = []
    for name in sorted(names):
        first = names[name]
        kind = first.get("kind", "untyped")
        lines.append(f"# HELP {name} {first.get('help', '')}")
        lines.append(f"# TYPE {name} {kind}")
        for host in sorted(per_host):
            fam = ((per_host[host] or {}).get("metrics") or {}).get(name)
            if fam is None:
                continue
            extra = dict((extra_labels or {}).get(host)
                         or ({"host": host} if host else {}))
            buckets = fam.get("buckets") or ()
            for s in fam.get("series", ()):
                key = _labels_key({**(s.get("labels") or {}), **extra})
                if kind == "histogram":
                    counts = s.get("counts", ())
                    n = int(s.get("count", 0))
                    for bucket, count in zip(buckets, counts):
                        bkey = _labels_key(dict(
                            key + (("le", _fmt_value(float(bucket))),)))
                        lines.append(
                            f"{name}_bucket{_fmt_labels(bkey)} {count}")
                    ikey = _labels_key(dict(key + (("le", "+Inf"),)))
                    lines.append(f"{name}_bucket{_fmt_labels(ikey)} {n}")
                    lines.append(f"{name}_sum{_fmt_labels(key)} "
                                 f"{_fmt_value(float(s.get('sum', 0.0)))}")
                    lines.append(f"{name}_count{_fmt_labels(key)} {n}")
                else:
                    lines.append(f"{name}{_fmt_labels(key)} "
                                 f"{_fmt_value(float(s.get('value', 0.0)))}")
    return "\n".join(lines) + "\n" if lines else ""

"""Network span exporters: OTLP/HTTP JSON and Zipkin v2.

The reference wires OTel exporters to real collectors by URL —
otlp/zipkin/jaeger/gofr (reference pkg/gofr/otel.go:131-151). These are
the same egress paths for this tracer: spans batch in a background
thread (ending a span never blocks a request on network IO) and POST
as JSON to the collector; failures log and drop, never crash or block
the app.

- :class:`OTLPHTTPExporter` — OTLP/HTTP with the standard proto3-JSON
  encoding of ``ExportTraceServiceRequest``, POSTed to
  ``<endpoint>/v1/traces`` (any OTel collector accepts it).
- :class:`ZipkinExporter` — Zipkin v2 JSON to ``<endpoint>/api/v2/spans``
  (zipkin, jaeger's zipkin port, grafana tempo).

Selected by ``TRACE_EXPORTER=otlp|zipkin`` + ``TRACER_URL`` (container
wiring, reference otel.go's exporter switch).

The port's copy of ``gofr_tpu/tracing/export.py``.
"""

from __future__ import annotations

import json
import queue
import threading
import urllib.request
from typing import Any

from .tracer import Span


class _BatchingHTTPExporter:
    """Shared batch/flush machinery: export() enqueues, a daemon thread
    drains into POSTs of up to ``batch_size`` spans."""

    def __init__(self, endpoint: str, path: str, *,
                 batch_size: int = 64, flush_interval_s: float = 2.0,
                 timeout_s: float = 5.0, logger: Any = None) -> None:
        self.endpoint = endpoint.rstrip("/")
        self.path = path
        self.batch_size = batch_size
        self.flush_interval_s = flush_interval_s
        self.timeout_s = timeout_s
        self.logger = logger
        self.sent = 0
        self.dropped = 0
        self._queue: queue.Queue = queue.Queue(maxsize=4096)
        self._closed = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="gofr-trace-export")
        self._thread.start()

    def export(self, span: Span) -> None:
        try:
            self._queue.put_nowait(span)
        except queue.Full:
            self.dropped += 1  # backpressure: drop, never block a request

    def _loop(self) -> None:
        while not self._closed.is_set():
            batch = self._drain()
            if batch:
                self._post(batch)

    def _drain(self) -> list[Span]:
        batch: list[Span] = []
        try:
            batch.append(self._queue.get(timeout=self.flush_interval_s))
        except queue.Empty:
            return batch
        while len(batch) < self.batch_size:
            try:
                batch.append(self._queue.get_nowait())
            except queue.Empty:
                break
        return batch

    def _post(self, batch: list[Span]) -> None:
        body = json.dumps(self.encode(batch)).encode()
        req = urllib.request.Request(
            self.endpoint + self.path, data=body,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s):
                pass
            self.sent += len(batch)
        except Exception as exc:
            self.dropped += len(batch)
            if self.logger is not None:
                self.logger.warn(f"trace export failed: {exc}")

    def encode(self, batch: list[Span]) -> Any:  # pragma: no cover
        raise NotImplementedError

    def close(self) -> None:
        """Flush what's queued, then stop the worker."""
        batch = []
        try:
            while True:
                batch.append(self._queue.get_nowait())
        except queue.Empty:
            pass
        if batch:
            self._post(batch)
        self._closed.set()
        self._thread.join(timeout=self.flush_interval_s + 1)


class OTLPHTTPExporter(_BatchingHTTPExporter):
    def __init__(self, endpoint: str, service_name: str = "gofr-app",
                 **kw: Any) -> None:
        super().__init__(endpoint, "/v1/traces", **kw)
        self.service_name = service_name

    def encode(self, batch: list[Span]) -> dict:
        spans = []
        for s in batch:
            end = s.end_time if s.end_time is not None else s.start_time
            spans.append({
                "traceId": s.trace_id,
                "spanId": s.span_id,
                **({"parentSpanId": s.parent_id} if s.parent_id else {}),
                "name": s.name,
                "kind": 2,  # SPAN_KIND_SERVER
                "startTimeUnixNano": str(int(s.start_time * 1e9)),
                "endTimeUnixNano": str(int(end * 1e9)),
                "attributes": [
                    {"key": k, "value": {"stringValue": str(v)}}
                    for k, v in s.attributes.items()],
                "status": {"code": 1 if s.status == "OK" else 2},
            })
        return {"resourceSpans": [{
            "resource": {"attributes": [{
                "key": "service.name",
                "value": {"stringValue": self.service_name}}]},
            "scopeSpans": [{"scope": {"name": "gofr_tpu"},
                            "spans": spans}],
        }]}


class ZipkinExporter(_BatchingHTTPExporter):
    def __init__(self, endpoint: str, service_name: str = "gofr-app",
                 **kw: Any) -> None:
        super().__init__(endpoint, "/api/v2/spans", **kw)
        self.service_name = service_name

    def encode(self, batch: list[Span]) -> list:
        out = []
        for s in batch:
            end = s.end_time if s.end_time is not None else s.start_time
            out.append({
                "traceId": s.trace_id,
                "id": s.span_id,
                **({"parentId": s.parent_id} if s.parent_id else {}),
                "name": s.name,
                "kind": "SERVER",
                "timestamp": int(s.start_time * 1e6),
                "duration": max(1, int((end - s.start_time) * 1e6)),
                "localEndpoint": {"serviceName": self.service_name},
                "tags": {k: str(v) for k, v in s.attributes.items()},
            })
        return out

"""Lightweight distributed tracing with W3C ``traceparent`` propagation
(the port's copy of ``gofr_tpu/tracing/tracer.py``: the same span shape,
header parser and formatter, sampling rule and exporters).

Spans carry 128-bit trace ids and 64-bit span ids, propagate over the
``traceparent`` header, sample by ``ratio`` (an inbound header's sampled
flag wins) and export through a pluggable exporter (``export(span)``):
:class:`InMemoryExporter` keeps the newest spans in a bounded ring,
:class:`ConsoleExporter` logs each at DEBUG. The active span rides a
context variable, so a request's HTTP span is the parent of what the
engine assembles for it at retire (:meth:`Tracer.emit_span`), and its
ids ride the logger's trace context
(``logging.logger.set_trace_context``), so every log line inside the
span carries ``trace_id`` / ``span_id``.

Every span's attributes start from the process-wide fleet context
(``host_id``, ``rank``, ``generation``, set at a control-plane join:
``logging.logger.set_fleet_context``) under its own, so a cross-host
trace names the host each span ran on.
"""

from __future__ import annotations

import os
import random
import threading
import time
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Any, Protocol

from ..logging.logger import (current_fleet_context, reset_trace_context,
                             set_trace_context)

_current_span: ContextVar["Span | None"] = ContextVar("gofr_current_span",
                                                      default=None)


def _rand_hex(nbytes: int) -> str:
    # os.urandom: immune to application random.seed() calls, so span
    # ids never collide across seeded workers
    return os.urandom(nbytes).hex()


# head sampling draws from a private generator for the same reason
_sample_rng = random.Random(os.urandom(8))


def current_span() -> "Span | None":
    """The span active on this thread's context, if any."""
    return _current_span.get()


def extract_traceparent(header: str | None) -> tuple[str, str] | None:
    """Parse ``00-<trace-id>-<parent-id>-<flags>`` -> (trace_id,
    parent_id); None for anything else (a garbage header starts a fresh
    trace)."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None
    try:
        int(parts[1], 16), int(parts[2], 16)
    except ValueError:
        return None
    if parts[1] == "0" * 32 or parts[2] == "0" * 16:
        return None
    return parts[1], parts[2]


def _traceparent_sampled(header: str) -> bool:
    """Read the W3C flags byte: bit 0 = sampled."""
    try:
        return bool(int(header.strip().split("-")[3], 16) & 0x01)
    except (IndexError, ValueError):
        return True


def format_traceparent(trace_id: str, span_id: str,
                       sampled: bool = True) -> str:
    return f"00-{trace_id}-{span_id}-{'01' if sampled else '00'}"


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: str | None
    start_time: float
    tracer: "Tracer"
    sampled: bool = True
    end_time: float | None = None
    attributes: dict[str, Any] = field(default_factory=dict)
    status: str = "OK"
    _ctx_token: Any = None
    _log_token: Any = None

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def set_status(self, status: str) -> None:
        self.status = status

    def end(self) -> None:
        if self.end_time is not None:
            return
        self.end_time = time.time()
        # best effort: a span ended on another thread than the one that
        # started it is still exported
        if self._ctx_token is not None:
            try:
                _current_span.reset(self._ctx_token)
            except ValueError:
                pass
            self._ctx_token = None
        if self._log_token is not None:
            try:
                reset_trace_context(self._log_token)
            except ValueError:
                pass
            self._log_token = None
        if self.sampled:
            self.tracer._export(self)

    @property
    def duration_ms(self) -> float:
        end = self.end_time if self.end_time is not None else time.time()
        return (end - self.start_time) * 1000.0

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None:
            self.status = f"ERROR: {exc}"
        self.end()


class SpanExporter(Protocol):
    def export(self, span: Span) -> None: ...


class InMemoryExporter:
    """Collects finished spans: the newest ``max_spans`` in a ring, the
    evictions counted in ``dropped``."""

    def __init__(self, max_spans: int = 8192) -> None:
        self.max_spans = max(1, int(max_spans))
        self.spans: list[Span] = []
        self.dropped = 0
        self._lock = threading.Lock()

    def export(self, span: Span) -> None:
        with self._lock:
            if len(self.spans) >= self.max_spans:
                del self.spans[0]
                self.dropped += 1
            self.spans.append(span)


class ConsoleExporter:
    """Logs each finished span at DEBUG on ``logger``
    (``TRACE_EXPORTER=console``)."""

    def __init__(self, logger) -> None:
        self._logger = logger

    def export(self, span: Span) -> None:
        self._logger.debug(
            f"span {span.name} {span.duration_ms:.2f}ms",
            trace=span.trace_id, span=span.span_id, status=span.status,
        )


def _with_resource(attributes: dict[str, Any] | None) -> dict[str, Any]:
    """A span's attributes: the fleet context under the explicit ones."""
    fleet = current_fleet_context()
    fleet.update(attributes or {})
    return fleet


class Tracer:
    """Creates spans, honours the sampling ratio, propagates context."""

    def __init__(self, service_name: str = "gofr-app",
                 exporter: SpanExporter | None = None,
                 ratio: float = 1.0) -> None:
        self.service_name = service_name
        self.exporter = exporter
        self.ratio = max(0.0, min(1.0, ratio))

    def _export(self, span: Span) -> None:
        if self.exporter is not None:
            self.exporter.export(span)

    def current_span(self) -> Span | None:
        return _current_span.get()

    def start_span(self, name: str, *, traceparent: str | None = None,
                   attributes: dict[str, Any] | None = None) -> Span:
        """Start a span as a child of the context span or of a remote
        parent (``traceparent``)."""
        parent = _current_span.get()
        remote = extract_traceparent(traceparent) if parent is None else None
        if parent is not None:
            trace_id, parent_id, sampled = (parent.trace_id, parent.span_id,
                                            parent.sampled)
        elif remote is not None:
            # the upstream sampling decision holds (W3C flags bit 0)
            trace_id, parent_id = remote
            sampled = _traceparent_sampled(traceparent)
        else:
            trace_id, parent_id = _rand_hex(16), None
            sampled = self.ratio >= 1.0 or _sample_rng.random() < self.ratio
        span = Span(name=name, trace_id=trace_id, span_id=_rand_hex(8),
                    parent_id=parent_id, start_time=time.time(), tracer=self,
                    sampled=sampled, attributes=_with_resource(attributes))
        span._ctx_token = _current_span.set(span)
        span._log_token = set_trace_context(span.trace_id, span.span_id)
        return span

    def emit_span(self, name: str, *, trace_id: str,
                  parent_id: str | None = None, start_time: float,
                  end_time: float, attributes: dict[str, Any] | None = None,
                  status: str = "OK") -> Span:
        """Build and export a finished span from explicit timestamps: the
        engine's assembly at retire, from times it already holds. Never
        touches the context and never samples (the caller calls it for
        sampled traces only)."""
        span = Span(name=name, trace_id=trace_id, span_id=_rand_hex(8),
                    parent_id=parent_id, start_time=start_time, tracer=self,
                    sampled=True, attributes=_with_resource(attributes),
                    status=status)
        span.end_time = end_time
        self._export(span)
        return span

    def inject_headers(self, headers: dict[str, str]) -> dict[str, str]:
        span = _current_span.get()
        if span is not None:
            headers["traceparent"] = format_traceparent(
                span.trace_id, span.span_id, span.sampled)
        return headers


__all__ = ["ConsoleExporter", "InMemoryExporter", "Span", "SpanExporter",
           "Tracer", "current_span", "extract_traceparent",
           "format_traceparent"]

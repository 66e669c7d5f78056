"""Tracing for the port (counterpart of ``gofr_tpu/tracing/``): the tracer
and its in-process exporters (:mod:`.tracer`) and the network exporters
(:mod:`.export`, OTLP/HTTP JSON and Zipkin v2, which
``TRACE_EXPORTER=otlp|jaeger|zipkin`` selects)."""

from .tracer import (
    ConsoleExporter,
    InMemoryExporter,
    Span,
    SpanExporter,
    Tracer,
    _traceparent_sampled,
    current_span,
    extract_traceparent,
    format_traceparent,
)

__all__ = ["ConsoleExporter", "InMemoryExporter", "Span", "SpanExporter",
           "Tracer", "current_span", "extract_traceparent",
           "format_traceparent"]

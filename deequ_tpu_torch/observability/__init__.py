"""Observability: end-to-end tracing, flight recorder, trace exporters.

- `trace` — thread-safe span tree (trace_id/span_id/parent_id, monotonic
  timestamps, typed events) with explicit cross-thread propagation;
  default-on, ``DEEQU_TPU_TRACE`` samples/disables.
- `recorder` — bounded process-global ring of finished spans
  (``DEEQU_TPU_TRACE_RING``); typed failures dump their correlated trace
  snippet as JSONL post-mortem artifacts (``DEEQU_TPU_FLIGHT_DIR``).
- `export` — Chrome trace-event / Perfetto JSON + JSONL journal, served
  from the ``/trace`` endpoint on `service.MetricsExporter`.

Copied from the reference (``deequ_tpu/observability/``); the streaming
service's scheduler, sessions and coalescer open its spans and record
their typed failures.
"""

from . import export, trace
from .recorder import FlightRecorder, record_failure, recorder
from .trace import (
    NULL,
    SPAN_KINDS,
    TRACE_ENV,
    TRACE_HEADER,
    TRACE_RING_ENV,
    Span,
    TraceContext,
    add_event,
    attach,
    capture,
    current_span,
    enabled,
    extract,
    inject,
    sampled_trace,
    span,
    start_span,
)

__all__ = [
    "trace", "export",
    "Span", "NULL", "span", "start_span", "attach", "capture",
    "current_span", "add_event", "enabled",
    "TraceContext", "inject", "extract", "sampled_trace",
    "FlightRecorder", "recorder", "record_failure",
    "TRACE_ENV", "TRACE_RING_ENV", "TRACE_HEADER", "SPAN_KINDS",
]

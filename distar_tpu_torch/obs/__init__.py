"""Telemetry: the metrics registry, its exporters, and trace spans.

Counterpart of the instrumentation half of ``distar_tpu.obs``: one
process-wide ``MetricsRegistry`` (``get_registry()``) that the serving
plane publishes into under the JAX package's series names, Prometheus text
and JSON responses, and explicit-context trace spans with a tail-sampled
``TraceBuffer``. Fleet health, the time-series store, the shipper, the
flight recorder, the profiler and the dynamics tree come with ROADMAP
Queue 1 item 9.
"""
from .exporters import (
    PROMETHEUS_CONTENT_TYPE,
    JsonlExporter,
    handle_health_get,
    render_prometheus,
    write_json_response,
    write_scrape_response,
)
from .registry import Counter, Gauge, Histogram, MetricsRegistry, get_registry, set_registry
from .trace import (
    Span,
    annotate,
    annotate_active,
    current_trace,
    finish_trace,
    format_traceparent,
    hop_names,
    is_trace,
    is_wire_ctx,
    join_trace,
    mark_hop,
    mint_span_id,
    parse_traceparent,
    set_active_trace,
    set_tracing,
    start_trace,
    trace_record,
    tracing_enabled,
    unwrap_payload,
    wire_ctx,
    wrap_payload,
)
from .tracestore import (
    ExemplarStore,
    TraceBuffer,
    get_exemplar_store,
    get_trace_buffer,
    note_exemplar,
    set_exemplar_store,
    set_trace_buffer,
)

__all__ = [
    "Counter",
    "ExemplarStore",
    "Gauge",
    "Histogram",
    "JsonlExporter",
    "MetricsRegistry",
    "PROMETHEUS_CONTENT_TYPE",
    "Span",
    "TraceBuffer",
    "annotate",
    "annotate_active",
    "current_trace",
    "finish_trace",
    "format_traceparent",
    "get_exemplar_store",
    "get_registry",
    "get_trace_buffer",
    "handle_health_get",
    "hop_names",
    "is_trace",
    "is_wire_ctx",
    "join_trace",
    "mark_hop",
    "mint_span_id",
    "note_exemplar",
    "parse_traceparent",
    "render_prometheus",
    "set_active_trace",
    "set_exemplar_store",
    "set_registry",
    "set_trace_buffer",
    "set_tracing",
    "start_trace",
    "trace_record",
    "tracing_enabled",
    "unwrap_payload",
    "wire_ctx",
    "wrap_payload",
    "write_json_response",
    "write_scrape_response",
]

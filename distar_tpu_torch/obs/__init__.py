"""Telemetry and fleet health.

Counterpart of ``distar_tpu.obs``. Instrumentation: one process-wide
``MetricsRegistry`` (``get_registry()``) that every layer publishes into
under the JAX package's series names, Prometheus text and JSON responses,
and explicit-context trace spans with a tail-sampled ``TraceBuffer``.

Fleet health: a bounded ring-buffer ``TimeSeriesStore`` fed by a
``RegistrySampler``; a ``TelemetryShipper`` pushing snapshots, span records
and exemplars from every fleet process to the coordinator's
``TelemetryIngest`` and ``TraceIngest``; a declarative ``HealthRule``
engine with a debounced ok -> warning -> firing state machine
(``HealthEvaluator``, ``default_rulebook``); a ``FlightRecorder`` crash
bundle; and the waterfall analyzer. Surfaced through ``GET /healthz``,
``/alerts``, ``/timeseries``, ``/traces`` and ``/trace/<id>`` on the
coordinator, the serve HTTP frontend and the replay admin.

Learner diagnostics: the ``torch.profiler`` session and its trace analyser
(``profiler.py``, ``traceview.py``), the perf monitor's MFU and memory
gauges (``perf.py``), and the training-dynamics tree, monitor and black-box
bundles (``dynamics.py``).
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
    TraceIngest,
    get_exemplar_store,
    get_trace_buffer,
    note_exemplar,
    set_exemplar_store,
    set_trace_buffer,
)
from .waterfall import build_waterfall, render_listing, render_waterfall
from .profiler import ProfilerSession, record_step_phases
from .perf import (
    PerfMonitor,
    count_flops,
    estimate_collective_bytes,
    memory_report,
    peak_flops,
)
from .traceview import analyze_trace, classify, render_markdown
from .timeseries import RegistrySampler, TimeSeriesStore
from .shipper import SERIALIZED_CONTENT_TYPE, TelemetryIngest, TelemetryShipper
from .flightrecorder import FlightRecorder, get_flight_recorder, set_flight_recorder
from .dynamics import (
    ANOMALY_CLASSES,
    BUNDLE_SCHEMA,
    DYNAMICS_DEFAULTS,
    DynamicsMonitor,
    DynamicsSpec,
    DynamicsTree,
    bundle_summary,
    config_digest,
    dynamics_tree,
    first_nonfinite,
    list_bundles,
    load_bundle,
    split_tree,
    tree_spec,
)
from .health import (
    FleetHealth,
    HealthEvaluator,
    HealthRule,
    default_rulebook,
    get_fleet_health,
    init_fleet_health,
    set_fleet_health,
)

__all__ = [
    "analyze_trace",
    "annotate",
    "annotate_active",
    "ANOMALY_CLASSES",
    "build_waterfall",
    "BUNDLE_SCHEMA",
    "bundle_summary",
    "classify",
    "config_digest",
    "count_flops",
    "Counter",
    "current_trace",
    "default_rulebook",
    "DYNAMICS_DEFAULTS",
    "dynamics_tree",
    "DynamicsMonitor",
    "DynamicsSpec",
    "DynamicsTree",
    "estimate_collective_bytes",
    "ExemplarStore",
    "finish_trace",
    "first_nonfinite",
    "FleetHealth",
    "FlightRecorder",
    "format_traceparent",
    "Gauge",
    "get_exemplar_store",
    "get_fleet_health",
    "get_flight_recorder",
    "get_registry",
    "get_trace_buffer",
    "handle_health_get",
    "HealthEvaluator",
    "HealthRule",
    "Histogram",
    "hop_names",
    "init_fleet_health",
    "is_trace",
    "is_wire_ctx",
    "join_trace",
    "JsonlExporter",
    "list_bundles",
    "load_bundle",
    "mark_hop",
    "memory_report",
    "MetricsRegistry",
    "mint_span_id",
    "note_exemplar",
    "parse_traceparent",
    "peak_flops",
    "PerfMonitor",
    "ProfilerSession",
    "PROMETHEUS_CONTENT_TYPE",
    "record_step_phases",
    "RegistrySampler",
    "render_listing",
    "render_markdown",
    "render_prometheus",
    "render_waterfall",
    "SERIALIZED_CONTENT_TYPE",
    "set_active_trace",
    "set_exemplar_store",
    "set_fleet_health",
    "set_flight_recorder",
    "set_registry",
    "set_trace_buffer",
    "set_tracing",
    "Span",
    "split_tree",
    "start_trace",
    "TelemetryIngest",
    "TelemetryShipper",
    "TimeSeriesStore",
    "trace_record",
    "TraceBuffer",
    "TraceIngest",
    "tracing_enabled",
    "tree_spec",
    "unwrap_payload",
    "wire_ctx",
    "wrap_payload",
    "write_json_response",
    "write_scrape_response",
]

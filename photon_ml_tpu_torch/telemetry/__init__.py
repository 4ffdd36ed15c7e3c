"""Unified telemetry: span tracing, metrics registry, exportable ledgers.

The training and serving stacks grew their timing/counting signals
piecemeal (``utils/timer.py``, ``opt/tracking.py``, ``serving/metrics.py``,
the ``Event`` pub/sub). This package is the single place they all land:

* :func:`span` — hierarchical, contextvar-scoped timing spans. Near-free
  when disabled (the default); see :mod:`photon_ml_tpu_torch.telemetry.span`.
* :func:`get_registry` — process-global counters/gauges/histograms,
  including the :func:`note_jit_trace` compile/retrace counter and
  :func:`record_memory_watermarks`.
* sinks — JSONL run ledger, Chrome trace-event (Perfetto) export, terminal
  summary table, and the :class:`TelemetryEventListener` bridge.
* :func:`start_run` — one handle tying the above together for a CLI/bench
  run (``--telemetry-out`` / ``--trace-out``).

See docs/OBSERVABILITY.md for the span model, metric names, and schemas.
"""
from photon_ml_tpu_torch.telemetry.span import (
    NOOP_SPAN,
    SpanRecord,
    Tracer,
    disable_tracing,
    enable_tracing,
    get_tracer,
    span,
)
from photon_ml_tpu_torch.telemetry.metrics import (
    MetricsRegistry,
    ScopedMetrics,
    get_registry,
    jit_trace_counts,
    note_jit_trace,
    record_memory_watermarks,
)
from photon_ml_tpu_torch.telemetry.sinks import (
    RunLedger,
    TelemetryEventListener,
    chrome_trace_events,
    cluster_lane_events,
    format_summary_table,
    span_tree_summary,
    write_chrome_trace,
)
from photon_ml_tpu_torch.telemetry.progress import (
    ConvergenceTracker,
    DivergenceError,
    convergence_report,
    extract_progress_records,
    format_progress_report,
    iterations_to_target_metric,
)
from photon_ml_tpu_torch.telemetry.session import TelemetryRun, start_run
from photon_ml_tpu_torch.telemetry.validate import (
    TruncatedLedgerWarning,
    validate_chrome_trace,
    validate_ledger,
)
from photon_ml_tpu_torch.telemetry.analyze import (
    RunReport,
    analyze_ledger,
    analyze_records,
    classify_span,
    cluster_report,
    format_cluster_report,
    format_report,
)

__all__ = [
    "NOOP_SPAN",
    "SpanRecord",
    "Tracer",
    "disable_tracing",
    "enable_tracing",
    "get_tracer",
    "span",
    "MetricsRegistry",
    "ScopedMetrics",
    "get_registry",
    "jit_trace_counts",
    "note_jit_trace",
    "record_memory_watermarks",
    "RunLedger",
    "TelemetryEventListener",
    "chrome_trace_events",
    "cluster_lane_events",
    "format_summary_table",
    "span_tree_summary",
    "write_chrome_trace",
    "ConvergenceTracker",
    "DivergenceError",
    "convergence_report",
    "extract_progress_records",
    "format_progress_report",
    "iterations_to_target_metric",
    "TelemetryRun",
    "start_run",
    "TruncatedLedgerWarning",
    "validate_chrome_trace",
    "validate_ledger",
    "RunReport",
    "analyze_ledger",
    "analyze_records",
    "classify_span",
    "cluster_report",
    "format_cluster_report",
    "format_report",
]

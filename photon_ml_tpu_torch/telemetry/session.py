"""Run-scoped telemetry session: tracer + registry + sinks, one handle.

A CLI (or bench lane) calls :func:`start_run` once, optionally
:meth:`TelemetryRun.attach`\\ es the driver's emitter so existing events
land in the ledger, and calls :meth:`TelemetryRun.finish` in its
``finally`` block. ``finish`` drains the tracer into the ledger and Chrome
trace files, records memory watermarks, logs the terminal summary table,
and returns the summary dict (which bench embeds in its artifacts).
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

import photon_ml_tpu_torch.telemetry.metrics as _metrics
import photon_ml_tpu_torch.telemetry.sinks as _sinks

# NB: imported per-name — the package __init__ re-exports a *function*
# named ``span`` that shadows the submodule on the package object.
from photon_ml_tpu_torch.telemetry.span import Tracer, enable_tracing, get_tracer

_log = logging.getLogger("photon_ml_tpu_torch.telemetry")

__all__ = ["TelemetryRun", "start_run"]


class TelemetryRun:
    """Owns the sinks for one run and (optionally) the global tracer."""

    def __init__(
        self,
        label: str,
        ledger: Optional[_sinks.RunLedger] = None,
        trace_path: Optional[str] = None,
        tracer: Optional[Tracer] = None,
        registry: Optional[_metrics.MetricsRegistry] = None,
    ):
        self.label = label
        self.ledger = ledger
        self.trace_path = trace_path
        self.tracer = tracer if tracer is not None else get_tracer()
        self.registry = (
            registry if registry is not None else _metrics.get_registry()
        )
        self._emitters: List[Any] = []
        self._finished = False
        self._spans_flushed = 0
        self._extra_trace_events: List[Dict[str, Any]] = []
        if self.ledger is not None:
            self.ledger.write("meta", phase="start", label=label)

    def add_trace_events(self, events) -> None:
        """Queue pre-built Chrome trace events (e.g. the per-host cluster
        lanes from :func:`~photon_ml_tpu_torch.telemetry.sinks.cluster_lane_events`)
        for the trace file ``finish`` writes. No-op without a trace path."""
        self._extra_trace_events.extend(events)

    def attach(self, emitter) -> _sinks.TelemetryEventListener:
        """Register the event bridge on ``emitter`` and track it so
        ``finish`` can report its swallowed listener-error count."""
        listener = _sinks.TelemetryEventListener(
            ledger=self.ledger, registry=self.registry
        )
        emitter.register_listener(listener)
        self._emitters.append(emitter)
        return listener

    def listener_errors(self) -> int:
        return sum(
            int(getattr(emitter, "listener_errors", 0))
            for emitter in self._emitters
        )

    def checkpoint(self, label: str = "") -> None:
        """Span-tree checkpoint: drain spans finished so far into the
        ledger and fsync it, so a later crash still leaves an analyzable
        prefix. Spans are written once — a checkpoint remembers how many it
        has flushed and ``finish`` continues from there."""
        if self.ledger is None or self._finished:
            return
        spans = self.tracer.spans()
        for rec in spans[self._spans_flushed:]:
            self.ledger.write_span(rec, self.tracer.origin_unix)
        self._spans_flushed = len(spans)
        self.ledger.write(
            "meta", phase="checkpoint", label=label or self.label,
            num_spans=self._spans_flushed,
        )
        self.ledger.flush()

    def finish(self, extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Drain spans into the sinks; returns the summary dict. Safe to
        call once per run (subsequent calls return the cached summary)."""
        if self._finished:
            return self._summary
        self._finished = True
        _metrics.record_memory_watermarks(self.registry)
        spans = self.tracer.spans()
        metrics_snapshot = self.registry.snapshot()
        listener_errors = self.listener_errors()
        summary: Dict[str, Any] = {
            "label": self.label,
            "num_spans": len(spans),
            "failed_spans": sum(1 for s in spans if s.failed),
            "listener_errors": listener_errors,
            "span_tree": _sinks.span_tree_summary(spans, max_depth=2),
            "jit_trace_counts": _metrics.jit_trace_counts(),
            "metrics": metrics_snapshot,
        }
        if extra:
            summary.update(extra)
        if self.trace_path:
            n = _sinks.write_chrome_trace(
                self.trace_path,
                spans,
                metadata={"label": self.label, "num_spans": len(spans)},
                extra_events=self._extra_trace_events or None,
                pid_key="host",
            )
            _log.info("wrote chrome trace (%d events) to %s", n, self.trace_path)
        if self.ledger is not None:
            for rec in spans[self._spans_flushed:]:
                self.ledger.write_span(rec, self.tracer.origin_unix)
            self._spans_flushed = len(spans)
            self.ledger.write("metrics", snapshot=metrics_snapshot)
            self.ledger.write(
                "meta",
                phase="finish",
                label=self.label,
                num_spans=len(spans),
                listener_errors=listener_errors,
            )
            self.ledger.close()
            _log.info(
                "wrote run ledger (%d records) to %s",
                self.ledger.num_records,
                self.ledger.path,
            )
        _log.info(
            "%s", _sinks.format_summary_table(spans, metrics_snapshot, self.label)
        )
        self._summary = summary
        return summary


def start_run(
    label: str,
    ledger_path: Optional[str] = None,
    trace_path: Optional[str] = None,
    enable_tracer: bool = True,
    device_sync: bool = True,
) -> TelemetryRun:
    """Open sinks and (by default) enable + clear the global tracer."""
    ledger = _sinks.RunLedger(ledger_path) if ledger_path else None
    tracer = get_tracer()
    if enable_tracer:
        enable_tracing(device_sync=device_sync, clear=True)
    return TelemetryRun(
        label=label, ledger=ledger, trace_path=trace_path, tracer=tracer
    )

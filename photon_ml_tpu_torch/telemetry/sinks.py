"""Telemetry sinks: JSONL run ledger, Chrome trace export, summary table.

Three complementary views of one run:

* :class:`RunLedger` — an append-only JSONL file. Every line is one typed
  record (``{"type": ..., "ts": <unix seconds>, ...}``): ``meta`` for run
  boundaries, ``event`` for bridged :class:`~photon_ml_tpu_torch.event.Event`\\ s,
  ``span`` for finished spans, ``metrics`` for registry snapshots.
* :func:`write_chrome_trace` — the span list as Chrome trace-event JSON
  (``ph: "X"`` complete events, microsecond timestamps), loadable in
  Perfetto / ``chrome://tracing``.
* :func:`format_summary_table` — an end-of-run terminal table aggregating
  spans by path with the headline counters.

:class:`TelemetryEventListener` bridges the existing pub/sub events into
the ledger (and folds the stats-bearing ones into the metrics registry),
so a run with ``--telemetry-out`` captures every ``Event`` without any of
the emit sites knowing telemetry exists.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional

from photon_ml_tpu_torch.event import (
    AnomalyEvent,
    Event,
    EventListener,
    ModelSwapEvent,
    ScoringFinishEvent,
    SolverStatsEvent,
    TransferStatsEvent,
)
from photon_ml_tpu_torch.telemetry.span import SpanRecord

__all__ = [
    "RunLedger",
    "TelemetryEventListener",
    "chrome_trace_events",
    "write_chrome_trace",
    "span_tree_summary",
    "format_summary_table",
]


def _jsonable(value: Any) -> Any:
    """Best-effort conversion to something json.dumps accepts."""
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple, set)):
        return [_jsonable(v) for v in value]
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return _jsonable(dataclasses.asdict(value))
    item = getattr(value, "item", None)  # numpy scalars
    if callable(item):
        try:
            return item()
        except Exception:
            pass
    return repr(value)


class RunLedger:
    """Streaming JSONL writer. Thread-safe; every record is flushed so a
    crashed run still leaves a readable ledger prefix."""

    def __init__(self, path: str):
        self.path = str(path)
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        self._lock = threading.Lock()
        self._f = open(self.path, "w", encoding="utf-8")
        self.num_records = 0

    def write(self, record_type: str, **fields: Any) -> None:
        record = {"type": record_type, "ts": time.time()}
        record.update({k: _jsonable(v) for k, v in fields.items()})
        line = json.dumps(record, sort_keys=True)
        with self._lock:
            if self._f.closed:
                return
            self._f.write(line + "\n")
            self._f.flush()
            self.num_records += 1

    def write_span(self, rec: SpanRecord, origin_unix: float) -> None:
        self.write(
            "span",
            name=rec.name,
            path=rec.path,
            span_id=rec.span_id,
            parent_id=rec.parent_id,
            start_unix=origin_unix + rec.start_s,
            duration_s=rec.duration_s,
            thread=rec.thread_name,
            failed=rec.failed,
            error=rec.error,
            attrs=rec.attrs,
        )

    def flush(self) -> None:
        """Push buffered records to stable storage (flush + best-effort
        fsync). ``write`` already flushes to the OS after every record; this
        additionally asks the kernel to persist, so span-tree checkpoints
        survive a machine-level crash, not just a process kill."""
        with self._lock:
            if self._f.closed:
                return
            self._f.flush()
            try:
                os.fsync(self._f.fileno())
            except OSError:
                pass

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()


class TelemetryEventListener(EventListener):
    """Bridge: every emitted ``Event`` becomes a ledger ``event`` record,
    and the stats-bearing events are folded into the metrics registry."""

    def __init__(self, ledger: Optional[RunLedger] = None, registry=None):
        self.ledger = ledger
        if registry is None:
            from photon_ml_tpu_torch.telemetry.metrics import get_registry

            registry = get_registry()
        self.registry = registry
        self.num_events = 0

    def on_event(self, event: Event) -> None:
        self.num_events += 1
        if self.ledger is not None:
            self.ledger.write(
                "event",
                event=type(event).__name__,
                fields=dataclasses.asdict(event),
            )
        reg = self.registry
        reg.count(f"events.{type(event).__name__}")
        if isinstance(event, SolverStatsEvent):
            reg.record_solver_stats(event, coordinate=event.coordinate_id)
        elif isinstance(event, TransferStatsEvent):
            reg.count("transfer.row_bytes_h2d", event.row_bytes_h2d)
            reg.count("transfer.row_bytes_d2h", event.row_bytes_d2h)
            reg.count("transfer.row_transfers_h2d", event.row_transfers_h2d)
            reg.count("transfer.row_transfers_d2h", event.row_transfers_d2h)
            reg.count("transfer.host_score_sums", event.host_score_sums)
            reg.count("transfer.device_plane_updates", event.device_plane_updates)
        elif isinstance(event, ScoringFinishEvent):
            reg.record_serving_snapshot(event.metrics or {})
        elif isinstance(event, ModelSwapEvent):
            reg.observe("serving.swap_blackout_s", event.blackout_s)
            if event.rolled_back:
                reg.count("serving.swap_rollbacks")
            else:
                reg.count("serving.swaps")
        elif isinstance(event, AnomalyEvent):
            reg.count("progress.anomaly_events")
            reg.count(f"progress.anomaly.{event.kind}")

    def close(self) -> None:
        if self.ledger is not None:
            self.ledger.write("meta", phase="listener_close", events=self.num_events)


# ---------------------------------------------------------------- chrome

def chrome_trace_events(
    spans: Iterable[SpanRecord], pid: int = 0, pid_key: Optional[str] = None
) -> List[Dict[str, Any]]:
    """Spans as Chrome trace-event dicts (``ph: "X"`` complete events).
    Timestamps/durations are microseconds relative to the tracer origin.
    ``pid_key`` names a span attribute whose integer value becomes the
    event's pid — per-host lanes for cluster-plane spans (a worker's
    ``cluster/fragment`` spans carry ``host=N``); spans without the
    attribute keep the default ``pid``."""
    events: List[Dict[str, Any]] = []
    for rec in spans:
        args = {str(k): _jsonable(v) for k, v in rec.attrs.items()}
        if rec.failed:
            args["error"] = rec.error
        event_pid = pid
        if pid_key is not None and pid_key in rec.attrs:
            try:
                event_pid = 1 + int(rec.attrs[pid_key])
            except (TypeError, ValueError):
                pass
        events.append(
            {
                "name": rec.name,
                "cat": rec.path.split("/", 1)[0],
                "ph": "X",
                "ts": rec.start_s * 1e6,
                "dur": rec.duration_s * 1e6,
                "pid": event_pid,
                "tid": rec.thread_id,
                "args": args,
            }
        )
    return events


def cluster_lane_events(
    cluster_passes: Iterable[Dict[str, Any]], origin_unix: float = 0.0
) -> List[Dict[str, Any]]:
    """Per-host Chrome trace lanes from the coordinator's skew profiles
    (``ClusterCoordinator.drain_pass_profiles()`` /
    ``ConvergenceTracker.cluster_passes``): one ``X`` event per dispatched
    fragment spanning dispatch→arrival, on ``pid = 1 + host`` so each
    worker host gets its own track while the coordinator's spans stay on
    pid 0. ``origin_unix`` is the tracer origin the coordinator's own
    spans are relative to, so the lanes line up with them."""
    events: List[Dict[str, Any]] = []
    for p in cluster_passes:
        base = float(p.get("start_unix", 0.0)) - float(origin_unix)
        for f in p.get("fragments", ()):
            dispatch = float(f.get("dispatch_s", 0.0))
            arrival = float(f.get("arrival_s", dispatch))
            events.append(
                {
                    "name": f"pass {p.get('pass_id')} frag {f.get('frag')}",
                    "cat": "cluster",
                    "ph": "X",
                    "ts": max(0.0, base + dispatch) * 1e6,
                    "dur": max(0.0, arrival - dispatch) * 1e6,
                    "pid": 1 + int(f.get("host", 0)),
                    "tid": 0,
                    "args": {str(k): _jsonable(v) for k, v in f.items()},
                }
            )
    return events


def write_chrome_trace(
    path: str,
    spans: Iterable[SpanRecord],
    metadata: Optional[Dict[str, Any]] = None,
    extra_events: Optional[Iterable[Dict[str, Any]]] = None,
    pid_key: Optional[str] = None,
) -> int:
    """Write a Perfetto-loadable trace file; returns the event count.
    ``extra_events`` (already trace-event dicts, e.g. from
    :func:`cluster_lane_events`) are appended verbatim."""
    events = chrome_trace_events(spans, pid_key=pid_key)
    if extra_events is not None:
        events.extend(extra_events)
    doc: Dict[str, Any] = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
    }
    if metadata:
        doc["otherData"] = {str(k): _jsonable(v) for k, v in metadata.items()}
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    return len(events)


# --------------------------------------------------------------- summary

def span_tree_summary(
    spans: Iterable[SpanRecord], max_depth: Optional[int] = None
) -> Dict[str, Dict[str, Any]]:
    """Aggregate spans by path: count, total/mean/max seconds, failures.
    ``max_depth`` keeps only spans nested at most that deep (depth 1 =
    top-level spans only); parents already include child wall time, so
    dropped children are not re-rolled-up."""
    out: Dict[str, Dict[str, Any]] = {}
    for rec in spans:
        if max_depth is not None and rec.depth > max_depth:
            continue
        path = rec.path
        entry = out.get(path)
        if entry is None:
            entry = out[path] = {
                "count": 0,
                "total_s": 0.0,
                "mean_s": 0.0,
                "max_s": 0.0,
                "failed": 0,
            }
        entry["count"] += 1
        entry["total_s"] += rec.duration_s
        entry["max_s"] = max(entry["max_s"], rec.duration_s)
        entry["failed"] += int(rec.failed)
    for entry in out.values():
        entry["mean_s"] = entry["total_s"] / entry["count"]
    return dict(sorted(out.items()))


def format_summary_table(
    spans: Iterable[SpanRecord],
    metrics_snapshot: Optional[Dict[str, Any]] = None,
    label: str = "run",
) -> str:
    """End-of-run terminal summary: span table + headline counters."""
    summary = span_tree_summary(spans)
    lines = [f"telemetry summary [{label}]"]
    if summary:
        name_w = max(len("span"), *(len(p) for p in summary))
        header = f"  {'span'.ljust(name_w)}  {'count':>7}  {'total_s':>10}  {'mean_s':>10}  {'max_s':>10}  fail"
        lines.append(header)
        for path, entry in summary.items():
            lines.append(
                f"  {path.ljust(name_w)}  {entry['count']:>7d}  "
                f"{entry['total_s']:>10.4f}  {entry['mean_s']:>10.4f}  "
                f"{entry['max_s']:>10.4f}  {entry['failed']:>4d}"
            )
    else:
        lines.append("  (no spans recorded)")
    if metrics_snapshot:
        counters = metrics_snapshot.get("counters", {})
        jit = {k: v for k, v in counters.items() if k.startswith("jit.traces.")}
        if jit:
            lines.append("  jit traces:")
            for name, value in sorted(jit.items()):
                lines.append(f"    {name[len('jit.traces.'):]}: {int(value)}")
        transfer = {
            k: v for k, v in counters.items() if k.startswith("transfer.")
        }
        if transfer:
            lines.append("  transfers:")
            for name, value in sorted(transfer.items()):
                lines.append(f"    {name[len('transfer.'):]}: {int(value)}")
    return "\n".join(lines)

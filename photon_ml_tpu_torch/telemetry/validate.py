"""Schema checks for telemetry artifacts (used by tests and the CI gate).

These are deliberately dependency-free structural validators — no
jsonschema in the image — that raise ``ValueError`` with a precise message
on the first violation and return the parsed payload on success.
"""
from __future__ import annotations

import json
import warnings as _warnings
from typing import Any, Dict, List

__all__ = ["validate_chrome_trace", "validate_ledger", "TruncatedLedgerWarning"]


class TruncatedLedgerWarning(UserWarning):
    """The ledger's final line was cut mid-write (crash-truncated); the
    valid prefix was still validated and returned."""

_REQUIRED_TRACE_KEYS = ("name", "cat", "ph", "ts", "dur", "pid", "tid")

# ledger record type -> required extra fields ("type" and "ts" are
# required on every record)
_LEDGER_SCHEMAS: Dict[str, tuple] = {
    "meta": ("phase",),
    "event": ("event", "fields"),
    "span": ("name", "path", "span_id", "duration_s", "failed"),
    "metrics": ("snapshot",),
    # convergence plane (telemetry/progress.py): one record per coordinate
    # update / validation probe / streamed block / watchdog anomaly
    "progress": ("kind",),
    # request plane (serving/requestplane.py): one record per SAMPLED
    # serving request — per-stage exclusive seconds + end-to-end latency
    "request": ("request_id", "bucket", "stages", "total_s"),
}

# per-stage exclusive durations every request record's "stages" dict must
# carry (they telescope: their sum IS total_s)
_REQUEST_STAGES = ("queue", "featurize", "route", "dispatch", "device", "reply")

# progress record kind -> required extra fields beyond "kind"
_PROGRESS_SCHEMAS: Dict[str, tuple] = {
    "coordinate": ("outer", "coordinate", "objective"),
    "validation": ("outer", "coordinate", "metric"),
    "block": ("outer", "coordinate", "block", "partial_loss",
              "partial_grad_norm", "gap_estimate"),
    # gap scheduler: one record per stochastic epoch's visit decision
    "schedule": ("outer", "coordinate", "epoch", "visited", "explored",
                 "num_blocks"),
    "anomaly": ("anomaly_kind", "objective"),
    # failure plane (resilience/): recovered or degraded events — retry
    # exhaustion, skipped blocks, supervised-thread crashes
    "resilience": ("failure_kind", "site"),
    # cluster plane (parallel/cluster): block rebalance / host-loss /
    # reassignment events of a distributed solve
    "cluster": ("outer", "coordinate", "event"),
    # cluster plane skew profiles: one record per distributed pass with
    # the exact wall-clock decomposition (busy + allreduce wait +
    # coordinator bubble == wall) ...
    "cluster_pass": ("outer", "coordinate", "pass_id", "wall_s", "busy_s",
                     "allreduce_wait_s", "bubble_s", "straggler_index",
                     "hosts"),
    # ... plus one record per (pass, host) with that host's measured
    # busy/wall and blocks visited (and, when present, the assigner's
    # predicted_share vs the measured actual_share)
    "host_pass": ("outer", "coordinate", "pass_id", "host", "busy_s",
                  "wall_s", "blocks"),
    # HBM residency plane (streaming/residency.py): one record per
    # pin/evict decision — which block, on what gap score, byte delta
    "residency": ("outer", "coordinate", "epoch", "action", "block",
                  "gap_score", "byte_delta"),
}


def validate_chrome_trace(path: str) -> Dict[str, Any]:
    """Check ``path`` is valid Chrome trace-event JSON (object form with a
    ``traceEvents`` list of complete events). Returns the parsed doc."""
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: trace must be a JSON object, got {type(doc).__name__}")
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError(f"{path}: missing traceEvents list")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"{path}: traceEvents[{i}] is not an object")
        for key in _REQUIRED_TRACE_KEYS:
            if key not in ev:
                raise ValueError(f"{path}: traceEvents[{i}] missing {key!r}")
        if ev["ph"] != "X":
            raise ValueError(
                f"{path}: traceEvents[{i}] has phase {ev['ph']!r}, expected 'X'"
            )
        for key in ("ts", "dur"):
            if not isinstance(ev[key], (int, float)) or ev[key] < 0:
                raise ValueError(
                    f"{path}: traceEvents[{i}][{key!r}] must be a non-negative "
                    f"number, got {ev[key]!r}"
                )
    return doc


def validate_ledger(
    path: str, allow_truncated_tail: bool = True
) -> List[Dict[str, Any]]:
    """Check every line of ``path`` is a typed JSONL record matching the
    ledger schema. Returns the parsed records.

    A crash-truncated ledger — the process was killed mid-``write``, so the
    FINAL line is a partial record with no trailing newline — is tolerated
    by default: the partial tail raises a :class:`TruncatedLedgerWarning`
    and the valid prefix is still validated and returned. A malformed line
    anywhere else (or any bad line with ``allow_truncated_tail=False``)
    remains a hard ``ValueError``: that is corruption, not a crash
    artifact.
    """
    with open(path, "r", encoding="utf-8", newline="") as f:
        raw = f.read()
    lines = raw.split("\n")
    # A well-formed ledger ends with "\n", leaving a trailing "" element; a
    # non-empty final element means the last write was cut short.
    truncated_tail = bool(lines) and lines[-1] != ""
    records: List[Dict[str, Any]] = []
    for lineno, line in enumerate(lines, start=1):
        line = line.strip()
        if not line:
            continue
        is_tail = lineno == len(lines) and truncated_tail
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            if is_tail and allow_truncated_tail:
                _warnings.warn(
                    f"{path}:{lineno}: final line is a partial record "
                    f"(crash-truncated ledger); validated the "
                    f"{len(records)}-record prefix",
                    TruncatedLedgerWarning,
                    stacklevel=2,
                )
                break
            raise ValueError(f"{path}:{lineno}: invalid JSON ({e})") from e
        if not isinstance(rec, dict):
            raise ValueError(f"{path}:{lineno}: record is not an object")
        rec_type = rec.get("type")
        if rec_type not in _LEDGER_SCHEMAS:
            raise ValueError(
                f"{path}:{lineno}: unknown record type {rec_type!r} "
                f"(expected one of {sorted(_LEDGER_SCHEMAS)})"
            )
        if not isinstance(rec.get("ts"), (int, float)):
            raise ValueError(f"{path}:{lineno}: missing numeric 'ts'")
        for field in _LEDGER_SCHEMAS[rec_type]:
            if field not in rec:
                raise ValueError(
                    f"{path}:{lineno}: {rec_type} record missing {field!r}"
                )
        if rec_type == "progress":
            kind = rec.get("kind")
            if kind not in _PROGRESS_SCHEMAS:
                raise ValueError(
                    f"{path}:{lineno}: unknown progress kind {kind!r} "
                    f"(expected one of {sorted(_PROGRESS_SCHEMAS)})"
                )
            for field in _PROGRESS_SCHEMAS[kind]:
                if field not in rec:
                    raise ValueError(
                        f"{path}:{lineno}: progress/{kind} record missing "
                        f"{field!r}"
                    )
        if rec_type == "request":
            stages = rec.get("stages")
            if not isinstance(stages, dict):
                raise ValueError(
                    f"{path}:{lineno}: request record 'stages' must be an "
                    f"object, got {type(stages).__name__}"
                )
            for stage in _REQUEST_STAGES:
                if not isinstance(stages.get(stage), (int, float)):
                    raise ValueError(
                        f"{path}:{lineno}: request record missing numeric "
                        f"stage {stage!r}"
                    )
            if not isinstance(rec.get("total_s"), (int, float)):
                raise ValueError(
                    f"{path}:{lineno}: request record 'total_s' must be a "
                    f"number"
                )
        records.append(rec)
    if not records:
        raise ValueError(f"{path}: ledger is empty")
    return records

"""Ledger-replay performance analyzer: RunLedger → occupancy report.

PR 5 made every hot path write telemetry; this module reads it back. From
one JSONL :class:`~photon_ml_tpu_torch.telemetry.sinks.RunLedger` it

* reconstructs the span tree (``span_id``/``parent_id`` chains),
* computes per-phase occupancy — wall-clock attributed to FE solves, RE
  chunked rounds, CD driver algebra, serving, incremental updates, I/O —
  from per-span **exclusive self-intervals** (a span's own interval minus
  the union of its direct children's intervals). Concurrent spans — the
  async CD schedule runs FE and RE solves on overlapping wall-clock — are
  shared via a sweep-line: a segment where k spans are simultaneously open
  contributes 1/k of its length to each span's phase, so phase ``seconds``
  always sum to wall-clock actually covered (coverage stays <= ~1), while
  the full per-phase busy time and the concurrency win are reported
  separately as ``busy_s`` and ``overlap_s = busy_s - seconds``,
* accounts the **bubbles**: driver-thread gaps where no span was open are
  attributed explicitly as host driver time, so the report sums to the
  measured wall-clock instead of silently dropping it,
* joins in the SolverStats / TransferStats events, jit retrace counters
  and the metrics-registry snapshot, and
* emits a structured :class:`RunReport` (JSON-ready) plus a human-readable
  table via :func:`format_report`.

The occupancy accounting is the Snap-ML-style per-level breakdown (arxiv
1803.06333) that the offline tuner (:mod:`photon_ml_tpu_torch.tuning`) consumes
to propose configs over the declared knob space. CLI:
``python -m photon_ml_tpu_torch.cli.analyze_run LEDGER.jsonl``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch.telemetry.progress import convergence_report
from photon_ml_tpu_torch.telemetry.validate import _REQUEST_STAGES, validate_ledger

__all__ = [
    "RunReport",
    "analyze_ledger",
    "analyze_records",
    "classify_span",
    "format_report",
    "format_request_report",
    "request_report",
    "PHASES",
]

# Canonical phase buckets, in report order. Span NAMES (not paths — paths
# concatenate parent names) map onto these; see classify_span.
PHASES = (
    "fe_solve",      # fixed-effect GLM solves (fe/*)
    "re_solve",      # random-effect chunked rounds / bucket solves (re/*)
    "cd_driver",     # coordinate-descent driver algebra (cd/*)
    "serving",       # online scoring path (serve/*)
    "incremental",   # nearline update path (incremental/*)
    "transfers",     # explicit host<->device transfer spans
    "io",            # data read / model save / artifact pack phases
    "host_driver",   # everything else: Python glue, setup, graph build
)

_IO_WORDS = (
    "read", "load", "save", "write", "export", "pack",
    "prepare feature maps", "build requests", "feature stats", "check data",
)


def classify_span(name: str) -> str:
    """Span name → phase bucket. Uses the name (the span's own identity),
    not the path, so nesting never reclassifies a child."""
    head = name.split("/", 1)[0]
    if head == "fe":
        return "fe_solve"
    if head == "re":
        return "re_solve"
    if head == "cd":
        return "cd_driver"
    if head == "serve":
        return "serving"
    if head == "incremental":
        return "incremental"
    low = name.lower()
    if "transfer" in low or "h2d" in low or "d2h" in low:
        return "transfers"
    if any(low.startswith(w) or f" {w}" in low for w in _IO_WORDS):
        return "io"
    return "host_driver"


@dataclasses.dataclass
class RunReport:
    """Structured result of replaying one run ledger.

    ``phases`` maps each phase bucket to ``{"seconds", "spans",
    "fraction", "busy_s", "overlap_s"}``. ``seconds`` is exclusive span
    time with concurrent segments SHARED across the open spans (a segment
    where k spans are open contributes 1/k to each), so phase seconds sum
    to covered wall-clock even under the async schedule's overlapped span
    trees. ``busy_s`` is the phase's full (unshared) exclusive time and
    ``overlap_s = busy_s - seconds`` is the wall-clock the phase spent
    running concurrently with other spans — the async schedule's win shows
    up here. ``bubble_s`` is wall-clock inside the run window covered by
    NO span (host driver gaps between instrumented regions) — it is
    attributed, not dropped, so ``attributed_s = Σ phases + bubble_s``
    and ``coverage = attributed_s / wall_clock_s`` should sit near 1.0
    regardless of concurrency; much below 1 means uninstrumented time.
    ``overlap_s`` (report level) totals the per-phase overlap.
    """

    label: str
    source_path: Optional[str]
    wall_clock_s: float
    span_extent_s: float
    phases: Dict[str, Dict[str, float]]
    bubble_s: float
    attributed_s: float
    coverage: float
    num_spans: int
    failed_spans: int
    top_spans: Dict[str, Dict[str, Any]]
    solver: Dict[str, Any]
    transfers: Dict[str, float]
    jit_traces: Dict[str, int]
    events: Dict[str, int]
    metrics: Dict[str, Any]
    warnings: List[str] = dataclasses.field(default_factory=list)
    overlap_s: float = 0.0
    # convergence-plane reconstruction (telemetry.progress.convergence_report)
    # when the ledger carries "progress" records; None for perf-only ledgers
    progress: Optional[Dict[str, Any]] = None
    # request-plane tail attribution (request_report) when the ledger
    # carries sampled "request" lifecycle records; None otherwise
    requests: Optional[Dict[str, Any]] = None
    # cluster-plane skew attribution (cluster_report) when the ledger
    # carries cluster_pass/host_pass progress records; None otherwise
    cluster: Optional[Dict[str, Any]] = None

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RunReport":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    # convenience readers used by the tuner ------------------------------
    def phase_seconds(self, phase: str) -> float:
        return float(self.phases.get(phase, {}).get("seconds", 0.0))

    def phase_fraction(self, phase: str) -> float:
        return float(self.phases.get(phase, {}).get("fraction", 0.0))

    def phase_overlap(self, phase: str) -> float:
        """Wall-clock this phase spent overlapped with other open spans
        (0.0 for sequential runs and for reports from older ledgers)."""
        return float(self.phases.get(phase, {}).get("overlap_s", 0.0))

    def metric(self, name: str) -> Optional[float]:
        """Look a flat metric name up across the snapshot's counters,
        gauges (last value) and histograms (mean), in that order."""
        snap = self.metrics or {}
        counters = snap.get("counters") or {}
        if name in counters:
            return float(counters[name])
        gauges = snap.get("gauges") or {}
        if name in gauges:
            return float(gauges[name]["last"])
        hists = snap.get("histograms") or {}
        if name in hists:
            return float(hists[name].get("mean", 0.0))
        return None


def _merge_intervals(
    intervals: Sequence[Tuple[float, float]]
) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals as a sorted, disjoint list."""
    out: List[Tuple[float, float]] = []
    for start, end in sorted(intervals):
        if end <= start:
            continue
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1] = (out[-1][0], end)
        else:
            out.append((start, end))
    return out


def _merged_coverage(intervals: Sequence[Tuple[float, float]]) -> float:
    """Total length of the union of [start, end) intervals."""
    return sum(end - start for start, end in _merge_intervals(intervals))


def _subtract_intervals(
    own: Tuple[float, float], children: Sequence[Tuple[float, float]]
) -> List[Tuple[float, float]]:
    """``own`` minus the union of ``children`` (clipped to ``own``): a
    span's exclusive SELF time as intervals rather than a scalar, so a
    parent whose concurrent children together outlast it still nets out at
    zero instead of going negative or double-counting."""
    s, e = own
    out: List[Tuple[float, float]] = []
    cursor = s
    for cs, ce in _merge_intervals(children):
        if ce <= cursor:
            continue
        if cs >= e:
            break
        if cs > cursor:
            out.append((cursor, min(cs, e)))
        cursor = max(cursor, ce)
        if cursor >= e:
            break
    if cursor < e:
        out.append((cursor, e))
    return out


def _span_tree_summary(spans: List[dict], max_depth: int = 2) -> Dict[str, dict]:
    """span_tree_summary over ledger span dicts (depth reconstructed from
    the path, which encodes the ancestor chain)."""
    out: Dict[str, dict] = {}
    for rec in spans:
        path = rec.get("path", rec["name"])
        # depth = nesting level in the span tree: count ancestors via
        # parent links is not possible per-path, so approximate from how
        # many recorded spans prefix this one; cheap proxy: parent chain
        if rec.get("_depth", 1) > max_depth:
            continue
        entry = out.setdefault(
            path,
            {"count": 0, "total_s": 0.0, "mean_s": 0.0, "max_s": 0.0, "failed": 0},
        )
        entry["count"] += 1
        entry["total_s"] += float(rec.get("duration_s", 0.0))
        entry["max_s"] = max(entry["max_s"], float(rec.get("duration_s", 0.0)))
        entry["failed"] += int(bool(rec.get("failed")))
    for entry in out.values():
        entry["mean_s"] = entry["total_s"] / entry["count"]
    return dict(sorted(out.items()))


def request_report(
    records: Sequence[Dict[str, Any]], tail_q: float = 99.0
) -> Optional[Dict[str, Any]]:
    """Tail-latency attribution over sampled ``request`` lifecycle records.

    Joins the request-plane's per-request stage durations into per-stage
    p50/p99 distributions, then isolates the tail (requests at or above
    the ``tail_q`` end-to-end percentile) and breaks its latency down by
    stage — because the stage boundaries telescope, the per-stage tail
    breakdown sums to the tail's end-to-end time (``coverage`` ~1.0), so
    "where did the p99 go" has a complete answer. Interference overlap
    (``swap_pause``, ``admission`` seconds inside request windows) is
    aggregated alongside, and the worst bucket carries exemplar request
    ids for flight-recorder-style drill-down. Returns None when the
    records carry no request entries.
    """
    reqs = [
        r
        for r in records
        if r.get("type") == "request" and isinstance(r.get("stages"), dict)
    ]
    if not reqs:
        return None
    totals = np.array([float(r.get("total_s", 0.0)) for r in reqs])
    per_stage = {
        s: np.array([float(r["stages"].get(s, 0.0)) for r in reqs])
        for s in _REQUEST_STAGES
    }

    def _dist(a: np.ndarray) -> Dict[str, float]:
        return {
            "p50_s": round(float(np.percentile(a, 50)), 9),
            "p99_s": round(float(np.percentile(a, 99)), 9),
            "mean_s": round(float(a.mean()), 9),
            "max_s": round(float(a.max()), 9),
        }

    stages = {s: _dist(a) for s, a in per_stage.items()}
    e2e = _dist(totals)

    # ---- the tail: requests at/above the e2e tail_q percentile ----------
    threshold = float(np.percentile(totals, tail_q))
    tail_idx = np.nonzero(totals >= threshold)[0]
    tail_total = float(totals[tail_idx].mean())
    breakdown = {
        s: round(float(per_stage[s][tail_idx].mean()), 9)
        for s in _REQUEST_STAGES
    }
    covered = sum(breakdown.values())
    worst_stage = max(breakdown, key=lambda s: breakdown[s])

    # worst bucket among tail requests, with exemplar ids for drill-down
    by_bucket: Dict[int, List[int]] = {}
    for i in tail_idx:
        by_bucket.setdefault(int(reqs[int(i)].get("bucket", -1)), []).append(
            int(i)
        )
    worst_bucket, worst_members = max(
        by_bucket.items(), key=lambda kv: float(totals[kv[1]].mean())
    )
    exemplar_idx = sorted(worst_members, key=lambda i: -totals[i])[:3]

    # ---- interference join ----------------------------------------------
    interference: Dict[str, Dict[str, float]] = {}
    for i, r in enumerate(reqs):
        for key, v in (r.get("interference") or {}).items():
            kind = key[:-2] if key.endswith("_s") else key
            entry = interference.setdefault(
                kind, {"requests": 0, "total_s": 0.0, "tail_s": 0.0}
            )
            entry["requests"] += 1
            entry["total_s"] += float(v)
            if totals[i] >= threshold:
                entry["tail_s"] += float(v)
    for entry in interference.values():
        entry["total_s"] = round(entry["total_s"], 9)
        entry["tail_s"] = round(entry["tail_s"], 9)

    by_batcher: Dict[str, int] = {}
    for r in reqs:
        name = str(r.get("batcher", "?"))
        by_batcher[name] = by_batcher.get(name, 0) + 1

    return {
        "num_records": len(reqs),
        "stages": stages,
        "e2e": e2e,
        "tail": {
            "quantile": tail_q / 100.0,
            "threshold_s": round(threshold, 9),
            "num_requests": int(tail_idx.size),
            "mean_total_s": round(tail_total, 9),
            "breakdown_s": breakdown,
            "attribution_coverage": (
                round(covered / tail_total, 6) if tail_total > 0 else 1.0
            ),
            "worst_stage": worst_stage,
            "worst_bucket": worst_bucket,
            "exemplars": [reqs[i].get("request_id") for i in exemplar_idx],
        },
        "interference": interference,
        "by_batcher": by_batcher,
    }


def format_request_report(report: Dict[str, Any]) -> str:
    """Human-readable tail-attribution table (``analyze_run --requests``
    and the live ``/requests`` route's text form)."""
    lines = [
        f"request plane: {report['num_records']} sampled lifecycle record(s)"
    ]
    e2e = report.get("e2e") or {}
    if e2e:
        lines.append(
            f"  end-to-end   p50 {e2e['p50_s'] * 1e3:9.3f}ms   "
            f"p99 {e2e['p99_s'] * 1e3:9.3f}ms   "
            f"max {e2e['max_s'] * 1e3:9.3f}ms"
        )
    lines.append(f"  {'stage':<12} {'p50 ms':>10} {'p99 ms':>10} {'tail ms':>10}")
    tail = report.get("tail") or {}
    breakdown = tail.get("breakdown_s") or {}
    for stage, dist in (report.get("stages") or {}).items():
        lines.append(
            f"  {stage:<12} {dist['p50_s'] * 1e3:>10.3f} "
            f"{dist['p99_s'] * 1e3:>10.3f} "
            f"{breakdown.get(stage, 0.0) * 1e3:>10.3f}"
        )
    if tail:
        lines.append(
            f"  tail (>= p{tail['quantile'] * 100:.0f}): "
            f"{tail['num_requests']} request(s) >= "
            f"{tail['threshold_s'] * 1e3:.3f}ms, worst stage "
            f"'{tail['worst_stage']}', attribution coverage "
            f"{tail['attribution_coverage'] * 100:.2f}%"
        )
        lines.append(
            f"  worst bucket {tail['worst_bucket']}: exemplar ids "
            + ", ".join(str(x) for x in tail.get("exemplars") or [])
        )
    interference = report.get("interference") or {}
    for kind, entry in sorted(interference.items()):
        lines.append(
            f"  interference '{kind}': {entry['requests']} request(s), "
            f"{entry['total_s'] * 1e3:.3f}ms overlap "
            f"({entry['tail_s'] * 1e3:.3f}ms on the tail)"
        )
    by_batcher = report.get("by_batcher") or {}
    if by_batcher:
        lines.append(
            "  by batcher: "
            + ", ".join(f"{k}={v}" for k, v in sorted(by_batcher.items()))
        )
    return "\n".join(lines)


def cluster_report(
    records: Sequence[Dict[str, Any]]
) -> Optional[Dict[str, Any]]:
    """Cluster-plane skew attribution over ``cluster_pass``/``host_pass``
    progress records (the coordinator's per-pass profiles).

    Per pass the coordinator's decomposition is exact — busy (start →
    first arrival) + allreduce wait (first → last arrival) + coordinator
    bubble (last arrival → end) == wall — so ``attribution_coverage``
    should sit at ~1.0; much below 1 means malformed records. Per host
    it joins measured busy seconds and blocks against the assigner's
    LPT-predicted gap shares (``share_error`` is the mean |predicted −
    actual|, the assignment-quality signal a skew-aware assigner would
    actuate on), ranks stragglers by how often each host was the last
    arrival, and tracks the straggler-index trend across passes. Joins
    kind="cluster" event records (rebalances, host losses) when present.
    Returns None when the records carry no ``cluster_pass`` entries.
    """
    progress = [r for r in records if r.get("kind")]
    passes = [r for r in progress if r.get("kind") == "cluster_pass"]
    if not passes:
        return None
    host_rows = [r for r in progress if r.get("kind") == "host_pass"]

    pass_rows: List[Dict[str, Any]] = []
    tot_wall = tot_busy = tot_wait = tot_bubble = 0.0
    straggler_counts: Dict[int, int] = {}
    trend: List[float] = []
    for r in passes:
        wall = float(r.get("wall_s", 0.0))
        busy = float(r.get("busy_s", 0.0))
        wait = float(r.get("allreduce_wait_s", 0.0))
        bubble = float(r.get("bubble_s", 0.0))
        cov = (busy + wait + bubble) / wall if wall > 0 else 1.0
        idx = float(r.get("straggler_index", 1.0))
        trend.append(round(idx, 4))
        sh = int(r.get("straggler_host", -1))
        if sh >= 0:
            straggler_counts[sh] = straggler_counts.get(sh, 0) + 1
        pass_rows.append({
            "outer": r.get("outer"),
            "pass_id": r.get("pass_id"),
            "hosts": int(r.get("hosts", 0)),
            "blocks": int(r.get("blocks", 0)),
            "wall_s": round(wall, 6),
            "busy_s": round(busy, 6),
            "allreduce_wait_s": round(wait, 6),
            "bubble_s": round(bubble, 6),
            "straggler_index": round(idx, 4),
            "straggler_host": sh,
            "attribution_coverage": round(cov, 6),
            "stray_partials": int(r.get("stray_partials", 0)),
            "requeued_blocks": int(r.get("requeued_blocks", 0)),
        })
        tot_wall += wall
        tot_busy += busy
        tot_wait += wait
        tot_bubble += bubble

    hosts: Dict[str, Dict[str, Any]] = {}
    for r in host_rows:
        h = hosts.setdefault(
            str(r.get("host")),
            {
                "passes": 0,
                "busy_s": 0.0,
                "wall_s": 0.0,
                "blocks": 0,
                "h2d_bytes": 0,
                "share_error": 0.0,
                "_share_samples": 0,
            },
        )
        h["passes"] += 1
        h["busy_s"] = round(h["busy_s"] + float(r.get("busy_s", 0.0)), 9)
        h["wall_s"] = round(h["wall_s"] + float(r.get("wall_s", 0.0)), 9)
        h["blocks"] += int(r.get("blocks", 0))
        h["h2d_bytes"] += int(r.get("h2d_bytes", 0))
        if "predicted_share" in r and "actual_share" in r:
            h["share_error"] += abs(
                float(r["predicted_share"]) - float(r["actual_share"])
            )
            h["_share_samples"] += 1
    for h in hosts.values():
        n = h.pop("_share_samples")
        h["share_error"] = round(h["share_error"] / n, 6) if n else None
        h["times_straggler"] = 0
    for sh, n in straggler_counts.items():
        if str(sh) in hosts:
            hosts[str(sh)]["times_straggler"] = n
    ranking = sorted(
        hosts,
        key=lambda k: (-hosts[k]["times_straggler"], -hosts[k]["wall_s"]),
    )

    events: Dict[str, int] = {}
    for r in progress:
        if r.get("kind") == "cluster":
            ev = str(r.get("event", "unknown"))
            events[ev] = events.get(ev, 0) + 1

    return {
        "num_passes": len(pass_rows),
        "num_hosts": len(hosts),
        "wall_s": round(tot_wall, 6),
        "busy_s": round(tot_busy, 6),
        "allreduce_wait_s": round(tot_wait, 6),
        "bubble_s": round(tot_bubble, 6),
        "busy_frac": round(tot_busy / tot_wall, 6) if tot_wall else 1.0,
        "comm_wait_frac": round(tot_wait / tot_wall, 6) if tot_wall else 0.0,
        "bubble_frac": round(tot_bubble / tot_wall, 6) if tot_wall else 0.0,
        "attribution_coverage": (
            round((tot_busy + tot_wait + tot_bubble) / tot_wall, 6)
            if tot_wall
            else 1.0
        ),
        "straggler_index_mean": round(sum(trend) / len(trend), 4),
        "imbalance_trend": trend,
        "straggler_ranking": ranking,
        "hosts": hosts,
        "passes": pass_rows,
        "events": events,
        "stray_partials": sum(p["stray_partials"] for p in pass_rows),
        "requeued_blocks": sum(p["requeued_blocks"] for p in pass_rows),
    }


def format_cluster_report(report: Dict[str, Any]) -> str:
    """Human-readable cluster skew tables (``analyze_run --cluster`` and
    the live ``/cluster`` route's text form)."""
    lines = [
        f"cluster plane: {report['num_passes']} distributed pass(es) over "
        f"{report['num_hosts']} host(s)"
    ]
    lines.append(
        f"  wall {report['wall_s']:.4f}s = busy {report['busy_s']:.4f}s "
        f"({report['busy_frac'] * 100:.1f}%) + allreduce wait "
        f"{report['allreduce_wait_s']:.4f}s "
        f"({report['comm_wait_frac'] * 100:.1f}%) + coordinator bubble "
        f"{report['bubble_s']:.4f}s ({report['bubble_frac'] * 100:.1f}%) — "
        f"coverage {report['attribution_coverage'] * 100:.2f}%"
    )
    lines.append(
        f"  {'pass':>5} {'hosts':>5} {'blocks':>6} {'wall s':>9} "
        f"{'busy s':>9} {'wait s':>9} {'skew':>6} {'requeue':>7}"
    )
    for p in report.get("passes") or []:
        lines.append(
            f"  {p['pass_id']:>5} {p['hosts']:>5} {p['blocks']:>6} "
            f"{p['wall_s']:>9.4f} {p['busy_s']:>9.4f} "
            f"{p['allreduce_wait_s']:>9.4f} {p['straggler_index']:>6.2f} "
            f"{p['requeued_blocks']:>7}"
        )
    hosts = report.get("hosts") or {}
    if hosts:
        lines.append(
            f"  {'host':>5} {'busy s':>9} {'blocks':>6} {'h2d MB':>8} "
            f"{'straggler':>9} {'share err':>9}"
        )
        for host in sorted(hosts, key=lambda k: int(k) if k.isdigit() else 0):
            h = hosts[host]
            err = h.get("share_error")
            lines.append(
                f"  {host:>5} {h['busy_s']:>9.4f} {h['blocks']:>6} "
                f"{h['h2d_bytes'] / 1e6:>8.2f} {h['times_straggler']:>9} "
                + (f"{err:>9.4f}" if err is not None else f"{'—':>9}")
            )
    ranking = report.get("straggler_ranking") or []
    if ranking:
        lines.append("  straggler ranking (worst first): " + ", ".join(
            f"host {h}" for h in ranking
        ))
    trend = report.get("imbalance_trend") or []
    if trend:
        lines.append(
            "  imbalance trend (straggler index per pass): "
            + " ".join(f"{x:.2f}" for x in trend)
            + f"   mean {report['straggler_index_mean']:.2f}"
        )
    if report.get("stray_partials"):
        lines.append(
            f"  stray partials dropped: {report['stray_partials']}"
        )
    events = report.get("events") or {}
    if events:
        lines.append("  events: " + ", ".join(
            f"{k}={v}" for k, v in sorted(events.items())
        ))
    return "\n".join(lines)


def analyze_records(
    records: Sequence[Dict[str, Any]],
    source_path: Optional[str] = None,
) -> RunReport:
    """Build a :class:`RunReport` from parsed ledger records (the output of
    :func:`photon_ml_tpu_torch.telemetry.validate.validate_ledger`)."""
    warnings: List[str] = []
    spans = [r for r in records if r.get("type") == "span"]
    metas = [r for r in records if r.get("type") == "meta"]
    events = [r for r in records if r.get("type") == "event"]
    metric_recs = [r for r in records if r.get("type") == "metrics"]
    progress_recs = [r for r in records if r.get("type") == "progress"]
    request_recs = [r for r in records if r.get("type") == "request"]

    label = next(
        (m.get("label", "run") for m in metas if m.get("phase") == "start"),
        "run",
    )
    start_ts = next(
        (float(m["ts"]) for m in metas if m.get("phase") == "start"), None
    )
    finish_ts = next(
        (float(m["ts"]) for m in metas if m.get("phase") == "finish"), None
    )

    # ---- span tree reconstruction --------------------------------------
    by_id: Dict[int, dict] = {}
    children_dur: Dict[int, float] = {}
    for rec in spans:
        sid = rec.get("span_id")
        if sid is not None:
            by_id[int(sid)] = rec
    for rec in spans:
        pid = rec.get("parent_id")
        if pid is not None:
            children_dur[int(pid)] = children_dur.get(int(pid), 0.0) + float(
                rec.get("duration_s", 0.0)
            )
    # depth for the top-span table: walk parent links
    for rec in spans:
        depth, pid = 1, rec.get("parent_id")
        while pid is not None and int(pid) in by_id and depth < 64:
            depth += 1
            pid = by_id[int(pid)].get("parent_id")
        rec["_depth"] = depth

    # ---- window and wall-clock -----------------------------------------
    starts = [float(r["start_unix"]) for r in spans if "start_unix" in r]
    ends = [
        float(r["start_unix"]) + float(r.get("duration_s", 0.0))
        for r in spans
        if "start_unix" in r
    ]
    span_extent = (max(ends) - min(starts)) if starts else 0.0
    if start_ts is not None and finish_ts is not None:
        wall = max(0.0, finish_ts - start_ts)
    elif start_ts is not None and ends:
        wall = max(0.0, max(ends) - start_ts)
        warnings.append(
            "no finish record (crash-truncated run?); wall-clock measured "
            "to the last span end"
        )
    else:
        wall = span_extent
        if start_ts is None:
            warnings.append("no start record; wall-clock is the span extent")

    # ---- per-phase exclusive occupancy ---------------------------------
    # Self-intervals (own interval minus the union of direct children),
    # then a sweep-line: a segment where k self-intervals are open gives
    # each phase its full length as busy_s but only length/k as seconds —
    # so concurrent span trees (the async CD schedule) never double-count
    # against wall-clock, and the concurrency win is explicit overlap_s.
    phases: Dict[str, Dict[str, float]] = {
        p: {
            "seconds": 0.0, "spans": 0, "fraction": 0.0,
            "busy_s": 0.0, "overlap_s": 0.0,
        }
        for p in PHASES
    }
    failed = 0
    have_starts = all("start_unix" in r for r in spans)
    for rec in spans:
        phases[classify_span(str(rec.get("name", "")))]["spans"] += 1
        failed += int(bool(rec.get("failed")))

    if have_starts and spans:
        children_iv: Dict[int, List[Tuple[float, float]]] = {}
        for rec in spans:
            pid = rec.get("parent_id")
            if pid is not None:
                s = float(rec["start_unix"])
                children_iv.setdefault(int(pid), []).append(
                    (s, s + float(rec.get("duration_s", 0.0)))
                )
        # boundary events over every span's self-intervals
        edges: List[Tuple[float, int, str]] = []
        for rec in spans:
            s = float(rec["start_unix"])
            own = (s, s + float(rec.get("duration_s", 0.0)))
            sid = rec.get("span_id")
            kids = children_iv.get(int(sid), []) if sid is not None else []
            phase = classify_span(str(rec.get("name", "")))
            for a, b in _subtract_intervals(own, kids):
                edges.append((a, 1, phase))
                edges.append((b, -1, phase))
        edges.sort(key=lambda e: (e[0], e[1]))
        active: Dict[str, int] = {}
        k = 0
        prev_t: Optional[float] = None
        for t, delta, phase in edges:
            if prev_t is not None and k > 0 and t > prev_t:
                seg = t - prev_t
                for ph, cnt in active.items():
                    if cnt:
                        phases[ph]["busy_s"] += seg * cnt
                        phases[ph]["seconds"] += seg * cnt / k
            active[phase] = active.get(phase, 0) + delta
            k += delta
            prev_t = t
        for p in phases.values():
            p["overlap_s"] = max(0.0, p["busy_s"] - p["seconds"])
    else:
        # legacy ledgers without start_unix: scalar exclusive time (no
        # interval data to share concurrency with)
        if spans and not have_starts:
            warnings.append(
                "span records lack start_unix; exclusive time computed "
                "per-span (concurrent spans may double-count)"
            )
        for rec in spans:
            dur = float(rec.get("duration_s", 0.0))
            sid = rec.get("span_id")
            child = children_dur.get(int(sid), 0.0) if sid is not None else 0.0
            exclusive = max(0.0, dur - child)
            bucket = phases[classify_span(str(rec.get("name", "")))]
            bucket["seconds"] += exclusive
            bucket["busy_s"] += exclusive

    # ---- bubble accounting ---------------------------------------------
    # gaps inside the run window covered by NO root span = host driver
    # time between instrumented regions (plus pre-first-span setup)
    root_intervals = []
    window_start = start_ts if start_ts is not None else (min(starts) if starts else 0.0)
    window_end = window_start + wall
    for rec in spans:
        if rec.get("parent_id") is None and "start_unix" in rec:
            s = max(window_start, float(rec["start_unix"]))
            e = min(window_end, float(rec["start_unix"]) + float(rec.get("duration_s", 0.0)))
            if e > s:
                root_intervals.append((s, e))
    covered = _merged_coverage(root_intervals)
    bubble = max(0.0, wall - covered)

    span_total = sum(p["seconds"] for p in phases.values())
    overlap_total = sum(p["overlap_s"] for p in phases.values())
    attributed = span_total + bubble
    coverage = attributed / wall if wall > 0 else 0.0
    for p in phases.values():
        p["fraction"] = (p["seconds"] / wall) if wall > 0 else 0.0
        p["seconds"] = round(p["seconds"], 6)
        p["fraction"] = round(p["fraction"], 6)
        p["busy_s"] = round(p["busy_s"], 6)
        p["overlap_s"] = round(p["overlap_s"], 6)

    # ---- joins ----------------------------------------------------------
    event_counts: Dict[str, int] = {}
    solver_events = []
    transfer_events = []
    for rec in events:
        name = str(rec.get("event", "?"))
        event_counts[name] = event_counts.get(name, 0) + 1
        if name == "SolverStatsEvent":
            solver_events.append(rec.get("fields") or {})
        elif name == "TransferStatsEvent":
            transfer_events.append(rec.get("fields") or {})

    solver: Dict[str, Any] = {}
    if solver_events:
        def _sum(key):
            return sum(float(f.get(key, 0) or 0) for f in solver_events)

        executed = _sum("executed_lane_iterations")
        lockstep = _sum("lockstep_lane_iterations")
        solver = {
            "buckets": len(solver_events),
            "entities": int(_sum("num_entities")),
            "rounds": int(_sum("rounds")),
            "executed_lane_iterations": int(executed),
            "lockstep_lane_iterations": int(lockstep),
            "lane_iteration_savings": (
                round(lockstep / executed, 4) if executed else None
            ),
            "chunk_retraces": int(_sum("chunk_retraces")),
            "unconverged_buckets": sum(
                1 for f in solver_events if not f.get("converged", True)
            ),
        }

    snapshot = dict(metric_recs[-1].get("snapshot") or {}) if metric_recs else {}
    counters = snapshot.get("counters") or {}
    transfers = {
        k[len("transfer."):]: v
        for k, v in counters.items()
        if k.startswith("transfer.")
    }
    if not transfers and transfer_events:
        for f in transfer_events:
            for k, v in f.items():
                if isinstance(v, (int, float)):
                    transfers[k] = transfers.get(k, 0) + v
    jit = {
        k[len("jit.traces."):]: int(v)
        for k, v in counters.items()
        if k.startswith("jit.traces.")
    }

    return RunReport(
        label=str(label),
        source_path=source_path,
        wall_clock_s=round(wall, 6),
        span_extent_s=round(span_extent, 6),
        phases=phases,
        bubble_s=round(bubble, 6),
        attributed_s=round(attributed, 6),
        coverage=round(coverage, 6),
        num_spans=len(spans),
        failed_spans=failed,
        top_spans=_span_tree_summary(spans, max_depth=2),
        solver=solver,
        transfers=transfers,
        jit_traces=jit,
        events=event_counts,
        metrics=snapshot,
        warnings=warnings,
        overlap_s=round(overlap_total, 6),
        progress=(
            convergence_report(progress_recs) if progress_recs else None
        ),
        requests=request_report(request_recs) if request_recs else None,
        cluster=cluster_report(progress_recs) if progress_recs else None,
    )


def analyze_ledger(path: str) -> RunReport:
    """Validate + replay one run-ledger file into a :class:`RunReport`.
    Crash-truncated ledgers analyze their valid prefix (with a report
    warning) rather than failing."""
    import warnings as _w

    with _w.catch_warnings(record=True) as caught:
        _w.simplefilter("always")
        records = validate_ledger(path)
    report = analyze_records(records, source_path=path)
    for w in caught:
        report.warnings.append(str(w.message))
    return report


def format_report(report: RunReport) -> str:
    """Human-readable occupancy report (the analyze_run CLI output)."""
    lines = [
        f"run report [{report.label}]"
        + (f" — {report.source_path}" if report.source_path else ""),
        f"  wall clock      {report.wall_clock_s:10.4f}s"
        f"   spans {report.num_spans}"
        + (f"   FAILED {report.failed_spans}" if report.failed_spans else ""),
        f"  attributed      {report.attributed_s:10.4f}s"
        f"   coverage {report.coverage * 100:6.2f}%",
        "",
        f"  {'phase':<12} {'seconds':>10} {'share':>8} {'spans':>7}",
    ]
    rows = sorted(
        ((p, v) for p, v in report.phases.items() if v["spans"] or v["seconds"]),
        key=lambda kv: -kv[1]["seconds"],
    )
    for phase, v in rows:
        overlap = float(v.get("overlap_s", 0.0) or 0.0)
        lines.append(
            f"  {phase:<12} {v['seconds']:>10.4f} {v['fraction'] * 100:>7.2f}% "
            f"{int(v['spans']):>7d}"
            + (f"   overlap {overlap:.4f}s" if overlap > 0 else "")
        )
    lines.append(
        f"  {'(bubbles)':<12} {report.bubble_s:>10.4f} "
        f"{(report.bubble_s / report.wall_clock_s * 100 if report.wall_clock_s else 0):>7.2f}%"
        f" {'—':>7}"
    )
    if report.overlap_s > 0:
        lines.append(
            f"  overlapped      {report.overlap_s:10.4f}s of concurrent span "
            "time shared across phases (busy − attributed)"
        )
    if report.solver:
        s = report.solver
        lines += [
            "",
            "  solver join: "
            f"{s['buckets']} bucket(s), {s['entities']} entities, "
            f"{s['rounds']} adaptive round(s)",
            f"    lane iterations executed/lockstep: "
            f"{s['executed_lane_iterations']}/{s['lockstep_lane_iterations']}"
            + (
                f" (savings {s['lane_iteration_savings']}x)"
                if s.get("lane_iteration_savings")
                else ""
            ),
        ]
    if report.transfers:
        lines.append("  transfer join: " + ", ".join(
            f"{k}={int(v)}" for k, v in sorted(report.transfers.items())
        ))
    if report.jit_traces:
        lines.append("  jit traces: " + ", ".join(
            f"{k}={v}" for k, v in sorted(report.jit_traces.items())
        ))
    if report.progress:
        prog = report.progress
        anomalies = prog.get("anomalies") or []
        lines.append(
            f"  convergence plane: {prog.get('num_updates', 0)} coordinate "
            f"update(s) over {len(prog.get('coordinates') or {})} "
            "coordinate(s)"
            + (f", {len(anomalies)} ANOMALY record(s)" if anomalies else "")
            + " — full report via analyze_run --progress"
        )
    if report.requests:
        req = report.requests
        tail = req.get("tail") or {}
        lines.append(
            f"  request plane: {req.get('num_records', 0)} sampled "
            f"lifecycle record(s), tail worst stage "
            f"'{tail.get('worst_stage', '?')}' — full attribution via "
            "analyze_run --requests"
        )
    if report.cluster:
        clu = report.cluster
        lines.append(
            f"  cluster plane: {clu.get('num_passes', 0)} distributed "
            f"pass(es) over {clu.get('num_hosts', 0)} host(s), comm wait "
            f"{clu.get('comm_wait_frac', 0.0) * 100:.1f}% of pass wall — "
            "full skew attribution via analyze_run --cluster"
        )
    if report.warnings:
        lines.append("")
        for w in report.warnings:
            lines.append(f"  warning: {w}")
    return "\n".join(lines)

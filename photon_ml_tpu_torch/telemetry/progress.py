"""Convergence observability plane: per-coordinate / per-block progress
telemetry, the divergence watchdog, and convergence-report reconstruction.

Every surface built in PRs 5–6 observes *time*; this module observes
*optimization progress*. A :class:`ConvergenceTracker` records, per outer
iteration and per coordinate, the objective value, gradient norm,
coefficient-delta norm, and solver/line-search iteration counts, plus the
held-out metric trace and — on the streaming path — per-block partial
loss / partial gradient norm / duality-gap estimates (see
``streaming.solver.BlockStatsProbe``). Records stream to a
checksum-friendly JSONL ledger (``type: "progress"``; schema enforced by
``telemetry/validate.py``), feed ``progress.*`` counters/gauges in the
:class:`MetricsRegistry`, and stay resident in memory for the live
``/progress`` introspection endpoint.

The embedded **divergence watchdog** turns the same stream into a health
signal: a non-finite objective, an objective increase beyond tolerance, or
repeated line-search failure while the gradient is still large emits a
structured :class:`photon_ml_tpu_torch.event.AnomalyEvent`, flips ``health()``
unhealthy (503 on ``/healthz``), and — with ``abort_on_divergence`` —
raises :class:`DivergenceError` so the driver aborts cleanly instead of
saving a garbage model.

``convergence_report`` reconstructs the ledger into iterations-to-
tolerance per coordinate, per-coordinate objective share, and
stall/plateau detection (``analyze_run --progress``); the per-block gap
estimates use the same first-order surrogate the DuHL gap scheduler
(``streaming/gapsched.py``, arxiv 1702.07005) schedules stochastic
epochs by, and its per-epoch visit decisions land here as ``schedule``
records via :meth:`ConvergenceTracker.record_schedule`.

Disabled-by-default contract: with no tracker attached, training runs the
identical programs and produces bitwise-identical models (same contract as
the tracer).
"""

from __future__ import annotations

import math
import threading
from typing import Any, Dict, List, Optional

from photon_ml_tpu_torch.event import AnomalyEvent
from photon_ml_tpu_torch.telemetry.metrics import MetricsRegistry, get_registry
from photon_ml_tpu_torch.telemetry.sinks import RunLedger

__all__ = [
    "ConvergenceTracker",
    "DivergenceError",
    "convergence_report",
    "extract_progress_records",
    "format_progress_report",
    "iterations_to_target_metric",
]


class DivergenceError(RuntimeError):
    """Training diverged: the watchdog tripped and ``abort_on_divergence``
    is set. Carries the structured anomaly for the driver's error path."""

    def __init__(self, anomaly: Dict[str, Any]):
        super().__init__(
            f"training diverged: {anomaly.get('anomaly_kind')} at outer "
            f"iteration {anomaly.get('outer')} coordinate "
            f"{anomaly.get('coordinate')!r} "
            f"(objective={anomaly.get('objective')!r})"
        )
        self.anomaly = anomaly


class ConvergenceTracker:
    """Records optimization progress and watches for divergence.

    Thread-safe: the introspection server reads ``health()`` /
    ``progress_json()`` from handler threads while the training thread
    appends. With ``ledger_path`` the tracker owns a dedicated
    ``progress.jsonl`` ledger (meta start/finish records bracket the run);
    with ``ledger`` it rides along an existing run ledger and writes only
    ``progress`` records.
    """

    #: consecutive line-search failures (with a still-large gradient)
    #: before the watchdog calls it a stall
    DEFAULT_MAX_LINE_SEARCH_FAILURES = 3

    def __init__(
        self,
        ledger_path: Optional[str] = None,
        ledger: Optional[RunLedger] = None,
        registry: Optional[MetricsRegistry] = None,
        emitter=None,
        divergence_tolerance: float = 1e-3,
        max_line_search_failures: Optional[int] = None,
        line_search_grad_norm: float = 1.0,
        abort_on_divergence: bool = True,
        label: str = "progress",
    ):
        if ledger is not None and ledger_path is not None:
            raise ValueError("pass ledger_path or ledger, not both")
        self._owns_ledger = ledger is None and ledger_path is not None
        self.ledger = ledger
        if self._owns_ledger:
            self.ledger = RunLedger(ledger_path)
            self.ledger.write("meta", phase="start", label=label)
        self.registry = registry if registry is not None else get_registry()
        self.emitter = emitter
        self.divergence_tolerance = float(divergence_tolerance)
        self.max_line_search_failures = (
            self.DEFAULT_MAX_LINE_SEARCH_FAILURES
            if max_line_search_failures is None
            else int(max_line_search_failures)
        )
        self.line_search_grad_norm = float(line_search_grad_norm)
        self.abort_on_divergence = bool(abort_on_divergence)
        self._lock = threading.RLock()
        self.records: List[Dict[str, Any]] = []
        # full skew profiles (fragment timelines included) — the trimmed
        # ledger records keep only the per-pass/per-host aggregates
        self.cluster_passes: List[Dict[str, Any]] = []
        self.anomaly: Optional[Dict[str, Any]] = None
        self._last_objective: Optional[float] = None
        self._resilience_count = 0
        self._failure_sink = None
        self._ls_failures = 0
        self._phase = "training"
        self._closed = False

    # -- recording --------------------------------------------------------

    def _emit(self, record: Dict[str, Any]) -> None:
        """Append to the in-memory trace and the ledger (caller holds the
        lock); the ledger adds type/ts."""
        self.records.append(record)
        if self.ledger is not None:
            self.ledger.write("progress", **record)

    def record_coordinate(
        self,
        outer: int,
        coordinate: str,
        objective: float,
        loss: Optional[float] = None,
        regularization: Optional[float] = None,
        grad_norm: Optional[float] = None,
        coef_delta_norm: Optional[float] = None,
        solver_iterations: Optional[int] = None,
        line_search_trials: Optional[int] = None,
        convergence_reason: Optional[str] = None,
    ) -> None:
        """One coordinate update's progress point. Runs the watchdog; may
        raise :class:`DivergenceError` (after recording the anomaly)."""
        objective = float(objective)
        with self._lock:
            rec: Dict[str, Any] = {
                "kind": "coordinate",
                "outer": int(outer),
                "coordinate": str(coordinate),
                "objective": objective,
            }
            if loss is not None:
                rec["loss"] = float(loss)
            if regularization is not None:
                rec["regularization"] = float(regularization)
            if grad_norm is not None:
                rec["grad_norm"] = float(grad_norm)
            if coef_delta_norm is not None:
                rec["coef_delta_norm"] = float(coef_delta_norm)
            if solver_iterations is not None:
                rec["solver_iterations"] = int(solver_iterations)
            if line_search_trials is not None:
                rec["line_search_trials"] = int(line_search_trials)
            if convergence_reason is not None:
                rec["convergence_reason"] = str(convergence_reason)
            self._emit(rec)
            reg = self.registry
            reg.count("progress.coordinate_updates")
            reg.gauge("progress.objective", objective)
            reg.gauge(f"progress.{coordinate}.objective", objective)
            if grad_norm is not None:
                reg.gauge(f"progress.{coordinate}.grad_norm", float(grad_norm))
            if coef_delta_norm is not None:
                reg.gauge(
                    f"progress.{coordinate}.coef_delta_norm",
                    float(coef_delta_norm),
                )
            if solver_iterations is not None:
                reg.count("progress.solver_iterations", int(solver_iterations))
            if line_search_trials is not None:
                reg.count(
                    "progress.line_search_trials", int(line_search_trials)
                )
            self._watchdog(rec, grad_norm, convergence_reason)

    def record_validation(self, outer: int, coordinate: str, metric) -> None:
        with self._lock:
            self._emit({
                "kind": "validation",
                "outer": int(outer),
                "coordinate": str(coordinate),
                "metric": float(metric),
            })
            self.registry.gauge("progress.validation_metric", float(metric))

    def record_blocks(
        self, outer: int, coordinate: str, block_stats: List[Dict[str, Any]]
    ) -> None:
        """Per-block contributions of a streamed solve's final pass
        (``BlockStatsProbe.last_pass``). Gap estimates also land as
        ``stream.block_gap.<index>`` gauges — the DuHL scheduler seam."""
        with self._lock:
            for stat in block_stats:
                self._emit({
                    "kind": "block",
                    "outer": int(outer),
                    "coordinate": str(coordinate),
                    "block": int(stat["block"]),
                    "partial_loss": float(stat["partial_loss"]),
                    "partial_grad_norm": float(stat["partial_grad_norm"]),
                    "gap_estimate": float(stat["gap_estimate"]),
                })
                self.registry.gauge(
                    f"stream.block_gap.{int(stat['block'])}",
                    float(stat["gap_estimate"]),
                )
            if block_stats:
                gaps = [float(s["gap_estimate"]) for s in block_stats]
                self.registry.gauge("stream.block_gap_max", max(gaps))
                self.registry.gauge("stream.block_gap_sum", sum(gaps))
                self.registry.count("progress.block_records", len(block_stats))

    def record_schedule(
        self, outer: int, coordinate: str, decisions: List[Dict[str, Any]]
    ) -> None:
        """Per-epoch gap-scheduler decisions of a stochastic streamed solve
        (``GapScheduler.drain_decisions()``): how many blocks the epoch
        visited, how many were pure exploration picks, and the score
        spread the choice was made on."""
        with self._lock:
            for d in decisions:
                rec = {
                    "kind": "schedule",
                    "outer": int(outer),
                    "coordinate": str(coordinate),
                    "epoch": int(d["epoch"]),
                    "visited": int(d["visited"]),
                    "explored": int(d["explored"]),
                    "num_blocks": int(d["num_blocks"]),
                }
                for key in ("unvisited", "score_max", "score_mean"):
                    if key in d:
                        rec[key] = float(d[key])
                self._emit(rec)
            if decisions:
                self.registry.count(
                    "progress.schedule_records", len(decisions)
                )

    def record_residency(
        self, outer: int, coordinate: str, decisions: List[Dict[str, Any]]
    ) -> None:
        """Pin/evict decisions of the HBM residency plane
        (``ResidencyManager.drain_decisions()``): which block entered or
        left the device-resident set, on what staleness-decayed gap score
        (-1.0 = bootstrap pin, no measurement yet), and the H2D byte delta
        the decision implies for every later pass."""
        with self._lock:
            if self._closed:
                return
            for d in decisions:
                self._emit({
                    "kind": "residency",
                    "outer": int(outer),
                    "coordinate": str(coordinate),
                    "epoch": int(d["epoch"]),
                    "action": str(d["action"]),
                    "block": int(d["block"]),
                    "gap_score": float(d["gap_score"]),
                    "byte_delta": int(d["byte_delta"]),
                    "resident_blocks": int(d.get("resident_blocks", 0)),
                    "resident_bytes": int(d.get("resident_bytes", 0)),
                })
            if decisions:
                last = decisions[-1]
                self.registry.gauge(
                    "stream.residency.resident_blocks",
                    float(last.get("resident_blocks", 0)),
                )
                self.registry.gauge(
                    "stream.residency.resident_bytes",
                    float(last.get("resident_bytes", 0)),
                )
                self.registry.count(
                    "progress.residency_records", len(decisions)
                )

    def record_cluster(
        self, outer: int, coordinate: str, events: List[Dict[str, Any]]
    ) -> None:
        """Cluster-plane events of a distributed streamed solve
        (``ClusterCoordinator.drain_events()``): per-pass block rebalances,
        host losses, and reassignments. Host losses are degraded-but-
        recovered signals — they land in the ledger and counters but do
        not flip health (the job survived by design)."""
        with self._lock:
            if self._closed:
                return
            for ev in events:
                rec: Dict[str, Any] = {
                    "kind": "cluster",
                    "outer": int(outer),
                    "coordinate": str(coordinate),
                    "event": str(ev.get("event", "unknown")),
                }
                for key, val in ev.items():
                    if key != "event":
                        rec[key] = val
                self._emit(rec)
            if events:
                self.registry.count("progress.cluster_records", len(events))

    def record_cluster_passes(
        self, outer: int, coordinate: str, profiles: List[Dict[str, Any]]
    ) -> None:
        """Per-pass skew profiles of a distributed streamed solve
        (``ClusterCoordinator.drain_pass_profiles()``): one ``cluster_pass``
        record per pass (wall decomposed exactly into busy + allreduce
        wait + coordinator bubble, plus the straggler picture) and one
        ``host_pass`` record per (pass, host) with that host's measured
        busy/wall/blocks and its predicted-vs-actual work share. Full
        profiles (with fragment timelines) stay in ``self.cluster_passes``
        for the /cluster route and per-host trace-lane export."""
        with self._lock:
            if self._closed:
                return
            for p in profiles:
                hosts = p.get("hosts") or {}
                self._emit({
                    "kind": "cluster_pass",
                    "outer": int(outer),
                    "coordinate": str(coordinate),
                    "pass_id": int(p["pass_id"]),
                    "wall_s": float(p["wall_s"]),
                    "busy_s": float(p["busy_s"]),
                    "allreduce_wait_s": float(p["allreduce_wait_s"]),
                    "bubble_s": float(p["bubble_s"]),
                    "straggler_index": float(p.get("straggler_index", 1.0)),
                    "straggler_host": int(p.get("straggler_host", -1)),
                    "hosts": len(hosts),
                    "blocks": int(p.get("blocks", 0)),
                    "stray_partials": int(p.get("stray_partials", 0)),
                    "requeued_blocks": int(p.get("requeued_blocks", 0)),
                })
                for host in sorted(hosts, key=int):
                    h = hosts[host]
                    rec: Dict[str, Any] = {
                        "kind": "host_pass",
                        "outer": int(outer),
                        "coordinate": str(coordinate),
                        "pass_id": int(p["pass_id"]),
                        "host": int(host),
                        "busy_s": float(h.get("busy_s", 0.0)),
                        "wall_s": float(h.get("wall_s", 0.0)),
                        "blocks": int(h.get("blocks", 0)),
                        "frags": int(h.get("frags", 0)),
                        "decode_s": float(h.get("decode_s", 0.0)),
                        "solve_s": float(h.get("solve_s", 0.0)),
                        "reply_s": float(h.get("reply_s", 0.0)),
                        "h2d_bytes": int(h.get("h2d_bytes", 0)),
                    }
                    if h.get("predicted_share") is not None:
                        rec["predicted_share"] = float(h["predicted_share"])
                    if h.get("actual_share") is not None:
                        rec["actual_share"] = float(h["actual_share"])
                    self._emit(rec)
            if profiles:
                self.cluster_passes.extend(dict(p) for p in profiles)
                self.registry.count(
                    "progress.cluster_pass_records", len(profiles)
                )

    def cluster_json(self) -> Dict[str, Any]:
        """Payload for the live ``/cluster`` introspection route: the
        skew profiles recorded so far plus the latest straggler picture."""
        with self._lock:
            passes = [dict(p) for p in self.cluster_passes]
        doc: Dict[str, Any] = {"num_passes": len(passes), "passes": passes}
        if passes:
            last = passes[-1]
            doc["straggler_index_last"] = last.get("straggler_index")
            doc["straggler_host_last"] = last.get("straggler_host")
            doc["allreduce_wait_last_s"] = last.get("allreduce_wait_s")
        return doc

    def record_resilience(
        self,
        failure_kind: str,
        site: str,
        detail: str = "",
        outer: Optional[int] = None,
        coordinate: Optional[str] = None,
        block: Optional[int] = None,
    ) -> None:
        """One failure-plane event (retry exhaustion, skipped block,
        thread crash) as a ``resilience`` ledger record. These are the
        *recovered/degraded* signals: they count and persist but do NOT
        flip health — divergence anomalies keep that role."""
        with self._lock:
            if self._closed:
                return
            rec: Dict[str, Any] = {
                "kind": "resilience",
                "failure_kind": str(failure_kind),
                "site": str(site),
                "detail": str(detail),
            }
            if outer is not None:
                rec["outer"] = int(outer)
            if coordinate is not None:
                rec["coordinate"] = str(coordinate)
            if block is not None:
                rec["block"] = int(block)
            self._emit(rec)
            self._resilience_count += 1
            self.registry.count("progress.resilience_records")
        if self.emitter is not None:
            self.emitter.send_event(AnomalyEvent(
                kind=str(failure_kind),
                coordinate_id=str(coordinate) if coordinate else str(site),
                outer_iteration=int(outer) if outer is not None else -1,
                objective_value=float("nan"),
                detail={"site": str(site), "detail": str(detail)},
            ))

    def attach_failure_sink(self) -> None:
        """Subscribe this tracker to the process-global resilience failure
        stream: every ``record_failure`` lands in the progress ledger as a
        ``resilience`` record (detached automatically by :meth:`finish`)."""
        from photon_ml_tpu_torch.resilience.failures import add_failure_sink

        if getattr(self, "_failure_sink", None) is not None:
            return

        def _sink(rec: Dict[str, Any]) -> None:
            self.record_resilience(
                rec.get("kind", "unknown"),
                rec.get("site", ""),
                rec.get("detail", ""),
                block=rec.get("block"),
            )

        self._failure_sink = _sink
        add_failure_sink(_sink)

    def detach_failure_sink(self) -> None:
        sink = getattr(self, "_failure_sink", None)
        if sink is None:
            return
        from photon_ml_tpu_torch.resilience.failures import remove_failure_sink

        remove_failure_sink(sink)
        self._failure_sink = None

    # -- divergence watchdog ---------------------------------------------

    def _watchdog(
        self,
        rec: Dict[str, Any],
        grad_norm: Optional[float],
        convergence_reason: Optional[str],
    ) -> None:
        objective = rec["objective"]
        anomaly_kind = None
        detail: Dict[str, Any] = {}
        if not math.isfinite(objective):
            anomaly_kind = "non_finite_objective"
        elif self._last_objective is not None:
            allowed = self._last_objective + self.divergence_tolerance * max(
                1.0, abs(self._last_objective)
            )
            if objective > allowed:
                anomaly_kind = "objective_increase"
                detail = {
                    "previous_objective": self._last_objective,
                    "allowed_objective": allowed,
                }
        if anomaly_kind is None:
            # "line search failed" is ALSO what a converged solve reports
            # (no descent step improves on the optimum), so a failure only
            # counts toward the stall watchdog while the gradient says we
            # are still far from stationarity
            failed = (
                convergence_reason == "OBJECTIVE_NOT_IMPROVING"
                and grad_norm is not None
                and grad_norm > self.line_search_grad_norm
            )
            self._ls_failures = self._ls_failures + 1 if failed else 0
            if self._ls_failures >= self.max_line_search_failures:
                anomaly_kind = "line_search_stall"
                detail = {
                    "consecutive_failures": self._ls_failures,
                    "grad_norm": grad_norm,
                }
        if math.isfinite(objective):
            self._last_objective = objective
        if anomaly_kind is None:
            return
        self._trip(anomaly_kind, rec, detail)

    def _trip(
        self, anomaly_kind: str, rec: Dict[str, Any], detail: Dict[str, Any]
    ) -> None:
        anomaly = {
            "kind": "anomaly",
            "anomaly_kind": anomaly_kind,
            "outer": rec["outer"],
            "coordinate": rec["coordinate"],
            "objective": rec["objective"],
            "detail": detail,
        }
        self.anomaly = anomaly
        self._phase = "diverged"
        self._emit(anomaly)
        self.registry.count("progress.anomalies")
        if self.emitter is not None:
            self.emitter.send_event(AnomalyEvent(
                kind=anomaly_kind,
                coordinate_id=rec["coordinate"],
                outer_iteration=rec["outer"],
                objective_value=rec["objective"],
                detail=detail,
            ))
        if self.abort_on_divergence:
            raise DivergenceError(anomaly)

    # -- live introspection ----------------------------------------------

    @property
    def healthy(self) -> bool:
        return self.anomaly is None

    def health(self) -> Dict[str, Any]:
        """Payload for the ``/healthz`` endpoint (503 when unhealthy)."""
        with self._lock:
            last = None
            for rec in reversed(self.records):
                if rec["kind"] == "coordinate":
                    last = rec
                    break
            doc: Dict[str, Any] = {
                "healthy": self.anomaly is None,
                "phase": self._phase,
            }
            if last is not None:
                doc["outer"] = last["outer"]
                doc["coordinate"] = last["coordinate"]
                doc["objective"] = last["objective"]
            if self.anomaly is not None:
                doc["anomaly"] = dict(self.anomaly)
            if self._resilience_count:
                # recovered/degraded events: visible, but not unhealthy
                doc["resilience_events"] = self._resilience_count
            return doc

    def progress_json(self) -> Dict[str, Any]:
        """Payload for the ``/progress`` endpoint: the full in-memory
        trace plus health."""
        with self._lock:
            return {
                "healthy": self.anomaly is None,
                "phase": self._phase,
                "num_records": len(self.records),
                "records": [dict(r) for r in self.records],
                "anomaly": dict(self.anomaly) if self.anomaly else None,
            }

    def finish(self) -> None:
        """Mark training done and close an owned ledger (idempotent)."""
        self.detach_failure_sink()
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._phase == "training":
                self._phase = "finished"
            if self._owns_ledger and self.ledger is not None:
                self.ledger.write(
                    "meta", phase="finish", num_records=len(self.records),
                    healthy=self.anomaly is None,
                )
                self.ledger.close()

    close = finish


# -- reconstruction (analyze_run --progress, the convergence sentinel) ----


def extract_progress_records(
    records: List[Dict[str, Any]],
) -> List[Dict[str, Any]]:
    """The ``progress`` records of a validated ledger, in write order."""
    return [r for r in records if r.get("type") == "progress"]


def iterations_to_target_metric(
    progress: List[Dict[str, Any]], target: float, higher_is_better: bool = True
) -> Optional[int]:
    """First outer iteration (1-based count of coordinate updates' outers)
    whose validation probe reaches ``target``; None if never reached."""
    for rec in progress:
        if rec.get("kind") != "validation":
            continue
        metric = rec["metric"]
        if (metric >= target) if higher_is_better else (metric <= target):
            return int(rec["outer"]) + 1
    return None


def _iters_to_tolerance(
    trace: List[tuple], final: float, tolerance: float
) -> Optional[int]:
    """1-based count of updates until the objective stays within
    ``tolerance`` (relative) of its final value."""
    scale = max(1.0, abs(final))
    for i, (_, obj) in enumerate(trace):
        if all(
            abs(o - final) <= tolerance * scale for _, o in trace[i:]
        ):
            return i + 1
    return None


def convergence_report(
    progress: List[Dict[str, Any]], tolerance: float = 1e-3
) -> Dict[str, Any]:
    """Reconstruct a convergence report from ``progress`` records.

    Per coordinate: updates, first/final objective, objective share (the
    coordinate's fraction of the total objective drop, attributed to the
    update that realized it), iterations-to-tolerance, solver totals, and
    plateau detection (the last two updates each improved the objective by
    less than ``tolerance`` relative).
    """
    coord_rows = [r for r in progress if r.get("kind") == "coordinate"]
    val_rows = [r for r in progress if r.get("kind") == "validation"]
    block_rows = [r for r in progress if r.get("kind") == "block"]
    anomalies = [r for r in progress if r.get("kind") == "anomaly"]
    residency_rows = [r for r in progress if r.get("kind") == "residency"]

    report: Dict[str, Any] = {
        "num_updates": len(coord_rows),
        "coordinates": {},
        "objective_trace": [
            [r["outer"], r["coordinate"], r["objective"]] for r in coord_rows
        ],
        "validation_trace": [
            [r["outer"], r["coordinate"], r["metric"]] for r in val_rows
        ],
        "anomalies": anomalies,
        "blocks": {},
        "tolerance": tolerance,
    }
    if not coord_rows:
        return report

    first_obj = coord_rows[0]["objective"]
    final_obj = coord_rows[-1]["objective"]
    total_drop = first_obj - final_obj
    report["first_objective"] = first_obj
    report["final_objective"] = final_obj
    report["objective_drop"] = total_drop
    full_trace = [(r["outer"], r["objective"]) for r in coord_rows]
    report["iterations_to_tolerance"] = _iters_to_tolerance(
        full_trace, final_obj, tolerance
    )
    if val_rows:
        report["final_validation_metric"] = val_rows[-1]["metric"]

    prev_obj = None
    per_coord: Dict[str, Dict[str, Any]] = {}
    for rec in coord_rows:
        cid = rec["coordinate"]
        c = per_coord.setdefault(cid, {
            "updates": 0,
            "first_objective": rec["objective"],
            "objective_share": 0.0,
            "solver_iterations": 0,
            "line_search_trials": 0,
            "trace": [],
        })
        c["updates"] += 1
        c["final_objective"] = rec["objective"]
        c["trace"].append((rec["outer"], rec["objective"]))
        if prev_obj is not None:
            c["objective_share"] += prev_obj - rec["objective"]
        c["solver_iterations"] += int(rec.get("solver_iterations") or 0)
        c["line_search_trials"] += int(rec.get("line_search_trials") or 0)
        if rec.get("grad_norm") is not None:
            c["final_grad_norm"] = rec["grad_norm"]
        prev_obj = rec["objective"]

    for cid, c in per_coord.items():
        trace = c.pop("trace")
        c["objective_share"] = (
            c["objective_share"] / total_drop if total_drop > 0 else 0.0
        )
        c["iterations_to_tolerance"] = _iters_to_tolerance(
            trace, c["final_objective"], tolerance
        )
        deltas = [
            a[1] - b[1] for a, b in zip(trace, trace[1:])
        ]
        scale = max(1.0, abs(c["final_objective"]))
        c["stalled"] = len(deltas) >= 2 and all(
            d <= tolerance * scale for d in deltas[-2:]
        )
    report["coordinates"] = per_coord

    if block_rows:
        per_blocks: Dict[str, Dict[str, Any]] = {}
        for rec in block_rows:
            cid = rec["coordinate"]
            b = per_blocks.setdefault(cid, {"final_pass": {}})
            # later records overwrite earlier ones per block index, so
            # final_pass ends as the LAST recorded pass per coordinate
            b.setdefault("_latest_outer", rec["outer"])
            if rec["outer"] >= b["_latest_outer"]:
                if rec["outer"] > b["_latest_outer"]:
                    b["final_pass"] = {}
                    b["_latest_outer"] = rec["outer"]
                b["final_pass"][int(rec["block"])] = {
                    "partial_loss": rec["partial_loss"],
                    "partial_grad_norm": rec["partial_grad_norm"],
                    "gap_estimate": rec["gap_estimate"],
                }
        for cid, b in per_blocks.items():
            b.pop("_latest_outer", None)
            gaps = [v["gap_estimate"] for v in b["final_pass"].values()]
            if gaps:
                b["gap_max"] = max(gaps)
                b["gap_sum"] = sum(gaps)
        report["blocks"] = per_blocks

    if residency_rows:
        per_res: Dict[str, Dict[str, Any]] = {}
        for rec in residency_rows:
            cid = rec["coordinate"]
            r = per_res.setdefault(cid, {
                "pins": 0, "evictions": 0, "resident_blocks": 0,
                "resident_bytes": 0, "saved_bytes_per_pass": 0,
            })
            if rec["action"] == "pin":
                r["pins"] += 1
            elif rec["action"] == "evict":
                r["evictions"] += 1
            # records are chronological: the last one carries the final
            # resident footprint; the byte deltas telescope to the same
            r["resident_blocks"] = int(rec.get("resident_blocks", 0))
            r["resident_bytes"] = int(rec.get("resident_bytes", 0))
            r["saved_bytes_per_pass"] = r["resident_bytes"]
        report["residency"] = per_res
    return report


def format_progress_report(report: Dict[str, Any]) -> str:
    """Human-readable convergence report (``analyze_run --progress``)."""
    lines: List[str] = []
    lines.append("== convergence report ==")
    lines.append(f"coordinate updates : {report.get('num_updates', 0)}")
    if "first_objective" in report:
        lines.append(
            f"objective          : {report['first_objective']:.6g} -> "
            f"{report['final_objective']:.6g} "
            f"(drop {report['objective_drop']:.6g})"
        )
        itt = report.get("iterations_to_tolerance")
        lines.append(
            f"iters-to-tolerance : "
            f"{itt if itt is not None else 'not reached'} "
            f"(tol {report['tolerance']:g} relative)"
        )
    if "final_validation_metric" in report:
        lines.append(
            f"final held-out     : {report['final_validation_metric']:.6g}"
        )
    coords = report.get("coordinates", {})
    if coords:
        lines.append("")
        lines.append(
            f"{'coordinate':<16} {'updates':>7} {'final obj':>12} "
            f"{'share':>7} {'to-tol':>6} {'slv-it':>6} {'stalled':>7}"
        )
        for cid, c in coords.items():
            itt = c.get("iterations_to_tolerance")
            lines.append(
                f"{cid:<16} {c['updates']:>7d} "
                f"{c['final_objective']:>12.6g} "
                f"{c['objective_share']:>6.1%} "
                f"{str(itt) if itt is not None else '-':>6} "
                f"{c['solver_iterations']:>6d} "
                f"{'yes' if c.get('stalled') else 'no':>7}"
            )
    blocks = report.get("blocks", {})
    for cid, b in blocks.items():
        final = b.get("final_pass", {})
        if final:
            lines.append("")
            lines.append(
                f"streamed blocks [{cid}]: {len(final)} blocks, "
                f"gap_sum={b.get('gap_sum', 0.0):.6g}, "
                f"gap_max={b.get('gap_max', 0.0):.6g}"
            )
    residency = report.get("residency", {})
    for cid, r in residency.items():
        lines.append("")
        lines.append(
            f"hbm residency [{cid}]: {r['resident_blocks']} blocks pinned "
            f"({r['resident_bytes'] / 1e6:.1f} MB), "
            f"{r['pins']} pins / {r['evictions']} evictions, "
            f"~{r['saved_bytes_per_pass'] / 1e6:.1f} MB H2D saved per pass"
        )
    anomalies = report.get("anomalies", [])
    if anomalies:
        lines.append("")
        for a in anomalies:
            lines.append(
                f"ANOMALY: {a.get('anomaly_kind')} at outer {a.get('outer')} "
                f"coordinate {a.get('coordinate')!r} "
                f"objective={a.get('objective')!r}"
            )
    return "\n".join(lines)

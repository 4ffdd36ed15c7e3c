"""Offline tuner: RunReport evidence → proposed config over the knob table.

:func:`propose` walks every registered :class:`KnobSpec`, resolves the
knob's declared ``metric_deps`` against the report, and applies a small
deterministic heuristic per knob. The output is a
:class:`TuningProposal` that records, for each knob, the proposed value,
whether it differs from the default, the rationale, and the resolved
evidence — so a proposal is auditable, not an oracle.

Proposals are *hypotheses*: :mod:`photon_ml_tpu_torch.tuning.autotune` A/Bs
them against the incumbent config and lets the MetricsRegistry judge.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from photon_ml_tpu_torch.telemetry.analyze import RunReport
from photon_ml_tpu_torch.tuning.knobs import KnobSpec, all_knobs

__all__ = ["KnobProposal", "TuningProposal", "propose", "resolve_dep", "ab_candidates"]


def resolve_dep(report: RunReport, dep: str) -> Optional[float]:
    """Resolve one ``metric_deps`` entry against a report.

    ``phase:<name>`` → phase wall-clock fraction; ``overlap:<name>`` →
    phase overlap seconds (concurrent span time — the async schedule's
    observable); ``solver:<field>`` → solver-join field; ``metric:<name>``
    → registry snapshot lookup; ``jit:<key>`` → retrace count. Missing
    evidence resolves to None — a knob with no evidence keeps its
    default."""
    kind, _, key = dep.partition(":")
    if kind == "phase":
        return report.phase_fraction(key)
    if kind == "overlap":
        return report.phase_overlap(key)
    if kind == "solver":
        value = (report.solver or {}).get(key)
        return float(value) if value is not None else None
    if kind == "metric":
        return report.metric(key)
    if kind == "jit":
        value = (report.jit_traces or {}).get(key)
        if value is None:
            total = sum(report.jit_traces.values()) if report.jit_traces else None
            return float(total) if total is not None else None
        return float(value)
    return None


@dataclasses.dataclass
class KnobProposal:
    name: str
    value: Any
    default: Any
    changed: bool
    rationale: str
    evidence: Dict[str, Optional[float]]

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class TuningProposal:
    report_label: str
    source_path: Optional[str]
    knobs: Dict[str, KnobProposal]

    def changed(self) -> Dict[str, Any]:
        return {k: p.value for k, p in self.knobs.items() if p.changed}

    def values(self) -> Dict[str, Any]:
        return {k: p.value for k, p in self.knobs.items()}

    def to_dict(self) -> Dict[str, Any]:
        return {
            "report_label": self.report_label,
            "source_path": self.source_path,
            "knobs": {k: p.to_dict() for k, p in sorted(self.knobs.items())},
        }


def _propose_one(spec: KnobSpec, report: RunReport) -> KnobProposal:
    ev = {dep: resolve_dep(report, dep) for dep in spec.metric_deps}
    value: Any = spec.default
    why = "no evidence moves this knob; keeping the default"

    def _f(dep: str, default: float = 0.0) -> float:
        v = ev.get(dep)
        return float(v) if v is not None else default

    if spec.name == "adaptive.chunk_iters":
        share = _f("phase:re_solve")
        savings = ev.get("solver:lane_iteration_savings")
        retraces = _f("solver:chunk_retraces")
        if share >= 0.15 and savings is not None:
            ladder = list(spec.candidates)
            idx = ladder.index(spec.default) if spec.default in ladder else 1
            if savings < 1.2 and idx > 0:
                value = ladder[idx - 1]
                why = (
                    f"RE solve holds {share:.0%} of wall-clock but lockstep/"
                    f"executed savings is only {savings:.2f}x — smaller chunks "
                    "re-check convergence sooner and cut wasted lane iterations"
                )
            elif savings >= 2.0 and retraces <= 2 and idx + 1 < len(ladder):
                value = ladder[idx + 1]
                why = (
                    f"adaptive rounds already save {savings:.2f}x with few "
                    "chunk retraces; larger chunks amortize more dispatch "
                    "overhead without new compiles"
                )
            else:
                why = (
                    f"RE share {share:.0%}, savings {savings:.2f}x sit in the "
                    "default's sweet spot"
                )
        elif share:
            why = f"RE solve is only {share:.0%} of wall-clock; not worth moving"

    elif spec.name == "adaptive.min_lanes":
        share = _f("phase:re_solve")
        savings = ev.get("solver:lane_iteration_savings")
        rounds = _f("solver:rounds")
        if share >= 0.15 and savings is not None:
            ladder = list(spec.candidates)
            idx = ladder.index(spec.default) if spec.default in ladder else 1
            if savings < 1.2 and idx > 0:
                value = ladder[idx - 1]
                why = (
                    "low lane-iteration savings — allow compaction to shrink "
                    "further so converged lanes stop burning device time"
                )
            elif rounds > 0 and savings >= 2.0 and idx + 1 < len(ladder):
                value = ladder[idx + 1]
                why = (
                    f"{int(rounds)} compaction rounds for {savings:.2f}x "
                    "savings — a higher floor trades a little lane waste for "
                    "fewer rounds and retraced shapes"
                )
            else:
                why = "compaction cadence looks balanced at the default floor"
        elif share:
            why = f"RE solve is only {share:.0%} of wall-clock; not worth moving"

    elif spec.name == "serving.bucket_sizes":
        fill = ev.get("metric:serving.batch_fill")
        compiles = _f("metric:serving.compile_count")
        if fill is not None:
            if fill < 0.6:
                value = max(spec.candidates, key=len)
                why = (
                    f"batch fill is {fill:.0%} — padding waste dominates; a "
                    "denser ladder cuts padding at the cost of more programs"
                )
            elif fill > 0.85 and compiles > 2 * len(spec.default):
                value = min(spec.candidates, key=len)
                why = (
                    f"fill already {fill:.0%} with {int(compiles)} compiles — "
                    "a sparser ladder drops compile pressure cheaply"
                )
            else:
                why = f"batch fill {fill:.0%} is healthy on the default ladder"

    elif spec.name == "serving.cache_capacity":
        hit = ev.get("metric:serving.cache_hit_rate")
        if hit is not None:
            ladder = list(spec.candidates)
            idx = ladder.index(spec.default) if spec.default in ladder else 1
            if hit < 0.8 and idx + 1 < len(ladder):
                value = ladder[idx + 1]
                why = (
                    f"cache hit rate {hit:.0%} — entity traffic overflows the "
                    "row cache; step capacity up the ladder"
                )
            elif hit > 0.98 and idx > 0:
                value = ladder[idx - 1]
                why = (
                    f"hit rate {hit:.0%} — the cache is oversized; reclaim "
                    "device memory"
                )
            else:
                why = f"cache hit rate {hit:.0%} is fine at current capacity"

    elif spec.name == "serving.shards":
        resident = ev.get("metric:serving.device_resident_rate")
        if resident is not None:
            why = (
                f"device residency {resident:.0%}; shard count trades gather "
                "fan-out for per-device rows — move it only via A/B on the "
                "target mesh"
            )

    elif spec.name == "serving.admit_batch":
        deferred = ev.get("metric:serving.deferred_rate")
        dropped = _f("metric:serving.admission_dropped_total")
        if deferred is not None:
            ladder = list(spec.candidates)
            idx = ladder.index(spec.default) if spec.default in ladder else 1
            if dropped > 0 and idx + 1 < len(ladder):
                value = ladder[idx + 1]
                why = (
                    f"admission dropped {int(dropped)} queued rows — the "
                    "drain can't keep up with the deferred stream; bigger "
                    "steps move more rows per scatter"
                )
            elif deferred < 0.01 and idx > 0:
                value = ladder[idx - 1]
                why = (
                    f"deferred rate {deferred:.1%} — the cold tail is thin; "
                    "smaller steps shorten the routing-lock hold for free"
                )
            else:
                why = (
                    f"deferred rate {deferred:.1%} with no drops — admission "
                    "keeps up at the default step size"
                )

    elif spec.name == "serving.batch_deadline_ms":
        fill = ev.get("metric:serving.batch_fill")
        p99 = ev.get("metric:serving.latency_p99_ms")
        if fill is not None and p99 is not None:
            ladder = list(spec.candidates)
            idx = ladder.index(spec.default) if spec.default in ladder else 1
            if fill < 0.5 and idx + 1 < len(ladder):
                value = ladder[idx + 1]
                why = (
                    f"batch fill {fill:.0%} at p99 {p99:.2f}ms — buckets "
                    "score half-empty; a longer deadline lets them fill"
                )
            elif fill > 0.9 and idx > 0:
                value = ladder[idx - 1]
                why = (
                    f"buckets already fill ({fill:.0%}) before the deadline; "
                    "a shorter one trims queueing from the tail"
                )
            else:
                why = (
                    f"fill {fill:.0%} / p99 {p99:.2f}ms balance at the "
                    "default deadline"
                )
        elif fill is not None:
            why = (
                f"batch fill {fill:.0%} but no latency evidence — the "
                "deadline trades the two, keep the default until both are "
                "measured"
            )

    elif spec.name == "serving.max_nnz":
        p99 = ev.get("metric:serving.latency_p99_ms")
        why = (
            "keep deriving the pow2 pad from traffic"
            + (f" (p99 {p99:.2f}ms)" if p99 is not None else "")
            + "; overriding only pays off with a fixed upstream schema"
        )

    elif spec.name == "train.schedule":
        fe = _f("phase:fe_solve")
        re_ = _f("phase:re_solve")
        overlap = _f("overlap:fe_solve") + _f("overlap:re_solve")
        if overlap > 0:
            why = (
                f"ledger already shows {overlap:.2f}s of FE/RE overlap — the "
                "async schedule is active and pulling its weight"
            )
        elif fe >= 0.2 and re_ >= 0.2:
            value = "async"
            why = (
                f"FE ({fe:.0%}) and RE ({re_:.0%}) both hold material "
                "wall-clock with zero measured overlap — pipelining them "
                "with bounded staleness can hide one behind the other"
            )
        elif fe or re_:
            why = (
                f"one side dominates (FE {fe:.0%}, RE {re_:.0%}); "
                "overlapping buys little, keep the reproducible sync loop"
            )

    elif spec.name == "train.staleness":
        overlap = _f("overlap:fe_solve") + _f("overlap:re_solve")
        share = _f("phase:cd_driver")
        if overlap > 0:
            why = (
                f"async overlap measured at {overlap:.2f}s — staleness "
                f"{spec.default} is doing its job; step it only via A/B"
            )
        elif share:
            why = (
                "no overlap evidence yet (sync run?); staleness only acts "
                "under schedule='async'"
            )

    elif spec.name == "train.engine":
        share = _f("phase:fe_solve")
        if share >= 0.3:
            why = (
                f"FE solve holds {share:.0%} of wall-clock and engines span a "
                "19x spread — worth an A/B across candidate engines"
            )
        elif share:
            why = f"FE solve is only {share:.0%} of wall-clock; engine stays auto"

    return KnobProposal(
        name=spec.name,
        value=value,
        default=spec.default,
        changed=value != spec.default,
        rationale=why,
        evidence=ev,
    )


def propose(report: RunReport) -> TuningProposal:
    """Propose a value (with rationale + evidence) for EVERY registered
    knob. Knobs without supporting evidence keep their defaults, but still
    appear — the proposal doubles as an audit of what was observable."""
    return TuningProposal(
        report_label=report.label,
        source_path=report.source_path,
        knobs={spec.name: _propose_one(spec, report) for spec in all_knobs()},
    )


def ab_candidates(
    proposal: TuningProposal,
    applies_to: str,
    max_candidates: int = 2,
) -> List[Dict[str, Any]]:
    """Flatten a proposal into candidate config dicts for the A/B layer.

    Candidate 0 is always the incumbent defaults (the control). Changed
    knobs scoped to ``applies_to`` are applied together as candidate 1;
    if nothing changed, the first non-default ladder step of the most
    evidence-backed knob is trialed so ``--auto-tune`` always has a B arm.
    """
    scoped = [
        p for name, p in sorted(proposal.knobs.items())
        if _spec(name).applies_to in (applies_to, "both")
    ]
    control = {p.name: p.default for p in scoped}
    changed = {p.name: p.value for p in scoped if p.changed}
    candidates: List[Dict[str, Any]] = [dict(control)]
    if changed:
        trial = dict(control)
        trial.update(changed)
        candidates.append(trial)
    else:
        backed = [
            p for p in scoped
            if any(v is not None for v in p.evidence.values())
            and len(_spec(p.name).candidates) > 1
        ]
        if backed:
            p = backed[0]
            alt = next(
                (c for c in _spec(p.name).candidates if c != p.default), None
            )
            if alt is not None:
                trial = dict(control)
                trial[p.name] = alt
                candidates.append(trial)
    return candidates[: max_candidates + 1]


def _spec(name: str) -> KnobSpec:
    from photon_ml_tpu_torch.tuning.knobs import get_knob

    return get_knob(name)

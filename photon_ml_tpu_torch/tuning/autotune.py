"""A/B trial harness for ``--auto-tune``: MetricsRegistry as the judge.

:func:`run_ab_trials` runs each candidate config through a caller-supplied
trial function and picks the winner by a named metric read from a **fresh**
:class:`~photon_ml_tpu_torch.telemetry.metrics.MetricsRegistry` per trial — never
the process-global registry, so (a) trial A's counters cannot leak into
trial B's judgment and (b) the surrounding run's telemetry is not polluted
by trial traffic. The lifecycle tests in ``tests/test_telemetry.py`` pin
this isolation contract.

The trial function does the real work (an iteration-0 fit, a warmup
replay) and records whatever it wants into the registry it is handed; if
it records nothing under the judge metric, the harness falls back to the
trial's wall-clock (recorded as ``autotune.wall_s``).
"""
from __future__ import annotations

import dataclasses
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

from photon_ml_tpu_torch.telemetry.metrics import MetricsRegistry

__all__ = ["TrialResult", "ABResult", "judge_from_snapshot", "run_ab_trials"]

DEFAULT_JUDGE_METRIC = "autotune.wall_s"


def judge_from_snapshot(snapshot: Dict[str, Any], metric: str) -> Optional[float]:
    """Read a judge metric from a registry snapshot: counters first, then
    gauge last-values, then histogram means."""
    counters = snapshot.get("counters") or {}
    if metric in counters:
        return float(counters[metric])
    gauges = snapshot.get("gauges") or {}
    if metric in gauges:
        return float(gauges[metric]["last"])
    hists = snapshot.get("histograms") or {}
    if metric in hists:
        return float(hists[metric].get("mean", 0.0))
    return None


@dataclasses.dataclass
class TrialResult:
    index: int
    config: Dict[str, Any]
    score: Optional[float]
    wall_s: float
    snapshot: Dict[str, Any]
    error: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d.pop("snapshot", None)  # snapshots are bulky; keep results portable
        return d


@dataclasses.dataclass
class ABResult:
    judge_metric: str
    minimize: bool
    trials: List[TrialResult]
    winner_index: int

    @property
    def winner(self) -> TrialResult:
        return self.trials[self.winner_index]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "judge_metric": self.judge_metric,
            "minimize": self.minimize,
            "winner_index": self.winner_index,
            "winner_config": self.winner.config,
            "trials": [t.to_dict() for t in self.trials],
        }


def run_ab_trials(
    candidates: Sequence[Dict[str, Any]],
    run_trial: Callable[[Dict[str, Any], MetricsRegistry], None],
    judge_metric: str = DEFAULT_JUDGE_METRIC,
    minimize: bool = True,
    logger=None,
) -> ABResult:
    """Run every candidate, judge by ``judge_metric``, return the bracket.

    A trial that raises is recorded with its error and an infinitely-bad
    score rather than aborting the bracket — auto-tune must never make a
    run fail that would have succeeded untuned. Candidate 0 (the control)
    wins ties, so the incumbent config is only displaced by a strict win.
    """
    if not candidates:
        raise ValueError("run_ab_trials needs at least one candidate")
    trials: List[TrialResult] = []
    for i, config in enumerate(candidates):
        registry = MetricsRegistry()  # fresh per trial: no cross-trial leaks
        start = time.perf_counter()
        error = None
        try:
            run_trial(dict(config), registry)
        except Exception:
            error = traceback.format_exc(limit=8)
        wall = time.perf_counter() - start
        registry.gauge("autotune.wall_s", wall)
        snapshot = registry.snapshot()
        score = None if error else judge_from_snapshot(snapshot, judge_metric)
        if score is None and not error:
            score = judge_from_snapshot(snapshot, DEFAULT_JUDGE_METRIC)
        trials.append(
            TrialResult(
                index=i,
                config=dict(config),
                score=score,
                wall_s=wall,
                snapshot=snapshot,
                error=error,
            )
        )
        if logger is not None:
            logger.info(
                "auto-tune trial %d/%d: %s=%s wall=%.3fs config=%s%s",
                i + 1,
                len(candidates),
                judge_metric,
                f"{score:.6g}" if score is not None else "n/a",
                wall,
                config,
                " (FAILED)" if error else "",
            )

    def _key(t: TrialResult) -> float:
        if t.score is None:
            return float("inf")
        return t.score if minimize else -t.score

    best = min(range(len(trials)), key=lambda i: (_key(trials[i]), i))
    return ABResult(
        judge_metric=judge_metric,
        minimize=minimize,
        trials=trials,
        winner_index=best,
    )

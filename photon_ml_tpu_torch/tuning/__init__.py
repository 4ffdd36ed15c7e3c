"""Offline tuning: declared knob space, report-driven proposals, A/B trials.

The loop this package closes: a run writes a RunLedger (PR 5) →
:func:`photon_ml_tpu_torch.telemetry.analyze_ledger` replays it into a
:class:`RunReport` → :func:`propose` turns the report's occupancy and
solver evidence into a config proposal over the registered
:class:`KnobSpec` table → ``--auto-tune`` on ``train_game``/``serve_game``
A/Bs the proposal against the incumbent via :func:`run_ab_trials` (judged
by a fresh MetricsRegistry per trial) → the winner persists into the
serving artifact's ``tuned_config`` so the next boot starts tuned.

See docs/OBSERVABILITY.md ("The knob registry" and "--auto-tune").
"""
from photon_ml_tpu_torch.tuning.knobs import (
    KNOBS,
    KnobSpec,
    all_knobs,
    get_knob,
    register_knob,
)
from photon_ml_tpu_torch.tuning.tuner import (
    KnobProposal,
    TuningProposal,
    ab_candidates,
    propose,
    resolve_dep,
)
from photon_ml_tpu_torch.tuning.autotune import (
    ABResult,
    TrialResult,
    judge_from_snapshot,
    run_ab_trials,
)

__all__ = [
    "KNOBS",
    "KnobSpec",
    "all_knobs",
    "get_knob",
    "register_knob",
    "KnobProposal",
    "TuningProposal",
    "ab_candidates",
    "propose",
    "resolve_dep",
    "ABResult",
    "TrialResult",
    "judge_from_snapshot",
    "run_ab_trials",
]

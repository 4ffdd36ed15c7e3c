"""Hosmer-Lemeshow goodness-of-fit test for logistic models.

Port of ``photon_ml_tpu/diagnostics/hl.py``, host numpy as there.

Reference parity: diagnostics/hl/HosmerLemeshowDiagnostic.scala:29 — bin
predicted probabilities (DefaultPredictedProbabilityVersusObserved-
FrequencyBinner: bins = min(dim + 2, 0.9·√n + 0.1·log1p(n)); the reference
code uses FACTOR_A for both terms, contradicting its own named constant —
the named intent is implemented here), accumulate expected vs observed
positive/negative counts per bin, χ² with dof = bins − 2, p-value and the
standard confidence-level cutoffs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np
from scipy.stats import chi2

STANDARD_CONFIDENCE_LEVELS = [
    0.000001, 0.01, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5,
    0.6, 0.7, 0.8, 0.9, 0.95, 0.99, 0.999999,
]
MINIMUM_EXPECTED_IN_BUCKET = 5


@dataclasses.dataclass(frozen=True)
class HistogramBin:
    """[lower, upper) predicted-probability range with expected/observed
    counts (reference PredictedProbabilityVersusObservedFrequency-
    HistogramBin)."""

    lower: float
    upper: float
    expected_pos: float
    expected_neg: float
    observed_pos: float
    observed_neg: float

    @property
    def count(self) -> float:
        return self.observed_pos + self.observed_neg


@dataclasses.dataclass
class HosmerLemeshowReport:
    bins: List[HistogramBin]
    chi_squared: float
    degrees_of_freedom: int
    # P[χ²_dof <= observed]: close to 1 ⇒ strong evidence of mis-calibration
    prob_at_chi_squared: float
    cutoffs: List[Tuple[float, float]]
    warnings: List[str]

    @property
    def p_value(self) -> float:
        """P[χ² >= observed | model calibrated]."""
        return 1.0 - self.prob_at_chi_squared


def default_bin_count(num_items: int, num_dimensions: int) -> int:
    by_dim = num_dimensions + 2
    by_data = int(0.9 * math.sqrt(num_items) + 0.1 * math.log1p(num_items))
    return max(3, min(by_dim, by_data))


def hosmer_lemeshow_diagnostic(
    predicted_probabilities,
    labels,
    num_dimensions: int,
    num_bins: int = None,
) -> HosmerLemeshowReport:
    """Equal-width probability bins over [0, 1]."""
    p = np.asarray(predicted_probabilities, dtype=np.float64)
    y = np.asarray(labels, dtype=np.float64) > 0.5
    n = len(p)
    if num_bins is None:
        num_bins = default_bin_count(n, num_dimensions)
    edges = np.linspace(0.0, 1.0, num_bins + 1)
    which = np.clip(np.digitize(p, edges[1:-1]), 0, num_bins - 1)

    bins: List[HistogramBin] = []
    warnings: List[str] = []
    chi_squared = 0.0
    for b in range(num_bins):
        sel = which == b
        cnt = int(sel.sum())
        exp_pos = float(p[sel].sum())
        exp_neg = cnt - exp_pos
        obs_pos = float(y[sel].sum())
        obs_neg = cnt - obs_pos
        hb = HistogramBin(
            lower=float(edges[b]), upper=float(edges[b + 1]),
            expected_pos=exp_pos, expected_neg=exp_neg,
            observed_pos=obs_pos, observed_neg=obs_neg,
        )
        bins.append(hb)
        if exp_pos > 0:
            chi_squared += (obs_pos - exp_pos) ** 2 / exp_pos
            if exp_pos < MINIMUM_EXPECTED_IN_BUCKET:
                warnings.append(
                    f"bin [{hb.lower:.3f},{hb.upper:.3f}): expected positive "
                    f"count {exp_pos:.2f} too small for a sound chi^2"
                )
        if exp_neg > 0:
            chi_squared += (obs_neg - exp_neg) ** 2 / exp_neg
            if exp_neg < MINIMUM_EXPECTED_IN_BUCKET:
                warnings.append(
                    f"bin [{hb.lower:.3f},{hb.upper:.3f}): expected negative "
                    f"count {exp_neg:.2f} too small for a sound chi^2"
                )

    dof = max(1, num_bins - 2)
    dist = chi2(dof)
    return HosmerLemeshowReport(
        bins=bins,
        chi_squared=float(chi_squared),
        degrees_of_freedom=dof,
        prob_at_chi_squared=float(dist.cdf(chi_squared)),
        cutoffs=[(lv, float(dist.ppf(lv))) for lv in STANDARD_CONFIDENCE_LEVELS],
        warnings=warnings,
    )

"""Kendall-τ rank-correlation independence tests.

Port of ``photon_ml_tpu/diagnostics/independence.py``, host numpy as there.

Reference parity: diagnostics/independence/KendallTauAnalysis.scala:26 —
concordant/discordant pair counts → τ-α, τ-β, z-score and two-sided p-value
(same formulas :63-77), with √n subsampling for large inputs; and
PredictionErrorIndependenceDiagnostic.scala (error vs prediction pairs).
The reference counts pairs with an O(n²) cartesian; here discordant pairs
are counted in O(n log n) by merge-sort inversion counting.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
from scipy.stats import norm


@dataclasses.dataclass
class KendallTauReport:
    num_concordant: int
    num_discordant: int
    num_items: int
    num_pairs: int
    effective_pairs: int
    tau_alpha: float
    tau_beta: float
    z_alpha: float
    # P[|Z| <= |z|]: close to 1 ⇒ strong evidence of DEPENDENCE (this is
    # what the reference calls pValue, KendallTauAnalysis.scala:74-75)
    prob_dependent: float
    message: str = ""

    @property
    def p_value(self) -> float:
        """Conventional two-sided p-value under H0 (independence) — the
        tail probability, matching HosmerLemeshowReport.p_value semantics."""
        return 1.0 - self.prob_dependent


def _count_inversions(a: np.ndarray) -> int:
    """Number of i<j with a[i] > a[j] (merge-sort, O(n log n))."""
    a = list(a)
    total = 0

    def sort(xs):
        nonlocal total
        if len(xs) <= 1:
            return xs
        mid = len(xs) // 2
        left, right = sort(xs[:mid]), sort(xs[mid:])
        out = []
        i = j = 0
        while i < len(left) and j < len(right):
            if left[i] <= right[j]:
                out.append(left[i]); i += 1
            else:
                total += len(left) - i
                out.append(right[j]); j += 1
        out.extend(left[i:]); out.extend(right[j:])
        return out

    sort(a)
    return total


def _tie_pairs(values: np.ndarray) -> int:
    _, counts = np.unique(values, return_counts=True)
    return int(np.sum(counts * (counts - 1) // 2))


def kendall_tau_analysis(
    a, b, max_items: int = None, seed: int = 0
) -> KendallTauReport:
    """τ test of independence between paired draws (a_i, b_i).

    With ``max_items`` (the reference subsamples ~√n of large RDDs), a
    uniform subsample bounds the O(n log n) work and normal-approx validity.
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if len(a) != len(b):
        raise ValueError("a and b must be paired")
    n = len(a)
    if max_items is not None and n > max_items:
        idx = np.random.default_rng(seed).choice(n, size=max_items, replace=False)
        a, b = a[idx], b[idx]
        n = max_items

    # lexsort by (a, then b): within tied-a runs b is ascending, so those
    # pairs contribute no inversions — discordant pairs are exactly the
    # inversions of b in this order
    order = np.lexsort((b, a))
    b_sorted = b[order]
    num_pairs = n * (n - 1) // 2
    ties_a = _tie_pairs(a)
    ties_b = _tie_pairs(b)
    _, ab_counts = np.unique(np.stack([a, b], axis=1), axis=0, return_counts=True)
    ties_ab = int(np.sum(ab_counts * (ab_counts - 1) // 2))
    discordant = _count_inversions(b_sorted)
    # pairs tied in a contribute neither concordant nor discordant; with the
    # lexsort, tied-a runs are sorted by b so they add no inversions
    concordant = num_pairs - discordant - ties_a - ties_b + ties_ab
    effective = concordant + discordant

    tau_alpha = (
        (concordant - discordant) / effective if effective > 0 else 0.0
    )
    no_ties_a = num_pairs - ties_a
    no_ties_b = num_pairs - ties_b
    tau_beta = (
        (concordant - discordant) / np.sqrt(float(no_ties_a) * float(no_ties_b))
        if no_ties_a > 0 and no_ties_b > 0
        else 0.0
    )
    # z under H0 (KendallTauAnalysis.scala:70-73)
    a_const = 2.0 * (2.0 * n + 5.0)
    b_const = 9.0 * n * (n - 1.0)
    d = np.sqrt(a_const / b_const) if b_const > 0 else 1.0
    z_alpha = tau_alpha / d
    prob_dependent = float(norm.cdf(abs(z_alpha)) - norm.cdf(-abs(z_alpha)))

    message = ""
    if ties_a + ties_b > 0:
        message = (
            f"detected ties (a: {ties_a}, b: {ties_b}); the tau-alpha z/p "
            "over-estimates independence"
        )
    return KendallTauReport(
        num_concordant=int(concordant),
        num_discordant=int(discordant),
        num_items=n,
        num_pairs=int(num_pairs),
        effective_pairs=int(effective),
        tau_alpha=float(tau_alpha),
        tau_beta=float(tau_beta),
        z_alpha=float(z_alpha),
        prob_dependent=prob_dependent,
        message=message,
    )


def prediction_error_independence(
    scores, labels, max_items: int = None, seed: int = 0
) -> KendallTauReport:
    """Error vs prediction independence (reference
    PredictionErrorIndependenceDiagnostic): error = label − score."""
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels, dtype=np.float64)
    return kendall_tau_analysis(
        scores, labels - scores, max_items=max_items, seed=seed
    )

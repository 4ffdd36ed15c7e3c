"""Feature importance rankings.

Port of ``photon_ml_tpu/diagnostics/feature_importance.py``, host numpy as
there; the ranking takes partial sorts (the same reports, without a full
sort of 2^24 + 1 importances).

Reference parity: diagnostics/featureimportance/ —
ExpectedMagnitudeFeatureImportanceDiagnostic.scala (importance =
|β_j · E|x_j||, falling back to |β_j| without a summary) and
VarianceFeatureImportanceDiagnostic.scala (importance = |β_j · Var(x_j)|);
AbstractFeatureImportanceDiagnostic ranks descending and keeps the top
MAX_RANKED_FEATURES plus an importance-vs-rank histogram.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from photon_ml_tpu_torch.indexmap import IndexMap, NAME_TERM_DELIMITER

MAX_RANKED_FEATURES = 25


@dataclasses.dataclass
class FeatureImportanceReport:
    importance_type: str
    importance_description: str
    # top features: (name, term, index, importance), descending
    ranked_features: List[Tuple[str, str, int, float]]
    # rank percentile (0-100, step 10) -> importance at that rank
    rank_to_importance: Dict[float, float]


def _build_report(
    importance: np.ndarray,
    index_map: Optional[IndexMap],
    importance_type: str,
    description: str,
) -> FeatureImportanceReport:
    n = len(importance)
    top = []
    for i in _top_order(importance, MAX_RANKED_FEATURES):
        key = index_map.get_feature_name(int(i)) if index_map else str(i)
        key = key if key is not None else str(i)
        name, _, term = key.partition(NAME_TERM_DELIMITER)
        top.append((name, term, int(i), float(importance[i])))
    # the importance at each rank is the rank's order statistic: a partial
    # sort gives it without ordering all 2^24 + 1 coefficients
    ranks = [min(n - 1, int(pct / 100.0 * n)) for pct in range(0, 101, 10)]
    at_rank = -np.partition(-importance, ranks)[ranks]
    rank_to_importance = {
        float(pct): float(v) for pct, v in zip(range(0, 101, 10), at_rank)
    }
    return FeatureImportanceReport(
        importance_type=importance_type,
        importance_description=description,
        ranked_features=top,
        rank_to_importance=rank_to_importance,
    )


def _top_order(importance: np.ndarray, k: int) -> np.ndarray:
    """``np.argsort(-importance, kind="stable")[:k]`` (the JAX module's
    ranking: descending, ties by index, NaN last) through a partial sort:
    the k-th largest value bounds the candidates, which keep index order."""
    neg = -importance
    k = min(k, neg.size)
    if k == 0:
        return np.zeros(0, dtype=np.int64)
    bound = np.partition(neg, k - 1)[k - 1]
    if np.isnan(bound):  # fewer than k values that are not NaN
        return np.argsort(neg, kind="stable")[:k]
    cand = np.flatnonzero(neg <= bound)
    return cand[np.argsort(neg[cand], kind="stable")][:k]


def expected_magnitude_importance(
    coefficients,
    mean_abs=None,
    index_map: Optional[IndexMap] = None,
) -> FeatureImportanceReport:
    """|β_j| · E|x_j| (ExpectedMagnitude...Diagnostic.scala:45-58)."""
    w = np.asarray(coefficients, dtype=np.float64)
    scale = np.ones_like(w) if mean_abs is None else np.asarray(mean_abs)
    return _build_report(
        np.abs(w * scale),
        index_map,
        "Inner product expectation",
        "Expected magnitude of inner product contribution"
        if mean_abs is not None
        else "Magnitude of feature coefficient",
    )


def variance_importance(
    coefficients,
    variance=None,
    index_map: Optional[IndexMap] = None,
) -> FeatureImportanceReport:
    """|β_j| · Var(x_j) (Variance...Diagnostic.scala:45-58)."""
    w = np.asarray(coefficients, dtype=np.float64)
    scale = np.ones_like(w) if variance is None else np.asarray(variance)
    return _build_report(
        np.abs(w * scale),
        index_map,
        "Inner product variance",
        "Expected inner product variance contribution"
        if variance is not None
        else "Magnitude of feature coefficient",
    )

"""Per-model metric maps.

Port of ``photon_ml_tpu/diagnostics/evaluation.py`` (reference
Evaluation.scala:31-160): regression metrics (RMSE, MAE, MSE), binary
classification metrics (ROC AUC, PR AUC, peak F1) and per-task
log-likelihoods (logistic, Poisson, squared, smoothed hinge), as host numpy
over (scores, labels, weights). The JAX module takes its AUC and losses
from the numpy twins in its ``evaluation/evaluators.py``; the port's
evaluators are torch, so this module keeps its own copies of the four.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from photon_ml_tpu_torch.types import TaskType

MetricsMap = Dict[str, float]

# metric names (reference Evaluation.scala:31-44)
ROOT_MEAN_SQUARED_ERROR = "RMSE"
MEAN_ABSOLUTE_ERROR = "MAE"
MEAN_SQUARED_ERROR = "MSE"
AREA_UNDER_ROC = "Area under ROC"
AREA_UNDER_PRECISION_RECALL = "Area under precision/recall"
PEAK_F1_SCORE = "Peak F1 score"
DATA_LOG_LIKELIHOOD = "Per-datum log likelihood"


def _np_auc(s: np.ndarray, y: np.ndarray, w: np.ndarray, order=None) -> float:
    """Rank-sum AUC with tie averaging and weights (the tie and weight
    semantics of ``evaluation.evaluators.area_under_roc_curve``); ``order``
    is ``np.argsort(s, kind="stable")`` when the caller has it."""
    pos_w = np.where(y > 0.5, w, 0.0)
    neg_w = np.where(y > 0.5, 0.0, w)
    if order is None:
        order = np.argsort(s, kind="stable")
    ss, pw, nw = s[order], pos_w[order], neg_w[order]
    is_new = np.concatenate([[True], ss[1:] != ss[:-1]])
    seg = np.cumsum(is_new) - 1
    seg_neg = np.bincount(seg, weights=nw)
    neg_below = np.cumsum(seg_neg)[seg] - seg_neg[seg]
    u = float(np.sum(pw * (neg_below + 0.5 * seg_neg[seg])))
    w_pos, w_neg = float(pw.sum()), float(nw.sum())
    return u / (w_pos * w_neg) if w_pos > 0 and w_neg > 0 else float("nan")


def _np_wmean(terms: np.ndarray, w: np.ndarray) -> float:
    return float(np.sum(np.where(w > 0, w * terms, 0.0)) / max(np.sum(w), 1e-30))


def _np_logistic(s, y, w):
    return _np_wmean(np.logaddexp(0.0, s) - y * s, w)


def _np_poisson(s, y, w):
    return _np_wmean(np.exp(s) - y * s, w)


def _np_smoothed_hinge(s, y, w):
    u = np.where(y > 0.5, 1.0, -1.0) * s
    terms = np.where(u >= 1, 0.0, np.where(u <= 0, 0.5 - u, 0.5 * (1 - u) ** 2))
    return _np_wmean(terms, w)


def _sigmoid(z: np.ndarray) -> np.ndarray:
    # the JAX module's tanh form in numpy (not torch.sigmoid), in the input's
    # precision: train_glm's Hosmer-Lemeshow bins are edges over these
    return 0.5 * (1.0 + np.tanh(0.5 * z))


def _descending(s: np.ndarray, ascending: np.ndarray) -> np.ndarray:
    """``np.argsort(-s, kind="stable")`` from ``ascending``, the stable
    ascending order of ``s``: its values that are not NaN reversed, each run
    of equal values turned back to index order, the NaNs last in index
    order (a sort's pass over the scores instead of a second sort)."""
    m = s.size - int(np.count_nonzero(np.isnan(s)))
    head = ascending[:m][::-1]
    if m == 0:
        return ascending.copy()
    v = s[head]
    new = np.empty(m, dtype=bool)
    new[0] = True
    np.not_equal(v[1:], v[:-1], out=new[1:])
    starts = np.flatnonzero(new)
    group = np.cumsum(new) - 1
    last = np.append(starts[1:], m) - 1
    # position p of the run [a, b] takes the run's entry at a + b - p
    src = starts[group] + last[group] - np.arange(m)
    return np.concatenate([head[src], ascending[m:]])


def _precision_recall_points(scores, labels, weights, order=None):
    """(precision, recall) at each distinct score threshold, descending
    (weighted; tied thresholds collapsed to their last cumulative point).
    Returns (None, None) with no positives. ``order`` is
    ``np.argsort(-scores, kind="stable")`` when the caller has it."""
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels, dtype=np.float64)
    w = np.ones_like(scores) if weights is None else np.asarray(weights, np.float64)
    pos = labels > 0.5
    total_pos = float(w[pos].sum())
    if total_pos == 0:
        return None, None
    if order is None:
        order = np.argsort(-scores, kind="stable")
    tp = np.cumsum(np.where(pos[order], w[order], 0.0))
    fp = np.cumsum(np.where(~pos[order], w[order], 0.0))
    s_sorted = scores[order]
    last_of_tie = np.append(s_sorted[1:] != s_sorted[:-1], True)
    tp, fp = tp[last_of_tie], fp[last_of_tie]
    precision = tp / np.maximum(tp + fp, 1e-30)
    recall = tp / total_pos
    return precision, recall


def _pr_auc(precision, recall) -> float:
    if precision is None:
        return float("nan")
    r = np.concatenate([[0.0], recall])
    p = np.concatenate([[precision[0] if len(precision) else 1.0], precision])
    return float(np.sum((r[1:] - r[:-1]) * (p[1:] + p[:-1]) / 2.0))


def _peak_f1(precision, recall) -> float:
    if precision is None:
        return float("nan")
    f1 = 2 * precision * recall / np.maximum(precision + recall, 1e-30)
    return float(np.max(f1))


def area_under_pr_curve(scores, labels, weights=None) -> float:
    """Weighted PR AUC by descending-score sweep (MLlib areaUnderPR
    semantics: trapezoid over (recall, precision), anchored at the first
    point's precision)."""
    return _pr_auc(*_precision_recall_points(scores, labels, weights))


def peak_f1(scores, labels, weights=None) -> float:
    """max_t F1(t) over all score thresholds (MLlib fMeasureByThreshold)."""
    return _peak_f1(*_precision_recall_points(scores, labels, weights))


def evaluate_metrics(
    scores,
    labels,
    task: TaskType,
    weights=None,
) -> MetricsMap:
    """Metric map for raw margins ``scores`` (offsets already added).

    Regression tasks report RMSE/MAE/MSE on the mean prediction; logistic
    adds ROC-AUC, PR-AUC and peak F1 on the margin; each task reports its
    per-datum loss as the log-likelihood proxy (Evaluation.scala:55-160).
    """
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels, dtype=np.float64)
    w = np.ones_like(scores) if weights is None else np.asarray(weights, np.float64)
    wsum = float(np.maximum(w.sum(), 1e-30))
    out: MetricsMap = {}

    if task is TaskType.LOGISTIC_REGRESSION:
        mean = _sigmoid(scores)
        # one sort serves the AUC and, turned around, the precision-recall
        # sweep, which serves both of its metrics (the JAX module sorts
        # three times)
        ascending = np.argsort(scores, kind="stable")
        out[AREA_UNDER_ROC] = _np_auc(scores, labels, w, ascending)
        points = _precision_recall_points(scores, labels, w, _descending(scores, ascending))
        out[AREA_UNDER_PRECISION_RECALL] = _pr_auc(*points)
        out[PEAK_F1_SCORE] = _peak_f1(*points)
        out[DATA_LOG_LIKELIHOOD] = -_np_logistic(scores, labels, w)
    elif task is TaskType.POISSON_REGRESSION:
        mean = np.exp(scores)
        out[DATA_LOG_LIKELIHOOD] = -_np_poisson(scores, labels, w)
    elif task is TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM:
        mean = scores
        out[DATA_LOG_LIKELIHOOD] = -_np_smoothed_hinge(scores, labels, w)
        out[AREA_UNDER_ROC] = _np_auc(scores, labels, w)
    else:
        mean = scores
        out[DATA_LOG_LIKELIHOOD] = -float(
            np.sum(w * (scores - labels) ** 2) / (2 * wsum)
        )

    err = mean - labels
    out[MEAN_SQUARED_ERROR] = float(np.sum(w * err * err) / wsum)
    out[ROOT_MEAN_SQUARED_ERROR] = float(np.sqrt(out[MEAN_SQUARED_ERROR]))
    out[MEAN_ABSOLUTE_ERROR] = float(np.sum(w * np.abs(err)) / wsum)
    return out

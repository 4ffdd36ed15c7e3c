"""Evaluators: AUC, RMSE/MSE/MAE, per-task losses, grouped metrics, P@k.

Port of ``photon_ml_tpu/evaluation/evaluators.py`` (reference
evaluation/Evaluator.scala:23, AreaUnderROCCurveLocalEvaluator.scala:25,
MultiEvaluator.scala:39, EvaluatorFactory.scala:22). Each metric is a
function on tensors, evaluated on the tensors' device in float64 so that a
metric does not depend on the order in which the device sums.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.losses.pointwise import (
    LogisticLoss,
    PoissonLoss,
    SmoothedHingeLoss,
    SquaredLoss,
)
from photon_ml_tpu_torch.types import TaskType


class EvaluatorType(enum.Enum):
    AUC = "AUC"
    RMSE = "RMSE"
    MSE = "MSE"
    MAE = "MAE"
    LOGISTIC_LOSS = "LOGISTIC_LOSS"
    POISSON_LOSS = "POISSON_LOSS"
    SQUARED_LOSS = "SQUARED_LOSS"
    SMOOTHED_HINGE_LOSS = "SMOOTHED_HINGE_LOSS"
    PRECISION_AT_K = "PRECISION_AT_K"


def area_under_roc_curve(
    scores: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """Rank-sum (Mann-Whitney) AUC with tie averaging, one sort; weighted
    ranks become cumulative weights. NaN when only one class is present."""
    pos_w = torch.where(labels > 0.5, weights, torch.zeros_like(weights))
    neg_w = torch.where(labels > 0.5, torch.zeros_like(weights), weights)
    s_sorted, order = torch.sort(scores, stable=True)
    pw, nw = pos_w[order], neg_w[order]
    # AUC = sum_i pw_i * (neg weight strictly below i + 0.5 * neg weight tied
    # with i) / (W_pos * W_neg); tie groups found after the sort
    is_new = torch.ones_like(s_sorted, dtype=torch.bool)
    is_new[1:] = s_sorted[1:] != s_sorted[:-1]
    seg = torch.cumsum(is_new.long(), 0) - 1
    # neg weight per group; an accumulating index_put_ repeats bitwise on the
    # card, where index_add_ adds with atomics
    seg_neg = torch.zeros_like(nw).index_put_((seg,), nw, accumulate=True)
    neg_below = torch.cumsum(seg_neg, 0)[seg] - seg_neg[seg]
    u = torch.sum(pw * (neg_below + 0.5 * seg_neg[seg]))
    w_pos, w_neg = pw.sum(), nw.sum()
    nan = torch.full_like(u, float("nan"))
    return torch.where((w_pos > 0) & (w_neg > 0), u / (w_pos * w_neg), nan)


def _weighted_mean(terms: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    num = torch.sum(torch.where(weights > 0, weights * terms, torch.zeros_like(terms)))
    return num / torch.clamp(torch.sum(weights), min=1e-30)


def _operands(scores, labels, weights):
    """(scores, labels, weights) as float64 tensors on the scores' device
    (numpy inputs go to the CPU); weights default to 1."""
    dev = scores.device if isinstance(scores, torch.Tensor) else torch.device("cpu")

    def f64(x):
        x = x if isinstance(x, torch.Tensor) else np.asarray(x)
        return torch.as_tensor(x, dtype=torch.float64, device=dev)

    s = f64(scores)
    return s, f64(labels), torch.ones_like(s) if weights is None else f64(weights)


def nan_aware_better_than(a: float, b: float, larger_is_better: bool = True) -> bool:
    """Is metric a better than b; any value beats NaN, NaN beats nothing
    (reference Evaluator.betterThan semantics)."""
    if b != b:
        return True
    if a != a:
        return False
    return a > b if larger_is_better else a < b


@dataclasses.dataclass(frozen=True)
class Evaluator:
    name: str
    fn: Callable  # (scores, labels, weights) -> 0-d tensor
    larger_is_better: bool = False

    def evaluate(self, scores, labels, weights=None) -> float:
        return float(self.fn(*_operands(scores, labels, weights)))

    def better_than(self, a: float, b: float) -> bool:
        """Is metric value a better than b (reference Evaluator.betterThan)."""
        return nan_aware_better_than(a, b, self.larger_is_better)


AUC = Evaluator("AUC", area_under_roc_curve, larger_is_better=True)
RMSE = Evaluator("RMSE", lambda s, y, w: torch.sqrt(_weighted_mean((s - y) ** 2, w)))
MSE = Evaluator("MSE", lambda s, y, w: _weighted_mean((s - y) ** 2, w))
MAE = Evaluator("MAE", lambda s, y, w: _weighted_mean(torch.abs(s - y), w))
LogisticLossEvaluator = Evaluator(
    "LOGISTIC_LOSS", lambda s, y, w: _weighted_mean(LogisticLoss.value(s, y), w)
)
PoissonLossEvaluator = Evaluator(
    "POISSON_LOSS", lambda s, y, w: _weighted_mean(PoissonLoss.value(s, y), w)
)
SquaredLossEvaluator = Evaluator(
    "SQUARED_LOSS", lambda s, y, w: _weighted_mean(SquaredLoss.value(s, y), w)
)
SmoothedHingeLossEvaluator = Evaluator(
    "SMOOTHED_HINGE_LOSS", lambda s, y, w: _weighted_mean(SmoothedHingeLoss.value(s, y), w)
)


def PrecisionAtK(k: int) -> Evaluator:
    """Precision@k: fraction of positives among the k highest scores."""

    def fn(scores, labels, weights):
        kk = min(k, scores.shape[0])
        top = torch.sort(-scores, stable=True).indices[:kk]
        return (labels[top] > 0.5).double().mean()

    return Evaluator(f"PRECISION@{k}", fn, larger_is_better=True)


@dataclasses.dataclass(frozen=True)
class MultiEvaluator:
    """Grouped metric: ``base`` per id-tag group, averaged over the groups
    where it is defined (reference MultiEvaluator.scala:49-64)."""

    base: Evaluator
    group_ids: tuple  # per-row group keys
    tag: Optional[str] = None

    @property
    def name(self) -> str:
        return f"{self.base.name}:{self.tag or 'grouped'}"

    def better_than(self, a: float, b: float) -> bool:
        return self.base.better_than(a, b)

    def evaluate(self, scores, labels, weights=None) -> float:
        s, y, w = _operands(scores, labels, weights)
        gids = np.asarray(self.group_ids)
        order = np.argsort(gids, kind="stable")
        sorted_gids = gids[order]
        starts = np.flatnonzero(
            np.concatenate([[True], sorted_gids[1:] != sorted_gids[:-1]])
        )
        ends = np.append(starts[1:], len(gids))
        order_t = torch.from_numpy(order).to(s.device)
        vals = []
        for a, b in zip(starts, ends):
            idx = order_t[a:b]
            v = float(self.base.fn(s[idx], y[idx], w[idx]))
            if v == v:  # skip NaN groups
                vals.append(v)
        return float(np.mean(vals)) if vals else float("nan")


def evaluator_for(etype: EvaluatorType, k: int = 10) -> Evaluator:
    """EvaluatorType -> implementation (reference EvaluatorFactory.scala:22)."""
    if etype is EvaluatorType.PRECISION_AT_K:
        return PrecisionAtK(k)
    return {
        EvaluatorType.AUC: AUC,
        EvaluatorType.RMSE: RMSE,
        EvaluatorType.MSE: MSE,
        EvaluatorType.MAE: MAE,
        EvaluatorType.LOGISTIC_LOSS: LogisticLossEvaluator,
        EvaluatorType.POISSON_LOSS: PoissonLossEvaluator,
        EvaluatorType.SQUARED_LOSS: SquaredLossEvaluator,
        EvaluatorType.SMOOTHED_HINGE_LOSS: SmoothedHingeLossEvaluator,
    }[etype]


def default_evaluator(task: TaskType) -> Evaluator:
    """Task -> default validation metric (reference GameEstimator default
    evaluators: AUC for logistic, RMSE for linear, Poisson loss for Poisson)."""
    return {
        TaskType.LOGISTIC_REGRESSION: AUC,
        TaskType.LINEAR_REGRESSION: RMSE,
        TaskType.POISSON_REGRESSION: PoissonLossEvaluator,
        TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: AUC,
    }[task]


def make_evaluator(spec: Optional[str], data):
    """'AUC', 'AUC:idTag', or 'PRECISION@k[:idTag]' → Evaluator /
    MultiEvaluator bound to the data's id tag (the string form of the
    reference's ``_make_evaluator``, cli/train_game.py)."""
    if not spec:
        return None
    name, _, tag = spec.partition(":")
    name = name.strip().upper()
    if name.startswith("PRECISION@"):
        try:
            k = int(name[len("PRECISION@"):])
        except ValueError:
            raise ValueError(
                f"bad precision@k spelling {name!r}; expected PRECISION@<int>"
            ) from None
        if k <= 0:
            raise ValueError(f"precision@k needs k >= 1, got {k}")
        base = PrecisionAtK(k)
    else:
        base = evaluator_for(EvaluatorType[name])
    if not tag:
        return base
    tag = tag.strip()
    ids = data.id_tags.get(tag)
    if ids is None:
        raise ValueError(f"data has no id tag '{tag}'")
    return MultiEvaluator(base=base, group_ids=tuple(ids), tag=tag)

"""Acquisition criteria for GP-guided search.

Reference parity: criteria/ExpectedImprovement.scala:* (PBO Eq. 1-2, sign
flipped by the evaluator's direction) and criteria/ConfidenceBound.scala:*
(UCB/LCB by direction; exploration factor scales √variance);
estimators/PredictionTransformation.scala:* is the shared interface.
"""

from __future__ import annotations

from typing import Callable, Protocol

import numpy as np
from scipy.stats import norm


class PredictionTransformation(Protocol):
    def __call__(
        self, predictive_means: np.ndarray, predictive_variances: np.ndarray
    ) -> np.ndarray: ...


class ExpectedImprovement:
    """Expected improvement over ``best_evaluation``.

    ``larger_is_better`` comes from the driving evaluator (AUC → True,
    RMSE → False), replacing the reference's ``evaluator.betterThan(1,-1)``
    direction probe.
    """

    def __init__(self, best_evaluation: float, larger_is_better: bool = True):
        self.best_evaluation = best_evaluation
        self.larger_is_better = larger_is_better

    def __call__(
        self, predictive_means: np.ndarray, predictive_variances: np.ndarray
    ) -> np.ndarray:
        std = np.sqrt(np.maximum(predictive_variances, 1e-18))
        direction = 1.0 if self.larger_is_better else -1.0
        gamma = direction * (predictive_means - self.best_evaluation) / std
        return std * (gamma * norm.cdf(gamma) + norm.pdf(gamma))


class ConfidenceBound:
    """Upper (maximizing) or lower (minimizing) confidence bound."""

    def __init__(self, larger_is_better: bool = True, exploration_factor: float = 2.0):
        self.larger_is_better = larger_is_better
        self.exploration_factor = exploration_factor

    def __call__(
        self, predictive_means: np.ndarray, predictive_variances: np.ndarray
    ) -> np.ndarray:
        bound = self.exploration_factor * np.sqrt(
            np.maximum(predictive_variances, 0.0)
        )
        if self.larger_is_better:
            return predictive_means + bound
        return predictive_means - bound

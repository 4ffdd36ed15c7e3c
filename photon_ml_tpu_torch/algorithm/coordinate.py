"""Coordinates: the per-block training units of GAME coordinate descent.

Port of ``photon_ml_tpu/algorithm/coordinate.py`` (reference
algorithm/Coordinate.scala:27 — updateModel with residual offsets :59-62;
FixedEffectCoordinate.scala:34; RandomEffectCoordinate.scala:39). A
coordinate owns its device-resident dataset and (a) trains its model
against residual offsets from all other coordinates, (b) scores every row
in the global row order. Both stay on the device: the residual arrives as
a device tensor and the scores leave as one.

Not ported: the multi-device grid padding of the fixed effect, the mesh
placement of random-effect buckets, and down-sampling (``sampler.py``,
ROADMAP.md Queue A).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_ml_tpu_torch.data.random_effect import RandomEffectDataset
from photon_ml_tpu_torch.estimators.random_effect import (
    score_random_effects_device,
    train_random_effects,
)
from photon_ml_tpu_torch.losses.objective import make_glm_objective
from photon_ml_tpu_torch.losses.pointwise import loss_for_task
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.models.random_effect import RandomEffectModel
from photon_ml_tpu_torch.ops.data import LabeledData
from photon_ml_tpu_torch.opt.config import GlmOptimizationConfiguration
from photon_ml_tpu_torch.opt.solve import solve
from photon_ml_tpu_torch.types import TaskType


def _check_down_sampling(configuration: GlmOptimizationConfiguration) -> None:
    if configuration.down_sampling_rate < 1.0:
        raise NotImplementedError(
            "down_sampling_rate < 1 needs sampler.py, which is not ported yet "
            "(ROADMAP.md, Queue A)"
        )


@dataclasses.dataclass
class FixedEffectCoordinate:
    """Global GLM over one feature shard (reference
    FixedEffectCoordinate.scala:34), solved by the batched L-BFGS with one
    lane. ``data`` carries the GAME-level base offsets; the residual scores
    are added on top per update."""

    data: LabeledData
    task: TaskType
    configuration: GlmOptimizationConfiguration
    # attach per-coefficient variances ~ 1/(H_jj + eps) to trained models
    # (reference COMPUTE_VARIANCE -> DistributedOptimizationProblem.scala:80-94)
    compute_variances: bool = False

    def __post_init__(self) -> None:
        _check_down_sampling(self.configuration)
        if self.data.norm is not None and not self.data.norm.is_identity:
            raise NotImplementedError(
                "a normalized fixed effect maps its coefficients back to the "
                "original space, which is not ported yet (ROADMAP.md, Queue A: "
                "build_normalization_context with stat/summary.py)"
            )

    def update_model_device(
        self, model: Optional[GeneralizedLinearModel], residual_scores: torch.Tensor
    ) -> GeneralizedLinearModel:
        data = self.data.with_offsets(self.data.offsets + residual_scores)
        objective = make_glm_objective(loss_for_task(self.task))
        if model is not None:
            w0 = model.coefficients.means.reshape(1, -1)
        else:
            w0 = torch.zeros((1, data.dim), dtype=torch.float32, device=data.labels.device)
        w = solve(objective, w0, data, self.configuration).w[0]
        variances = None
        if self.compute_variances:
            diag = objective.hessian_diag(w, data, self.configuration.l2_weight)
            variances = 1.0 / (diag + 1e-12)
        return GeneralizedLinearModel(
            coefficients=Coefficients(means=w, variances=variances), task=self.task
        )

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

    def __post_init__(self) -> None:
        _check_down_sampling(self.configuration)

    def update_model_device(
        self, model: Optional[RandomEffectModel], residual_scores: torch.Tensor
    ) -> RandomEffectModel:
        ds = self.dataset.update_offsets_device(self.base_offsets + residual_scores)
        return train_random_effects(
            ds, self.task, self.configuration, initial_model=model,
            compute_variances=self.compute_variances,
        )[0]

    def score_device(self, model: RandomEffectModel) -> torch.Tensor:
        return score_random_effects_device(model, self.dataset)

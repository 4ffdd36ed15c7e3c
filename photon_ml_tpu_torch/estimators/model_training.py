"""Single-GLM training: the warm-started regularization sweep.

Port of ``photon_ml_tpu/estimators/model_training.py`` (reference
ModelTraining.trainGeneralizedLinearModel, ModelTraining.scala:106-213): one
problem solved for each λ of a sweep sorted high → low, each fit
warm-started from the previous optimum (:160-206); optional per-coefficient
variances from the inverse Hessian diagonal
(DistributedOptimizationProblem.scala:80-94). The solve is one lane of the
batched solvers (L-BFGS, TRON or OWL-QN, ``opt.solve``); on the fused
sparse engine its maps are the ``csr_matvec_f32`` and ``csc_rmatvec_f32``
kernels, and the variances run ``csc_rmatvec_f32`` with the "sq"
transform.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.losses.objective import make_glm_objective
from photon_ml_tpu_torch.losses.pointwise import loss_for_task
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.ops.data import LabeledData
from photon_ml_tpu_torch.opt.config import GlmOptimizationConfiguration
from photon_ml_tpu_torch.opt.solve import solve
from photon_ml_tpu_torch.opt.state import SolveResult
from photon_ml_tpu_torch.types import TaskType


@dataclasses.dataclass
class GlmFit:
    """One trained model of a sweep."""

    regularization_weight: float
    model: GeneralizedLinearModel
    result: SolveResult  # one lane, in the training (normalized) space
    # per-iteration models in the original space, when ``track_models``
    # (the reference's ModelTracker)
    tracked_models: Optional[List[GeneralizedLinearModel]] = None


def _normalized_box(box_constraints, data: LabeledData, intercept_index):
    """Per-feature (lower, upper) of the original space → the training
    space: w_orig = factor ∘ w_norm with factor > 0, so the bounds divide by
    the same factor. A shift mixes the intercept with every coefficient, so
    a bounded intercept under shift normalization is refused."""
    lo, hi = (torch.as_tensor(np.asarray(b, dtype=np.float32), device=data.labels.device)
              for b in box_constraints)
    norm = data.norm
    if norm is None:
        return lo, hi
    if norm.shift is not None and intercept_index is not None:
        if bool(torch.isfinite(lo[intercept_index])) or bool(torch.isfinite(hi[intercept_index])):
            raise ValueError(
                "an intercept box constraint cannot be combined with "
                "shift normalization (the intercept mixes all "
                "coefficients there); constrain only non-intercept "
                "features or use a factor-only normalization"
            )
    if norm.factor is not None:
        lo, hi = lo / norm.factor, hi / norm.factor
    return lo, hi


def train_glm(
    data: LabeledData,
    task: TaskType,
    configuration: GlmOptimizationConfiguration,
    regularization_weights: Optional[Sequence[float]] = None,
    initial_model: Optional[GeneralizedLinearModel] = None,
    warm_start: bool = True,
    compute_variances: bool = False,
    track_models: bool = False,
    intercept_index: Optional[int] = None,
    box_constraints=None,
) -> List[GlmFit]:
    """Train one GLM per regularization weight, warm-starting down the sweep
    sorted high → low; fits come back in the caller's order.

    Models carry original-space coefficients: with ``data.norm`` training
    runs in the normalized space, the warm start is mapped into it and the
    optimum (and variances, tracked models) back. ``box_constraints`` =
    per-feature (lower [d], upper [d]) in the original space (the
    reference's constraint map); the configuration's scalar bounds apply
    without it.
    """
    objective = make_glm_objective(loss_for_task(task))
    if regularization_weights is None:
        regularization_weights = [configuration.regularization_weight]
    if track_models:
        configuration = dataclasses.replace(
            configuration,
            optimizer_config=dataclasses.replace(
                configuration.optimizer_config, track_coefficients=True
            ),
        )
    device = data.labels.device
    norm = data.norm
    if initial_model is not None:
        w = initial_model.coefficients.means.to(device, torch.float32)
        if norm is not None:
            w = norm.inverse_transform_model_coefficients(w, intercept_index)
    else:
        w = torch.zeros(data.dim, dtype=torch.float32, device=device)
    box = (None if box_constraints is None
           else _normalized_box(box_constraints, data, intercept_index))

    reg = configuration.regularization
    # an explicit 0 pins L-BFGS/TRON where no weight of the sweep has L1
    # (a λ = 0 inside an L1 sweep solves its smooth problem by L-BFGS here,
    # where the reference runs OWL-QN with a zero weight)
    use_l1 = any(reg.l1_weight(lam) > 0 for lam in regularization_weights)

    def to_original(w_i: torch.Tensor) -> torch.Tensor:
        return w_i if norm is None else norm.transform_model_coefficients(w_i, intercept_index)

    fits = {}
    for lam in sorted(regularization_weights, reverse=True):
        l2 = reg.l2_weight(lam)
        result = solve(
            objective, w.reshape(1, -1), data, configuration, l2_weight=l2,
            l1_weight=reg.l1_weight(lam) if use_l1 else 0.0, box=box,
        )
        if warm_start:
            w = result.w[0]
        variances = None
        if compute_variances:
            # var_j ≈ 1 / (H_jj + eps) (reference
            # DistributedOptimizationProblem.scala:80-94)
            variances = 1.0 / (objective.hessian_diag(result.w[0], data, l2) + 1e-12)
            if norm is not None:
                variances = norm.transform_model_variances(variances, intercept_index)
        model = GeneralizedLinearModel(
            coefficients=Coefficients(means=to_original(result.w[0]), variances=variances),
            task=task,
        )
        tracked = None
        if track_models:
            iters = int(result.iterations[0])
            tracked = [
                GeneralizedLinearModel(coefficients=Coefficients(means=to_original(w_i)),
                                       task=task)
                for w_i in result.w_history[0, : iters + 1]
            ]
        fits[lam] = GlmFit(
            regularization_weight=lam, model=model, result=result, tracked_models=tracked
        )
    return [fits[lam] for lam in regularization_weights]

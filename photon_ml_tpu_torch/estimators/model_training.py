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

Over a (data x feat) device grid (``parallel.GridShardedFeatures``) the
solve runs on ``parallel.mesh.BlockVector``s, as the JAX package's
runs on sharded arrays: w, the gradient, the directions, the trial
points, the box bounds, the normalization's factor and shift and the s/y
rings are feat blocks of ``d_loc`` on the grid's feat columns, the row
arrays data blocks of ``n_loc``. A model's means are made whole only
after the solve (its first ``model_dim`` entries); ``GlmFit.blocks`` keeps
the blocks for the caller's warm start and scoring.
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
    # on a device grid: the model's original-space means as the solve left
    # them, feat blocks of the padded length (None off a grid)
    blocks: Optional[object] = None


def _grid_of(data: LabeledData):
    """The data's grid features, or None off a grid."""
    from photon_ml_tpu_torch.parallel.grid_features import GridShardedFeatures

    return data.features if isinstance(data.features, GridShardedFeatures) else None


def _on_grid(data: LabeledData, grid) -> LabeledData:
    """The row arrays as data blocks and the normalization's factor and
    shift as feat blocks (a no-op for what is placed already)."""
    norm = data.norm
    if norm is not None:
        norm = dataclasses.replace(norm, **{
            k: grid.feat_vector(getattr(norm, k)) for k in ("factor", "shift")
            if getattr(norm, k) is not None})
    return dataclasses.replace(
        data, labels=grid.data_vector(data.labels), offsets=grid.data_vector(data.offsets),
        weights=grid.data_vector(data.weights), norm=norm)


def _normalized_box(box_constraints, data: LabeledData, intercept_index, grid=None):
    """Per-feature (lower, upper) of the original space → the training
    space: w_orig = factor ∘ w_norm with factor > 0, so the bounds divide by
    the same factor. A shift mixes the intercept with every coefficient, so
    a bounded intercept under shift normalization is refused. On a grid
    the bounds become feat blocks."""
    lo, hi = (torch.as_tensor(np.asarray(b, dtype=np.float32), device=data.labels.device)
              for b in box_constraints)
    if grid is not None:
        lo, hi = grid.feat_vector(lo.cpu()), grid.feat_vector(hi.cpu())
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
    model_dim: Optional[int] = None,
) -> List[GlmFit]:
    """Train one GLM per regularization weight, warm-starting down the sweep
    sorted high → low; fits come back in the caller's order.

    Models carry original-space coefficients: with ``data.norm`` training
    runs in the normalized space, the warm start is mapped into it and the
    optimum (and variances, tracked models) back. ``box_constraints`` =
    per-feature (lower [d], upper [d]) in the original space (the
    reference's constraint map); the configuration's scalar bounds apply
    without it. ``model_dim`` keeps the models' first coefficients only
    (a grid's padding columns dropped).
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
    grid = _grid_of(data)
    if grid is not None:
        data = _on_grid(data, grid)
    device = data.labels.device
    norm = data.norm
    if initial_model is not None:
        w = initial_model.coefficients.means
        w = grid.feat_vector(w) if grid is not None else w.to(device, torch.float32)
        if norm is not None:
            w = norm.inverse_transform_model_coefficients(w, intercept_index)
    elif grid is not None:
        w = grid.feat_full(0.0)
    else:
        w = torch.zeros(data.dim, dtype=torch.float32, device=device)
    box = (None if box_constraints is None
           else _normalized_box(box_constraints, data, intercept_index, grid))

    reg = configuration.regularization
    # an explicit 0 pins L-BFGS/TRON where no weight of the sweep has L1
    # (a λ = 0 inside an L1 sweep solves its smooth problem by L-BFGS here,
    # where the reference runs OWL-QN with a zero weight)
    use_l1 = any(reg.l1_weight(lam) > 0 for lam in regularization_weights)

    def to_original(w_i: torch.Tensor) -> torch.Tensor:
        return w_i if norm is None else norm.transform_model_coefficients(w_i, intercept_index)

    def whole(x):
        """A model's vector: a grid's blocks made whole, its first
        ``model_dim`` entries."""
        if grid is not None:
            return x.full(length=model_dim)
        return x if model_dim is None else x[:model_dim]

    fits = {}
    for lam in sorted(regularization_weights, reverse=True):
        l2 = reg.l2_weight(lam)
        result = solve(
            objective, w.unsqueeze(0), data, configuration, l2_weight=l2,
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
        means = to_original(result.w[0])
        model = GeneralizedLinearModel(
            coefficients=Coefficients(
                means=whole(means), variances=None if variances is None else whole(variances)),
            task=task,
        )
        tracked = None
        if track_models:
            iters = int(result.iterations[0])
            hist = result.w_history[0]
            tracked = [
                GeneralizedLinearModel(coefficients=Coefficients(means=whole(to_original(hist[i]))),
                                       task=task)
                for i in range(iters + 1)
            ]
        fits[lam] = GlmFit(
            regularization_weight=lam, model=model, result=result, tracked_models=tracked,
            blocks=means if grid is not None else None,
        )
    return [fits[lam] for lam in regularization_weights]

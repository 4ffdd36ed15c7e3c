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

A random effect with ``overlap_buckets >= 2`` (set under the async
schedule) solves its buckets at once on worker streams.

Telemetry spans (the JAX package's names): ``fe/solve`` (with a
current-stream barrier) around a fixed-effect update, ``re/train`` around
a random effect's bucket solves.

On a (data x feat) device grid (``estimators.game.ParallelConfiguration``)
a fixed effect trains over ``parallel.GridShardedFeatures``, whose rows and
columns are padded to the grid, with its row arrays as data blocks and
its solve vector as feat blocks (``parallel.mesh.BlockVector``): the
coordinate keeps the padded solve vector in those blocks between outer
iterations (the JAX ``_w_padded_cache``), scores from it, and speaks real
shapes at its boundary (models of ``num_real_cols`` coefficients,
``num_real_rows`` scores), the only place a whole vector is made. A
random effect given a ``mesh`` solves each bucket's entity slices where
``data.random_effect.place_dataset`` put them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.data.random_effect import RandomEffectDataset
from photon_ml_tpu_torch.estimators.model_training import train_glm
from photon_ml_tpu_torch.estimators.random_effect import (
    score_random_effects_device,
    train_random_effects,
)
from photon_ml_tpu_torch.models.coefficients import Coefficients
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
from photon_ml_tpu_torch.telemetry.span import span
from photon_ml_tpu_torch.types import TaskType


def _host(x) -> np.ndarray:
    """A row array (a tensor or a grid's data blocks) on the host."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x.full("cpu").numpy()


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
    # a grid layout pads the batch and the feature axis; the coordinate
    # speaks real shapes at its boundary (models of num_real_cols
    # coefficients, num_real_rows scores)
    num_real_rows: Optional[int] = None
    num_real_cols: Optional[int] = None

    last_tracker: Optional[FixedEffectOptimizationTracker] = dataclasses.field(
        default=None, repr=False
    )
    # (model, padded solve vector) of the model last returned: warm starts
    # and scoring of that model reuse the padded vector (on a grid, its
    # feat blocks). Keyed by identity through the strong reference.
    _w_padded_cache: Optional[tuple] = dataclasses.field(default=None, init=False, repr=False)
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
            weights = torch.from_numpy(down_sampler_for(self.task, rate).sample_weights(
                _host(self.data.labels), _host(self.data.weights),
                seed=self.down_sampling_seed,
            ))
            grid = self._grid()
            self._sampled_weights = (grid.data_vector(weights) if grid is not None
                                     else weights.to(self.data.weights.device))
        return self._sampled_weights

    def _grid(self):
        """The grid features, or None off a grid."""
        return self.data.features if self.num_real_cols is not None else None

    def update_model_device(
        self, model: Optional[GeneralizedLinearModel], residual_scores: torch.Tensor
    ) -> GeneralizedLinearModel:
        """Solve against the residual offsets; models carry original-space
        coefficients (``train_glm``). Traced as ``fe/solve``."""
        with span("fe/solve", device_sync=True,
                  optimizer=self.configuration.optimizer_config.optimizer.name):
            n_pad = self.data.labels.shape[0]
            if residual_scores.shape[0] < n_pad:
                residual_scores = torch.nn.functional.pad(
                    residual_scores, (0, n_pad - residual_scores.shape[0]))
            grid = self._grid()
            if grid is not None:
                residual_scores = grid.data_vector(residual_scores)
            data = dataclasses.replace(
                self.data, offsets=self.data.offsets + residual_scores, weights=self._weights()
            )
            fit = train_glm(
                data, self.task, self.configuration, initial_model=self._pad_model(model),
                compute_variances=self.compute_variances, intercept_index=self.intercept_index,
                model_dim=self.num_real_cols,
            )[0]
            self.last_tracker = FixedEffectOptimizationTracker(
                states=OptimizationStatesTracker.from_result(fit.result)
            )
            if grid is not None:
                self._w_padded_cache = (fit.model, fit.blocks)
            return fit.model

    def _pad_model(self, model: Optional[GeneralizedLinearModel]):
        """A warm start of real [d] coefficients in the padded [d_pad]
        solve space (zeros for the padding columns)."""
        if model is None or self.num_real_cols is None:
            return model
        return dataclasses.replace(model, coefficients=Coefficients(means=self._padded_w(model)))

    def _padded_w(self, model: GeneralizedLinearModel):
        """The padded solve-space vector of ``model`` as feat blocks, cached
        by identity: the blocks of the model this coordinate returned, or,
        for a model from elsewhere (a warm start, a checkpoint), its
        coefficients padded once and placed."""
        cached = self._w_padded_cache
        if cached is not None and cached[0] is model:
            return cached[1]
        w = model.coefficients.means
        if self.num_real_cols is not None:
            if w.shape[0] < self.data.dim:
                w = torch.nn.functional.pad(w, (0, self.data.dim - w.shape[0]))
            w = self._grid().feat_vector(w)
        self._w_padded_cache = (model, w)
        return w

    def score_device(self, model: GeneralizedLinearModel) -> torch.Tensor:
        scores = self.data.features.matvec(self._padded_w(model))
        if self.num_real_rows is not None:
            scores = scores.full(length=self.num_real_rows)
        return scores


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
    # the async schedule's RE leg: buckets solved at once (0 or 1: in turn);
    # set by GameEstimator for every fit
    overlap_buckets: int = 0
    # a device mesh: each bucket's entity axis is split over every device
    # of it (independent per-entity solves, no reduction); the dataset is
    # placed by GameEstimator (data.random_effect.place_dataset)
    mesh: Optional[object] = None
    mesh_axes: Optional[tuple] = None
    last_tracker: Optional[RandomEffectOptimizationTracker] = dataclasses.field(
        default=None, repr=False
    )
    last_solver_stats: list = dataclasses.field(default_factory=list, repr=False)

    def update_model_device(
        self, model: Optional[RandomEffectModel], residual_scores: torch.Tensor
    ) -> RandomEffectModel:
        ds = self.dataset.update_offsets_device(self.base_offsets + residual_scores)
        stats: list = []
        with span("re/train", buckets=len(ds.buckets)):
            new_model, results = train_random_effects(
                ds, self.task, self.configuration, initial_model=model,
                compute_variances=self.compute_variances, stats_out=stats,
                overlap_buckets=self.overlap_buckets,
            )
        self.last_solver_stats = stats
        # entity lanes beyond the real ids (mesh padding) carry zero weights
        # and no valid projection: their solves are trivial and the
        # telemetry excludes them
        self.last_tracker = RandomEffectOptimizationTracker.from_results(
            results, real_counts=[len(ids) for ids in ds.entity_ids]
        )
        return new_model

    def score_device(self, model: RandomEffectModel) -> torch.Tensor:
        return score_random_effects_device(model, self.dataset)

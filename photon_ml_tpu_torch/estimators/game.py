"""GameEstimator: fit() for GAME/GLMix models.

Port of ``photon_ml_tpu/estimators/game.py`` (reference
estimators/GameEstimator.scala:52): build each coordinate's dataset once
(entity grouping, projection, sparse layouts — prepareTrainingDataSets
:292-343), run block coordinate descent with the sync schedule, evaluate
validation data after every coordinate update, keep the best model by the
evaluator. Everything runs on ``device`` (default ``cuda``; raises without
a card unless ``device="cpu"``).

Fixed effects may train normalized (``normalization`` per feature shard,
reference prepareNormalizationContexts); random effects train unnormalized,
as in the reference.

Not ported (ROADMAP.md, Queue A: The rest of training, factored random
effects, streaming): ``fit_streaming``, ``fit_multiple`` and tuning,
checkpoints, the async schedule, the device mesh, factored random effects
and ``resolve_coordinate``.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from photon_ml_tpu_torch.algorithm.coordinate import (
    FixedEffectCoordinate,
    RandomEffectCoordinate,
)
from photon_ml_tpu_torch.algorithm.coordinate_descent import CoordinateDescent
from photon_ml_tpu_torch.data.game_data import GameData
from photon_ml_tpu_torch.data.random_effect import (
    RandomEffectDataConfiguration,
    build_random_effect_dataset,
)
from photon_ml_tpu_torch.device import DEFAULT_DEVICE, DeviceLike, resolve_device
from photon_ml_tpu_torch.evaluation.evaluators import default_evaluator
from photon_ml_tpu_torch.losses.pointwise import loss_for_task
from photon_ml_tpu_torch.models.game import CoordinateMeta, GameModel
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.models.random_effect import RandomEffectModel
from photon_ml_tpu_torch.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.data import LabeledData
from photon_ml_tpu_torch.opt.config import GlmOptimizationConfiguration
from photon_ml_tpu_torch.types import TaskType

logger = logging.getLogger("photon_ml_tpu_torch")


@dataclasses.dataclass(frozen=True)
class FixedEffectCoordinateConfiguration:
    """Reference FixedEffectDataConfiguration + per-coordinate optimizer."""

    feature_shard: str
    optimizer: GlmOptimizationConfiguration = GlmOptimizationConfiguration()
    # sparse engine for the global problem: "auto" | "ell" | "fused" |
    # "benes" (GameData.sparse_features; "auto" picks the fused kernels on
    # the card for a shard of at least 2^20 nonzeros)
    sparse_engine: str = "auto"


@dataclasses.dataclass(frozen=True)
class RandomEffectCoordinateConfiguration:
    feature_shard: str
    data: RandomEffectDataConfiguration
    optimizer: GlmOptimizationConfiguration = GlmOptimizationConfiguration()


CoordinateConfiguration = Union[
    FixedEffectCoordinateConfiguration, RandomEffectCoordinateConfiguration
]


@dataclasses.dataclass
class GameFit:
    model: GameModel
    validation_metric: Optional[float]
    objective_history: List[Tuple[str, float]]
    validation_history: List[Tuple[str, float]]
    # seconds of each coordinate update, in update order
    update_seconds: List[Tuple[str, float]] = dataclasses.field(default_factory=list)


def _coordinate_regularization(model, coord) -> float:
    """One coordinate's 0.5·l2·‖w‖² + l1·‖w‖₁ over its current model
    (reference getRegularizationTermValue); one scalar to the host."""
    opt = coord.configuration

    def term(a: torch.Tensor) -> torch.Tensor:
        return 0.5 * opt.l2_weight * (a * a).sum() + opt.l1_weight * a.abs().sum()

    if isinstance(model, GeneralizedLinearModel):
        return float(term(model.coefficients.means))
    if isinstance(model, RandomEffectModel):
        return float(sum(term(c) for c in model.coefficients))
    return 0.0


class GameEstimator:
    def __init__(
        self,
        task: TaskType,
        coordinates: Dict[str, CoordinateConfiguration],
        update_order: Optional[Sequence[str]] = None,
        num_outer_iterations: int = 1,
        evaluator=None,
        extra_evaluators: Sequence = (),
        compute_variance: bool = False,
        normalization: Optional[Dict[str, NormalizationContext]] = None,
        intercept_indices: Optional[Dict[str, Optional[int]]] = None,
        device: DeviceLike = DEFAULT_DEVICE,
        emitter=None,
    ) -> None:
        """``evaluator`` selects the best model (default by task);
        ``extra_evaluators`` are computed and logged per coordinate update
        (reference CoordinateDescent.scala:283-293) without affecting the
        choice. ``normalization`` and ``intercept_indices`` are per feature
        shard and apply to fixed-effect coordinates: their solves run in the
        normalized space and the models hold original-space coefficients.
        ``emitter`` (an ``event.EventEmitter``) receives the random-effect
        solver stats of every update."""
        if not coordinates:
            raise ValueError("need at least one coordinate configuration")
        for cid, cfg in coordinates.items():
            if not isinstance(
                cfg, (FixedEffectCoordinateConfiguration, RandomEffectCoordinateConfiguration)
            ):
                raise NotImplementedError(
                    f"coordinate {cid!r}: {type(cfg).__name__} is not ported yet "
                    "(ROADMAP.md, Queue A: Factored random effects)"
                )
        self.task = task
        self.coordinate_configs = dict(coordinates)
        self.update_order = list(update_order) if update_order else list(coordinates)
        self.num_outer_iterations = num_outer_iterations
        self.evaluator = evaluator or default_evaluator(task)
        self.extra_evaluators = list(extra_evaluators)
        self.compute_variance = compute_variance
        self.normalization = dict(normalization or {})
        self.intercept_indices = dict(intercept_indices or {})
        self.device = resolve_device(device)
        self.emitter = emitter

    def _build_coordinate(self, cid: str, cfg: CoordinateConfiguration, data: GameData):
        dev = self.device
        if isinstance(cfg, FixedEffectCoordinateConfiguration):
            labeled = LabeledData.create(
                data.sparse_features(cfg.feature_shard, engine=cfg.sparse_engine, device=dev),
                torch.from_numpy(data.labels).to(dev),
                offsets=torch.from_numpy(data.offsets).to(dev),
                weights=torch.from_numpy(data.weights).to(dev),
                norm=self.normalization.get(cfg.feature_shard),
            )
            return FixedEffectCoordinate(
                data=labeled, task=self.task, configuration=cfg.optimizer,
                intercept_index=self.intercept_indices.get(cfg.feature_shard),
                compute_variances=self.compute_variance,
            )
        shard = data.feature_shards[cfg.feature_shard]
        re_ds = build_random_effect_dataset(
            data.id_tags[cfg.data.random_effect_type],
            shard.rows, shard.cols, shard.vals, shard.dim,
            data.labels, cfg.data,
            offsets=data.offsets, weights=data.weights, device=dev,
        )
        logger.info("[%s] %s", cid, re_ds.to_summary_string())
        return RandomEffectCoordinate(
            dataset=re_ds, task=self.task, configuration=cfg.optimizer,
            base_offsets=torch.from_numpy(data.offsets).to(dev),
            compute_variances=self.compute_variance,
        )

    def build_coordinates(self, data: GameData) -> Dict[str, object]:
        """Every coordinate's device-resident dataset, built once."""
        return {
            cid: self._build_coordinate(cid, cfg, data)
            for cid, cfg in self.coordinate_configs.items()
        }

    def _meta(self) -> Dict[str, CoordinateMeta]:
        meta = {}
        for cid, cfg in self.coordinate_configs.items():
            if isinstance(cfg, FixedEffectCoordinateConfiguration):
                meta[cid] = CoordinateMeta(
                    feature_shard=cfg.feature_shard, sparse_engine=cfg.sparse_engine
                )
            else:
                meta[cid] = CoordinateMeta(
                    feature_shard=cfg.feature_shard,
                    random_effect_type=cfg.data.random_effect_type,
                )
        return meta

    def fit(
        self,
        data: GameData,
        validation_data: Optional[GameData] = None,
        initial_models: Optional[Dict[str, object]] = None,
        coordinates: Optional[Dict[str, object]] = None,
    ) -> GameFit:
        """Train by block coordinate descent; ``initial_models`` warm-start
        coordinates (models of the same datasets); ``coordinates`` reuses
        datasets from :meth:`build_coordinates`."""
        if coordinates is None:
            coordinates = self.build_coordinates(data)
        return self._run_fit(coordinates, data, validation_data, initial_models)

    def _run_fit(self, coordinates, data, validation_data, initial_models) -> GameFit:
        dev = self.device
        meta = self._meta()
        loss = loss_for_task(self.task)
        labels = torch.from_numpy(data.labels).to(dev)
        weights = torch.from_numpy(data.weights).to(dev)
        offsets = torch.from_numpy(data.offsets).to(dev)

        def training_objective(total_scores: torch.Tensor) -> float:
            z = offsets + total_scores
            terms = loss.value(z, labels)
            return float(torch.where(weights > 0, weights * terms, torch.zeros_like(terms)).sum())

        # keyed by model identity: only the coordinate that just updated
        # recomputes its term
        reg_cache: Dict[str, Tuple[object, float]] = {}

        def regularization_term(models: Dict[str, object]) -> float:
            total = 0.0
            for cid, m in models.items():
                cached = reg_cache.get(cid)
                if cached is None or cached[0] is not m:
                    reg_cache[cid] = (m, _coordinate_regularization(m, coordinates[cid]))
                total += reg_cache[cid][1]
            return total

        validate = None
        if validation_data is not None:
            val_offsets = torch.from_numpy(validation_data.offsets).to(dev)

            def validate(models: Dict[str, object]) -> float:
                gm = GameModel(models=dict(models), meta={c: meta[c] for c in models},
                               task=self.task)
                scores = gm.score(validation_data) + val_offsets
                primary = self.evaluator.evaluate(
                    scores, validation_data.labels, validation_data.weights
                )
                if self.extra_evaluators:
                    logger.info(
                        "validation metrics: %s=%.6f %s", self.evaluator.name, primary,
                        " ".join(
                            f"{ev.name}={ev.evaluate(scores, validation_data.labels, validation_data.weights):.6f}"
                            for ev in self.extra_evaluators
                        ),
                    )
                return primary

        cd = CoordinateDescent(
            coordinates,
            num_rows=data.num_rows,
            device=dev,
            update_order=self.update_order,
            training_objective=training_objective,
            regularization_term=regularization_term,
            validate=validate,
            validation_better_than=self.evaluator.better_than,
            emitter=self.emitter,
        )
        result = cd.run(self.num_outer_iterations, initial_models=initial_models)
        return GameFit(
            model=GameModel(models=result.best_models, meta=meta, task=self.task),
            validation_metric=result.best_metric,
            objective_history=result.objective_history,
            validation_history=result.validation_history,
            update_seconds=cd.update_seconds,
        )

"""GameEstimator: fit() for GAME/GLMix models.

Port of ``photon_ml_tpu/estimators/game.py`` (reference
estimators/GameEstimator.scala:52): build each coordinate's dataset once
(entity grouping, projection, sparse layouts — prepareTrainingDataSets
:292-343), run block coordinate descent with the sync schedule, evaluate
validation data after every coordinate update, keep the best model by the
evaluator. Everything runs on ``device`` (default ``cuda``; raises without
a card unless ``device="cpu"``).

Coordinates are fixed effects, random effects and factored random effects
(per-entity latent factors and a learned projection matrix,
``algorithm/factored_random_effect.py``). Fixed effects may train
normalized (``normalization`` per feature shard, reference
prepareNormalizationContexts); random effects train unnormalized, as in the
reference. With ``checkpoint_dir`` the training state is written after
every outer iteration (``checkpoint.py``) and a checkpoint found there is
resumed.

Not ported (ROADMAP.md, Queue A: The rest of training, streaming):
``fit_streaming``, ``fit_multiple`` and tuning, the async schedule, the
device mesh and ``resolve_coordinate``.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from photon_ml_tpu_torch import checkpoint as ckpt
from photon_ml_tpu_torch.algorithm.coordinate import (
    FixedEffectCoordinate,
    RandomEffectCoordinate,
)
from photon_ml_tpu_torch.algorithm.coordinate_descent import CoordinateDescent
from photon_ml_tpu_torch.algorithm.factored_random_effect import (
    FactoredRandomEffectCoordinate,
    FactoredRandomEffectModel,
    MFOptimizationConfiguration,
)
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


@dataclasses.dataclass(frozen=True)
class FactoredRandomEffectCoordinateConfiguration:
    """Reference FactoredRandomEffectOptimizationProblem.scala:42: a latent
    random-effect problem and a projection-matrix problem, and the MF
    configuration; ``matrix_optimizer`` defaults to ``optimizer``."""

    feature_shard: str
    data: RandomEffectDataConfiguration
    mf: MFOptimizationConfiguration
    optimizer: GlmOptimizationConfiguration = GlmOptimizationConfiguration()
    matrix_optimizer: Optional[GlmOptimizationConfiguration] = None


CoordinateConfiguration = Union[
    FixedEffectCoordinateConfiguration,
    RandomEffectCoordinateConfiguration,
    FactoredRandomEffectCoordinateConfiguration,
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
    (reference getRegularizationTermValue); a factored model adds the
    latent factors' term and the projection matrix's, each under its own
    configuration. One scalar to the host."""

    def term(a: torch.Tensor, opt: GlmOptimizationConfiguration) -> torch.Tensor:
        return 0.5 * opt.l2_weight * (a * a).sum() + opt.l1_weight * a.abs().sum()

    if isinstance(model, FactoredRandomEffectModel):
        total = sum(term(c, coord.re_configuration) for c in model.latent.coefficients)
        return float(total + term(model.projection_matrix, coord.matrix_configuration))
    if isinstance(model, GeneralizedLinearModel):
        return float(term(model.coefficients.means, coord.configuration))
    if isinstance(model, RandomEffectModel):
        return float(sum(term(c, coord.configuration) for c in model.coefficients))
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
        solver stats of every update. Variances (``compute_variance``) are
        attached to fixed- and random-effect models, not to factored ones
        (they do not carry back through the projection)."""
        if not coordinates:
            raise ValueError("need at least one coordinate configuration")
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
        if isinstance(cfg, FactoredRandomEffectCoordinateConfiguration):
            return FactoredRandomEffectCoordinate(
                dataset=re_ds, task=self.task, re_configuration=cfg.optimizer,
                matrix_configuration=cfg.matrix_optimizer or cfg.optimizer,
                mf_configuration=cfg.mf,
                base_offsets=torch.from_numpy(data.offsets).to(dev),
            )
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

    @staticmethod
    def _check_resume_compatible(
        models: Dict[str, object], coordinates: Dict[str, object], require_all: bool = True
    ) -> None:
        """Fail fast, with a clear message, when a checkpoint's (or warm
        start's) layout does not match the datasets rebuilt from the current
        data and configuration."""
        problems = []
        for cid, model in models.items():
            coord = coordinates.get(cid)
            if coord is None:
                problems.append(f"{cid}: not in current configuration")
                continue
            if isinstance(model, GeneralizedLinearModel):
                if not isinstance(coord, FixedEffectCoordinate):
                    problems.append(
                        f"{cid}: checkpoint holds a fixed-effect model but the "
                        f"coordinate is now configured as {type(coord).__name__}"
                    )
                elif model.dim != coord.data.dim:
                    problems.append(
                        f"{cid}: checkpoint dim {model.dim} != data dim {coord.data.dim}"
                    )
                continue
            latent = getattr(model, "latent", model)
            if not isinstance(latent, RandomEffectModel):
                continue
            if latent.entity_ids != coord.dataset.entity_ids:
                problems.append(
                    f"{cid}: checkpoint entity layout differs from the dataset "
                    "rebuilt from the current data/config"
                )
        if require_all and set(coordinates) - set(models):
            missing = sorted(set(coordinates) - set(models))
            problems.append(f"coordinates missing from checkpoint: {missing}")
        if problems:
            raise ValueError(
                "checkpoint is incompatible with this run — it was written for "
                "different data or configuration:\n  " + "\n  ".join(problems)
            )

    def fit(
        self,
        data: GameData,
        validation_data: Optional[GameData] = None,
        initial_models: Optional[Dict[str, object]] = None,
        coordinates: Optional[Dict[str, object]] = None,
        checkpoint_dir: Optional[str] = None,
    ) -> GameFit:
        """Train by block coordinate descent; ``initial_models`` warm-start
        coordinates (models of the same datasets); ``coordinates`` reuses
        datasets from :meth:`build_coordinates`. With ``checkpoint_dir`` the
        training state is written atomically after every outer iteration,
        and a checkpoint already there is resumed (its completed iterations
        skipped; it takes precedence over ``initial_models``)."""
        if coordinates is None:
            coordinates = self.build_coordinates(data)
        return self._run_fit(coordinates, data, validation_data, initial_models, checkpoint_dir)

    def _run_fit(
        self, coordinates, data, validation_data, initial_models, checkpoint_dir=None
    ) -> GameFit:
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
        start_iteration, initial_best, on_iteration_end = 0, None, None
        prior_objectives: List[Tuple[str, float]] = []
        prior_validations: List[Tuple[str, float]] = []
        if initial_models is not None:
            # a warm start may cover a subset of the coordinates
            self._check_resume_compatible(initial_models, coordinates, require_all=False)
        if checkpoint_dir is not None:
            if ckpt.has_checkpoint(checkpoint_dir):
                initial_models, state, best = ckpt.load_training_checkpoint(
                    checkpoint_dir, device=dev
                )
                self._check_resume_compatible(initial_models, coordinates)
                start_iteration = int(state["completed_iterations"])
                if best is not None and state.get("best_metric") is not None:
                    initial_best = (best, float(state["best_metric"]))
                prior_objectives = [tuple(x) for x in state.get("objective_history", [])]
                prior_validations = [tuple(x) for x in state.get("validation_history", [])]
                logger.info("resuming from checkpoint %s at outer iteration %d",
                            checkpoint_dir, start_iteration)

            def on_iteration_end(outer: int, running) -> None:
                ckpt.save_training_checkpoint(
                    checkpoint_dir,
                    running.models,
                    state={
                        "completed_iterations": outer + 1,
                        "best_metric": running.best_metric,
                        # full histories, so that a second resume stays complete
                        "objective_history": prior_objectives + running.objective_history,
                        "validation_history": prior_validations + running.validation_history,
                    },
                    best_models=running.best_models if validate is not None else None,
                )

        result = cd.run(
            self.num_outer_iterations, initial_models=initial_models,
            start_iteration=start_iteration, initial_best=initial_best,
            on_iteration_end=on_iteration_end,
        )
        return GameFit(
            model=GameModel(models=result.best_models, meta=meta, task=self.task),
            validation_metric=result.best_metric,
            objective_history=prior_objectives + result.objective_history,
            validation_history=prior_validations + result.validation_history,
            update_seconds=cd.update_seconds,
        )

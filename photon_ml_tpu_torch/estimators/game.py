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

``fit_multiple`` trains one model per optimizer configuration over
coordinates built once (a λ sweep; ``select_best_fit`` picks by the
evaluator), ``resolve_coordinate`` re-solves one coordinate against new
data (the nearline loop's step), and ``schedule="async"`` pipelines the
coordinate solves and overlaps random-effect buckets on CUDA streams
(``algorithm/schedule.py``). Hyperparameter tuning is
``estimators/tuning.py``.

``fit(progress=...)`` feeds a ``telemetry.progress.ConvergenceTracker``
(one record per coordinate update, the divergence watchdog). Telemetry
spans: ``game/build_coordinate``, ``game/resolve_coordinate`` and
``game/fit`` around the coordinate-descent run.

``fit_streaming`` trains out of core: fixed effects stream fixed-shape
blocks from a ``streaming.StreamingSource`` through the pinned prefetcher
(``streaming/*``); random effects train in memory from one streamed setup
pass.

``parallel=ParallelConfiguration(n_data, n_feat, engine)`` trains over a
(data x feat) device grid: each fixed effect through a grid of sparse-engine
tiles (``parallel/grid_features.py``; margins summed over ``feat``,
gradients over ``data``), each random effect's entity blocks split over
every device of the grid. ``score_plane="host"`` keeps the coordinate
descent's score plane in numpy; it is the plane whenever the process group
of ``torch.distributed`` has more than one rank, and the schedule is then
sync. ``fit_streaming(cluster=...)`` runs the streamed fixed-effect solve
data-parallel across the worker processes of ``parallel/cluster``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from photon_ml_tpu_torch import checkpoint as ckpt
from photon_ml_tpu_torch.algorithm.coordinate import (
    FixedEffectCoordinate,
    RandomEffectCoordinate,
)
from photon_ml_tpu_torch.algorithm.coordinate_descent import SCORE_PLANES, CoordinateDescent
from photon_ml_tpu_torch.algorithm.schedule import SCHEDULES
from photon_ml_tpu_torch.algorithm.factored_random_effect import (
    FactoredRandomEffectCoordinate,
    FactoredRandomEffectModel,
    MFOptimizationConfiguration,
)
from photon_ml_tpu_torch.data.game_data import FeatureShard, GameData
from photon_ml_tpu_torch.data.random_effect import (
    RandomEffectDataConfiguration,
    build_random_effect_dataset,
    pad_entities_to_multiple,
    place_dataset,
)
from photon_ml_tpu_torch.device import DEFAULT_DEVICE, DeviceLike, resolve_device
from photon_ml_tpu_torch.estimators.random_effect import align_warm_start
from photon_ml_tpu_torch.evaluation.evaluators import default_evaluator
from photon_ml_tpu_torch.event import SolverStatsEvent
from photon_ml_tpu_torch.losses.pointwise import loss_for_task
from photon_ml_tpu_torch.models.game import CoordinateMeta, GameModel
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.models.random_effect import RandomEffectModel
from photon_ml_tpu_torch.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.data import LabeledData
from photon_ml_tpu_torch.opt.config import GlmOptimizationConfiguration
from photon_ml_tpu_torch.opt.tracking import TransferStats
from photon_ml_tpu_torch.parallel.mesh import world
from photon_ml_tpu_torch.streaming.coordinate import StreamingFixedEffectCoordinate
from photon_ml_tpu_torch.telemetry.span import span
from photon_ml_tpu_torch.types import TaskType

logger = logging.getLogger("photon_ml_tpu_torch")


def _describe_config(cfg: GlmOptimizationConfiguration) -> str:
    return (
        f"{cfg.optimizer_config.optimizer.name}"
        f"(λ={cfg.regularization_weight}, {cfg.regularization.reg_type.name})"
    )


def _config_digest(overrides: Dict[str, GlmOptimizationConfiguration]) -> str:
    """Stable 8-hex fingerprint of a per-coordinate override map, part of
    the per-configuration checkpoint path, so that an edited sweep list
    cannot resume from a checkpoint trained under other settings. Computed
    from the port's own configuration objects (their reprs): stable from
    run to run and changed by any override, but it need not equal the JAX
    package's digest of the same map."""
    key = repr(sorted((cid, cfg) for cid, cfg in overrides.items()))
    return hashlib.sha1(key.encode()).hexdigest()[:8]


@dataclasses.dataclass(frozen=True)
class ParallelConfiguration:
    """Layout of GAME training over a (data x feat) device grid (JAX
    ``ParallelConfiguration``).

    - Fixed-effect coordinates train through the grid-tiled sparse engine
      (``parallel/grid_features.py``): examples split over ``n_data``
      devices, coefficients over ``n_feat`` (margins summed over feat,
      gradients over data) in place of the reference's treeAggregate and
      broadcast.
    - Random-effect coordinates split their entity blocks over ALL
      n_data * n_feat devices (independent per-entity solves).

    ``devices`` (optional, may repeat one device) are the grid's devices
    in order; by default the visible cards of the estimator's device
    (``cuda``) or the host (``cpu``). ``engine`` is the tile engine:
    "benes" | "ell" | "fused"."""

    n_data: int
    n_feat: int = 1
    engine: str = "benes"
    devices: Optional[Tuple[str, ...]] = None

    def build_mesh(self, device: DeviceLike = DEFAULT_DEVICE):
        from photon_ml_tpu_torch.parallel.grid_features import grid_mesh

        return grid_mesh(self.n_data, self.n_feat, devices=self.devices, device=device)


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
        schedule: str = "sync",
        staleness: int = 1,
        parallel: Optional[ParallelConfiguration] = None,
        score_plane: str = "device",
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
        (they do not carry back through the projection).

        ``schedule``: "sync" (default, bitwise-repeatable trajectories) or
        "async" (bounded-staleness pipelined solves, at most ``staleness``
        unreconciled updates behind, and random-effect bucket overlap; each
        worker on its own CUDA stream on the card).

        ``parallel`` trains over a (data x feat) device grid
        (:class:`ParallelConfiguration`). ``score_plane``: "device"
        (default) or "host" (the coordinate descent's score plane in numpy;
        always the plane, and the schedule sync, under a process group of
        more than one rank)."""
        if schedule not in SCHEDULES:
            raise ValueError(f"schedule must be one of {SCHEDULES}, got {schedule!r}")
        if int(staleness) < 0:
            raise ValueError(f"staleness must be >= 0, got {staleness}")
        if not coordinates:
            raise ValueError("need at least one coordinate configuration")
        if score_plane not in SCORE_PLANES:
            raise ValueError(f"score_plane must be one of {SCORE_PLANES}, got {score_plane!r}")
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
        self.parallel = parallel
        self._mesh = parallel.build_mesh(self.device) if parallel is not None else None
        if self._mesh is not None:
            # the score plane and the reductions' scalars live on the
            # grid's home device; the grid FE's vectors stay in blocks
            self.device = self._mesh.home
        self.score_plane = score_plane
        self.emitter = emitter
        self.schedule = schedule
        self.staleness = int(staleness)
        # per-bucket SolverStats of the most recent resolve_coordinate
        self.last_resolve_stats: list = []
        # TransferStats of the most recent fit / resolve_coordinate
        self.last_transfer_stats: Optional[TransferStats] = None
        self.last_resolve_transfers: Optional[TransferStats] = None

    def _effective_score_plane(self) -> str:
        """The device plane holds one process's score arrays; under a
        process group of more than one rank the host plane runs, its
        numpy algebra in the same order on every rank."""
        if world()[1] > 1:
            return "host"
        return self.score_plane

    def _effective_schedule(self) -> str:
        """The async schedule pipelines updates on the device plane; on the
        host plane (chosen, or forced by several ranks) it is sync."""
        if self.schedule == "async" and self._effective_score_plane() != "device":
            return "sync"
        return self.schedule

    def _build_coordinate(self, cid: str, cfg: CoordinateConfiguration, data: GameData):
        with span("game/build_coordinate", coordinate=cid, kind=type(cfg).__name__):
            return self._build_coordinate_impl(cid, cfg, data)

    def _build_coordinate_impl(self, cid: str, cfg: CoordinateConfiguration, data: GameData):
        dev = self.device
        if isinstance(cfg, FixedEffectCoordinateConfiguration):
            if self.parallel is not None:
                return self._build_grid_fixed_effect(cfg, data)
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
        factored = isinstance(cfg, FactoredRandomEffectCoordinateConfiguration)
        re_ds = build_random_effect_dataset(
            data.id_tags[cfg.data.random_effect_type],
            shard.rows, shard.cols, shard.vals, shard.dim,
            data.labels, cfg.data,
            offsets=data.offsets, weights=data.weights,
            # on a grid the blocks go to their devices slice by slice
            device="cpu" if self.parallel is not None else dev,
        )
        logger.info("[%s] %s", cid, re_ds.to_summary_string())
        mesh = mesh_axes = None
        if self.parallel is not None:
            from photon_ml_tpu_torch.parallel.grid_features import DATA_AXIS, FEAT_AXIS

            mesh, mesh_axes = self._mesh, (DATA_AXIS, FEAT_AXIS)
            # entity-axis split over every device of the grid, once, for the
            # factored coordinate too (its latent datasets derive from these
            # slices where they live); a rank keeps its own positions'
            # slices, save for a factored coordinate, whose projection solve
            # runs over every row
            re_ds = place_dataset(
                pad_entities_to_multiple(re_ds, self.parallel.n_data * self.parallel.n_feat),
                mesh, mesh_axes, owned_only=not factored,
            )
        if factored:
            return FactoredRandomEffectCoordinate(
                dataset=re_ds, task=self.task, re_configuration=cfg.optimizer,
                matrix_configuration=cfg.matrix_optimizer or cfg.optimizer,
                mf_configuration=cfg.mf,
                base_offsets=torch.from_numpy(data.offsets).to(dev),
                mesh=mesh, mesh_axes=mesh_axes,
            )
        return RandomEffectCoordinate(
            dataset=re_ds, task=self.task, configuration=cfg.optimizer,
            base_offsets=torch.from_numpy(data.offsets).to(dev),
            compute_variances=self.compute_variance,
            mesh=mesh, mesh_axes=mesh_axes,
        )

    def _build_grid_fixed_effect(self, cfg: FixedEffectCoordinateConfiguration,
                                 data: GameData) -> FixedEffectCoordinate:
        """A fixed effect over the (data x feat) device grid: features tiled
        through the grid engine, the row arrays padded with weight-0 rows
        and placed as data blocks (``shard_vector_data``), the
        normalization context padded on the feature axis and placed as
        feat blocks. The coordinate trims back to real shapes at its
        boundary."""
        from photon_ml_tpu_torch.parallel.grid_features import grid_from_coo

        shard = data.feature_shards[cfg.feature_shard]
        n, d = data.num_rows, shard.dim
        gf = grid_from_coo(shard.rows, shard.cols, shard.vals, (n, d), self._mesh,
                           engine=self.parallel.engine)

        def pad_rows(a):
            out = np.zeros(gf.num_rows, dtype=np.float32)
            out[:n] = np.asarray(a, dtype=np.float32)
            return gf.data_vector(torch.from_numpy(out))

        norm = self.normalization.get(cfg.feature_shard)
        if norm is not None:
            pads = {}
            if norm.factor is not None:
                pads["factor"] = gf.feat_vector(
                    torch.nn.functional.pad(norm.factor, (0, gf.dim - d), value=1.0))
            if norm.shift is not None:
                pads["shift"] = gf.feat_vector(torch.nn.functional.pad(norm.shift, (0, gf.dim - d)))
            norm = dataclasses.replace(norm, **pads)
        labeled = LabeledData(features=gf, labels=pad_rows(data.labels),
                              offsets=pad_rows(data.offsets), weights=pad_rows(data.weights),
                              norm=norm)
        return FixedEffectCoordinate(
            data=labeled, task=self.task, configuration=cfg.optimizer,
            intercept_index=self.intercept_indices.get(cfg.feature_shard),
            compute_variances=self.compute_variance,
            num_real_rows=n, num_real_cols=d,
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
                if not isinstance(coord, (FixedEffectCoordinate,
                                          StreamingFixedEffectCoordinate)):
                    problems.append(
                        f"{cid}: checkpoint holds a fixed-effect model but the "
                        f"coordinate is now configured as {type(coord).__name__}"
                    )
                    continue
                # a grid layout pads the coordinate's feature axis;
                # checkpoints carry real-dim models
                want = (coord.dim if isinstance(coord, StreamingFixedEffectCoordinate)
                        else coord.num_real_cols or coord.data.dim)
                if model.dim != want:
                    problems.append(
                        f"{cid}: checkpoint dim {model.dim} != data dim {want}"
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

    def resolve_coordinate(
        self,
        cid: str,
        data: GameData,
        models: Dict[str, object],
        initial_model: object = "auto",
    ):
        """Warm-started re-solve of ONE coordinate against ``data``: the
        single-coordinate slice of a CD outer iteration, for the nearline
        incremental trainer (reference: the JAX module's
        ``resolve_coordinate``).

        Builds only this coordinate's dataset over ``data``, scores every
        OTHER coordinate's model as the residual, and runs one
        ``update_model_device``. A random-effect warm start
        (``initial_model``, by default ``models[cid]``) is re-laid out onto
        the fresh dataset's entities by id (``align_warm_start``): entities
        the old model never saw start at 0. Returns the re-solved model in
        the new dataset's layout."""
        cfg = self.coordinate_configs.get(cid)
        if cfg is None:
            raise ValueError(
                f"unknown coordinate {cid!r}; have {sorted(self.coordinate_configs)}"
            )
        if isinstance(cfg, FactoredRandomEffectCoordinateConfiguration):
            raise ValueError(
                f"coordinate {cid!r} is factored — single-coordinate re-solve "
                "supports fixed-effect and plain random-effect coordinates"
            )
        with span("game/resolve_coordinate", coordinate=cid, num_rows=data.num_rows):
            return self._resolve_coordinate_impl(cid, cfg, data, models, initial_model)

    def _resolve_coordinate_impl(self, cid, cfg, data, models, initial_model):
        coord = self._build_coordinate(cid, cfg, data)
        meta = self._meta()
        others = {c: m for c, m in models.items() if c != cid and m is not None}
        if others:
            residual = GameModel(
                models=others, meta={c: meta[c] for c in others}, task=self.task
            ).score(data)
        else:
            residual = torch.zeros(data.num_rows, dtype=torch.float32, device=self.device)
        model0 = models.get(cid) if initial_model == "auto" else initial_model
        if isinstance(coord, RandomEffectCoordinate) and model0 is not None:
            model0 = align_warm_start(model0, coord.dataset)
        # the residual is scored on the device: one update folded on the
        # device plane, no row-length array moved
        transfers = TransferStats(score_plane="device", num_rows=data.num_rows)
        transfers.coordinate_updates = 1
        transfers.device_plane_updates = 1
        updated = coord.update_model_device(model0, residual)
        self.last_resolve_transfers = transfers
        self.last_resolve_stats = list(getattr(coord, "last_solver_stats", []))
        if self.emitter is not None:
            for s in self.last_resolve_stats:
                self.emitter.send_event(SolverStatsEvent.from_stats(cid, s))
        return updated

    def fit(
        self,
        data: GameData,
        validation_data: Optional[GameData] = None,
        initial_models: Optional[Dict[str, object]] = None,
        coordinates: Optional[Dict[str, object]] = None,
        checkpoint_dir: Optional[str] = None,
        progress: Optional[object] = None,
    ) -> GameFit:
        """Train by block coordinate descent; ``initial_models`` warm-start
        coordinates (models of the same datasets); ``coordinates`` reuses
        datasets from :meth:`build_coordinates`. With ``checkpoint_dir`` the
        training state is written atomically after every outer iteration,
        and a checkpoint already there is resumed (its completed iterations
        skipped; it takes precedence over ``initial_models``). ``progress``
        is an optional ``telemetry.progress.ConvergenceTracker``; None (the
        default) and a tracker give bitwise the same fit."""
        if coordinates is None:
            coordinates = self.build_coordinates(data)
        return self._run_fit(coordinates, data, validation_data, initial_models, checkpoint_dir,
                             progress=progress)

    def fit_streaming(
        self,
        source,
        validation_data: Optional[GameData] = None,
        checkpoint_dir: Optional[str] = None,
        initial_models: Optional[Dict[str, object]] = None,
        prefetch_depth: int = 2,
        mode: str = "full",
        stochastic_epochs: int = 5,
        stochastic_chunk_iters: int = 4,
        blocks_per_update: int = 1,
        seed: int = 0,
        gap_schedule: bool = False,
        resident_blocks: int = 0,
        resident_bytes: Optional[int] = None,
        progress: Optional[object] = None,
        cluster: Optional[object] = None,
    ) -> GameFit:
        """Out-of-core ``fit`` (JAX ``GameEstimator.fit_streaming``):
        fixed-effect coordinates stream fixed-shape blocks from a
        :class:`~photon_ml_tpu_torch.streaming.StreamingSource` instead of
        holding the design matrix in memory.

        One streamed setup pass accumulates the per-row scalar planes
        (labels/offsets/weights/id tags) and the COO of the random-effect
        shards, so RE coordinates are built as in ``fit``. The FE feature
        payload never materializes: each CD update and score re-streams it,
        with host staging bounded by ``prefetch_depth × block bytes``.

        ``mode='full'`` is the exact full-batch streamed solve (the
        default); ``mode='stochastic'`` visits shuffled block groups per
        epoch on the resumable solver seam. ``gap_schedule=True``
        (stochastic only) replaces the blind shuffle with duality-gap-guided
        block selection. ``resident_blocks``/``resident_bytes`` cap a
        device-resident set of top-gap blocks whose uploads persist across
        passes; the fit is bitwise the non-resident one, only the uploaded
        bytes drop.

        ``cluster`` (a ``parallel.cluster.ClusterPlane`` or a bare
        ``ClusterCoordinator``) runs the fixed-effect solve data-parallel
        across worker processes: every streamed pass becomes the cluster's
        distributed pass over the workers' block shares, while random
        effects stay in this process. It requires ``mode='full'`` and
        exactly one fixed-effect coordinate (one cluster drives one block
        plan), and no residency."""
        if self.parallel is not None:
            raise ValueError(
                "streaming training does not compose with the device-grid "
                "parallel layout yet (multi-host streaming is roadmap work)"
            )
        if self.compute_variance:
            raise ValueError(
                "streaming training cannot compute coefficient variances "
                "(needs a second Hessian-diagonal pass; train in-memory)"
            )
        fe_cfgs = {
            cid: cfg for cid, cfg in self.coordinate_configs.items()
            if isinstance(cfg, FixedEffectCoordinateConfiguration)
        }
        for cid, cfg in fe_cfgs.items():
            if self.normalization.get(cfg.feature_shard) is not None:
                raise ValueError(
                    f"streaming coordinate {cid!r}: normalization requires "
                    "a streamed feature-stats pass (not implemented); use "
                    "--normalization-type NONE or train in-memory"
                )
        if cluster is not None:
            if mode != "full":
                raise ValueError(
                    "cluster training requires mode='full' (the distributed "
                    "pass sums exact per-host partials)"
                )
            if len(fe_cfgs) != 1:
                raise ValueError(
                    "cluster training requires exactly one fixed-effect "
                    f"coordinate, config has {sorted(fe_cfgs) or 'none'}"
                )
        re_shards = sorted({
            cfg.feature_shard for cid, cfg in self.coordinate_configs.items()
            if cid not in fe_cfgs
        })
        planes = source.row_planes(coo_shards=re_shards)
        data = GameData(
            labels=planes.labels,
            feature_shards={
                sid: FeatureShard(rows=r, cols=c, vals=v, dim=d)
                for sid, (r, c, v, d) in planes.shard_coo.items()
            },
            id_tags=planes.id_tags,
            offsets=planes.offsets,
            weights=planes.weights,
        )
        coordinates: Dict[str, object] = {}
        for cid, cfg in self.coordinate_configs.items():
            if cid in fe_cfgs:
                coordinates[cid] = StreamingFixedEffectCoordinate(
                    source=source,
                    shard_id=cfg.feature_shard,
                    task=self.task,
                    configuration=cfg.optimizer,
                    prefetch_depth=prefetch_depth,
                    mode=mode,
                    epochs=stochastic_epochs,
                    chunk_iters=stochastic_chunk_iters,
                    blocks_per_update=blocks_per_update,
                    seed=seed,
                    device=self.device,
                    gap_schedule=gap_schedule,
                    resident_blocks=resident_blocks,
                    resident_bytes=resident_bytes,
                    # per-block probes only when a tracker reads them
                    collect_block_stats=progress is not None,
                    cluster=cluster,
                )
            else:
                coordinates[cid] = self._build_coordinate(cid, cfg, data)
        return self._run_fit(coordinates, data, validation_data, initial_models,
                             checkpoint_dir, progress=progress)

    def fit_multiple(
        self,
        data: GameData,
        validation_data: Optional[GameData] = None,
        configs: Sequence[Dict[str, GlmOptimizationConfiguration]] = (),
        warm_start: bool = True,
        checkpoint_dir: Optional[str] = None,
        coordinates: Optional[Dict[str, object]] = None,
    ) -> List[GameFit]:
        """One fit per model configuration (reference
        GameEstimator.scala:175-217); best-model selection is the caller's
        (``select_best_fit``).

        Each entry of ``configs`` maps coordinate id → optimizer
        configuration; coordinates absent from an entry keep the
        estimator's. The datasets are built once (or taken from
        ``coordinates``, as ``fit`` takes them) and shared by every fit:
        only the solver configuration changes per fit. ``warm_start`` seeds
        each fit with the previous fit's models. ``checkpoint_dir`` gets one
        subdirectory per configuration, ``config-{i:03d}-{digest}``
        (``_config_digest``), so a resume after the sweep list was edited
        retrains."""
        base = coordinates if coordinates is not None else self.build_coordinates(data)
        if not configs:
            configs = [{}]
        fits: List[GameFit] = []
        prev_models: Optional[Dict[str, object]] = None
        for i, overrides in enumerate(configs):
            unknown = set(overrides) - set(base)
            if unknown:
                raise ValueError(f"config {i} names unknown coordinates: {sorted(unknown)}")
            coords = {
                cid: (self._replace_optimizer(coord, overrides[cid])
                      if cid in overrides else coord)
                for cid, coord in base.items()
            }
            logger.info(
                "fit %d/%d with config overrides: %s", i + 1, len(configs),
                {c: _describe_config(v) for c, v in overrides.items()} or "(defaults)",
            )
            fit = self._run_fit(
                coords, data, validation_data,
                prev_models if warm_start else None,
                None if checkpoint_dir is None
                else f"{checkpoint_dir}/config-{i:03d}-{_config_digest(overrides)}",
            )
            fits.append(fit)
            if warm_start:
                prev_models = fit.model.models
        return fits

    def select_best_fit(self, fits: Sequence[GameFit]) -> Optional[int]:
        """Index of the fit the validation evaluator ranks best (reference
        Driver.scala:356 selectBestModel); None when no fit carries a
        validation metric."""
        best: Optional[int] = None
        for i, fit in enumerate(fits):
            if fit.validation_metric is None:
                continue
            if best is None or self.evaluator.better_than(
                fit.validation_metric, fits[best].validation_metric
            ):
                best = i
        return best

    @staticmethod
    def _replace_optimizer(coord, opt: GlmOptimizationConfiguration):
        """A coordinate with the same device-resident dataset and a new
        optimizer configuration. A factored coordinate's projection-matrix
        solve follows only when it shared the latent solve's configuration;
        a separately configured ``matrix_optimizer`` is kept."""
        if isinstance(coord, FactoredRandomEffectCoordinate):
            shared = coord.matrix_configuration == coord.re_configuration
            return dataclasses.replace(
                coord, re_configuration=opt,
                matrix_configuration=opt if shared else coord.matrix_configuration,
            )
        return dataclasses.replace(coord, configuration=opt)

    @staticmethod
    def with_configuration(coord, cfg: CoordinateConfiguration):
        """A built coordinate under the optimizer(s) of a coordinate
        configuration of the same kind (a tuning trial's): its
        ``optimizer``, and a factored coordinate's ``matrix_optimizer`` (or
        ``optimizer``) for the projection matrix."""
        if isinstance(coord, FactoredRandomEffectCoordinate):
            return dataclasses.replace(
                coord, re_configuration=cfg.optimizer,
                matrix_configuration=cfg.matrix_optimizer or cfg.optimizer,
            )
        return dataclasses.replace(coord, configuration=cfg.optimizer)

    def _run_fit(
        self, coordinates, data, validation_data, initial_models, checkpoint_dir=None,
        progress=None,
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

        # the async schedule's RE leg: overlap bucket solves inside each
        # random-effect coordinate; set on every fit, so that built
        # coordinates shared between fits follow this fit's schedule
        for coord in coordinates.values():
            if hasattr(coord, "overlap_buckets"):
                coord.overlap_buckets = 2 if self._effective_schedule() == "async" else 0

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
            schedule=self._effective_schedule(),
            staleness=self.staleness,
            progress=progress,
            score_plane=self._effective_score_plane(),
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

        with span("game/fit", coordinates=len(coordinates), num_rows=data.num_rows,
                  score_plane=cd.score_plane):
            result = cd.run(
                self.num_outer_iterations, initial_models=initial_models,
                start_iteration=start_iteration, initial_best=initial_best,
                on_iteration_end=on_iteration_end,
            )
        self.last_transfer_stats = cd.transfer_stats
        return GameFit(
            model=GameModel(models=result.best_models, meta=meta, task=self.task),
            validation_metric=result.best_metric,
            objective_history=prior_objectives + result.objective_history,
            validation_history=prior_validations + result.validation_history,
            update_seconds=cd.update_seconds,
        )

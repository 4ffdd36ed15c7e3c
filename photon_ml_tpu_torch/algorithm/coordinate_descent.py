"""Block coordinate descent: the outer GAME training loop.

Port of the sync schedule of ``photon_ml_tpu/algorithm/coordinate_descent.py``
(reference algorithm/CoordinateDescent.scala:40, optimize :97-321): per
outer iteration, per coordinate — residual = total score minus the
coordinate's own score (:183), retrain the coordinate against it, rescore,
log the objective (:247-258), evaluate validation after each update
(:265-294), and keep the best full model by the first evaluator (:299-307).

The score plane lives on the device: a running total updated incrementally
(``total += new_own − old_own``), so each update costs O(rows) device work
and no row-length array crosses to the host; the training objective reads
the running total, one scalar to the host per update. The sequence of f32
adds is fixed, so a run is repeatable bitwise on one device.

After each update the coordinate's solver trackers are logged, and an
``event.EventEmitter`` receives one ``SolverStatsEvent`` per random-effect
bucket.

Not ported: the async schedule, the host score plane, checkpoint resume
and progress tracking (ROADMAP.md, Queue A: The rest of training).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from photon_ml_tpu_torch.evaluation.evaluators import nan_aware_better_than
from photon_ml_tpu_torch.event import SolverStatsEvent

logger = logging.getLogger("photon_ml_tpu_torch")


@dataclasses.dataclass
class CoordinateDescentResult:
    models: Dict[str, object]                    # final per-coordinate models
    best_models: Dict[str, object]               # best by validation (== models without)
    best_metric: Optional[float]
    objective_history: List[Tuple[str, float]]   # (coordinate, training objective)
    validation_history: List[Tuple[str, float]]  # (coordinate, first-evaluator metric)


class CoordinateDescent:
    """Sequential coordinate updates: host control flow; the coordinates do
    their work on the device."""

    def __init__(
        self,
        coordinates: Dict[str, object],
        num_rows: int,
        device: torch.device,
        update_order: Optional[Sequence[str]] = None,
        training_objective: Optional[Callable[[torch.Tensor], float]] = None,
        regularization_term: Optional[Callable[[Dict[str, object]], float]] = None,
        validate: Optional[Callable[[Dict[str, object]], float]] = None,
        validation_better_than: Optional[Callable[[float, float], bool]] = None,
        emitter=None,
    ) -> None:
        if not coordinates:
            raise ValueError("need at least one coordinate")
        self.coordinates = coordinates
        self.num_rows = num_rows
        self.device = device
        self.update_order = list(update_order) if update_order else list(coordinates)
        unknown = set(self.update_order) - set(coordinates)
        if unknown:
            raise ValueError(f"unknown coordinates in update order: {unknown}")
        self.training_objective = training_objective
        self.regularization_term = regularization_term
        self.validate = validate
        self.validation_better_than = validation_better_than or nan_aware_better_than
        self.emitter = emitter
        # seconds of each coordinate update (train + rescore, synchronised)
        # of the most recent run, in update order
        self.update_seconds: List[Tuple[str, float]] = []

    def _log_solver_stats(self, cid: str, coord) -> None:
        tracker = getattr(coord, "last_tracker", None)
        if tracker is not None:
            logger.info("CD coordinate %s: %s", cid, tracker.to_summary_string())
        for s in getattr(coord, "last_solver_stats", ()):
            logger.info("CD coordinate %s: %s", cid, s.to_summary_string())
            if self.emitter is not None:
                self.emitter.send_event(SolverStatsEvent.from_stats(cid, s))

    def run(
        self, num_iterations: int, initial_models: Optional[Dict[str, object]] = None
    ) -> CoordinateDescentResult:
        models: Dict[str, object] = dict(initial_models or {})
        scores: Dict[str, torch.Tensor] = {
            cid: self.coordinates[cid].score_device(m) for cid, m in models.items()
        }
        zeros = torch.zeros(self.num_rows, dtype=torch.float32, device=self.device)
        total = zeros.clone()
        for s in scores.values():
            total = total + s

        objective_history: List[Tuple[str, float]] = []
        validation_history: List[Tuple[str, float]] = []
        best_metric: Optional[float] = None
        best_models: Dict[str, object] = {}
        self.update_seconds = []

        for outer in range(num_iterations):
            for cid in self.update_order:
                coord = self.coordinates[cid]
                t0 = time.perf_counter()
                # partialScore = fullScore - ownScore (reference
                # CoordinateDescent.scala:183)
                old_own = scores.get(cid, zeros)
                model = coord.update_model_device(models.get(cid), total - old_own)
                models[cid] = model
                new_own = coord.score_device(model)
                total = total + new_own - old_own
                scores[cid] = new_own
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self.update_seconds.append((cid, time.perf_counter() - t0))
                self._log_solver_stats(cid, coord)

                if self.training_objective is not None:
                    loss_val = float(self.training_objective(total))
                    if self.regularization_term is not None:
                        reg = float(self.regularization_term(models))
                        obj = loss_val + reg
                        logger.info(
                            "CD iter %d coordinate %s: loss %.6f + regularization "
                            "%.6f = objective %.6f", outer, cid, loss_val, reg, obj,
                        )
                    else:
                        obj = loss_val
                        logger.info(
                            "CD iter %d coordinate %s: training objective %.6f",
                            outer, cid, loss_val,
                        )
                    objective_history.append((cid, obj))
                if self.validate is not None:
                    metric = float(self.validate(models))
                    validation_history.append((cid, metric))
                    logger.info("CD iter %d coordinate %s: validation %.6f", outer, cid, metric)
                    # best-model tracking starts once every coordinate has
                    # trained: a snapshot missing whole coordinates is not a
                    # model (reference CoordinateDescent.scala:265-294)
                    if all(c in models for c in self.update_order) and (
                        best_metric is None
                        or self.validation_better_than(metric, best_metric)
                    ):
                        best_metric = metric
                        best_models = dict(models)

        if self.validate is None or not best_models:
            best_models = dict(models)
        return CoordinateDescentResult(
            models=models,
            best_models=best_models,
            best_metric=best_metric,
            objective_history=objective_history,
            validation_history=validation_history,
        )

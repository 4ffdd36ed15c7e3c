"""Block coordinate descent: the outer GAME training loop.

Port of ``photon_ml_tpu/algorithm/coordinate_descent.py`` (reference
algorithm/CoordinateDescent.scala:40, optimize :97-321): per outer
iteration, per coordinate — residual = total score minus the coordinate's
own score (:183), retrain the coordinate against it, rescore, log the
objective (:247-258), evaluate validation after each update (:265-294),
and keep the best full model by the first evaluator (:299-307).

The score plane lives on the device: a running total updated incrementally
(``total += new_own − old_own``), so each update costs O(rows) device work
and no row-length array crosses to the host; the training objective reads
the running total, one scalar to the host per update. The sequence of f32
adds is fixed, so a run is repeatable bitwise on one device.

Schedule: ``schedule="sync"`` (default) runs the strictly sequential loop
above. ``schedule="async"`` pipelines the coordinate solves: each solve is
dispatched onto a worker (``algorithm/schedule.py``; on the card, a CUDA
stream per worker) against the residual computed from the *current*
running total — which may still miss up to ``staleness`` in-flight updates
— and finished solves are folded back into the total in dispatch order.
Residuals are computed on the dispatching thread and reconciliation is
FIFO, so the trajectory is deterministic for a given ``staleness``;
``staleness=0`` reconciles everything before each dispatch and is bitwise
the sync trajectory (the solve merely runs on a worker). A full drain ends
every outer iteration. No device-wide sync runs on a worker's path: a
worker's update is timed by a sync of its own stream.

After each update the coordinate's solver trackers are logged, and an
``event.EventEmitter`` receives one ``SolverStatsEvent`` per random-effect
bucket. ``transfer_stats`` (``opt.tracking.TransferStats``) counts the
run's coordinate updates and device-plane folds (``total += new − old``);
no row-length score array crosses to the host on this plane, so its row
transfers stay 0. After each outer iteration the emitter receives one
``TransferStatsEvent`` with that iteration's deltas. ``run`` resumes from
a checkpoint: it skips completed outer iterations, starts from the
restored best model, and hands the running result to a callback after
each outer iteration.

Telemetry, with the JAX package's span names and attribute keys:
``cd/run`` > ``cd/outer_iter`` > ``cd/coordinate`` (sync; a barrier on the
current stream) or ``cd/reconcile`` (async, on the dispatching thread: its
closing barrier runs after ``InFlight.result`` made the dispatcher's
stream wait on the worker, so it covers the worker's work), then
``cd/objective`` and ``cd/validate``; a worker's solve runs in
``cd/overlap`` (``algorithm/schedule.py``). With ``progress`` (a
``telemetry.progress.ConvergenceTracker``) every update is recorded and
checked by the divergence watchdog, which may raise ``DivergenceError``.
Spans and the tracker add stream syncs and host reads, never arithmetic:
a traced or tracked fit is bitwise the plain one.

Not ported: the host score plane, which serves multi-controller runs
(ROADMAP.md, Queue A item 8).
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from photon_ml_tpu_torch.algorithm.schedule import SCHEDULES, ScheduleExecutor
from photon_ml_tpu_torch.evaluation.evaluators import nan_aware_better_than
from photon_ml_tpu_torch.event import SolverStatsEvent, TransferStatsEvent
from photon_ml_tpu_torch.opt.tracking import TransferStats
from photon_ml_tpu_torch.telemetry.span import span

logger = logging.getLogger("photon_ml_tpu_torch")


@dataclasses.dataclass
class CoordinateDescentResult:
    models: Dict[str, object]                    # final per-coordinate models
    best_models: Dict[str, object]               # best by validation (== models without)
    best_metric: Optional[float]
    objective_history: List[Tuple[str, float]]   # (coordinate, training objective)
    validation_history: List[Tuple[str, float]]  # (coordinate, first-evaluator metric)


class CoordinateDescent:
    """Coordinate updates in turn (sync) or pipelined (async): host control
    flow; the coordinates do their work on the device."""

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
        schedule: str = "sync",
        staleness: int = 1,
        progress: Optional[object] = None,
    ) -> None:
        if not coordinates:
            raise ValueError("need at least one coordinate")
        if schedule not in SCHEDULES:
            raise ValueError(f"schedule must be one of {SCHEDULES}, got {schedule!r}")
        if int(staleness) < 0:
            raise ValueError(f"staleness must be >= 0, got {staleness}")
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
        self.schedule = schedule
        self.staleness = int(staleness)
        # optional telemetry.progress.ConvergenceTracker: one record per
        # update plus the divergence watchdog (its record_coordinate may
        # raise DivergenceError). None touches nothing.
        self.progress = progress
        # seconds of each coordinate update of the most recent run, in
        # update order: train + rescore, synchronised (sync), or from the
        # worker's start to the end of its stream's work (async)
        self.update_seconds: List[Tuple[str, float]] = []
        # transfer accounting of the most recent (or in-flight) run
        self.transfer_stats = TransferStats(score_plane="device", num_rows=num_rows)

    def _log_solver_stats(self, cid: str, coord) -> None:
        tracker = getattr(coord, "last_tracker", None)
        if tracker is not None:
            logger.info("CD coordinate %s: %s", cid, tracker.to_summary_string())
        for s in getattr(coord, "last_solver_stats", ()):
            logger.info("CD coordinate %s: %s", cid, s.to_summary_string())
            if self.emitter is not None:
                self.emitter.send_event(SolverStatsEvent.from_stats(cid, s))

    def _emit_transfer_stats(self, outer: int, prev: Dict[str, object]) -> None:
        """One TransferStatsEvent with THIS outer iteration's deltas."""
        t = self.transfer_stats
        t.outer_iterations += 1
        if self.emitter is None:
            return
        cur = t.snapshot()

        def delta(key: str) -> int:
            return int(cur[key]) - int(prev[key])

        d_h2d, d_d2h = delta("row_transfers_h2d"), delta("row_transfers_d2h")
        self.emitter.send_event(TransferStatsEvent(
            score_plane=t.score_plane, outer_iteration=outer, num_rows=t.num_rows,
            row_transfers_h2d=d_h2d, row_transfers_d2h=d_d2h,
            row_bytes_h2d=d_h2d * t.bytes_per_row_array,
            row_bytes_d2h=d_d2h * t.bytes_per_row_array,
            host_score_sums=delta("host_score_sums"),
            device_plane_updates=delta("device_plane_updates"),
        ))

    def _model_for_progress(self, run: "_Run", cid: str):
        """The coordinate's model before its update, kept past the update
        for the tracker's coefficient delta only: an untracked fit frees
        it when the update is folded in, as before tracking existed."""
        return run.models.get(cid) if self.progress is not None else None

    def _record_progress(
        self, outer: int, cid: str, coord, prev_model, model,
        objective: float, loss: Optional[float], regularization: Optional[float],
    ) -> None:
        """Fold one update into the convergence tracker: the objective, the
        solver telemetry of the coordinate's ``last_tracker`` (a fixed
        effect's iterations, convergence reason and final gradient norm)
        and ``last_solve_info`` (a streamed solve's line-search trials),
        the coefficient-delta norm, computed on a copy and pulled with
        ``float()``, and a streamed coordinate's per-block stats,
        gap-scheduler and residency decisions and skipped blocks. May raise
        ``DivergenceError`` (the watchdog).

        The JAX package's branches for cluster events have no producer in
        the port yet (ROADMAP.md, Queue A item 8, The cluster plane)."""
        tracker = self.progress
        if tracker is None:
            return
        solver_iterations = convergence_reason = grad_norm = None
        states = getattr(getattr(coord, "last_tracker", None), "states", None)
        if states is not None:
            solver_iterations = int(states.iterations)
            convergence_reason = states.convergence_reason.name
            grad_norm = states.grad_norm
        info = getattr(coord, "last_solve_info", None)
        line_search_trials = int(info.line_search_trials) if info is not None else None
        coef_delta_norm = None
        new_means = getattr(getattr(model, "coefficients", None), "means", None)
        if new_means is not None:
            old_means = getattr(getattr(prev_model, "coefficients", None), "means", None)
            delta = new_means if old_means is None else new_means - old_means
            coef_delta_norm = float(torch.linalg.norm(delta))
        block_stats = getattr(coord, "last_block_stats", None)
        if block_stats:
            tracker.record_blocks(outer, cid, block_stats)
        schedule = getattr(coord, "last_schedule_decisions", None)
        if schedule:
            tracker.record_schedule(outer, cid, schedule)
            coord.last_schedule_decisions = None
        residency = getattr(coord, "last_residency_decisions", None)
        if residency:
            tracker.record_residency(outer, cid, residency)
            coord.last_residency_decisions = None
        skipped = getattr(coord, "last_skipped_blocks", None)
        if skipped:
            for s in skipped:
                tracker.record_resilience(
                    "block_skipped", "stream.build_block", s.get("error", ""),
                    outer=outer, coordinate=cid, block=s.get("block"),
                )
            coord.last_skipped_blocks = None
        tracker.record_coordinate(
            outer, cid, objective, loss=loss, regularization=regularization,
            grad_norm=grad_norm, coef_delta_norm=coef_delta_norm,
            solver_iterations=solver_iterations, line_search_trials=line_search_trials,
            convergence_reason=convergence_reason,
        )

    def run(
        self,
        num_iterations: int,
        initial_models: Optional[Dict[str, object]] = None,
        start_iteration: int = 0,
        initial_best: Optional[Tuple[Dict[str, object], float]] = None,
        on_iteration_end: Optional[Callable[[int, CoordinateDescentResult], None]] = None,
    ) -> CoordinateDescentResult:
        """Outer iterations ``start_iteration`` .. ``num_iterations`` − 1
        from ``initial_models``; ``initial_best`` is a restored (best models,
        best metric); ``on_iteration_end(outer, running result)`` runs after
        each outer iteration (checkpointing)."""
        with span("cd/run", score_plane="device", num_rows=self.num_rows,
                  iterations=num_iterations, schedule=self.schedule):
            self.transfer_stats = TransferStats(score_plane="device", num_rows=self.num_rows)
            run = _Run(self, initial_models, initial_best)
            self.update_seconds = run.update_seconds
            if self.schedule == "async":
                self._run_async(run, num_iterations, start_iteration, on_iteration_end)
            else:
                self._run_sync(run, num_iterations, start_iteration, on_iteration_end)
            logger.info("CD %s", self.transfer_stats.to_summary_string())
            return run.result(final=True)

    def _run_sync(self, run: "_Run", num_iterations, start_iteration, on_iteration_end):
        for outer in range(start_iteration, num_iterations):
            with span("cd/outer_iter", outer=outer):
                prev_transfers = self.transfer_stats.snapshot()
                for cid in self.update_order:
                    coord = self.coordinates[cid]
                    self.transfer_stats.coordinate_updates += 1
                    prev_model = self._model_for_progress(run, cid)
                    with span("cd/coordinate", device_sync=True, coordinate=cid, outer=outer):
                        t0 = time.perf_counter()
                        # partialScore = fullScore - ownScore (reference
                        # CoordinateDescent.scala:183)
                        old_own = run.scores.get(cid)
                        model = coord.update_model_device(
                            run.models.get(cid), run.residual(old_own))
                        new_own = coord.score_device(model)
                        run.fold(cid, model, new_own, old_own)
                        if self.device.type == "cuda":
                            torch.cuda.synchronize(self.device)
                        seconds = time.perf_counter() - t0
                    run.record(outer, cid, seconds, prev_model)
                self._emit_transfer_stats(outer, prev_transfers)
                if on_iteration_end is not None:
                    on_iteration_end(outer, run.result())

    # ------------------------------------------------------------- async
    def _solve_in_flight(self, coord, model0, residual):
        """Worker body of one dispatched coordinate solve: train against the
        (possibly stale) residual and rescore; touches no state of the loop
        state. Timed to the end of its own stream's work."""
        t0 = time.perf_counter()
        model = coord.update_model_device(model0, residual)
        new_own = coord.score_device(model)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return model, new_own, time.perf_counter() - t0

    def _run_async(self, run: "_Run", num_iterations, start_iteration, on_iteration_end):
        """Bounded-staleness pipelined schedule (reference: the JAX module's
        ``_run_async``). Per outer iteration, each coordinate's residual is
        computed on the dispatching thread from the CURRENT running total
        and the solve is dispatched to the worker pool. Before every
        dispatch the loop reconciles down to the staleness bound (FIFO),
        folding each finished solve into the total and recording its
        objective and validation entry then, so the histories keep one
        entry per update. A full drain ends each iteration."""
        executor = ScheduleExecutor(
            max_in_flight=min(len(self.update_order), self.staleness + 1),
            name="cd-async", device=self.device,
        )
        # (cid, old_own) of the in-flight solves, in the executor's FIFO order
        pending: List[Tuple[str, Optional[torch.Tensor]]] = []

        def reconcile_one(outer: int) -> None:
            cid, old_own = pending.pop(0)
            prev_model = self._model_for_progress(run, cid)
            with span("cd/reconcile", device_sync=True, coordinate=cid, outer=outer):
                model, new_own, seconds = executor.pop_oldest().result()
                run.fold(cid, model, new_own, old_own)
            run.record(outer, cid, seconds, prev_model)

        try:
            for outer in range(start_iteration, num_iterations):
                with span("cd/outer_iter", outer=outer, schedule="async"):
                    prev_transfers = self.transfer_stats.snapshot()
                    for cid in self.update_order:
                        # bound the lag BEFORE dispatch: at most `staleness`
                        # unreconciled updates may be missing from the
                        # residual this coordinate trains against
                        while len(pending) > self.staleness:
                            reconcile_one(outer)
                        self.transfer_stats.coordinate_updates += 1
                        old_own = run.scores.get(cid)
                        model0 = run.models.get(cid)
                        residual = run.residual(old_own)
                        executor.submit(
                            cid,
                            functools.partial(
                                self._solve_in_flight, self.coordinates[cid], model0, residual
                            ),
                            inputs=(residual, model0),
                            span_name="cd/overlap", coordinate=cid, outer=outer,
                        )
                        pending.append((cid, old_own))
                    # iteration barrier: the plane lags within an iteration
                    # only
                    while pending:
                        reconcile_one(outer)
                    self._emit_transfer_stats(outer, prev_transfers)
                    if on_iteration_end is not None:
                        on_iteration_end(outer, run.result())
        finally:
            executor.shutdown(wait=True)


class _Run:
    """The running state of one ``CoordinateDescent.run``: models, the
    device score plane, histories and the best model; shared by both
    schedules, touched by the dispatching thread alone."""

    def __init__(self, cd: CoordinateDescent, initial_models, initial_best) -> None:
        self.cd = cd
        self.models: Dict[str, object] = dict(initial_models or {})
        self.scores: Dict[str, torch.Tensor] = {
            cid: cd.coordinates[cid].score_device(m) for cid, m in self.models.items()
        }
        self.zeros = torch.zeros(cd.num_rows, dtype=torch.float32, device=cd.device)
        self.total = self.zeros.clone()
        for s in self.scores.values():
            self.total = self.total + s
        self.objective_history: List[Tuple[str, float]] = []
        self.validation_history: List[Tuple[str, float]] = []
        self.best_metric: Optional[float] = None
        self.best_models: Dict[str, object] = {}
        if initial_best is not None:
            self.best_models, self.best_metric = dict(initial_best[0]), initial_best[1]
        self.update_seconds: List[Tuple[str, float]] = []

    def residual(self, old_own: Optional[torch.Tensor]) -> torch.Tensor:
        return self.total - (old_own if old_own is not None else self.zeros)

    def fold(self, cid: str, model, new_own: torch.Tensor,
             old_own: Optional[torch.Tensor]) -> None:
        self.models[cid] = model
        self.total = self.total + new_own - (old_own if old_own is not None else self.zeros)
        self.scores[cid] = new_own
        self.cd.transfer_stats.device_plane_updates += 1

    def record(self, outer: int, cid: str, seconds: float, prev_model) -> None:
        """After an update is folded in: its seconds, solver stats, training
        objective, progress record and validation metric, and the best
        model. ``prev_model``: the coordinate's model before the update."""
        cd = self.cd
        coord = cd.coordinates[cid]
        self.update_seconds.append((cid, seconds))
        cd._log_solver_stats(cid, coord)
        if cd.training_objective is not None:
            with span("cd/objective", coordinate=cid, outer=outer):
                loss_val = float(cd.training_objective(self.total))
                if cd.regularization_term is not None:
                    reg = float(cd.regularization_term(self.models))
                    obj = loss_val + reg
                    logger.info(
                        "CD iter %d coordinate %s: loss %.6f + regularization "
                        "%.6f = objective %.6f", outer, cid, loss_val, reg, obj,
                    )
                else:
                    reg, obj = None, loss_val
                    logger.info(
                        "CD iter %d coordinate %s: training objective %.6f", outer, cid, loss_val,
                    )
                self.objective_history.append((cid, obj))
            cd._record_progress(outer, cid, coord, prev_model, self.models[cid], obj, loss_val, reg)
        if cd.validate is not None:
            with span("cd/validate", coordinate=cid, outer=outer):
                metric = float(cd.validate(self.models))
                self.validation_history.append((cid, metric))
                if cd.progress is not None:
                    cd.progress.record_validation(outer, cid, metric)
                logger.info("CD iter %d coordinate %s: validation %.6f", outer, cid, metric)
                # best-model tracking starts once every coordinate has
                # trained: a snapshot missing whole coordinates is not a
                # model (reference CoordinateDescent.scala:265-294)
                if all(c in self.models for c in cd.update_order) and (
                    self.best_metric is None
                    or cd.validation_better_than(metric, self.best_metric)
                ):
                    self.best_metric = metric
                    self.best_models = dict(self.models)

    def result(self, final: bool = False) -> CoordinateDescentResult:
        best = self.best_models
        if not best or (final and self.cd.validate is None):
            best = self.models
        return CoordinateDescentResult(
            models=dict(self.models),
            best_models=dict(best),
            best_metric=self.best_metric,
            objective_history=list(self.objective_history),
            validation_history=list(self.validation_history),
        )

"""Streaming fixed-effect coordinate: out-of-core CD participation.

Port of ``photon_ml_tpu/streaming/coordinate.py``. The in-memory
:class:`FixedEffectCoordinate` owns a device-resident ``LabeledData`` for
the whole dataset. This coordinate instead owns a :class:`StreamingSource`
and re-streams fixed-shape blocks from disk through a
:class:`BlockPrefetcher` for every solve and every score:

* ``update_model_device`` adds each block's slice of the CD residual
  (padded once per update to ``num_blocks × block_rows``) to the block's
  base offsets, then runs the streamed full-batch (or stochastic) solver;
* ``score_device`` assembles the global ``[num_rows]`` score plane from
  per-block matvecs written into their row ranges.

With ``cluster`` (a ``parallel.cluster.ClusterPlane`` or a bare
``ClusterCoordinator``) a full-batch solve hands every streamed pass to the
cluster's distributed pass (``_solve_cluster``): the workers stream their
block shares, the coordinator sums their partial ``(f, g)`` in float64,
and the regularization is finalized here, as on one host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.device import DEFAULT_DEVICE, DeviceLike, resolve_device
from photon_ml_tpu_torch.losses.objective import GlmObjective, make_glm_objective
from photon_ml_tpu_torch.losses.pointwise import loss_for_task
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.opt.config import GlmOptimizationConfiguration
from photon_ml_tpu_torch.opt.tracking import (
    FixedEffectOptimizationTracker,
    OptimizationStatesTracker,
)
from photon_ml_tpu_torch.streaming.blocks import StreamingSource
from photon_ml_tpu_torch.streaming.gapsched import GapScheduler
from photon_ml_tpu_torch.streaming.prefetch import (
    BlockPrefetcher,
    DeviceBlock,
    PrefetchStats,
)
from photon_ml_tpu_torch.streaming.residency import ResidencyManager
from photon_ml_tpu_torch.streaming.solver import (
    BlockStatsProbe,
    StreamPrograms,
    StreamSolveInfo,
    solve_streaming,
    solve_streaming_stochastic,
)
from photon_ml_tpu_torch.telemetry.span import span
from photon_ml_tpu_torch.types import TaskType

# make_glm_objective builds fresh closures per call; the streamed programs
# are memoized per objective, so same-task coordinates share one instance
_OBJECTIVE_CACHE: Dict[TaskType, GlmObjective] = {}


def _objective_for_task(task: TaskType) -> GlmObjective:
    obj = _OBJECTIVE_CACHE.get(task)
    if obj is None:
        obj = make_glm_objective(loss_for_task(task))
        _OBJECTIVE_CACHE[task] = obj
    return obj


def _fuse_block_offsets(data, residual_padded: torch.Tensor, start: int):
    """The block's data with its slice of the residual added to its base
    offsets (a new LabeledData; the block's own tensors are untouched)."""
    b = data.offsets.shape[0]
    return data.with_offsets(data.offsets + residual_padded[start:start + b])


@dataclasses.dataclass
class StreamingFixedEffectCoordinate:
    """Fixed-effect GLM trained out-of-core from a StreamingSource, on
    ``device`` (default ``cuda``; raises without a card unless
    ``device="cpu"``).

    Restrictions vs the in-memory coordinate (enforced by the estimator):
    no normalization context, no per-coefficient variances, first-order
    solvers only in full-batch mode.
    """

    source: StreamingSource
    shard_id: str
    task: TaskType
    configuration: GlmOptimizationConfiguration
    prefetch_depth: int = 2
    mode: str = "full"            # "full" (exact) | "stochastic"
    epochs: int = 5               # stochastic: passes per update
    chunk_iters: int = 4          # stochastic: solver iters per block group
    blocks_per_update: int = 1    # stochastic: blocks concatenated per group
    seed: int = 0
    device: DeviceLike = DEFAULT_DEVICE
    last_tracker: Optional[FixedEffectOptimizationTracker] = dataclasses.field(
        default=None, repr=False
    )
    last_solve_info: Optional[StreamSolveInfo] = dataclasses.field(
        default=None, repr=False
    )
    last_prefetch_stats: Optional[PrefetchStats] = dataclasses.field(
        default=None, repr=False
    )
    # convergence plane: when True, full-batch solves run the probe variant
    # of the accumulation program and leave each pass's per-block partial
    # loss / grad norm / gap estimate in ``last_block_stats`` (and on the
    # pass's PrefetchStats.block_gaps). Off by default; on or off, the same
    # fit bitwise.
    collect_block_stats: bool = False
    last_block_stats: Optional[list] = dataclasses.field(
        default=None, repr=False
    )
    # DuHL: when True, stochastic epochs visit blocks by staleness-decayed
    # duality-gap importance (GapScheduler) instead of the blind per-epoch
    # permutation. The scheduler persists across updates so gap scores
    # survive between CD rounds; each solve's per-epoch decisions land in
    # ``last_schedule_decisions`` for the progress ledger.
    gap_schedule: bool = False
    last_schedule_decisions: Optional[list] = dataclasses.field(
        default=None, repr=False
    )
    # failure plane: blocks skipped this update (on_block_error=skip),
    # drained by the CD driver into the progress ledger
    last_skipped_blocks: Optional[list] = dataclasses.field(
        default=None, repr=False
    )
    # cluster plane: when set (a ClusterPlane or ClusterCoordinator,
    # parallel/cluster), full-batch solves hand every streamed pass to the
    # distributed pass: this process streams nothing itself, the workers
    # stream their block shares and the solver takes the summed (f, g)
    # through the pass_fn seam. Full-batch only: the stochastic trajectory
    # depends on the visit order, so no cross-host split preserves it.
    cluster: Optional[object] = dataclasses.field(default=None, repr=False)
    last_cluster_events: Optional[list] = dataclasses.field(default=None, repr=False)
    # per-pass skew profiles (coordinator telemetry, when enabled) drained
    # after each cluster solve for the progress ledger's
    # cluster_pass/host_pass records
    last_cluster_passes: Optional[list] = dataclasses.field(default=None, repr=False)
    # HBM residency plane (streaming/residency.py): a nonzero block budget
    # and/or a byte budget keeps the top-gap blocks' device tensors across
    # passes, skipping their upload; the non-resident remainder streams
    # through the prefetcher as before. The visit order is unchanged, so
    # the fit is bitwise the non-resident one. The manager persists across
    # CD outer iterations; re-pinning happens only between passes.
    resident_blocks: int = 0
    resident_bytes: Optional[int] = None
    last_residency_decisions: Optional[list] = dataclasses.field(
        default=None, repr=False
    )
    _residency: Optional[ResidencyManager] = dataclasses.field(
        default=None, repr=False
    )
    _gap_scheduler: Optional[GapScheduler] = dataclasses.field(
        default=None, repr=False
    )
    _objective: Optional[GlmObjective] = dataclasses.field(
        default=None, repr=False
    )

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        if self.mode not in ("full", "stochastic"):
            raise ValueError(
                f"streaming mode must be 'full' or 'stochastic', got {self.mode!r}"
            )
        if self.shard_id not in self.source.plan.shard_dims:
            raise ValueError(
                f"shard {self.shard_id!r} not in streaming plan "
                f"{sorted(self.source.plan.shard_dims)}"
            )
        if self.gap_schedule and self.mode != "stochastic":
            raise ValueError(
                "gap_schedule requires stochastic streaming mode (full-batch"
                " mode must visit every block per pass to stay exact)"
            )
        if self.cluster is not None:
            if self.mode != "full":
                raise ValueError(
                    "cluster training requires full-batch streaming mode: "
                    "the distributed pass sums exact per-host partials"
                )
            if self.cluster.num_blocks != self.source.plan.num_blocks:
                raise ValueError(
                    f"cluster planned {self.cluster.num_blocks} blocks but "
                    f"this source streams {self.source.plan.num_blocks}"
                )
        if self.resident_blocks or self.resident_bytes is not None:
            if self.cluster is not None:
                raise ValueError(
                    "device residency requires local streaming: cluster "
                    "workers own their blocks' device placement"
                )
            if self.mode == "stochastic" and not self.gap_schedule:
                raise ValueError(
                    "stochastic residency requires gap_schedule — the "
                    "scheduler's gap feedback is what picks the resident set"
                )
            self._residency = ResidencyManager(
                self.source.plan.num_blocks,
                self.source.block_upload_bytes((self.shard_id,)),
                max_blocks=int(self.resident_blocks),
                max_bytes=self.resident_bytes,
            )

    # -- shapes -----------------------------------------------------------

    @property
    def dim(self) -> int:
        return self.source.plan.shard_dims[self.shard_id]

    @property
    def num_rows(self) -> int:
        return self.source.plan.total_rows

    def objective(self) -> GlmObjective:
        if self._objective is None:
            self._objective = _objective_for_task(self.task)
        return self._objective

    # -- streamed passes --------------------------------------------------

    def _prefetcher(self, order) -> BlockPrefetcher:
        prefetcher = BlockPrefetcher(
            self.source,
            shards=(self.shard_id,),
            depth=self.prefetch_depth,
            order=order,
            device=self.device,
        )
        self.last_prefetch_stats = prefetcher.stats
        return prefetcher

    def _blocks(self, residual_padded=None, order=None):
        """One streamed pass of DeviceBlocks for this shard; when a padded
        residual plane is given, each block's offsets get its slice added."""
        for blk in self._prefetcher(order):
            if residual_padded is not None:
                blk.data[self.shard_id] = _fuse_block_offsets(
                    blk.data[self.shard_id], residual_padded, blk.start
                )
            yield blk

    def _pass_blocks(self, residual_padded=None, order=None, probe=None):
        """One streamed pass, residency-aware. With no residency plane this
        is ``_blocks``; with one it is the resident/streamed merge of
        ``_resident_pass``. Either way the probe (when given) is told each
        yielded block's true index so gap attribution survives skips and
        merges."""
        if self._residency is None:
            for blk in self._blocks(residual_padded, order=order):
                if probe is not None:
                    probe.note_visit(blk.index)
                yield blk
            return
        yield from self._resident_pass(residual_padded, order, probe)

    def _resident_pass(self, residual_padded, order, probe):
        """Merge device-resident blocks with the streamed remainder.

        The visit order is IDENTICAL to the non-resident pass — resident
        blocks are served in place from device memory, only the
        non-resident remainder flows through the prefetcher — so the
        accumulation, and the fit, is bitwise the non-resident one.

        Resident entries keep their BASE offsets; the CD residual is added
        into a per-pass copy. Re-pinning happens HERE, at pass start, from
        the probe's previous completed pass — between passes, never
        mid-pass.
        """
        mgr = self._residency
        if probe is not None and probe.has_measurements:
            mgr.update_gaps({
                s["block"]: s["gap_estimate"] for s in probe.last_pass
            })
            mgr.repin()
        visit = (
            list(range(self.source.plan.num_blocks))
            if order is None
            else [int(i) for i in order]
        )
        prefetcher = self._prefetcher([i for i in visit if not mgr.is_resident(i)])
        streamed = iter(prefetcher)
        pending = next(streamed, None)
        for i in visit:
            blk = mgr.get(i)
            if blk is not None:
                prefetcher.stats.resident_hit_blocks += 1
                prefetcher.stats.resident_hit_bytes += mgr.block_bytes
            elif pending is not None and pending.index == i:
                blk = pending
                # store-on-visit: the upload just paid for is retained if
                # the block is in the pin target and the budget has room
                mgr.offer(i, blk)
                pending = next(streamed, None)
            else:
                continue  # skipped upstream (on_block_error=skip)
            if probe is not None:
                probe.note_visit(blk.index)
            data = blk.data[self.shard_id]
            if residual_padded is not None:
                data = _fuse_block_offsets(data, residual_padded, blk.start)
            yield DeviceBlock(
                index=blk.index, start=blk.start, num_real=blk.num_real,
                data={self.shard_id: data}, weight_sum=blk.weight_sum,
            )

    # -- Coordinate interface --------------------------------------------

    def update_model_device(
        self, model: Optional[GeneralizedLinearModel], residual_scores: torch.Tensor
    ) -> GeneralizedLinearModel:
        plan = self.source.plan
        residual_padded = torch.nn.functional.pad(
            residual_scores.to(self.device, torch.float32),
            (0, plan.padded_rows - residual_scores.shape[0]),
        )
        w0 = (
            torch.zeros((self.dim,), dtype=torch.float32, device=self.device)
            if model is None
            else model.coefficients.means.to(self.device)
        )
        info = StreamSolveInfo()
        probe = (
            BlockStatsProbe()
            # the residency plane NEEDS the gap probe: the resident set is
            # chosen from measured gaps, never statically
            if (self.collect_block_stats or self._residency is not None)
            and self.mode == "full"
            and self.cluster is None  # the workers report stats instead
            else None
        )
        with span(
            "fe/solve",
            device_sync=True,
            optimizer=self.configuration.optimizer_config.optimizer.name,
            streaming=self.mode,
            blocks=plan.num_blocks,
        ):
            if self.cluster is not None:
                result = self._solve_cluster(w0, residual_scores, info)
            elif self.mode == "full":
                result = solve_streaming(
                    self.objective(),
                    w0,
                    make_blocks=lambda: (
                        blk.data[self.shard_id]
                        for blk in self._pass_blocks(residual_padded, probe=probe)
                    ),
                    configuration=self.configuration,
                    info=info,
                    probe=probe,
                )
            else:
                total_weight = float(np.sum(self.source.row_planes().weights))
                scheduler = None
                if self.gap_schedule:
                    if self._gap_scheduler is None:
                        self._gap_scheduler = GapScheduler(
                            plan.num_blocks, plan=plan, seed=self.seed
                        )
                        if self._residency is not None:
                            # stochastic repin rides the scheduler's own
                            # epoch-end gap feedback; mark_failed evicts
                            # through the same attachment
                            self._gap_scheduler.attach_residency(self._residency)
                    scheduler = self._gap_scheduler
                result = solve_streaming_stochastic(
                    self.objective(),
                    w0,
                    make_blocks_ordered=lambda order: _OwnShardBlocks(
                        self, residual_padded, order
                    ),
                    configuration=self.configuration,
                    num_blocks=plan.num_blocks,
                    total_weight=total_weight,
                    epochs=self.epochs,
                    chunk_iters=self.chunk_iters,
                    blocks_per_update=self.blocks_per_update,
                    seed=self.seed,
                    info=info,
                    scheduler=scheduler,
                )
                if scheduler is not None:
                    self.last_schedule_decisions = scheduler.drain_decisions()
        skipped = self.source.drain_skipped_blocks()
        if skipped:
            self.last_skipped_blocks = skipped
            failed = [s["block"] for s in skipped]
            if self._gap_scheduler is not None:
                self._gap_scheduler.mark_failed(failed)
            if self._residency is not None:
                # idempotent with the scheduler's forwarding: a pinned
                # block that failed to rebuild must leave the device
                self._residency.mark_failed(failed)
        self.last_solve_info = info
        self.last_tracker = FixedEffectOptimizationTracker(
            states=OptimizationStatesTracker.from_result(result)
        )
        if probe is not None:
            self.last_block_stats = probe.last_pass
            if self.last_prefetch_stats is not None:
                self.last_prefetch_stats.block_gaps = {
                    s["block"]: s["gap_estimate"] for s in probe.last_pass
                }
        if self._residency is not None:
            if probe is not None and probe.has_measurements:
                # fold the FINAL pass's gaps in so the next solve (or the
                # score passes between CD outer iterations) starts on the
                # freshest resident set — still a between-pass repin
                self._residency.update_gaps({
                    s["block"]: s["gap_estimate"] for s in probe.last_pass
                })
                self._residency.repin()
            decisions = self._residency.drain_decisions()
            if decisions:
                self.last_residency_decisions = (
                    self.last_residency_decisions or []
                ) + decisions
        return GeneralizedLinearModel(
            coefficients=Coefficients(means=result.w[0]), task=self.task
        )

    def _solve_cluster(self, w0: torch.Tensor, residual_scores: torch.Tensor,
                       info: StreamSolveInfo):
        """Full-batch solve with every streamed pass handed to the
        cluster's distributed pass (``parallel/cluster``).

        The workers return UNregularized partial (f, g) sums, summed in
        float64 by the coordinator; the regularization is finalized here,
        as the single-host full pass does, so the L-BFGS trajectory is the
        single-host one up to the order of the partial sums. The last
        pass's worker block stats land in ``last_block_stats``, the
        reassignment and rebalance events in ``last_cluster_events`` and
        the pass profiles in ``last_cluster_passes``."""
        programs = StreamPrograms.for_objective(self.objective())
        self.cluster.set_residual(
            None if residual_scores is None
            else residual_scores.detach().to(torch.float32).cpu().numpy()
        )
        last_stats: list = []

        def pass_fn(w_at, l2):
            f_sum, g_sum, _, block_stats = self.cluster.distributed_pass(
                w_at.detach().cpu().numpy()
            )
            info.blocks += len(block_stats)
            last_stats[:] = block_stats
            return programs.finalize(
                torch.tensor(f_sum, dtype=w_at.dtype, device=w_at.device),
                torch.from_numpy(np.asarray(g_sum)).to(w_at.device, w_at.dtype),
                w_at,
                l2,
            )

        result = solve_streaming(
            self.objective(), w0, make_blocks=None, configuration=self.configuration,
            info=info, pass_fn=pass_fn,
        )
        if last_stats:
            self.last_block_stats = [
                {
                    "block": st["block"],
                    "partial_loss": st["partial_loss"],
                    "partial_grad_norm": st["partial_grad_norm"],
                    "gap_estimate": st["gap"],
                    "host": st.get("host", -1),
                }
                for st in sorted(last_stats, key=lambda s: s["block"])
            ]
        events = self.cluster.drain_events()
        if events:
            self.last_cluster_events = events
        drain_profiles = getattr(self.cluster, "drain_pass_profiles", None)
        if drain_profiles is not None:
            profiles = drain_profiles()
            if profiles:
                self.last_cluster_passes = profiles
        return result

    def score_device(self, model: GeneralizedLinearModel) -> torch.Tensor:
        plan = self.source.plan
        w = model.coefficients.means.to(self.device)
        out = torch.zeros((plan.padded_rows,), dtype=torch.float32, device=self.device)
        # residency-aware: score passes serve pinned blocks from the device
        for blk in self._pass_blocks():
            scores = blk.data[self.shard_id].features.matvec(w)
            out[blk.start:blk.start + scores.shape[0]] = scores
        return out[: plan.total_rows]

    def score(self, model: GeneralizedLinearModel) -> np.ndarray:
        return self.score_device(model).cpu().numpy()


class _OwnShardBlocks:
    """Iterable view of one streamed pass restricted to the coordinate's
    shard, with residual offsets added (stochastic mode needs block-level
    weight sums, so it receives the DeviceBlock-shaped wrapper)."""

    def __init__(self, coord, residual_padded, order):
        self.coord = coord
        self.residual_padded = residual_padded
        self.order = None if order is None else [int(i) for i in order]

    def __iter__(self):
        for blk in self.coord._pass_blocks(self.residual_padded, order=self.order):
            yield _ShardBlock(
                data=blk.data[self.coord.shard_id],
                weight_sum=blk.weight_sum,
                index=blk.index,
            )


@dataclasses.dataclass
class _ShardBlock:
    data: object
    weight_sum: float
    # real block index: keeps gap attribution correct when a degraded
    # pass (on_block_error=skip) yields fewer blocks than ordered
    index: int = -1

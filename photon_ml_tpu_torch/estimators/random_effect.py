"""Random-effect training and scoring: batched per-entity solves.

Port of ``photon_ml_tpu/estimators/random_effect.py`` (reference
algorithm/RandomEffectCoordinate.scala:39 — updateModel :103-143 runs one
local solve per entity; score :157-187 covers active + passive data). Each
bucket is one batched solve over its entity lanes — L-BFGS, TRON or
OWL-QN, as the configuration selects (``opt.solve``) — whose value and
gradient go through the fused kernel ``fused_value_grad_batched_f32`` on
the card.

Convergence-adaptive driver: a lockstep dispatch runs until its slowest
entity converges. With ``configuration.adaptive.enabled`` a bucket instead
runs in chunks of ``chunk_iters`` outer iterations (the whole solver state
carried across chunks, so each lane's trajectory equals the one-shot
dispatch's), pulls the per-lane converged mask after each chunk, and
compacts the unconverged entities into a dense prefix of the next smaller
power-of-two lane count.

``overlap_buckets`` (the async schedule's RE leg) solves buckets on worker
threads, each on a CUDA stream of its own (``algorithm/schedule.py``):
while one bucket's solve waits on its host pulls, another bucket's
launches keep the card busy. ``align_warm_start`` re-lays a model out onto
another dataset's entities by id (``GameEstimator.resolve_coordinate``).

A dataset placed over a device grid (``data.random_effect.place_dataset``)
solves each bucket one device slice at a time, each slice where it was
placed at build (K6 once a slice); the slices' results travel to the home
device only to make the model, concatenated there in slice order, as do
the scores. Entity solves are independent, so the result is the unsplit
solve's, lane for lane. On a mesh that spans ranks a rank solves and
scores only its own slices, and the other ranks' results arrive by
``all_gather_blocks`` (every rank's model is the one-process model,
bitwise).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.algorithm.schedule import ScheduleExecutor
from photon_ml_tpu_torch.data.random_effect import PlacedBucket, RandomEffectDataset, ReBucket
from photon_ml_tpu_torch.losses.objective import GlmObjective, make_glm_objective
from photon_ml_tpu_torch.losses.pointwise import loss_for_task
from photon_ml_tpu_torch.models.random_effect import RandomEffectModel
from photon_ml_tpu_torch.ops.data import LabeledData
from photon_ml_tpu_torch.ops.features import DenseFeatures
from photon_ml_tpu_torch.opt.config import GlmOptimizationConfiguration
from photon_ml_tpu_torch.opt.solve import (
    solve,
    solve_chunk,
    solve_finalize,
    solve_init,
    solver_kind,
)
from photon_ml_tpu_torch.opt.state import SolveResult
from photon_ml_tpu_torch.opt.tracking import SolverStats
from photon_ml_tpu_torch.projector import ProjectorType
from photon_ml_tpu_torch.telemetry.span import span
from photon_ml_tpu_torch.types import ConvergenceReason, TaskType

_NOT_CONVERGED = ConvergenceReason.NOT_CONVERGED.value


def _bucket_data(bucket: ReBucket) -> LabeledData:
    return LabeledData(
        features=DenseFeatures(matrix=bucket.X),
        labels=bucket.labels,
        offsets=bucket.offsets,
        weights=bucket.weights,
    )


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


@dataclasses.dataclass
class _BucketSolver:
    """One (task, configuration, compute_variances) combination; the
    configuration's own L1 weight selects OWL-QN (an L1 weight of 0 pins
    L-BFGS or TRON)."""

    objective: GlmObjective
    configuration: GlmOptimizationConfiguration
    compute_variances: bool
    kind: str  # opt.solve.solver_kind

    @property
    def l2(self) -> float:
        return self.configuration.l2_weight

    def mask_and_var(self, res: SolveResult, data: LabeledData, pv: torch.Tensor):
        """Coefficients of padding columns forced to 0, and the optional
        variances 1/(H_jj + eps) (reference
        DistributedOptimizationProblem.scala:80-94)."""
        w = torch.where(pv, res.w, torch.zeros_like(res.w))
        var = None
        if self.compute_variances:
            diag = self.objective.hessian_diag(res.w, data, self.l2)
            var = torch.where(pv, 1.0 / (diag + 1e-12), torch.zeros_like(diag))
        return w, var

    def oneshot(self, bucket: ReBucket, w0: torch.Tensor, index: int):
        """Lockstep dispatch: every lane until the slowest is done."""
        data = _bucket_data(bucket)
        res = solve(self.objective, w0, data, self.configuration)
        w, var = self.mask_and_var(res, data, bucket.proj_valid)
        stats = SolverStats.of_bucket(
            index, self.kind, self.configuration.adaptive.chunk_iters, (bucket.num_entities,),
            None, res.iterations.cpu().numpy(), res.reason.cpu().numpy(),
        )
        return res, w, var, stats

    def adaptive(self, bucket: ReBucket, w0: torch.Tensor, index: int):
        """Chunked rounds + power-of-two lane compaction; results in the
        bucket's entity order."""
        cfg = self.configuration
        E = bucket.num_entities
        K = cfg.adaptive.chunk_iters
        max_iter = cfg.optimizer_config.max_iterations
        data = _bucket_data(bucket)
        pv = bucket.proj_valid
        state = solve_init(self.objective, w0, data, cfg)
        live = torch.arange(E, device=w0.device)  # lane -> entity row
        width = E
        buffers: Dict[str, torch.Tensor] = {}
        its_before = np.zeros(E, dtype=np.int64)
        executed, widths = 0, []

        def scatter_extract():
            # done lanes never advance, so re-scattering one is idempotent
            res = solve_finalize(state, cfg)
            w_m, var = self.mask_and_var(res, data, pv)
            leaves = {"__w": w_m, "__var": var}
            leaves.update({f.name: getattr(res, f.name) for f in dataclasses.fields(res)})
            for name, arr in leaves.items():
                if arr is None:
                    continue
                if name not in buffers:
                    buffers[name] = torch.zeros(
                        (E,) + tuple(arr.shape[1:]), dtype=arr.dtype, device=arr.device
                    )
                buffers[name][live] = arr

        # ceil(max_iter/K) chunks finish every lane; +1 for the
        # converged-at-init case where the first chunk advances nothing
        for round_index in range(-(-max_iter // K) + 1):
            with span("re/adaptive_round", bucket=index, round=round_index, width=width):
                state = solve_chunk(self.objective, state, data, cfg, num_iters=K)
                widths.append(width)
                its_after = state.it.cpu().numpy()
                executed += width * int(np.max(its_after - its_before))
                its_before = its_after
                done = (state.reason != _NOT_CONVERGED) | (state.it >= max_iter)
                n_live = int((~done).sum())
                if n_live == 0:
                    break
                new_width = _next_pow2(max(n_live, cfg.adaptive.min_lanes))
                if new_width < width:
                    # freeze the current results, then move the survivors
                    # (and done lanes as filler up to the new width) to a
                    # dense prefix
                    scatter_extract()
                    keep = torch.argsort(done.to(torch.int8), stable=True)[:new_width]
                    state = state.take_lanes(keep)
                    data = data.take_lanes(keep)
                    pv, live, width = pv[keep], live[keep], new_width
                    its_before = its_before[keep.cpu().numpy()]
        scatter_extract()
        res = SolveResult(**{
            f.name: buffers.get(f.name) for f in dataclasses.fields(SolveResult)
        })
        stats = SolverStats.of_bucket(
            index, self.kind, K, widths, executed,
            res.iterations.cpu().numpy(), res.reason.cpu().numpy(),
        )
        return res, buffers["__w"], buffers.get("__var"), stats


def train_random_effects(
    dataset: RandomEffectDataset,
    task: TaskType,
    configuration: GlmOptimizationConfiguration,
    initial_model: Optional[RandomEffectModel] = None,
    compute_variances: bool = False,
    stats_out: Optional[List[SolverStats]] = None,
    overlap_buckets: int = 0,
) -> Tuple[RandomEffectModel, List[SolveResult]]:
    """Solve one GLM per entity, bucket by bucket. Returns the model and the
    per-bucket SolveResults (one lane per entity); ``stats_out`` gets one
    ``SolverStats`` a bucket.

    With ``configuration.adaptive.enabled``, buckets of more than
    ``adaptive.min_lanes`` entities run through the convergence-adaptive
    driver; its results equal the one-shot dispatch's lane for lane.
    ``initial_model`` warm-starts from a model of the same dataset.

    ``overlap_buckets >= 2`` solves that many buckets at once on worker
    threads, each on its own CUDA stream; the warm starts are laid out on
    the calling thread. The bucket solves are independent and no kernel on
    the path adds with atomics, so the results equal the sequential path's
    bitwise.
    """
    solver = _BucketSolver(
        make_glm_objective(loss_for_task(task)), configuration, compute_variances,
        solver_kind(configuration),  # raises for TRON with L1
    )
    adaptive = configuration.adaptive

    def warm_start(b: int, bucket: ReBucket) -> torch.Tensor:
        if initial_model is not None:
            return _lanes(initial_model.coefficients[b].to(bucket.home, torch.float32),
                          bucket.num_entities)
        return torch.zeros(
            (bucket.num_entities, bucket.local_dim), dtype=torch.float32,
            device=bucket.home,
        )

    def use_adaptive(bucket: ReBucket) -> bool:
        return adaptive.enabled and bucket.num_entities > adaptive.min_lanes

    def solve_whole(b: int, bucket: ReBucket, w0: torch.Tensor):
        if use_adaptive(bucket):
            return solver.adaptive(bucket, w0, b)
        return solver.oneshot(bucket, w0, b)

    def solve_bucket(b: int, bucket: ReBucket, w0: torch.Tensor):
        if isinstance(bucket, PlacedBucket):
            return _solve_placed(solve_whole, b, bucket, w0)
        return solve_whole(b, bucket, w0)

    def span_attrs(b: int, bucket: ReBucket) -> dict:
        return dict(bucket=b, mode="adaptive" if use_adaptive(bucket) else "oneshot",
                    entities=bucket.num_entities, optimizer=solver.kind)

    buckets = dataset.buckets
    if int(overlap_buckets) >= 2 and len(buckets) > 1:
        with ScheduleExecutor(
            max_in_flight=min(int(overlap_buckets), len(buckets)), name="re-buckets",
            device=buckets[0].home,
        ) as executor:
            for b, bucket in enumerate(buckets):
                w0 = warm_start(b, bucket)
                executor.submit(
                    b, functools.partial(solve_bucket, b, bucket, w0), inputs=w0,
                    span_name="re/solve_bucket", overlap=True, **span_attrs(b, bucket),
                )
            outs = executor.drain()
    else:
        outs = []
        for b, bucket in enumerate(buckets):
            w0 = warm_start(b, bucket)
            with span("re/solve_bucket", device_sync=True, **span_attrs(b, bucket)):
                outs.append(solve_bucket(b, bucket, w0))

    coeffs, variances, results = [], [], []
    for res, w, var, stats in outs:
        if stats_out is not None:
            stats_out.extend(stats if isinstance(stats, list) else [stats])
        coeffs.append(w)
        variances.append(var)
        results.append(res)
    model = RandomEffectModel(
        random_effect_type=dataset.config.random_effect_type,
        task=task,
        coefficients=coeffs,
        variances=variances,
        proj_indices=[b.proj_indices for b in dataset.buckets],
        proj_valid=[b.proj_valid for b in dataset.buckets],
        entity_ids=dataset.entity_ids,
        entity_to_loc=dataset.entity_to_loc,
        global_dim=dataset.global_dim,
        projector_type=dataset.config.projector,
        projection_seed=dataset.config.seed,
    )
    return model, results


def _solve_placed(solve_whole, b: int, bucket: PlacedBucket, w0: torch.Tensor):
    """One placed bucket solved a slice at a time where each slice lives
    (this process's slices), the results concatenated in slice order on
    the home device, the other ranks' gathered; one SolverStats a slice
    solved here."""
    per = bucket.per_slice
    outs = {k: solve_whole(b, sl, w0[k * per:(k + 1) * per].to(sl.home))
            for k, sl in bucket.local()}

    def cat(i, name=None):
        parts = {k: (o[i] if name is None else getattr(o[i], name)) for k, o in outs.items()}
        return None if next(iter(parts.values())) is None else bucket.gather(parts)

    res = SolveResult(**{f.name: cat(0, f.name) for f in dataclasses.fields(SolveResult)})
    return res, cat(1), cat(2), [o[3] for o in outs.values()]


def _lanes(w: torch.Tensor, num_entities: int) -> torch.Tensor:
    """A bucket's coefficients [E', D] laid on its ``num_entities`` lanes: a
    model of the same entities with or without a grid's entity padding
    (lanes with no entity id hold zeros)."""
    if w.shape[0] > num_entities:
        return w[:num_entities]
    if w.shape[0] < num_entities:
        return torch.nn.functional.pad(w, (0, 0, 0, num_entities - w.shape[0]))
    return w


def _bucket_scores(bucket: ReBucket, w: torch.Tensor) -> torch.Tensor:
    """x·w of every active slot of a bucket, flat [E*S]: a placed bucket's
    slice by slice where each lives, gathered on the home device."""
    w = _lanes(w, bucket.num_entities)
    if not isinstance(bucket, PlacedBucket):
        return torch.einsum("esd,ed->es", bucket.X, w).reshape(-1)
    per = bucket.per_slice
    return bucket.gather({
        k: torch.einsum("esd,ed->es", sl.X, w[k * per:(k + 1) * per].to(sl.home)).reshape(-1)
        for k, sl in bucket.local()})


def align_warm_start(
    model: RandomEffectModel, dataset: RandomEffectDataset
) -> RandomEffectModel:
    """Re-lay a trained RE model out onto a DIFFERENT dataset's entity and
    bucket layout, so that it can warm-start ``train_random_effects`` there
    (reference :482 of the JAX module).

    ``train_random_effects`` takes ``initial_model.coefficients[b]`` by
    position, which is right only for a model of the same dataset. The old
    coefficients are joined by entity id and global feature and scattered
    through the new dataset's projection indices; an entity or a feature the
    old model never saw starts at 0. On the device: one ``searchsorted`` a
    bucket into the old model's sorted (entity, feature) keys
    (``RandomEffectModel.score_table``)."""
    if dataset.config.projector is ProjectorType.RANDOM:
        raise ValueError(
            "align_warm_start cannot re-scatter into a RANDOM-projected "
            "dataset: projected local spaces are seed/dim-dependent and "
            "global-space coefficients do not map back exactly"
        )
    dev = dataset.buckets[0].home
    if model.projector_type is ProjectorType.RANDOM or model.score_table()[0].numel() == 0:
        # back-projected dense coefficients, through the host
        dense = dict(model.items())
        coeffs = []
        for b, bucket in enumerate(dataset.buckets):
            idx_b = bucket.proj_indices.cpu().numpy()
            ok_b = bucket.proj_valid.cpu().numpy()
            w = np.zeros(idx_b.shape, dtype=np.float32)
            for e, eid in enumerate(dataset.entity_ids[b]):
                old = dense.get(eid)
                if old:
                    w[e] = [old.get(int(i), 0.0) if ok else 0.0
                            for i, ok in zip(idx_b[e], ok_b[e])]
            coeffs.append(torch.from_numpy(w).to(dev))
    else:
        keys, table = (t.to(dev) for t in model.score_table())
        stride = model.global_dim + 1
        coeffs = []
        for b, bucket in enumerate(dataset.buckets):
            pos = torch.from_numpy(model.entity_positions(dataset.entity_ids[b])).to(dev)
            pidx = bucket.proj_indices.long()
            want = pos.unsqueeze(1) * stride + pidx
            at = torch.searchsorted(keys, want).clamp(max=keys.numel() - 1)
            hit = ((keys[at] == want) & (pos.unsqueeze(1) >= 0) & bucket.proj_valid
                   & (pidx < model.global_dim))
            coeffs.append(torch.where(hit, table[at], torch.zeros((), device=dev)))
    return RandomEffectModel(
        random_effect_type=dataset.config.random_effect_type,
        task=model.task,
        coefficients=coeffs,
        variances=[None] * len(coeffs),
        proj_indices=[b.proj_indices for b in dataset.buckets],
        proj_valid=[b.proj_valid for b in dataset.buckets],
        entity_ids=dataset.entity_ids,
        entity_to_loc=dataset.entity_to_loc,
        global_dim=dataset.global_dim,
        projector_type=dataset.config.projector,
        projection_seed=dataset.config.seed,
    )


def score_random_effects_device(
    model: RandomEffectModel, dataset: RandomEffectDataset
) -> torch.Tensor:
    """Raw per-row scores x·w_entity in the original row order (active +
    passive rows, reference RandomEffectCoordinate.score :157-187; offsets
    not included), on the device: every bucket's scores are concatenated and
    gathered through ``dataset.row_gather`` (each row has exactly one source
    slot; uncovered rows read the trailing 0). No per-row entity lookup."""
    parts = []
    for w, bucket, p in zip(model.coefficients, dataset.buckets, dataset.passive):
        parts.append(_bucket_scores(bucket, w))
        if p is not None:
            parts.append((p.X * w[p.entity_index]).sum(-1))
    flat = torch.cat(parts + [torch.zeros(1, dtype=torch.float32, device=dataset.row_gather.device)])
    return flat[dataset.row_gather]

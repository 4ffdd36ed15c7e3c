"""Factored random-effect coordinate: per-entity latent factors and a shared
projection matrix, trained by alternating solves.

Port of ``photon_ml_tpu/algorithm/factored_random_effect.py`` (reference
algorithm/FactoredRandomEffectCoordinate.scala:40 — the alternating loop
:112-146 interleaves (a) a per-entity random-effect solve in the
k-dimensional latent space and (b) a global solve for the projection matrix
B as one (d·k)-coefficient GLM over Kronecker-product features
kron(x, latent) (:227-280); MFOptimizationConfiguration.scala:29).

Everything stays on the device. Step (a) projects each bucket through B
(one batched product X @ B[proj_indices]) and runs the batched
random-effect trainer in the latent space: its value and gradient go
through ``fused_value_grad_batched_f32`` at [E, S, k]. Step (b) never
materializes kron(x, v): :class:`KronFeatures` gives the solvers the three
linear maps of the implicit [n, d·k] design matrix as batched products and
one fixed-order segmented sum into the [d, k] gradient, so L-BFGS, TRON and
OWL-QN run unchanged over vec(B) as one lane. The segments (every local
column grouped by its global column) are the same for the whole solve, so
their plan is made once: chunks of at most ``SEGMENT_CHUNK`` terms summed
by one padded gather and a sum over the chunk axis, then the chunks'
sums the same way, until one row a column is left. At full width an
accumulating ``index_put_`` (which sorts its 2·10⁷ rows of k values on
every call) and ``torch.segment_reduce`` (a thread a column and factor)
each take about a second or more a call on an H100 (PERF.md).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.data.random_effect import RandomEffectDataset
from photon_ml_tpu_torch.estimators.random_effect import (
    score_random_effects_device,
    train_random_effects,
)
from photon_ml_tpu_torch.losses.objective import make_glm_objective
from photon_ml_tpu_torch.losses.pointwise import loss_for_task
from photon_ml_tpu_torch.models.random_effect import RandomEffectModel
from photon_ml_tpu_torch.ops.data import LabeledData
from photon_ml_tpu_torch.opt.config import GlmOptimizationConfiguration
from photon_ml_tpu_torch.opt.solve import solve
from photon_ml_tpu_torch.projector import ProjectorType
from photon_ml_tpu_torch.types import TaskType


@dataclasses.dataclass(frozen=True)
class MFOptimizationConfiguration:
    """Reference MFOptimizationConfiguration.scala:29
    (``numLatentFactors,numIterations``)."""

    num_latent_factors: int
    num_iterations: int = 1
    seed: int = 0

    def __post_init__(self) -> None:
        if self.num_latent_factors < 1:
            raise ValueError("num_latent_factors must be >= 1")
        if self.num_iterations < 1:
            raise ValueError("num_iterations must be >= 1")


# terms a chunk of the segmented sum (KronFeatures.segments)
SEGMENT_CHUNK = 256


def segment_plan(order: torch.Tensor, lengths: torch.Tensor,
                 chunk: int = SEGMENT_CHUNK) -> List[torch.Tensor]:
    """Gather indices of a fixed-order segmented sum. ``order`` lists the
    terms' positions segment by segment, ``lengths`` the segments' sizes.
    Each level cuts every segment into chunks of at most ``chunk`` entries
    and gives a [chunks, width] index into the level's input, padded with
    the input's row count (the caller appends a zero row there); summing
    the gathered rows over the width axis gives the next level's input,
    whose segments are the chunk counts. The last level has one chunk a
    segment."""
    levels = []
    src = order
    while True:
        n_chunks = (lengths + chunk - 1) // chunk
        width = min(chunk, int(lengths.max()))
        seg = torch.repeat_interleave(torch.arange(lengths.numel(), device=order.device),
                                      n_chunks)
        first = torch.cumsum(n_chunks, 0) - n_chunks
        within = torch.arange(seg.numel(), device=order.device) - first[seg]
        base = (torch.cumsum(lengths, 0) - lengths)[seg] + within * chunk
        count = torch.clamp(lengths[seg] - within * chunk, max=chunk)
        slot = torch.arange(width, device=order.device)
        pos = torch.clamp(base.unsqueeze(1) + slot, max=src.numel() - 1)
        levels.append(torch.where(slot < count.unsqueeze(1), src[pos], src.numel()))
        if seg.numel() == lengths.numel():
            return levels
        src = torch.arange(seg.numel(), device=order.device)
        lengths = n_chunks


def segment_sums(values: torch.Tensor, plan: List[torch.Tensor]) -> torch.Tensor:
    """Σ of the rows of ``values`` [N, k] segment by segment, in the fixed
    order of ``plan`` (:func:`segment_plan`): [segments, k]."""
    for idx in plan:
        values = torch.cat([values, values.new_zeros(1, values.shape[1])])[idx].sum(1)
    return values


@dataclasses.dataclass
class KronFeatures:
    """Implicit design matrix of the projection-matrix solve.

    Row (e, s) of bucket b has features kron(latent[e], x[e, s]) laid out as
    vec(B) with B of shape [d_global, k]: coefficient (c, j) multiplies the
    value at global column c times latent[e, j]. Rows are the concatenation
    of every bucket's flattened [E·S] axis (padding rows have weight 0
    upstream, padding columns x = 0).
    """

    xs: List[torch.Tensor]       # per bucket [E, S, D] local features
    pidxs: List[torch.Tensor]    # per bucket [E, D] int64 global column of each local one
    latents: List[torch.Tensor]  # per bucket [E, k]
    d_global: int
    k: int
    # (columns, plan): the distinct global columns of every bucket's local
    # ones, and the segment_plan that sums the local columns' terms by
    # global column (built at first use)
    _segments: Optional[Tuple[torch.Tensor, List[torch.Tensor]]] = dataclasses.field(
        default=None, init=False, repr=False
    )

    @property
    def num_rows(self) -> int:
        return sum(x.shape[0] * x.shape[1] for x in self.xs)

    @property
    def dim(self) -> int:
        return self.d_global * self.k

    def matvec(self, w: torch.Tensor) -> torch.Tensor:
        """z[e, s] = x[e, s] · (B[pidx[e]] @ v[e]): the [E, D] per-entity
        coefficients first, then one batched product with x (no [E, S, D, k]
        temporary)."""
        B = w.reshape(self.d_global, self.k)
        outs = []
        for x, pidx, v in zip(self.xs, self.pidxs, self.latents):
            w_e = torch.bmm(B[pidx], v.unsqueeze(-1))  # [E, D, 1]
            outs.append(torch.bmm(x, w_e).reshape(-1))
        return torch.cat(outs)

    def segments(self) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(global columns, segment plan), made at the first call."""
        if self._segments is None:
            cols, order = torch.sort(torch.cat([p.reshape(-1) for p in self.pidxs]), stable=True)
            uniq, lengths = torch.unique_consecutive(cols, return_counts=True)
            self._segments = (uniq, segment_plan(order, lengths))
        return self._segments

    def _scatter(self, c: torch.Tensor, square: bool) -> torch.Tensor:
        """Σ over rows of c·x[e, s, d]·v[e, j] (squared x and v when
        ``square``) added into row pidx[e, d] of the [d_global, k] result:
        the [E, D, k] terms of every bucket in global-column order, summed
        segment by segment in that order (the same order every call, on
        either device)."""
        contribs = []
        start = 0
        for x, v in zip(self.xs, self.latents):
            e_n, s_n = x.shape[0], x.shape[1]
            cb = c[start:start + e_n * s_n].reshape(e_n, 1, s_n)
            start += e_n * s_n
            if square:
                x, v = x * x, v * v
            g = torch.bmm(cb, x).squeeze(1)  # [E, D]
            contribs.append((g.unsqueeze(-1) * v.unsqueeze(1)).reshape(-1, self.k))
        cols, plan = self.segments()
        out = torch.zeros(self.d_global, self.k, dtype=c.dtype, device=c.device)
        out[cols] = segment_sums(torch.cat(contribs), plan)
        return out.reshape(-1)

    def rmatvec(self, c: torch.Tensor) -> torch.Tensor:
        return self._scatter(c, square=False)

    def rmatvec_sq(self, c: torch.Tensor) -> torch.Tensor:
        return self._scatter(c, square=True)

    def row_norms_sq(self) -> torch.Tensor:
        """‖kron(v_e, x_es)‖² = ‖x_es‖²·‖v_e‖²."""
        outs = []
        for x, v in zip(self.xs, self.latents):
            xn = (x * x).sum(-1)
            vn = (v * v).sum(-1)
            outs.append((xn * vn.unsqueeze(-1)).reshape(-1))
        return torch.cat(outs)


@dataclasses.dataclass
class FactoredRandomEffectModel:
    """Latent per-entity factors and a shared projection matrix (reference
    model/FactoredRandomEffectModel.scala:33). The effective per-entity
    coefficient vector in the original space is B @ latent_e."""

    random_effect_type: str
    task: TaskType
    latent: RandomEffectModel          # coefficients are [E, k] latent factors
    projection_matrix: torch.Tensor    # [d_global, k]

    @property
    def device(self) -> torch.device:
        return self.projection_matrix.device

    @property
    def num_latent_factors(self) -> int:
        return int(self.projection_matrix.shape[1])

    def to_summary_string(self) -> str:
        """Reference Summarizable.toSummaryString (FactoredRandomEffectModel)."""
        return (
            f"factored random effect '{self.random_effect_type}': "
            f"{self.latent.num_entities} entities x "
            f"{self.num_latent_factors} latent factors, projection matrix "
            f"[{int(self.projection_matrix.shape[0])}, {self.num_latent_factors}]"
        )

    def coefficients_for(self, entity_id: str) -> Optional[dict]:
        """Dense original-space coefficients w = B @ latent for one entity."""
        loc = self.latent.entity_to_loc.get(str(entity_id))
        if loc is None:
            return None
        b, e = loc
        w = (self.projection_matrix @ self.latent.coefficients[b][e]).cpu().numpy()
        return {int(i): float(x) for i, x in enumerate(w)}


def _latent_dataset(dataset: RandomEffectDataset, B: torch.Tensor) -> RandomEffectDataset:
    """Every bucket projected into the latent space of B (step (a)'s input):
    X_latent[e, s] = B[pidx[e]]ᵀ x[e, s]; passive rows likewise.

    The returned dataset's "global" space is the k-dimensional latent space
    (identity projection, ``global_dim`` = k), so the latent model trained
    on it exports {latent axis: factor} maps."""
    k = int(B.shape[1])
    new_buckets, new_passive = [], []
    for bucket, p in zip(dataset.buckets, dataset.passive):
        Bg = B[bucket.proj_indices]  # [E, D, k]; padding columns have x == 0
        e_n = bucket.num_entities
        new_buckets.append(dataclasses.replace(
            bucket,
            X=torch.bmm(bucket.X, Bg),
            proj_indices=torch.arange(k, device=B.device).expand(e_n, k).contiguous(),
            proj_valid=torch.ones(e_n, k, dtype=torch.bool, device=B.device),
        ))
        if p is not None:
            Xp = torch.bmm(p.X.unsqueeze(1), Bg[p.entity_index]).squeeze(1)
            new_passive.append(dataclasses.replace(p, X=Xp))
        else:
            new_passive.append(None)
    return dataclasses.replace(
        dataset,
        buckets=new_buckets,
        passive=new_passive,
        global_dim=k,
        config=dataclasses.replace(
            dataset.config, projector=ProjectorType.IDENTITY, projected_dim=None
        ),
    )


@dataclasses.dataclass
class FactoredRandomEffectCoordinate:
    """Alternating MF-style coordinate (reference
    FactoredRandomEffectCoordinate.scala:40), with the coordinate protocol
    of ``CoordinateDescent``: ``update_model_device`` and ``score_device``,
    both on the device."""

    dataset: RandomEffectDataset       # INDEX_MAP/IDENTITY projected blocks
    task: TaskType
    re_configuration: GlmOptimizationConfiguration      # latent-factor solves
    matrix_configuration: GlmOptimizationConfiguration  # projection-matrix solve
    mf_configuration: MFOptimizationConfiguration
    base_offsets: torch.Tensor  # [n] GAME-level offsets, original row order
    # seconds of steps (a) and (b) of each MF iteration of the last update
    last_step_seconds: List[Tuple[float, float]] = dataclasses.field(
        default_factory=list, repr=False
    )
    # a device mesh (the dataset placed over it by GameEstimator): the
    # latent solves inherit the placement, a device slice at a time
    mesh: Optional[object] = None
    mesh_axes: Optional[tuple] = None

    def __post_init__(self) -> None:
        # a RANDOM-projected dataset has no per-column global index map
        # (its proj_indices are zeros): B's gathers and scatters would pile
        # onto row 0
        if self.dataset.config.projector is ProjectorType.RANDOM:
            raise ValueError(
                "FactoredRandomEffectCoordinate requires an INDEX_MAP or "
                "IDENTITY projected dataset (the factored coordinate learns "
                "its own projection matrix)"
            )

    @property
    def device(self) -> torch.device:
        return self.base_offsets.device

    def _init_matrix(self) -> torch.Tensor:
        """Gaussian init scaled 1/sqrt(k), drawn on the host from the seed
        as the JAX package draws it (reference :95)."""
        k = self.mf_configuration.num_latent_factors
        rng = np.random.default_rng(self.mf_configuration.seed)
        B = rng.standard_normal((self.dataset.global_dim, k)) / np.sqrt(k)
        return torch.from_numpy(B.astype(np.float32)).to(self.device)

    def _sync(self) -> None:
        """Wait for the current stream alone (the step timings): under the
        async schedule the update runs on a worker's stream, and a
        device-wide sync would wait for the other workers too."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def update_model_device(
        self, model: Optional[FactoredRandomEffectModel], residual_scores: torch.Tensor
    ) -> FactoredRandomEffectModel:
        ds = self.dataset.update_offsets_device(self.base_offsets + residual_scores)
        B = model.projection_matrix if model is not None else self._init_matrix()
        latent_model = model.latent if model is not None else None
        self.last_step_seconds = []
        for _ in range(self.mf_configuration.num_iterations):
            t0 = time.perf_counter()
            # (a) per-entity latent solve in the space of the current B
            latent_model, _ = train_random_effects(
                _latent_dataset(ds, B), self.task, self.re_configuration,
                initial_model=latent_model,
            )
            self._sync()
            t1 = time.perf_counter()
            # (b) global projection-matrix solve over implicit kron features
            B = self._solve_matrix(ds, latent_model, B)
            self._sync()
            self.last_step_seconds.append((t1 - t0, time.perf_counter() - t1))
        return FactoredRandomEffectModel(
            random_effect_type=self.dataset.config.random_effect_type,
            task=self.task,
            latent=latent_model,
            projection_matrix=B,
        )

    def kron_data(
        self, ds: RandomEffectDataset, latent_model: RandomEffectModel
    ) -> LabeledData:
        """Step (b)'s problem: every bucket's rows over :class:`KronFeatures`."""
        feats = KronFeatures(
            xs=[b.X for b in ds.buckets],
            pidxs=[b.proj_indices for b in ds.buckets],
            latents=list(latent_model.coefficients),
            d_global=ds.global_dim,
            k=self.mf_configuration.num_latent_factors,
        )
        return LabeledData(
            features=feats,
            labels=torch.cat([b.labels.reshape(-1) for b in ds.buckets]),
            offsets=torch.cat([b.offsets.reshape(-1) for b in ds.buckets]),
            weights=torch.cat([b.weights.reshape(-1) for b in ds.buckets]),
        )

    def _solve_matrix(
        self, ds: RandomEffectDataset, latent_model: RandomEffectModel, B: torch.Tensor
    ) -> torch.Tensor:
        objective = make_glm_objective(loss_for_task(self.task))
        result = solve(
            objective, B.reshape(1, -1), self.kron_data(ds, latent_model),
            self.matrix_configuration,
        )
        return result.w[0].reshape(B.shape)

    def score_device(self, model: FactoredRandomEffectModel) -> torch.Tensor:
        """Active and passive scores in the original row order: the latent
        model scored over the B-projected blocks."""
        latent_ds = _latent_dataset(self.dataset, model.projection_matrix)
        return score_random_effects_device(model.latent, latent_ds)

"""Random-effect dataset: entity-grouped padded blocks for batched solves.

Port of ``photon_ml_tpu/data/random_effect.py`` (reference
data/RandomEffectDataSet.scala:47, data/LocalDataSet.scala:36,
projector/IndexMapProjectorRDD.scala:31). A coordinate's data is a handful
of dense padded blocks

    X [E, S, D_local]   labels/offsets/weights [E, S]   proj_indices [E, D_local]

with E entities in a bucket, S that bucket's most samples an entity and
D_local its widest per-entity projected space. The host-side planning —
entity grouping, the active/passive split, index-map projection, the
Pearson feature filter and the padded-cell-minimizing bucket plan — is
copied from the reference unchanged, so the port's buckets equal the
reference's, entity for entity; the blocks are then placed on the device,
where one batched solve per bucket takes the reference's ``vmap``.

On a device grid (``estimators.game.ParallelConfiguration``) every
bucket's entity axis is padded to a multiple of the grid's positions
(:func:`pad_entities_to_multiple`) and split over them once, at build
(:func:`place_dataset`, a :class:`PlacedBucket` a bucket): each slice
lives on its position's device and is solved and scored there. On a mesh
that spans ranks a rank holds only the slices of its own positions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.device import DEFAULT_DEVICE, DeviceLike, resolve_device
from photon_ml_tpu_torch.projector import ProjectorType, RandomProjectionMatrix


@dataclasses.dataclass(frozen=True)
class RandomEffectDataConfiguration:
    """Copy of the reference package's configuration (reference
    RandomEffectDataConfiguration.scala:42 (string mini-language
    ``reType,shard,numPartitions,activeCap,passiveLB,featureRatio,projector``
    with ``index_map``/``identity``/``random=k``) as a typed config.
    numPartitions is superseded by size-bucketing."""

    random_effect_type: str
    active_data_upper_bound: Optional[int] = None   # max active samples/entity
    passive_data_lower_bound: Optional[int] = None  # min samples for an entity to keep passive rows
    features_to_samples_ratio: Optional[float] = None  # cap D_local <= ratio * n_samples
    max_local_features: Optional[int] = None        # hard cap on D_local
    num_buckets: int = 1
    seed: int = 0
    # Projection of per-entity problems (reference ProjectorType):
    # INDEX_MAP (default, exact remap of observed features), IDENTITY
    # (local space == global space), RANDOM (shared Gaussian matrix,
    # ``projected_dim`` required — the `random=k` mini-language arm).
    projector: ProjectorType = ProjectorType.INDEX_MAP
    projected_dim: Optional[int] = None

    def __post_init__(self) -> None:
        if self.projector is ProjectorType.RANDOM:
            if not self.projected_dim:
                raise ValueError("RANDOM projector requires projected_dim (random=k)")
            if (
                self.features_to_samples_ratio is not None
                or self.max_local_features is not None
            ):
                raise ValueError(
                    "feature selection (features_to_samples_ratio / "
                    "max_local_features) does not apply to the RANDOM "
                    "projector; the projection itself bounds the local dim"
                )


@dataclasses.dataclass
class ReBucket:
    """One size-bucket of entities, fully padded, on the device."""

    X: torch.Tensor             # [E, S, D] local-projected dense features
    labels: torch.Tensor        # [E, S]
    offsets: torch.Tensor       # [E, S]
    weights: torch.Tensor       # [E, S] (0 = padding)
    sample_pos: torch.Tensor    # [E, S] int64 original row index (0 where padding)
    proj_indices: torch.Tensor  # [E, D] int64 global feature id per local column
    proj_valid: torch.Tensor    # [E, D] bool: local column is a real feature

    @property
    def num_entities(self) -> int:
        return self.X.shape[0]

    @property
    def max_samples(self) -> int:
        return self.X.shape[1]

    @property
    def local_dim(self) -> int:
        return self.X.shape[2]

    @property
    def home(self) -> torch.device:
        return self.X.device

    @property
    def active_samples(self) -> int:
        return int((self.weights > 0).sum())

    @property
    def cells(self) -> int:
        return self.weights.numel()


@dataclasses.dataclass
class PlacedBucket:
    """A bucket whose entity axis is split over a device mesh
    (:func:`place_dataset`): slice k, entities [k·per, (k+1)·per), is a
    :class:`ReBucket` on the device of mesh position ``positions[k]``,
    moved there once; None where another rank owns that position. The
    projection arrays stay whole on the home device (the coordinate's
    model carries them)."""

    slices: List[Optional[ReBucket]]
    mesh: object                # parallel.mesh.Mesh
    positions: List[tuple]      # slice k's mesh position
    proj_indices: torch.Tensor  # [E, D] int64, whole, on home
    proj_valid: torch.Tensor    # [E, D] bool, whole, on home
    max_samples: int
    active_samples: int         # cells of weight > 0, over every slice
    cells: int                  # cells, over every slice

    @property
    def num_entities(self) -> int:
        return self.proj_indices.shape[0]

    @property
    def local_dim(self) -> int:
        return self.proj_indices.shape[1]

    @property
    def per_slice(self) -> int:
        return self.num_entities // len(self.slices)

    @property
    def home(self) -> torch.device:
        return self.proj_indices.device

    def local(self) -> List[Tuple[int, ReBucket]]:
        """(slice index, slice) of the slices this process holds."""
        return [(k, sl) for k, sl in enumerate(self.slices) if sl is not None]

    def gather(self, parts: Dict[int, torch.Tensor]) -> torch.Tensor:
        """Per-slice tensors (this process's slices, each with ``per_slice``
        leading rows) concatenated in slice order on the home device; the
        slices of other ranks arrive by ``all_gather_blocks``, a collective
        every rank calls in the same order."""
        home = self.home
        vals = {k: p.to(home) for k, p in parts.items()}
        if len(vals) < len(self.slices):
            from photon_ml_tpu_torch.parallel.mesh import all_gather_blocks

            got = all_gather_blocks({self.positions[k]: v for k, v in vals.items()},
                                    self.positions, self.mesh, next(iter(vals.values())))
            vals = {k: got[pos] for k, pos in enumerate(self.positions)}
        return torch.cat([vals[k] for k in range(len(self.slices))])


@dataclasses.dataclass
class RePassiveRows:
    """Passive (score-only) rows of one bucket, local-projected."""

    X: torch.Tensor             # [P, D]
    entity_index: torch.Tensor  # [P] int64 row into the bucket's entity axis
    sample_pos: torch.Tensor    # [P] int64 original row index


@dataclasses.dataclass
class RandomEffectDataset:
    """All buckets of one random-effect coordinate + host-side id maps."""

    config: RandomEffectDataConfiguration
    buckets: List[ReBucket]                    # or PlacedBucket (place_dataset)
    passive: List[Optional[RePassiveRows]]     # parallel to buckets
    entity_ids: List[List[str]]                # per bucket, per entity row
    entity_to_loc: Dict[str, Tuple[int, int]]  # id -> (bucket, row)
    num_rows: int                              # total rows in the source data
    global_dim: int
    # row -> slot in the concatenation of per-bucket flattened active score
    # blocks [E*S] (bucket order, each followed by its passive block [P]),
    # with one trailing zero slot for rows no bucket covers: scoring is one
    # gather (the inverse of the sample_pos scatter)
    row_gather: torch.Tensor = dataclasses.field(repr=False, compare=False)

    @property
    def num_entities(self) -> int:
        return sum(len(ids) for ids in self.entity_ids)

    def to_summary_string(self) -> str:
        """Reference RandomEffectDataSet.toSummaryString
        (RandomEffectDataSet.scala:204-228): active/passive sample counts
        plus this layout's padding accounting."""
        active = sum(b.active_samples for b in self.buckets)
        cells = sum(b.cells for b in self.buckets)
        passive = sum(0 if p is None else p.sample_pos.numel() for p in self.passive)
        pad = cells / active if active else float("nan")
        return (
            f"random-effect dataset '{self.config.random_effect_type}': "
            f"{self.num_entities} entities in {len(self.buckets)} buckets, "
            f"{active} active samples (padding {pad:.2f}x), "
            f"{passive} passive samples, global dim {self.global_dim}"
        )

    def update_offsets_device(self, offsets: torch.Tensor) -> "RandomEffectDataset":
        """Regroup a full-data offset vector on the device into the
        entity-grouped [E, S] blocks: ``sample_pos`` is the row -> (bucket,
        lane, slot) map from build time, so this is one gather per bucket,
        masked to the active slots (padding keeps offset 0); a placed
        bucket's slices each gather on their own device."""
        on: Dict[torch.device, torch.Tensor] = {}

        def regroup(b: ReBucket) -> ReBucket:
            dev = b.weights.device
            if dev not in on:
                on[dev] = offsets.to(dev)
            return dataclasses.replace(b, offsets=torch.where(
                b.weights > 0, on[dev][b.sample_pos], torch.zeros_like(b.offsets)))

        new_buckets = [
            dataclasses.replace(b, slices=[None if sl is None else regroup(sl)
                                           for sl in b.slices])
            if isinstance(b, PlacedBucket) else regroup(b)
            for b in self.buckets
        ]
        return dataclasses.replace(self, buckets=new_buckets)


def _build_row_gather(
    num_rows: int,
    actives: List[Tuple[np.ndarray, np.ndarray]],
    passive_pos: List[Optional[np.ndarray]],
) -> np.ndarray:
    """Invert the (sample_pos, weights>0) scatter into a row -> source-slot
    index over the concatenation [active_b0 | passive_b0 | active_b1 | ...]
    plus one trailing zero slot (rows outside every bucket gather 0.0).
    Active rows are unique across (bucket, lane, slot), so each row has
    exactly one source and the gather reproduces the scatter bitwise."""
    total = sum(pos.size for pos, _ in actives) + sum(
        0 if sp is None else sp.size for sp in passive_pos
    )
    inv = np.full(num_rows, total, dtype=np.int64)
    base = 0
    for (pos, wt), sp in zip(actives, passive_pos):
        flat_pos = np.asarray(pos).ravel()
        m = np.asarray(wt).ravel() > 0
        inv[flat_pos[m]] = base + np.nonzero(m)[0]
        base += flat_pos.size
        if sp is not None:
            inv[np.asarray(sp)] = base + np.arange(sp.size, dtype=np.int64)
            base += sp.size
    return inv



def _expand_nnz(
    act_rows: np.ndarray, row_start: np.ndarray, row_end: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Flatten the CSR slices of ``act_rows`` into (sample_index, flat_index)
    pairs: sample_index points back into act_rows, flat_index into fc/fv."""
    cnt = row_end[act_rows] - row_start[act_rows]
    total = int(cnt.sum())
    rep = np.repeat(np.arange(len(act_rows), dtype=np.int64), cnt)
    within = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    return rep, row_start[act_rows][rep] + within


def _pearson_scores_flat(
    ukeys: np.ndarray,
    ecol: np.ndarray,
    n_ent: int,
    nz_keys: np.ndarray,
    nz_v: np.ndarray,
    y_nz: np.ndarray,
    w_nz: np.ndarray,
    e_act: np.ndarray,
    y_act: np.ndarray,
    w_act: np.ndarray,
) -> np.ndarray:
    """|weighted Pearson| per (entity, local column), computed from segment
    sums over the nonzeros only — the vectorized equivalent of
    :func:`_pearson_scores` over every entity at once (zero feature values
    contribute nothing to the x-moments but their samples still weight the
    label moments, identical to the dense formula)."""
    W = np.bincount(e_act, weights=w_act, minlength=n_ent)
    W = np.maximum(W, 1e-12)
    my = np.bincount(e_act, weights=w_act * y_act, minlength=n_ent) / W
    vy = (
        np.bincount(e_act, weights=w_act * y_act * y_act, minlength=n_ent) / W
        - my * my
    )
    kidx = np.searchsorted(ukeys, nz_keys)
    m = len(ukeys)
    Sx = np.bincount(kidx, weights=w_nz * nz_v, minlength=m)
    Sxx = np.bincount(kidx, weights=w_nz * nz_v * nz_v, minlength=m)
    Sxy = np.bincount(kidx, weights=w_nz * nz_v * y_nz, minlength=m)
    We = W[ecol]
    mx = Sx / We
    cov = Sxy / We - mx * my[ecol]
    vx = Sxx / We - mx * mx
    denom = np.sqrt(np.maximum(vx * vy[ecol], 0.0))
    corr = np.where(denom > 1e-12, np.abs(cov) / np.maximum(denom, 1e-12), 0.0)
    const_nonzero = (vx <= 1e-12) & (np.abs(mx) > 0)
    return np.where(const_nonzero, np.inf, corr)


def _plan_buckets(samples: np.ndarray, dims: np.ndarray, nb: int) -> np.ndarray:
    """Entity → bucket assignment minimizing total padded cells.

    Exact DP over ≤512 candidate boundaries on entities sorted by
    (samples, dims): the cost of a bucket spanning sorted ranks (j, i] is
    count x maxS x maxD — the REAL padded-cell bill of one [E, maxS, maxD]
    block, with the two maxima tracked separately (a product surrogate can
    underestimate ~1000x when samples and dims anti-correlate). O(512² x
    nb) regardless of entity count (candidates are count-quantile
    collapsed, so boundaries are optimal at ~0.2% count granularity).
    The reference bounds the same skew with its partitioner + active cap
    (RandomEffectDataSet.scala:287-388); with dense padded blocks the
    bucket boundaries ARE the balancing mechanism, so they are optimized.
    """
    n = len(samples)
    if nb <= 1 or n <= 1:
        return np.zeros(n, dtype=np.int64)
    order = np.lexsort((dims, samples))
    s_sorted = samples[order].astype(np.float64)
    d_sorted = dims[order].astype(np.float64)
    m = min(512, n)
    bounds = np.unique((np.arange(1, m + 1, dtype=np.int64) * n) // m)  # prefix counts
    G = len(bounds)
    # group g covers sorted ranks [bounds[g-1], bounds[g]); sorted by
    # samples, so a range's maxS is its LAST group's max; maxD needs a
    # running max per range start
    starts = np.concatenate([[0], bounds[:-1]])
    grp_maxS = np.maximum.reduceat(s_sorted, starts)
    grp_maxD = np.maximum.reduceat(d_sorted, starts)
    # maxD[j, i-1] = max of groups j..i-1 (suffix cummax per row); an extra
    # all-zero row for j = G keeps the cand matrix rectangular (that column
    # is forbidden below anyway)
    maxD = np.zeros((G + 1, G))
    for j in range(G):
        maxD[j, j:] = np.maximum.accumulate(grp_maxD[j:])
    C = np.concatenate([[0], bounds]).astype(np.float64)  # [G+1] prefix counts

    # dp[j] = min cost of the first j candidate groups with at most k
    # buckets; splits[k][i-1] remembers the argmin boundary for backtrack
    dp = np.full(G + 1, np.inf)
    dp[0] = 0.0
    row = np.arange(G)[:, None]
    col = np.arange(G + 1)[None, :]
    forbid = col > row  # bucket (j, i] needs j <= i-1, i = row+1
    splits = []
    for _ in range(nb):
        # cand[i-1, j] = dp[j] + (C[i] - C[j]) * maxS(j,i] * maxD(j,i]
        cand = (
            dp[None, :]
            + (C[1:, None] - C[None, :]) * grp_maxS[:, None] * maxD.T
        )  # maxD.T is [G, G+1]: rows i-1, cols j (col G forbidden below)
        cand[forbid] = np.inf
        arg = np.argmin(cand, axis=1)                      # [G]
        best = cand[np.arange(G), arg]
        new_dp = np.concatenate([[0.0], np.minimum(best, dp[1:])])
        # keep the one-fewer-buckets solution where it is already better
        arg = np.where(best <= dp[1:], arg, -1)            # -1 = no new cut
        splits.append(arg)
        dp = new_dp

    # backtrack from the last group through the remembered argmins
    cuts = []
    i = G
    for k in range(len(splits) - 1, -1, -1):
        if i == 0:
            break
        j = int(splits[k][i - 1])
        if j < 0:
            continue  # this level added no bucket ending at i
        cuts.append((j, i))
        i = j
    assert i == 0, "bucket DP backtrack failed to reach the start"
    cuts.reverse()

    bucket_of = np.zeros(n, dtype=np.int64)
    for b, (j, i) in enumerate(cuts):
        lo, hi = int(C[j]), int(C[i])
        bucket_of[order[lo:hi]] = b
    return bucket_of


def build_random_effect_dataset(
    entity_ids: Sequence,
    feature_rows: np.ndarray,
    feature_cols: np.ndarray,
    feature_vals: np.ndarray,
    global_dim: int,
    labels: np.ndarray,
    config: RandomEffectDataConfiguration,
    offsets: Optional[np.ndarray] = None,
    weights: Optional[np.ndarray] = None,
    device: DeviceLike = DEFAULT_DEVICE,
) -> RandomEffectDataset:
    """Group rows by entity, cap/sample, project, bucket, and pad (host
    numpy, as in the reference), then place the blocks on ``device``.

    entity_ids: per-row entity key (len n). feature_*: COO triplets over the
    global feature space. Rows with entities are ALL consumed: up to the active
    cap into solver blocks, the remainder into passive (score-only) rows.
    """
    dev = resolve_device(device)

    def put(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

    n = len(entity_ids)
    labels = np.asarray(labels, dtype=np.float32)
    offsets = np.zeros(n, dtype=np.float32) if offsets is None else np.asarray(offsets, dtype=np.float32)
    weights = np.ones(n, dtype=np.float32) if weights is None else np.asarray(weights, dtype=np.float32)
    rng = np.random.default_rng(config.seed)

    # Entity codes: np.unique on the raw array (no per-row Python str()); the
    # string form is only materialized once per ENTITY for the id maps.
    ids_arr = np.asarray(entity_ids)
    uniq_raw, codes = np.unique(ids_arr, return_inverse=True)
    uniq = uniq_raw.astype(str)
    n_ent = len(uniq)
    counts = np.bincount(codes, minlength=n_ent)

    # CSR-ify the COO features once (row-sorted)
    feature_rows = np.asarray(feature_rows, dtype=np.int64)
    feature_cols = np.asarray(feature_cols, dtype=np.int64)
    feature_vals = np.asarray(feature_vals, dtype=np.float32)
    forder = np.argsort(feature_rows, kind="stable")
    fr, fc, fv = feature_rows[forder], feature_cols[forder], feature_vals[forder]
    row_start = np.searchsorted(fr, np.arange(n))
    row_end = np.searchsorted(fr, np.arange(n) + 1)

    # ---- active/passive split, all entities at once -----------------------
    # Group rows by entity (random order within an entity when capping) and
    # keep the first `cap` per entity: a uniform without-replacement subset —
    # the vectorized equivalent of the reference's per-entity reservoir
    # (RandomEffectDataSet.scala:325-388).
    cap = config.active_data_upper_bound
    if cap is not None:
        perm = np.lexsort((rng.random(n), codes))
    else:
        perm = np.argsort(codes, kind="stable")
    codes_p = codes[perm]
    ent_start_p = np.searchsorted(codes_p, np.arange(n_ent))
    rank_p = np.arange(n, dtype=np.int64) - ent_start_p[codes_p]
    if cap is not None:
        active_m = rank_p < cap
        lb = config.passive_data_lower_bound
        pas_m = ~active_m
        if lb is not None:
            pas_m &= counts[codes_p] >= lb
    else:
        active_m = np.ones(n, dtype=bool)
        pas_m = np.zeros(n, dtype=bool)
    act = perm[active_m]            # active rows, grouped by entity
    e_act_g = codes_p[active_m]     # entity code per active row
    s_act_g = rank_p[active_m]      # slot within entity
    pas = perm[pas_m]
    e_pas_g = codes_p[pas_m]
    acounts = np.bincount(e_act_g, minlength=n_ent)

    # Active nnz, expanded once (reused by projection + Pearson + scatter).
    rep_a, fidx_a = _expand_nnz(act, row_start, row_end)
    nz_e = e_act_g[rep_a]           # entity code per active nonzero
    nz_c = fc[fidx_a]
    nz_v = fv[fidx_a]

    rproj = (
        RandomProjectionMatrix(
            projected_dim=int(config.projected_dim),
            global_dim=int(global_dim),
            seed=config.seed,
        )
        if config.projector is ProjectorType.RANDOM
        else None
    )
    identity = config.projector is ProjectorType.IDENTITY
    G1 = global_dim + 1

    # ---- per-entity local column maps (INDEX_MAP), no entity loop ---------
    if rproj is not None or identity:
        ukeys = np.empty(0, dtype=np.int64)
        ecol = np.empty(0, dtype=np.int64)
        ucol = np.empty(0, dtype=np.int64)
        dlocs = (
            np.full(n_ent, global_dim, dtype=np.int64)
            if identity
            else np.zeros(n_ent, dtype=np.int64)
        )
    else:
        # observed (entity, col) pairs from ACTIVE data only (reference
        # IndexMapProjectorRDD.scala:164); np.unique returns them sorted by
        # entity then column — exactly the flat local-col layout.
        ukeys = np.unique(nz_e * G1 + nz_c)
        ecol = ukeys // G1
        ucol = ukeys % G1
        dlocs = np.bincount(ecol, minlength=n_ent)

        # feature-selection caps (ratio * samples, hard cap)
        d_cap_e = None
        if config.features_to_samples_ratio is not None:
            d_cap_e = np.maximum(
                (config.features_to_samples_ratio * acounts).astype(np.int64), 1
            )
        if config.max_local_features is not None:
            hard = int(config.max_local_features)
            d_cap_e = np.full(n_ent, hard, dtype=np.int64) if d_cap_e is None else np.minimum(d_cap_e, hard)
        if d_cap_e is not None and np.any(dlocs > d_cap_e):
            scores = _pearson_scores_flat(
                ukeys,
                ecol,
                n_ent,
                nz_keys=nz_e * G1 + nz_c,
                nz_v=nz_v,
                y_nz=labels[act][rep_a],
                w_nz=weights[act][rep_a],
                e_act=e_act_g,
                y_act=labels[act],
                w_act=weights[act],
            )
            # top-k per entity, stable on ties by column order (the flat
            # layout is column-sorted per entity, matching the reference's
            # stable argsort over local columns)
            sel = np.lexsort((np.arange(len(ukeys)), -scores, ecol))
            estart = np.searchsorted(ecol[sel], np.arange(n_ent))
            r2 = np.arange(len(ukeys), dtype=np.int64) - estart[ecol[sel]]
            kept = np.sort(sel[r2 < d_cap_e[ecol[sel]]])
            ukeys, ecol, ucol = ukeys[kept], ecol[kept], ucol[kept]
            dlocs = np.bincount(ecol, minlength=n_ent)

    dstart = np.zeros(n_ent + 1, dtype=np.int64)
    np.cumsum(dlocs, out=dstart[1:])

    # ---- size-bucketing by (samples x local dim) --------------------------
    # Split points are chosen by a small DP that MINIMIZES total padded
    # cells (sum over buckets of count x in-bucket max size): under a Zipf
    # entity-size tail, count-quantiles lump the giant head entities into a
    # bucket with thousands of medium ones (~3x padding measured) and
    # mass-quantiles stretch the tail bucket instead (~6x); the DP places
    # both kinds of boundary where they pay (tests/test_ragged_stress.py
    # gates the measured overhead at <2x).
    nb = max(1, min(config.num_buckets, n_ent))
    dims_e = (
        np.full(n_ent, rproj.projected_dim, dtype=np.int64)
        if rproj
        else np.maximum(dlocs, 1)
    )
    bucket_of = _plan_buckets(acounts, dims_e, nb)
    nb = int(bucket_of.max()) + 1 if n_ent else 1

    # Resolve every active nonzero's local column once (INDEX_MAP only).
    if rproj is None and not identity:
        qk = nz_e * G1 + nz_c
        ii = np.searchsorted(ukeys, qk)
        ii_c = np.minimum(ii, max(len(ukeys) - 1, 0))
        nz_match = (
            (ii < len(ukeys)) & (ukeys[ii_c] == qk)
            if len(ukeys)
            else np.zeros(len(qk), dtype=bool)
        )
        nz_j = ii_c - dstart[nz_e]  # local column per active nonzero
    elif identity:
        nz_match = np.ones(len(nz_c), dtype=bool)
        nz_j = nz_c

    def _project_rows(rows_g: np.ndarray) -> np.ndarray:
        """x_projected = B^T x per sample of ``rows_g`` (RANDOM projector)."""
        rep, fidx = _expand_nnz(rows_g, row_start, row_end)
        return rproj.project_coo(rep, fc[fidx], fv[fidx], len(rows_g))

    buckets: List[ReBucket] = []
    passives: List[Optional[RePassiveRows]] = []
    bucket_ids: List[List[str]] = []
    entity_to_loc: Dict[str, Tuple[int, int]] = {}
    host_actives: List[Tuple[np.ndarray, np.ndarray]] = []
    host_passive_pos: List[Optional[np.ndarray]] = []

    for b in range(nb):
        ent_m = bucket_of == b
        E = int(ent_m.sum())
        if E == 0:
            continue
        bi = len(buckets)
        # Cost-sorted dispatch: entity rows within the bucket are ordered by
        # DESCENDING active sample count (stable), so lockstep lanes carry
        # similar per-iteration work and the adaptive driver's compacted
        # prefixes keep heavy (slow-converging) entities co-scheduled.
        codes_b = np.nonzero(ent_m)[0]
        order_b = np.argsort(-acounts[codes_b], kind="stable")
        new_e = np.zeros(n_ent, dtype=np.int64)  # entity code -> row within bucket
        new_e[codes_b[order_b]] = np.arange(E, dtype=np.int64)
        S = int(acounts[ent_m].max())
        D = int(
            rproj.projected_dim
            if rproj
            else max(int(np.maximum(dlocs[ent_m], 1).max()), 1)
        )

        lab = np.zeros((E, S), dtype=np.float32)
        off = np.zeros((E, S), dtype=np.float32)
        wt = np.zeros((E, S), dtype=np.float32)
        pos = np.zeros((E, S), dtype=np.int32)
        rm = ent_m[e_act_g]
        er, sr = new_e[e_act_g[rm]], s_act_g[rm]
        lab[er, sr] = labels[act[rm]]
        off[er, sr] = offsets[act[rm]]
        wt[er, sr] = weights[act[rm]]
        pos[er, sr] = act[rm]

        pidx = np.zeros((E, D), dtype=np.int32)
        pval = np.zeros((E, D), dtype=bool)
        if rproj is not None:
            # projected-space coordinates are all live; back-projection goes
            # through the shared matrix, not pidx
            pval[:, :] = True
        elif identity:
            pidx[:, :] = np.arange(global_dim, dtype=np.int32)[None, :]
            pval[:, :] = True
        else:
            km = ent_m[ecol]
            jj = np.arange(len(ukeys), dtype=np.int64) - dstart[ecol]
            pidx[new_e[ecol[km]], jj[km]] = ucol[km]
            pval[new_e[ecol[km]], jj[km]] = True

        X = np.zeros((E, S, D), dtype=np.float32)
        if rproj is not None:
            X[er, sr] = _project_rows(act[rm])
        else:
            zm = ent_m[nz_e] & nz_match
            X[new_e[nz_e[zm]], s_act_g[rep_a[zm]], nz_j[zm]] = nz_v[zm]

        pm = ent_m[e_pas_g]
        pas_b = pas[pm]
        n_pas = len(pas_b)
        pX = np.zeros((n_pas, D), dtype=np.float32)
        if n_pas:
            if rproj is not None:
                pX = _project_rows(pas_b)
            else:
                rep_p, fidx_p = _expand_nnz(pas_b, row_start, row_end)
                pc, pv_ = fc[fidx_p], fv[fidx_p]
                pe = e_pas_g[pm][rep_p]
                if identity:
                    pX[rep_p, pc] = pv_
                else:
                    qk = pe * G1 + pc
                    ii = np.searchsorted(ukeys, qk)
                    ii_c = np.minimum(ii, max(len(ukeys) - 1, 0))
                    match = (
                        (ii < len(ukeys)) & (ukeys[ii_c] == qk)
                        if len(ukeys)
                        else np.zeros(len(qk), dtype=bool)
                    )
                    jcol = ii_c - dstart[pe]
                    pX[rep_p[match], jcol[match]] = pv_[match]

        ids_b = uniq[codes_b[order_b]].tolist()
        entity_to_loc.update(
            (eid, (bi, e)) for e, eid in enumerate(ids_b)
        )

        buckets.append(
            ReBucket(
                X=put(X),
                labels=put(lab),
                offsets=put(off),
                weights=put(wt),
                sample_pos=put(pos, np.int64),
                proj_indices=put(pidx, np.int64),
                proj_valid=put(pval),
            )
        )
        passives.append(
            RePassiveRows(
                X=put(pX),
                entity_index=put(new_e[e_pas_g[pm]], np.int64),
                sample_pos=put(pas_b, np.int64),
            )
            if n_pas
            else None
        )
        bucket_ids.append(ids_b)
        host_actives.append((pos, wt))
        host_passive_pos.append(
            pas_b.astype(np.int32) if n_pas else None
        )

    return RandomEffectDataset(
        config=config,
        buckets=buckets,
        passive=passives,
        entity_ids=bucket_ids,
        entity_to_loc=entity_to_loc,
        num_rows=n,
        global_dim=int(global_dim),
        row_gather=put(_build_row_gather(n, host_actives, host_passive_pos)),
    )


def pad_entities_to_multiple(dataset: RandomEffectDataset, multiple: int) -> RandomEffectDataset:
    """Pad every bucket's entity axis to a multiple of ``multiple`` with
    weight-0 entities that have no samples and no valid feature. Padded
    lanes carry no entity id, so model extraction and scoring ignore them;
    padding once at build time keeps shapes stable across updates. The
    row gather is rebuilt over the padded blocks."""
    if multiple <= 1:
        return dataset
    new_buckets = []
    padded_any = False
    for b in dataset.buckets:
        pad = (-b.num_entities) % multiple
        if pad == 0:
            new_buckets.append(b)
            continue
        padded_any = True

        def pad0(a: torch.Tensor) -> torch.Tensor:
            return torch.cat([a, torch.zeros((pad,) + tuple(a.shape[1:]), dtype=a.dtype,
                                             device=a.device)])

        new_buckets.append(ReBucket(
            X=pad0(b.X), labels=pad0(b.labels), offsets=pad0(b.offsets),
            weights=pad0(b.weights), sample_pos=pad0(b.sample_pos),
            proj_indices=pad0(b.proj_indices), proj_valid=pad0(b.proj_valid),
        ))
    if not padded_any:
        return dataset
    # the flattened [E*S] blocks grew: the row -> slot gather shifts
    gather = _build_row_gather(
        dataset.num_rows,
        [(b.sample_pos.cpu().numpy(), b.weights.cpu().numpy()) for b in new_buckets],
        [None if p is None else p.sample_pos.cpu().numpy() for p in dataset.passive],
    )
    return dataclasses.replace(
        dataset, buckets=new_buckets,
        row_gather=torch.from_numpy(gather).to(dataset.row_gather.device),
    )


def place_dataset(dataset: RandomEffectDataset, mesh, axis_names,
                  owned_only: bool = True) -> RandomEffectDataset:
    """Split every bucket's entity axis over the positions of ``mesh``'s
    ``axis_names``, once: slice k moves to the device of position k and is
    solved and scored there (independent per-entity solves, no reduction),
    as the JAX package puts the entity axis ``P(axes)``. Every bucket must
    hold a multiple of that many entities (:func:`pad_entities_to_multiple`).
    The projection arrays, passive rows and row gather move to the mesh's
    home device. On a mesh that spans ranks a rank keeps only the slices of
    its own positions (``owned_only=False`` keeps every slice, the others on
    this rank's home device)."""
    axes = (axis_names,) if isinstance(axis_names, str) else tuple(axis_names)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    for b in dataset.buckets:
        if b.num_entities % n:
            raise ValueError(
                f"a bucket of {b.num_entities} entities does not split over {n} "
                "devices; pad it first (pad_entities_to_multiple)"
            )
    home = mesh.home
    positions = list(np.ndindex(mesh.devices.shape))[:n]
    buckets = []
    for b in dataset.buckets:
        per = b.num_entities // n
        slices = []
        for k, pos in enumerate(positions):
            if mesh.is_local(pos):
                slices.append(slice_bucket(b, k * per, (k + 1) * per, mesh.devices[pos]))
            else:
                slices.append(None if owned_only else slice_bucket(b, k * per, (k + 1) * per,
                                                                   home))
        buckets.append(PlacedBucket(
            slices=slices, mesh=mesh, positions=positions,
            proj_indices=b.proj_indices.to(home), proj_valid=b.proj_valid.to(home),
            max_samples=b.max_samples, active_samples=b.active_samples, cells=b.cells))
    passive = [None if p is None else RePassiveRows(
        X=p.X.to(home), entity_index=p.entity_index.to(home), sample_pos=p.sample_pos.to(home))
        for p in dataset.passive]
    return dataclasses.replace(dataset, buckets=buckets, passive=passive,
                               row_gather=dataset.row_gather.to(home))


def slice_bucket(bucket: ReBucket, lo: int, hi: int, device) -> ReBucket:
    """Entities [lo, hi) of a bucket on ``device``."""
    return ReBucket(**{f.name: getattr(bucket, f.name)[lo:hi].to(device)
                       for f in dataclasses.fields(ReBucket)})

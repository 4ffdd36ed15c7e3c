"""Per-feature summary statistics for normalization and diagnostics.

Counterpart of ``photon_ml_tpu/stat/summary.py`` (reference
stat/BasicStatisticalSummary.scala:50, Spark MLlib's
MultivariateOnlineSummarizer: weighted mean / variance / min / max / nnz /
count): one pass over a ``LabeledData`` batch on its device, through each
feature layout's own maps:

- dense: column reductions;
- ELL: sums by ``features.scatter_add`` (in a fixed order on either device),
  min and max by ``scatter_reduce_`` (``amin``/``amax``);
- Benes (and each block of a column split): the sums are the engine's
  transformed rmatvecs; min and max route the live-row mask to CSC slot
  order through the ``lane_shuffle_f32``/``sublane_shuffle_f32`` kernels
  and reduce per column there;
- the fused engine: ``abs``/``nnz`` through the ``csc_rmatvec_f32``
  transforms; min and max a segmented reduction over its CSC values with
  rows masked by ``weights[row] > 0`` (the port's counterpart of the
  reference's ``csc_view``), over both entry sets of a bf16 payload.

Variance is the unbiased weighted sample variance, MLlib's estimator.
"""

from __future__ import annotations

import dataclasses

import torch

from photon_ml_tpu_torch.ops.data import LabeledData
from photon_ml_tpu_torch.ops.features import DenseFeatures, EllFeatures, scatter_add
from photon_ml_tpu_torch.ops.fused_perm import FusedSparseFeatures
from photon_ml_tpu_torch.ops.sparse_perm import (
    BenesSparseFeatures,
    ColumnSplitFeatures,
    _ZeroColumnsBlock,
)

_INF = float("inf")


@dataclasses.dataclass
class BasicStatisticalSummary:
    mean: torch.Tensor          # [d] weighted mean
    variance: torch.Tensor      # [d] unbiased weighted variance
    num_nonzeros: torch.Tensor  # [d] weighted count of nonzero entries
    max_abs: torch.Tensor       # [d] max |x| (0 for all-zero features)
    min_val: torch.Tensor       # [d] min over observed values incl. implicit zeros
    max_val: torch.Tensor       # [d] max over observed values incl. implicit zeros
    count: torch.Tensor         # scalar total weight
    mean_abs: torch.Tensor      # [d] weighted mean of |x| (reference meanAbs)


_index_add = scatter_add


def _dense_stats(matrix: torch.Tensor, weights: torch.Tensor):
    w = weights.unsqueeze(1)
    live = w > 0
    s1 = (w * matrix).sum(0)
    s2 = (w * matrix * matrix).sum(0)
    sabs = (w * matrix.abs()).sum(0)
    nnz = torch.where(matrix != 0, w, torch.zeros_like(w)).sum(0)
    mx = torch.where(live, matrix, -_INF).amax(0)
    mn = torch.where(live, matrix, _INF).amin(0)
    return s1, s2, sabs, nnz, mn, mx, weights.sum()


def _ell_stats(feats: EllFeatures, weights: torch.Tensor):
    d = feats.num_cols
    vals = feats.values
    idx = feats.indices.reshape(-1)
    w = weights.unsqueeze(1)
    wv = w * vals

    def scatter_sum(contrib: torch.Tensor) -> torch.Tensor:
        return _index_add(torch.zeros(d, dtype=vals.dtype, device=vals.device), idx,
                          contrib.reshape(-1))

    s1 = scatter_sum(wv)
    s2 = scatter_sum(wv * vals)
    sabs = scatter_sum(wv.abs())
    nnz = scatter_sum(torch.where(vals != 0, w, torch.zeros_like(w)))
    # min/max over EXPLICIT values; implicit zeros folded in by summarize
    live = (vals != 0) & (w > 0)
    mx = torch.full((d,), -_INF, dtype=vals.dtype, device=vals.device).scatter_reduce_(
        0, idx, torch.where(live, vals, -_INF).reshape(-1), "amax")
    mn = torch.full((d,), _INF, dtype=vals.dtype, device=vals.device).scatter_reduce_(
        0, idx, torch.where(live, vals, _INF).reshape(-1), "amin")
    return s1, s2, sabs, nnz, mn, mx, weights.sum()


def _benes_stats(feats: BenesSparseFeatures, weights: torch.Tensor):
    """The weighted sums are the engine's (transformed) rmatvecs; min/max
    route the live-row mask to the column-grouped side once and reduce per
    column there."""
    ell, hot, sp = feats.ell_values, feats.hot_matrix, feats.spill_vals

    def nonzero(a):
        return (a != 0).to(ell.dtype)

    s1 = feats.rmatvec(weights)
    s2 = feats.rmatvec_sq(weights)
    sabs = feats._rmatvec_impl(ell.abs(), None if hot is None else hot.abs(), weights,
                               None if sp is None else sp.abs())
    nnz = feats._rmatvec_impl(nonzero(ell), None if hot is None else nonzero(hot), weights,
                              None if sp is None else nonzero(sp))
    # the live-row mask in CSC slot order: a column's explicit entries are
    # contiguous there, so per-column min/max are row reductions
    n, k = ell.shape
    mask_ell = (weights > 0).to(ell.dtype).unsqueeze(1).expand(n, k).reshape(-1)
    d, kp = feats.csc_values.shape
    mask_csc = feats._to_csc(feats._pad(mask_ell))[: d * kp].reshape(d, kp)
    csc = feats.csc_values
    live = (csc != 0) & (mask_csc > 0)
    mx = torch.where(live, csc, -_INF).amax(1)
    mn = torch.where(live, csc, _INF).amin(1)
    mn, mx = _fold_hot_minmax(mn, mx, hot, feats.hot_cols, weights)
    mn, mx = _fold_spill_minmax(mn, mx, feats, weights)
    return s1, s2, sabs, nnz, mn, mx, weights.sum()


def _fused_stats(feats: FusedSparseFeatures, weights: torch.Tensor):
    """The sums through the ``csc_rmatvec_f32`` transforms (with a bf16
    payload, those of both entry sets); min/max :func:`_fused_minmax`."""
    s1 = feats.rmatvec(weights)
    s2 = feats.rmatvec_sq(weights)
    sabs = feats._rmatvec_impl(weights, "abs")
    nnz = feats._rmatvec_impl(weights, "nnz")
    mn, mx = _fused_minmax(feats, weights)
    return s1, s2, sabs, nnz, mn, mx, weights.sum()


def _fused_minmax(feats: FusedSparseFeatures, weights: torch.Tensor):
    """Per-column min/max: a segmented reduction over the CSC values of the
    live rows, the exact entry set (hot columns and spill of a bf16
    payload) folded in."""
    vals = feats.vals_csc
    live = (vals != 0) & (weights[feats.row_idx.long()] > 0)
    lengths = feats.col_ptr.diff()
    mx = torch.segment_reduce(torch.where(live, vals, -_INF), "max", lengths=lengths,
                              unsafe=True, initial=-_INF)
    mn = torch.segment_reduce(torch.where(live, vals, _INF), "min", lengths=lengths,
                              unsafe=True, initial=_INF)
    if feats.exact is not None:
        emn, emx = _fused_minmax(feats.exact, weights)
        mn, mx = torch.minimum(mn, emn), torch.maximum(mx, emx)
    return mn, mx


def _split_stats(feats: ColumnSplitFeatures, weights: torch.Tensor):
    """Per-block engine stats concatenated on the column axis, the global
    hot side folded in afterwards."""
    wsum = weights.sum()
    parts = []
    for blk in feats.blocks:
        if isinstance(blk, _ZeroColumnsBlock):
            z = torch.zeros(blk.num_cols_, dtype=torch.float32, device=weights.device)
            parts.append((z, z, z, z, torch.full_like(z, _INF), torch.full_like(z, -_INF)))
        elif isinstance(blk, BenesSparseFeatures):
            parts.append(_benes_stats(blk, weights)[:6])
        else:
            raise TypeError(f"unknown column block type {type(blk)!r}")
    s1, s2, sabs, nnz, mn, mx = (torch.cat([p[i] for p in parts]) for i in range(6))
    hot = feats.hot_matrix
    if hot is not None:
        w = weights.unsqueeze(1)
        hc = feats.hot_cols
        s1 = _index_add(s1, hc, (w * hot).sum(0))
        s2 = _index_add(s2, hc, (w * hot * hot).sum(0))
        sabs = _index_add(sabs, hc, (w * hot.abs()).sum(0))
        nnz = _index_add(nnz, hc, torch.where(hot != 0, w, torch.zeros_like(w)).sum(0))
        mn, mx = _fold_hot_minmax(mn, mx, hot, hc, weights)
    return s1, s2, sabs, nnz, mn, mx, wsum


def _fold_spill_minmax(mn, mx, feats: BenesSparseFeatures, weights):
    """Fold a KP-cap spill side's values into per-column min/max."""
    sv = feats.spill_vals
    if sv is None:
        return mn, mx
    live = (sv != 0) & (weights[feats.spill_rows] > 0)
    mn = mn.scatter_reduce(0, feats.spill_cols, torch.where(live, sv, _INF), "amin")
    mx = mx.scatter_reduce(0, feats.spill_cols, torch.where(live, sv, -_INF), "amax")
    return mn, mx


def _fold_hot_minmax(mn, mx, hot, hot_cols, weights):
    """Fold a hot-column dense side's per-column min/max into (mn, mx)."""
    if hot is None:
        return mn, mx
    hlive = (hot != 0) & (weights > 0).unsqueeze(1)
    hmx = torch.where(hlive, hot, -_INF).amax(0)
    hmn = torch.where(hlive, hot, _INF).amin(0)
    return (mn.scatter_reduce(0, hot_cols, hmn, "amin"),
            mx.scatter_reduce(0, hot_cols, hmx, "amax"))


def summarize(data: LabeledData) -> BasicStatisticalSummary:
    """The per-feature summary of ``data`` (features of any layout above)."""
    feats, weights = data.features, data.weights
    sparse = True
    if isinstance(feats, DenseFeatures):
        stats = _dense_stats(feats.matrix, weights)
        sparse = False
    elif isinstance(feats, ColumnSplitFeatures):
        stats = _split_stats(feats, weights)
    elif isinstance(feats, BenesSparseFeatures):
        stats = _benes_stats(feats, weights)
    elif isinstance(feats, FusedSparseFeatures):
        stats = _fused_stats(feats, weights)
    elif isinstance(feats, EllFeatures):
        stats = _ell_stats(feats, weights)
    else:
        raise TypeError(f"summarize: unknown feature layout {type(feats).__name__}")
    s1, s2, sabs, nnz, mn, mx, wsum = stats

    mean = s1 / torch.clamp(wsum, min=1e-30)
    # unbiased weighted variance (MLlib): (s2 - wsum*mean^2) / (wsum - 1)
    var = torch.clamp(s2 - wsum * mean * mean, min=0.0) / torch.clamp(wsum - 1.0, min=1e-30)
    zero = torch.zeros_like(mx)
    if sparse:
        # features with implicit zeros extend min/max to include 0
        implicit_zero = nnz < wsum
        mx = torch.where(torch.isneginf(mx), zero,
                         torch.where(implicit_zero, torch.clamp(mx, min=0.0), mx))
        mn = torch.where(torch.isposinf(mn), zero,
                         torch.where(implicit_zero, torch.clamp(mn, max=0.0), mn))
    else:
        mx = torch.where(torch.isneginf(mx), zero, mx)
        mn = torch.where(torch.isposinf(mn), zero, mn)
    return BasicStatisticalSummary(
        mean=mean,
        variance=var,
        num_nonzeros=nnz,
        max_abs=torch.maximum(mx.abs(), mn.abs()),
        min_val=mn,
        max_val=mx,
        count=wsum,
        mean_abs=sabs / torch.clamp(wsum, min=1e-30),
    )

"""The stage-by-stage Benes sparse engine (``sparse_engine: "benes"``).

Counterpart of ``photon_ml_tpu/ops/sparse_perm.py``. Both directions of the
fixed-effect map are dense vector work plus ONE static data movement per
call, executed by the shuffle kernels of ``ops/permute_net.py``:

- ``matvec`` (z = X w): broadcast w over the column-grouped (CSC-ELL) slot
  grid, apply the inverse permutation to land each w value at its
  row-grouped (ELL) slot, multiply by the stored values and row-sum.
- ``rmatvec`` (g = X^T c): broadcast c over ELL slots, apply the forward
  permutation to column-grouped slots, row-sum per column.

Layouts (S = routed network size):

- ELL side: flat [S] position p = row * K + k for p < n*K; the rest pads.
- CSC side: flat [S] position q = col * KP + k' for q < d*KP; the rest pads.
- ``plan`` maps CSC position q -> ELL position p for real entries and pads
  to pads (a bijection on [0, S)); ``plan_inv`` is its inverse.

High-degree ("hot") columns (an intercept) go to a dense [n, H] side
matrix computed with ``torch.matmul``; entries beyond a column's KP cap go
to a COO spill side added by ``features.scatter_add`` (in a fixed order,
so a fit repeats bitwise). A column split (:class:`ColumnSplitFeatures`) keeps each
network on the valid-size ladder. The layout planner, the routing and the
plan cache are host numpy and the same code as the reference's, so one
pattern gives the reference's layout and plans.

The planner also serves the fused engine's bfloat16 payload
(:func:`fused_payload_partition`): which entries the reference's fused
builder routes, and so rounds, follows from its layout alone (power-of-two
slot groups, an optional network size floor and hot-column threshold).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.device import DEFAULT_DEVICE, DeviceLike, resolve_device
from photon_ml_tpu_torch.ops import routing
from photon_ml_tpu_torch.ops.features import coalesce_coo, scatter_add
from photon_ml_tpu_torch.ops.permute_net import DevicePlan, apply_plan, device_plan
from photon_ml_tpu_torch.utils.cachedir import per_uid_cache_dir
from photon_ml_tpu_torch.utils.nativesort import lexsort_pairs


_index_add = scatter_add


@dataclasses.dataclass
class BenesSparseFeatures:
    """Sparse [n, d] feature matrix with Benes-routed linear maps; the same
    ``matvec``/``rmatvec``/``rmatvec_sq``/``row_norms_sq`` protocol as the
    other engines."""

    ell_values: torch.Tensor     # [n, K] f32, 0 in padding slots
    csc_values: torch.Tensor     # [d, KP] f32, 0 in padding slots
    plan: DevicePlan             # CSC position q -> ELL position p
    plan_inv: DevicePlan         # ELL position p -> CSC position q
    hot_matrix: Optional[torch.Tensor]  # [n, H] dense hot columns (or None)
    hot_cols: Optional[torch.Tensor]    # [H] int64 original column ids
    num_rows_: int
    num_cols_: int
    # entries beyond each column's KP cap (plan_column_layout), as COO
    spill_rows: Optional[torch.Tensor] = None  # [M] int64
    spill_cols: Optional[torch.Tensor] = None  # [M] int64
    spill_vals: Optional[torch.Tensor] = None  # [M] f32

    @property
    def num_rows(self) -> int:
        return self.num_rows_

    @property
    def dim(self) -> int:
        return self.num_cols_

    @property
    def ell_k(self) -> int:
        return self.ell_values.shape[1]

    @property
    def csc_k(self) -> int:
        return self.csc_values.shape[1]

    def _to_ell(self, csc_flat: torch.Tensor) -> torch.Tensor:
        """Move a CSC-slot array into ELL slot order."""
        return apply_plan(self.plan_inv, csc_flat)

    def _to_csc(self, ell_flat: torch.Tensor) -> torch.Tensor:
        """Move an ELL-slot array into CSC slot order."""
        return apply_plan(self.plan, ell_flat)

    def _pad(self, flat: torch.Tensor) -> torch.Tensor:
        if flat.shape[0] == self.plan.size:
            return flat
        out = torch.zeros(self.plan.size, dtype=flat.dtype, device=flat.device)
        out[: flat.shape[0]] = flat
        return out

    def matvec(self, w: torch.Tensor) -> torch.Tensor:
        n, k = self.ell_values.shape
        d, kp = self.csc_values.shape
        wexp = self._pad(w.unsqueeze(1).expand(d, kp).reshape(-1))
        w_ell = self._to_ell(wexp)[: n * k].reshape(n, k)
        z = (self.ell_values * w_ell).sum(-1)
        if self.hot_matrix is not None:
            z = z + self.hot_matrix @ w[self.hot_cols]
        if self.spill_rows is not None:
            z = _index_add(z, self.spill_rows, self.spill_vals * w[self.spill_cols])
        return z

    def rmatvec(self, c: torch.Tensor) -> torch.Tensor:
        return self._rmatvec_impl(self.ell_values, self.hot_matrix, c, self.spill_vals)

    def rmatvec_sq(self, c: torch.Tensor) -> torch.Tensor:
        hot_sq = None if self.hot_matrix is None else self.hot_matrix * self.hot_matrix
        spill_sq = None if self.spill_vals is None else self.spill_vals * self.spill_vals
        return self._rmatvec_impl(self.ell_values * self.ell_values, hot_sq, c, spill_sq)

    def _rmatvec_impl(
        self,
        vals: torch.Tensor,
        hot: Optional[torch.Tensor],
        c: torch.Tensor,
        spill_vals: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Xᵀ·c with the stored values replaced by ``vals`` (ELL side),
        ``hot`` and ``spill_vals`` (a transform of them: the reference's
        ``_rmatvec_impl``)."""
        d, kp = self.csc_values.shape
        t = self._pad((vals * c.unsqueeze(1)).reshape(-1))
        g = self._to_csc(t)[: d * kp].reshape(d, kp).sum(-1)
        if hot is not None:
            g = _index_add(g, self.hot_cols, hot.T @ c)
        if spill_vals is not None:
            g = _index_add(g, self.spill_cols, spill_vals * c[self.spill_rows])
        return g

    def row_norms_sq(self) -> torch.Tensor:
        sq = (self.ell_values * self.ell_values).sum(-1)
        if self.hot_matrix is not None:
            sq = sq + (self.hot_matrix * self.hot_matrix).sum(-1)
        if self.spill_rows is not None:
            sq = _index_add(sq, self.spill_rows, self.spill_vals * self.spill_vals)
        return sq


@dataclasses.dataclass
class _ZeroColumnsBlock:
    """A column block with no entries: all maps are exact zeros."""

    num_rows_: int
    num_cols_: int
    device: torch.device

    @property
    def num_rows(self) -> int:
        return self.num_rows_

    @property
    def dim(self) -> int:
        return self.num_cols_

    def matvec(self, w: torch.Tensor) -> torch.Tensor:
        return torch.zeros(self.num_rows_, dtype=w.dtype, device=w.device)

    def rmatvec(self, c: torch.Tensor) -> torch.Tensor:
        return torch.zeros(self.num_cols_, dtype=c.dtype, device=c.device)

    rmatvec_sq = rmatvec

    def row_norms_sq(self) -> torch.Tensor:
        return torch.zeros(self.num_rows_, dtype=torch.float32, device=self.device)


@dataclasses.dataclass
class ColumnSplitFeatures:
    """Sparse [n, d] matrix as independent column-block engines.

    The routed network's valid sizes step c*128^k with c in {1, 2, 4, 8}
    (``routing.valid_size``), so a shard whose d*KP lands just past a step
    pays up to 16x slot padding. Splitting the column space into B blocks
    gives B networks back on the ladder, at the cost of B network passes
    per linear map. Every block is a full engine (own spill side); the
    hot-column side is global. Results are exact sums/concatenations of the
    block results.
    """

    blocks: Tuple[object, ...]  # BenesSparseFeatures | _ZeroColumnsBlock
    hot_matrix: Optional[torch.Tensor]
    hot_cols: Optional[torch.Tensor]
    col_bounds: Tuple[int, ...]  # len(blocks) + 1 column offsets
    num_rows_: int
    num_cols_: int

    @property
    def num_rows(self) -> int:
        return self.num_rows_

    @property
    def dim(self) -> int:
        return self.num_cols_

    def matvec(self, w: torch.Tensor) -> torch.Tensor:
        z = None
        for b, blk in enumerate(self.blocks):
            zb = blk.matvec(w[self.col_bounds[b]: self.col_bounds[b + 1]])
            z = zb if z is None else z + zb
        if self.hot_matrix is not None:
            z = z + self.hot_matrix @ w[self.hot_cols]
        return z

    def rmatvec(self, c: torch.Tensor) -> torch.Tensor:
        g = torch.cat([blk.rmatvec(c) for blk in self.blocks])
        if self.hot_matrix is not None:
            g = _index_add(g, self.hot_cols, self.hot_matrix.T @ c)
        return g

    def rmatvec_sq(self, c: torch.Tensor) -> torch.Tensor:
        g = torch.cat([blk.rmatvec_sq(c) for blk in self.blocks])
        if self.hot_matrix is not None:
            g = _index_add(g, self.hot_cols, (self.hot_matrix * self.hot_matrix).T @ c)
        return g

    def row_norms_sq(self) -> torch.Tensor:
        sq = None
        for blk in self.blocks:
            sb = blk.row_norms_sq()
            sq = sb if sq is None else sq + sb
        if self.hot_matrix is not None:
            sq = sq + (self.hot_matrix * self.hot_matrix).sum(-1)
        return sq


# One spilled (over-cap) entry is priced at this many routed slots by the
# layout planner (the reference's default _spill_slot_cost()).
SPILL_SLOT_COST = 32

# Hard bound: spill stays a small fraction of nnz (spill <= nnz / 8).
_MAX_SPILL_FRACTION = 8

# Most column blocks the planner considers (powers of two up to this).
_MAX_BLOCKS = 16


def plan_column_layout(
    col_counts: np.ndarray,
    n: int,
    d: int,
    K: int,
    kp_full: int,
    row_block_k: Optional[Callable[[int], int]] = None,
    size_floor: int = 0,
    spill_scale: float = 1.0,
):
    """Jointly pick (kp_cap, n_col_blocks) minimizing total cost in routed
    slots, over-cap (spilled) entries priced at ``SPILL_SLOT_COST`` slots
    each. Candidates: every power-of-two cap whose spill stays under nnz/8,
    crossed with block counts {1, 2, 4, ..., 16}; ``row_block_k(t)``
    gives the per-block row group size of a t-way split; every network has
    at least ``size_floor`` slots. ``spill_scale`` prices the spill in one
    network's units where ``col_counts`` span several (a grid's tiles:
    1/tiles). Returns ``(cap_or_None, n_blocks)``; a multi-block layout
    must beat the plain one by >= 2x in total cost."""
    nnz = int(col_counts.sum())
    s_plain = routing.valid_size(max(n * K, d * kp_full, size_floor, 1))
    if not nnz or (kp_full <= 1 and d <= 1):
        return None, 1
    max_spill = max(nnz // _MAX_SPILL_FRACTION, 4096)
    cands = []
    p = 1
    while p < kp_full:
        cands.append(p)
        p *= 2
    cands.append(kp_full)  # the uncapped candidate (spill 0), always kept
    caps = []  # (cap, spill_cost)
    for p in cands:
        spill = 0 if p >= kp_full else int(np.maximum(col_counts - p, 0).sum())
        if spill <= max_spill:
            caps.append((p, spill * SPILL_SLOT_COST * spill_scale))
    best = (None, 1, s_plain)
    for cap, spill_cost in caps:
        t = 1
        while t <= _MAX_BLOCKS:
            d_b = -(-d // t)
            k_t = row_block_k(t) if (row_block_k and t > 1) else K
            s_t = t * routing.valid_size(max(n * k_t, d_b * cap, size_floor, 1)) + spill_cost
            if s_t < best[2]:
                best = (None if cap >= kp_full else cap, t, s_t)
            t *= 2
    cap, t, s_best = best
    if t > 1 and s_best * 2 > s_plain:
        # a multi-block layout must be a clear (2x) win; fall back to the
        # best single-block layout if capping alone still helps
        best_cap, best_cost = None, s_plain
        for cap, spill_cost in caps:
            if cap >= kp_full:
                continue
            cost = routing.valid_size(max(n * K, d * cap, size_floor, 1)) + spill_cost
            if cost < best_cost:
                best_cap, best_cost = cap, cost
        return best_cap, 1
    return cap, t


def make_row_block_k(rows, cols, n: int, d: int, pow2: bool = False):
    """Per-block row group size estimator for the layout planner: for a
    t-way column split, the max nnz any single row holds within one block.
    Memoized per t; ``pow2`` rounds up for the fused engine's power-of-two
    slot groups."""
    cache: dict = {}

    def row_block_k(t: int) -> int:
        if t not in cache:
            d_b = -(-d // t)
            key = rows * t + (cols // d_b)
            # unique, not bincount: memory stays O(nnz)
            if key.size:
                _, counts = np.unique(key, return_counts=True)
                k = int(counts.max())
            else:
                k = 1
            if pow2:
                k = next_pow2(k)
            cache[t] = max(k, 1)
        return cache[t]

    return row_block_k


def auto_kp_cap(col_counts: np.ndarray, n: int, d: int, K: int, kp_full: int,
                size_floor: int = 0) -> Optional[int]:
    """The smallest power-of-two cap on the CSC slot-group size KP whose
    spill stays under nnz/128, when it shrinks the network; else None."""
    nnz = int(col_counts.sum())
    if not nnz or kp_full <= 1:
        return None
    s_now = routing.valid_size(max(n * K, d * kp_full, size_floor, 1))
    budget = max(nnz // 128, 4096)
    p = 1
    while p < kp_full:
        spill = int(np.maximum(col_counts - p, 0).sum())
        if spill <= budget:
            s_new = routing.valid_size(max(n * K, d * p, size_floor, 1))
            return p if s_new < s_now else None
        p *= 2
    return None


def resolve_kp_cap(kp_cap, col_counts, n, d, K, kp_full, size_floor: int = 0) -> Optional[int]:
    """Normalize a ``kp_cap`` argument ("auto" | int | None/0) to an
    effective cap strictly below ``kp_full``, or None."""
    if not kp_cap:
        return None
    if kp_cap == "auto":
        return auto_kp_cap(col_counts, n, d, K, kp_full, size_floor)
    cap = int(kp_cap)
    if cap <= 0 or cap >= kp_full:
        return None
    if cap & (cap - 1):
        raise ValueError(f"kp_cap={cap} must be a power of two (or 'auto')")
    return cap


def _best_split(n: int, d: int, K: int, kp_eff: int, size_floor: int = 0) -> int:
    """Best block count for a FIXED effective KP (2x-win hysteresis)."""
    s_one = routing.valid_size(max(n * K, d * kp_eff, size_floor, 1))
    best_t, best_s = 1, s_one
    t = 2
    while t <= _MAX_BLOCKS:
        s_t = t * routing.valid_size(max(n * K, -(-d // t) * kp_eff, size_floor, 1))
        if s_t < best_s:
            best_t, best_s = t, s_t
        t *= 2
    return best_t if best_s * 2 <= s_one else 1


def resolve_layout(kp_cap, col_split, col_counts, n, d, K, kp_full, row_block_k=None,
                   size_floor: int = 0, spill_scale: float = 1.0):
    """Normalize (kp_cap, col_split) arguments to an effective
    ``(cap_or_None, n_blocks)`` layout. "auto"/"auto" runs the joint
    planner; manual values are validated and used as they are."""
    if kp_cap == "auto" and col_split == "auto":
        return plan_column_layout(col_counts, n, d, K, kp_full, row_block_k=row_block_k,
                                  size_floor=size_floor, spill_scale=spill_scale)
    cap = resolve_kp_cap(kp_cap, col_counts, n, d, K, kp_full, size_floor)
    if col_split == "auto":
        t = _best_split(n, d, K, cap or kp_full, size_floor)
    else:
        t = max(int(col_split or 1), 1)
        if t > 1 and t & (t - 1):
            raise ValueError(f"col_split={t} must be a power of two")
    return cap, t


def build_column_split(build_block, rows, cols, vals, n: int, d: int, t: int, cap: Optional[int],
                       hot_matrix: Optional[np.ndarray], hot_ids: Optional[np.ndarray],
                       plan_cache: Optional[str], device: torch.device) -> ColumnSplitFeatures:
    """Partition COLD entries into ``t`` column blocks and build each with
    ``build_block`` (a :func:`from_coo`-compatible callable); the hot side stays
    global. The blocks' networks are independent, so they are routed on a
    thread each (the router is native code that holds no shared state; the
    plans are the ones a sequential build makes)."""
    d_b = -(-d // t)
    bounds = [min(b * d_b, d) for b in range(t + 1)]
    blk_of = cols // d_b

    def build(b: int):
        width = bounds[b + 1] - bounds[b]
        m = blk_of == b
        if width <= 0 or not m.any():
            return _ZeroColumnsBlock(n, max(width, 0), device)
        return build_block(
            rows[m], cols[m] - bounds[b], vals[m], (n, width), plan_cache=plan_cache,
            max_hot_cols=0, kp_cap=cap, col_split=1, device=device,
        )

    with ThreadPoolExecutor(max_workers=max(1, min(t, os.cpu_count() or 1))) as pool:
        blocks = list(pool.map(build, range(t)))
    return ColumnSplitFeatures(
        blocks=tuple(blocks),
        hot_matrix=None if hot_matrix is None else torch.from_numpy(hot_matrix).to(device),
        hot_cols=None if hot_ids is None else torch.from_numpy(hot_ids.astype(np.int64)).to(device),
        col_bounds=tuple(bounds),
        num_rows_=int(n),
        num_cols_=int(d),
    )


def from_coo(
    rows,
    cols,
    vals,
    shape,
    max_nnz_row: Optional[int] = None,
    plan_cache: Optional[str] = None,
    max_hot_cols: int = 128,
    kp_cap="auto",
    col_split="auto",
    device: DeviceLike = DEFAULT_DEVICE,
    hot_col_threshold: Optional[int] = None,
):
    """Build from COO triplets on ``device`` (host numpy planning + one Benes
    routing per network). Duplicates are coalesced by summation.

    The routing is the expensive one-time step (seconds to a minute per
    2^24-slot network). It is memoized keyed on the sparsity pattern in
    ``plan_cache`` (a directory; default :func:`default_plan_cache`).

    Columns with degree above max(8, 4x the mean column degree, n/16) go
    to the dense hot side (degree above ``hot_col_threshold`` when given), at most ``max_hot_cols`` of them (0 disables). ``kp_cap`` ("auto", None/0, or a
    power of two) bounds the CSC padding KP, spilling over-cap entries;
    ``col_split`` ("auto" or a power of two) may partition the columns into
    independent networks (the result is then a :class:`ColumnSplitFeatures`).
    """
    dev = resolve_device(device)
    n, d = shape
    rows, cols, vals, hot_matrix, hot_ids, row_counts, col_counts = prepare_cold_entries(
        rows, cols, vals, shape, max_nnz_row, max_hot_cols, hot_col_threshold
    )
    nnz = rows.size
    k_needed = int(row_counts.max()) if nnz else 1
    # max_nnz_row doubles as a K floor (shape-stable [n, K] ELL arrays)
    K = max(k_needed, int(max_nnz_row) if max_nnz_row is not None else 1, 1)
    KP = max(int(col_counts.max()) if nnz else 1, 1)

    cap, t = (None, 1)
    if nnz:
        cap, t = resolve_layout(kp_cap, col_split, col_counts, n, d, K, KP,
                                row_block_k=make_row_block_k(rows, cols, n, d))
    if t > 1:
        return build_column_split(from_coo, rows, cols, vals, n, d, t, cap,
                                  hot_matrix, hot_ids, plan_cache, dev)

    spill = (None, None, None)
    if cap is not None:
        rows, cols, vals, sr, sc, sv = split_spill_entries(rows, cols, vals, col_counts, cap)
        spill = (sr, sc, sv)
        row_counts = np.bincount(rows, minlength=n)
        col_counts = np.minimum(col_counts, cap)
        KP = cap
    return _assemble(rows, cols, vals, n, d, K, KP, hot_matrix, hot_ids, plan_cache, dev,
                     row_counts=row_counts, col_counts=col_counts, spill=spill)


def prepare_cold_entries(rows, cols, vals, shape, max_nnz_row: Optional[int],
                         max_hot_cols: int, hot_col_threshold: Optional[int] = None):
    """Prologue of :func:`from_coo`: coalesce, validate ``max_nnz_row``, split hot
    columns, count degrees. Returns ``(rows, cols, vals, hot_matrix,
    hot_ids, row_counts, col_counts)`` with rows/cols/vals the cold
    entries."""
    n, d = shape
    rows, cols, vals = _coalesce_checked(rows, cols, vals, n, d, max_nnz_row)
    nnz = rows.size
    hot_ids = select_hot_cols(rows, cols, n, d, max_hot_cols, hot_col_threshold)
    hot_matrix = None
    if hot_ids is not None:
        rows, cols, vals, hot_matrix = split_hot_entries(rows, cols, vals, n, d, hot_ids)
        nnz = rows.size
    row_counts = np.bincount(rows, minlength=n) if nnz else np.zeros(n, np.int64)
    col_counts = np.bincount(cols, minlength=d) if nnz else np.zeros(d, np.int64)
    return rows, cols, vals, hot_matrix, hot_ids, row_counts, col_counts


def _coalesce_checked(rows, cols, vals, n: int, d: int, max_nnz_row: Optional[int]):
    """Coalesced (row, col)-sorted triplets; raises when a row holds more
    than ``max_nnz_row`` entries."""
    rows, cols, vals, counts = coalesce_coo(rows, cols, vals, n, d)
    if max_nnz_row is not None and rows.size and int(counts.max()) > int(max_nnz_row):
        raise ValueError(f"row with {int(counts.max())} nnz exceeds max_nnz_row={max_nnz_row}")
    return rows, cols, vals


def spill_mask(rows, cols, col_counts: np.ndarray, cap: int) -> np.ndarray:
    """Which entries exceed their column's cap of ``cap`` routed entries:
    each column keeps its first ``cap`` in (col, row) order."""
    nnz = rows.size
    corder = lexsort_pairs(cols, rows)
    col_starts = np.zeros(col_counts.size + 1, dtype=np.int64)
    np.cumsum(col_counts, out=col_starts[1:])
    rank = np.arange(nnz, dtype=np.int64) - col_starts[cols[corder]]
    spill = np.zeros(nnz, dtype=bool)
    spill[corder] = rank >= cap
    return spill


def split_spill_entries(rows, cols, vals, col_counts: np.ndarray, cap: int):
    """Split entries so every column keeps at most ``cap`` routed entries
    (:func:`spill_mask`). Returns ``(cold_rows, cold_cols, cold_vals,
    spill_rows, spill_cols, spill_vals)``."""
    spill = spill_mask(rows, cols, col_counts, cap)
    keep = ~spill
    return rows[keep], cols[keep], vals[keep], rows[spill], cols[spill], vals[spill]


def select_hot_cols(rows: np.ndarray, cols: np.ndarray, n_rows: int, d: int,
                    max_hot_cols: int,
                    hot_col_threshold: Optional[int] = None) -> Optional[np.ndarray]:
    """The hot-column set (sorted ids) or None: degree above
    ``hot_col_threshold``, by default max(8, 4x the mean degree, n/16)
    (densifying such a column inflates its storage at most 16x), at most
    ``max_hot_cols`` columns and a dense block of about 512 MB."""
    nnz = rows.size
    if not nnz or max_hot_cols <= 0:
        return None
    col_counts_all = np.bincount(cols, minlength=d)
    if hot_col_threshold is None:
        thr = max(8, int(4 * np.ceil(nnz / max(d, 1))), n_rows // 16)
    else:
        thr = int(hot_col_threshold)
    h_cap = min(int(max_hot_cols), max(1, (128 << 20) // max(n_rows, 1)))
    hot_mask = col_counts_all > thr
    n_hot = int(hot_mask.sum())
    if n_hot > h_cap:
        top = np.argpartition(col_counts_all, -h_cap)[-h_cap:]
        return np.sort(top)
    if n_hot > 0:
        return np.flatnonzero(hot_mask)
    return None


def split_hot_entries(rows, cols, vals, n: int, d: int, hot_ids: np.ndarray):
    """Split entries into (cold rows/cols/vals, dense [n, H] hot matrix)."""
    hot_pos = np.full(d, -1, dtype=np.int64)
    hot_pos[hot_ids] = np.arange(hot_ids.size)
    is_hot = hot_pos[cols] >= 0
    hot_matrix = np.zeros((n, hot_ids.size), dtype=np.float32)
    hot_matrix[rows[is_hot], hot_pos[cols[is_hot]]] = vals[is_hot]
    return rows[~is_hot], cols[~is_hot], vals[~is_hot], hot_matrix


def next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


@dataclasses.dataclass
class PayloadPartition:
    """Which entries of a sparse matrix the reference's fused engine sends
    through its network (and so rounds to a reduced payload dtype): the
    cold entries that are routed and not spilled. The rest, the hot columns
    and each block's over-cap spill, it evaluates exactly in f32.

    ``rows``/``cols``/``vals`` are the coalesced, (row, col)-sorted entries;
    ``hot`` and ``spilled`` mask them. The layout behind the masks:
    ``hot_cols`` (sorted ids or None), the column blocks ``col_bounds``
    (t + 1 offsets) and each block's effective KP cap (None: no spill)."""

    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    hot: np.ndarray      # [nnz] bool
    spilled: np.ndarray  # [nnz] bool
    hot_cols: Optional[np.ndarray]
    col_bounds: Tuple[int, ...]
    kp_caps: Tuple[Optional[int], ...]

    @property
    def payload(self) -> np.ndarray:
        return ~(self.hot | self.spilled)

    def summary(self) -> dict:
        return {
            "hot_columns": 0 if self.hot_cols is None else int(self.hot_cols.size),
            "column_blocks": len(self.col_bounds) - 1,
            "kp_caps": list(self.kp_caps),
            "spilled_entries": int(self.spilled.sum()),
            "rounded_entries": int(self.payload.sum()),
            "exact_entries": int((self.hot | self.spilled).sum()),
        }


def fused_payload_partition(rows, cols, vals, shape, max_nnz_row: Optional[int] = None,
                            hot_col_threshold: Optional[int] = None, max_hot_cols: int = 128,
                            kp_cap="auto", col_split="auto",
                            size_floor: int = 0) -> PayloadPartition:
    """The reference fused builder's layout (``fused_perm.from_coo``,
    pins off) without its routing: hot columns as :func:`select_hot_cols`;
    power-of-two slot groups K and KP; :func:`resolve_layout` with
    ``size_floor`` and the power-of-two ``row_block_k``; then either one
    network spilling at the cap, or ``t`` column blocks each planned again
    as a builder of its own (``kp_cap=cap, col_split=1``, no hot columns,
    no size floor) that spills within its own columns. The partition
    follows from row and column degrees alone."""
    n, d = int(shape[0]), int(shape[1])
    rows, cols, vals = _coalesce_checked(rows, cols, vals, n, d, max_nnz_row)
    hot_ids = select_hot_cols(rows, cols, n, d, max_hot_cols, hot_col_threshold)
    hot = np.zeros(rows.size, dtype=bool)
    if hot_ids is not None:
        is_hot_col = np.zeros(d, dtype=bool)
        is_hot_col[hot_ids] = True
        hot = is_hot_col[cols]
    cold = np.flatnonzero(~hot)
    r, c = rows[cold], cols[cold]
    spilled = np.zeros(rows.size, dtype=bool)
    bounds, caps = (0, d), (None,)
    if cold.size:
        row_counts = np.bincount(r, minlength=n)
        col_counts = np.bincount(c, minlength=d)
        K = max(next_pow2(int(row_counts.max())),
                next_pow2(int(max_nnz_row)) if max_nnz_row is not None else 1, 1)
        KP = max(next_pow2(int(col_counts.max())), 1)
        cap, t = resolve_layout(kp_cap, col_split, col_counts, n, d, K, KP,
                                row_block_k=make_row_block_k(r, c, n, d, pow2=True),
                                size_floor=size_floor)
        if t == 1:
            caps = (cap,)
            if cap is not None:
                spilled[cold[spill_mask(r, c, col_counts, cap)]] = True
        else:
            d_b = -(-d // t)
            bounds = tuple(min(b * d_b, d) for b in range(t + 1))
            blk_of = c // d_b
            block_caps = []
            for b in range(t):
                width = bounds[b + 1] - bounds[b]
                m = np.flatnonzero(blk_of == b)
                if width <= 0 or not m.size:
                    block_caps.append(None)
                    continue
                bc = c[m] - bounds[b]
                counts_b = np.bincount(bc, minlength=width)
                # the block's own builder: an int cap at or above its own
                # power-of-two KP spills nothing
                cap_b = resolve_kp_cap(cap, counts_b, n, width, K,
                                       next_pow2(int(counts_b.max())))
                block_caps.append(cap_b)
                if cap_b is not None:
                    spilled[cold[m[spill_mask(r[m], bc, counts_b, cap_b)]]] = True
            caps = tuple(block_caps)
    return PayloadPartition(rows, cols, vals, hot, spilled, hot_ids, tuple(bounds), caps)


def grid_payload_partitions(entries, n_dd: int, n_df: int, n_loc: int, d_loc: int,
                            hot_col_threshold: Optional[int] = None, max_hot_cols: int = 128,
                            kp_cap="auto", col_split="auto") -> dict:
    """The :class:`PayloadPartition` of every tile of an (n_dd x n_df) grid
    of fused tiles, by the one layout the reference grid lays over all
    tiles (``photon_ml_tpu/parallel/grid_features.py`` ``grid_from_coo``):
    each tile's own hot columns; power-of-two K and KP, the largest over
    the tiles' cold entries; :func:`resolve_layout` over the degrees of
    every tile (row blocks sized over every tile, the spill priced per
    tile); then that cap applied to each tile, or to each column block of
    each tile. ``entries(dd, df)`` gives a tile's (rows, cols, vals) in
    tile coordinates. Returns ``{(dd, df): PayloadPartition}``."""
    tiles = {}
    for dd in range(n_dd):
        for df in range(n_df):
            tr, tc, tv = _coalesce_checked(*entries(dd, df), n_loc, d_loc, None)
            hot_ids = select_hot_cols(tr, tc, n_loc, d_loc, max_hot_cols, hot_col_threshold)
            hot = np.zeros(tr.size, dtype=bool)
            if hot_ids is not None:
                is_hot_col = np.zeros(d_loc, dtype=bool)
                is_hot_col[hot_ids] = True
                hot = is_hot_col[tc]
            cold = np.flatnonzero(~hot)
            tiles[dd, df] = (tr, tc, tv, hot_ids, hot, cold)
    K, KP = 1, 1
    counts = {}
    for key, (tr, tc, _, _, _, cold) in tiles.items():
        counts[key] = np.bincount(tc[cold], minlength=d_loc)
        if cold.size:
            K = max(K, int(np.bincount(tr[cold]).max()))
            KP = max(KP, int(counts[key].max()))
    K, KP = next_pow2(K), next_pow2(KP)
    cap, t = None, 1
    if kp_cap or col_split != 1:
        def row_block_k(blocks: int) -> int:
            d_b = -(-d_loc // blocks)
            k_max = 1
            for tr, tc, _, _, _, cold in tiles.values():
                if cold.size:
                    _, cnts = np.unique(tr[cold] * blocks + tc[cold] // d_b, return_counts=True)
                    k_max = max(k_max, int(cnts.max()))
            return next_pow2(k_max)

        cap, t = resolve_layout(kp_cap, col_split,
                                np.concatenate([counts[key] for key in sorted(counts)]),
                                n_loc, d_loc, K, KP, row_block_k=row_block_k,
                                spill_scale=1.0 / len(tiles))
    d_b = -(-d_loc // t)
    bounds = tuple(min(b * d_b, d_loc) for b in range(t + 1))
    out = {}
    for key, (tr, tc, tv, hot_ids, hot, cold) in tiles.items():
        spilled = np.zeros(tr.size, dtype=bool)
        if cap is not None:
            r, c = tr[cold], tc[cold]
            for b in range(t):
                m = np.flatnonzero(c // d_b == b)
                bc = c[m] - b * d_b
                counts_b = np.bincount(bc, minlength=d_b)
                if m.size and counts_b.max() > cap:
                    spilled[cold[m[spill_mask(r[m], bc, counts_b, cap)]]] = True
        out[key] = PayloadPartition(tr, tc, tv, hot, spilled, hot_ids, bounds, (cap,) * t)
    return out


def build_slot_perm(rows, cols, n: int, d: int, K: int, KP: int, S: int,
                    row_counts: np.ndarray, col_counts: np.ndarray):
    """(ell_pos, csc_pos, perm) for one routed layout: entry e's ELL slot
    (row*K + slot), its CSC slot (col*KP + slot), and the bijection on
    [0, S) with perm[q] = p for real entries, pads mapped to pads in
    ascending order."""
    nnz = rows.size
    row_starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(row_counts, out=row_starts[1:])
    ell_pos = rows * K + (np.arange(nnz, dtype=np.int64) - row_starts[rows])

    corder = lexsort_pairs(cols, rows)
    col_starts = np.zeros(d + 1, dtype=np.int64)
    np.cumsum(col_counts, out=col_starts[1:])
    csc_slot = np.arange(nnz, dtype=np.int64) - col_starts[cols[corder]]
    csc_pos = np.empty(nnz, dtype=np.int64)
    csc_pos[corder] = cols[corder] * KP + csc_slot

    perm = np.full(S, -1, dtype=np.int64)
    perm[csc_pos] = ell_pos
    free_dst = np.flatnonzero(perm < 0)
    used_src = np.zeros(S, dtype=bool)
    used_src[ell_pos] = True
    perm[free_dst] = np.flatnonzero(~used_src)
    return ell_pos, csc_pos, perm


def route_layout(rows, cols, n: int, d: int, K: int, KP: int, plan_cache: Optional[str],
                 row_counts=None, col_counts=None):
    """Validate the paddings, size the network, build slot positions and the
    (plan, plan_inv) pair. Returns ``(ell_pos, csc_pos, plan, plan_inv, S)``."""
    nnz = rows.size
    if row_counts is None:
        row_counts = np.bincount(rows, minlength=n) if nnz else np.zeros(n, np.int64)
    if col_counts is None:
        col_counts = np.bincount(cols, minlength=d) if nnz else np.zeros(d, np.int64)
    if nnz and (row_counts.max() > K or col_counts.max() > KP):
        raise ValueError("pinned paddings smaller than the actual degrees")
    S = routing.valid_size(max(n * K, d * KP, 1))
    ell_pos, csc_pos, perm = build_slot_perm(rows, cols, n, d, K, KP, S, row_counts, col_counts)
    plan = _build_plan_cached(perm, plan_cache)
    return ell_pos, csc_pos, plan, plan.invert(), S


def _assemble(rows, cols, vals, n: int, d: int, K: int, KP: int,
              hot_matrix: Optional[np.ndarray], hot_ids: Optional[np.ndarray],
              plan_cache: Optional[str], device: torch.device,
              row_counts=None, col_counts=None, spill=(None, None, None)) -> BenesSparseFeatures:
    """Route and lay out one (cold entries, hot side) pair on ``device``;
    ``spill`` is the (rows, cols, vals) COO side of over-cap entries."""
    ell_pos, csc_pos, plan, plan_inv, _ = route_layout(
        rows, cols, n, d, K, KP, plan_cache, row_counts, col_counts
    )
    ell_values = np.zeros((n, K), dtype=np.float32)
    ell_values.reshape(-1)[ell_pos] = vals
    csc_values = np.zeros((d, KP), dtype=np.float32)
    csc_values.reshape(-1)[csc_pos] = vals

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)

    sr, sc, sv = spill
    has_spill = sr is not None and sr.size > 0
    return BenesSparseFeatures(
        ell_values=t(ell_values, np.float32),
        csc_values=t(csc_values, np.float32),
        plan=device_plan(plan, device),
        plan_inv=device_plan(plan_inv, device),
        hot_matrix=None if hot_matrix is None else t(hot_matrix, np.float32),
        hot_cols=None if hot_ids is None else t(hot_ids, np.int64),
        num_rows_=int(n),
        num_cols_=int(d),
        spill_rows=t(sr, np.int64) if has_spill else None,
        spill_cols=t(sc, np.int64) if has_spill else None,
        spill_vals=t(sv, np.float32) if has_spill else None,
    )


def from_ell(ell, plan_cache: Optional[str] = None, device: DeviceLike = DEFAULT_DEVICE):
    """Convert an ``ops.features.EllFeatures`` (host round trip)."""
    vals = ell.values.cpu().numpy()
    idx = ell.indices.cpu().numpy()
    n, k = vals.shape
    live = vals != 0.0
    rows = np.repeat(np.arange(n, dtype=np.int64), k).reshape(n, k)[live]
    return from_coo(rows, idx[live].astype(np.int64), vals[live], (n, ell.num_cols),
                    max_nnz_row=k, plan_cache=plan_cache, device=device)


# Bump on any plan-format or routing change so that stale entries from
# older code are never served (the reference's format, v2: int8 indices).
_PLAN_FORMAT = "benesplan_v2"


def _build_plan_cached(perm: np.ndarray, cache_dir: Optional[str]) -> routing.PermPlan:
    if cache_dir is None:
        cache_dir = default_plan_cache()
    if not cache_dir:  # None or "": disabled
        return routing.build_plan(perm)
    h = hashlib.sha1(perm.tobytes()).hexdigest()[:16]
    path = Path(cache_dir) / f"{_PLAN_FORMAT}_{perm.shape[0]}_{h}.npz"
    if path.exists():
        try:
            return _load_plan_file(path)
        except (OSError, ValueError, KeyError):
            pass  # an unreadable or foreign entry: rebuild and overwrite

    plan = routing.build_plan(perm)
    arrays = {"size": np.int64(plan.size)}
    kinds = []
    i = 0
    for st in plan.stages:
        if isinstance(st, routing.LaneShuffle):
            kinds.append("lane")
            arrays[f"idx{i}"] = st.idx.astype(np.int8)
            i += 1
        elif isinstance(st, routing.SublaneShuffle):
            kinds.append(f"sublane:{st.rows}")
            arrays[f"idx{i}"] = st.idx.astype(np.int8)
            i += 1
        elif isinstance(st, routing.Enter):
            kinds.append(f"enter:{st.blocks}:{st.rows}")
        else:
            kinds.append(f"leave:{st.blocks}:{st.rows}")
    arrays["kinds"] = np.array(kinds)
    path.parent.mkdir(parents=True, exist_ok=True)
    # atomic publish: concurrent processes routing one pattern never read
    # a half-written file
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return plan


def _load_plan_file(path) -> routing.PermPlan:
    with np.load(path) as data:
        stages: list = []
        i = 0
        for kind in data["kinds"]:
            parts = str(kind).split(":")
            if parts[0] == "lane":
                stages.append(routing.LaneShuffle(idx=data[f"idx{i}"]))
                i += 1
            elif parts[0] == "sublane":
                stages.append(routing.SublaneShuffle(idx=data[f"idx{i}"], rows=int(parts[1])))
                i += 1
            elif parts[0] == "enter":
                stages.append(routing.Enter(int(parts[1]), int(parts[2])))
            elif parts[0] == "leave":
                stages.append(routing.Leave(int(parts[1]), int(parts[2])))
            else:
                raise ValueError(f"unknown cached stage kind {kind!r}")
        return routing.PermPlan(size=int(data["size"]), stages=stages)


def default_plan_cache() -> Optional[str]:
    """The routing-plan cache directory: ``$PHOTON_ML_TPU_TORCH_PLAN_CACHE``
    ("" disables caching), else ``$TMPDIR/photon_ml_tpu_torch_plan_cache_<uid>``
    created 0700 (None, no cache, when it cannot be made or is not the
    user's own). Plans are keyed by the sha1 of the permutation and a
    format version; entries that fail to load are rebuilt."""
    env = os.environ.get("PHOTON_ML_TPU_TORCH_PLAN_CACHE")
    if env is not None:
        return env or None
    return per_uid_cache_dir("photon_ml_tpu_torch_plan_cache")

"""Feature-matrix representations and their linear maps, on tensors.

Port of ``photon_ml_tpu/ops/features.py``:

- :class:`DenseFeatures` — plain ``[n, d]`` matrix, or ``[E, s, d]``: one
  dense problem per leading-axis lane (the reference wraps its 2-D maps in
  ``jax.vmap`` for that; here ``torch.matmul`` batches them).
- :class:`EllFeatures` — padded row-sparse (ELL) layout ``values/indices
  [n, k]`` with k = max nnz per row; padding slots carry value 0.0 so they
  are algebraic no-ops. ``matvec`` is ``torch.gather`` plus a sum over the
  slot axis; ``rmatvec`` a :func:`scatter_add` into the columns.

Each layout has the three maps a GLM needs: ``matvec(w)`` = X·w,
``rmatvec(c)`` = Xᵀ·c, ``rmatvec_sq(c)`` = (X∘X)ᵀ·c.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from photon_ml_tpu_torch.device import DEFAULT_DEVICE, DeviceLike, resolve_device


@dataclasses.dataclass
class DenseFeatures:
    """Dense ``[n, d]`` feature matrix, or ``[E, s, d]`` (E problems)."""

    matrix: torch.Tensor

    @property
    def num_rows(self) -> int:
        return self.matrix.shape[-2]

    @property
    def dim(self) -> int:
        return self.matrix.shape[-1]

    def matvec(self, w: torch.Tensor) -> torch.Tensor:
        """[n, d]·[d] → [n], or [E, s, d]·[E, d] → [E, s]."""
        if self.matrix.dim() == 3:
            return torch.matmul(self.matrix, w.unsqueeze(-1)).squeeze(-1)
        return self.matrix @ w

    def rmatvec(self, c: torch.Tensor) -> torch.Tensor:
        """[n, d]ᵀ·[n] → [d], or [E, s, d]ᵀ·[E, s] → [E, d]."""
        return self._rmatvec(self.matrix, c)

    def rmatvec_sq(self, c: torch.Tensor) -> torch.Tensor:
        return self._rmatvec(self.matrix * self.matrix, c)

    @staticmethod
    def _rmatvec(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:
            return torch.matmul(c.unsqueeze(-2), x).squeeze(-2)
        return x.T @ c


@dataclasses.dataclass
class EllFeatures:
    """Padded row-sparse (ELL) feature matrix.

    values:  [n, k] float32 — feature values, 0.0 in padding slots.
    indices: [n, k] int64 — column index per slot, 0 in padding slots.
    num_cols: feature dimension d.
    """

    values: torch.Tensor
    indices: torch.Tensor
    num_cols: int

    @property
    def num_rows(self) -> int:
        return self.values.shape[0]

    @property
    def dim(self) -> int:
        return self.num_cols

    def matvec(self, w: torch.Tensor) -> torch.Tensor:
        gathered = torch.gather(w.expand(self.num_rows, -1), 1, self.indices)
        return (self.values * gathered).sum(dim=-1)

    def rmatvec(self, c: torch.Tensor) -> torch.Tensor:
        """Xᵀ·c: c_i·v_is added into column indices_is; padding adds 0."""
        return self._scatter(self.values * c[:, None])

    def rmatvec_sq(self, c: torch.Tensor) -> torch.Tensor:
        return self._scatter(self.values * self.values * c[:, None])

    def row_norms_sq(self) -> torch.Tensor:
        return (self.values * self.values).sum(dim=-1)

    def _scatter(self, contrib: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(self.num_cols, dtype=contrib.dtype, device=contrib.device)
        return scatter_add(out, self.indices.reshape(-1), contrib.reshape(-1))


def scatter_add(out: torch.Tensor, index: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``out[index] += values``, repeated indices summed, in an order that is
    the same run to run on either device: on the card the accumulating
    ``index_put_`` sorts the indices (``index_add_`` adds with atomics
    there); on the host ``index_add_`` adds in order (``index_put_`` adds
    from several threads there)."""
    if out.device.type == "cpu":
        return out.index_add_(0, index, values)
    return out.index_put_((index,), values, accumulate=True)


FeatureMatrix = Union[DenseFeatures, EllFeatures]


def coalesce_coo(rows, cols, vals, n, d):
    """Validate + duplicate-coalesce COO triplets (host numpy); returns
    (row, col)-sorted triplets and the per-row counts. Copy of the
    reference's ``_coalesce_coo``: duplicates summed in float64, then cast
    to float32; already-sorted duplicate-free input skips the sort."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float32)
    if rows.size:
        if rows.min() < 0 or rows.max() >= n:
            raise ValueError(f"row index out of range [0, {n})")
        if d is not None and (cols.min() < 0 or cols.max() >= d):
            raise ValueError(f"column index out of range [0, {d})")
        in_order = bool(
            np.all(
                (rows[1:] > rows[:-1])
                | ((rows[1:] == rows[:-1]) & (cols[1:] >= cols[:-1]))
            )
        )
        if not in_order:
            order = np.lexsort((cols, rows))
            rows, cols, vals = rows[order], cols[order], vals[order]
        boundary = np.empty(rows.size, dtype=bool)
        boundary[0] = True
        boundary[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
        uniq = int(boundary.sum())
        if uniq != rows.size:
            seg_ids = np.cumsum(boundary) - 1
            summed = np.zeros(uniq, dtype=np.float64)
            np.add.at(summed, seg_ids, vals)
            rows, cols = rows[boundary], cols[boundary]
            vals = summed.astype(np.float32)
    counts = np.bincount(rows, minlength=n)
    return rows, cols, vals, counts


def _scatter_ell(rows, cols, vals, counts, values, indices) -> None:
    """Scatter coalesced, (row, col)-sorted triplets into ELL arrays."""
    if not rows.size:
        return
    n = values.shape[0]
    # slot index within each row: position minus that row's start offset
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    slots = np.arange(rows.size, dtype=np.int64) - starts[rows]
    values[rows, slots] = vals
    indices[rows, slots] = cols


def pack_ell_host(rows, cols, vals, shape, max_nnz=None):
    """Host-side ELL packing of COO triplets: numpy ``(values [n, k] f32,
    indices [n, k] int32)``, allocating nothing on a device (copy of the
    reference's). Duplicates coalesced by summation; ``ValueError`` when a
    row exceeds ``max_nnz``. Indices stay int32 on the host, as in the JAX
    package, so a staged block counts the same bytes in both packages."""
    n, d = shape
    rows, cols, vals, counts = coalesce_coo(rows, cols, vals, n, d)
    needed = int(counts.max()) if rows.size else 1
    k = max(int(max_nnz) if max_nnz is not None else needed, 1)
    if needed > k:
        raise ValueError(
            f"row with {needed} nonzeros exceeds max_nnz={k}; raise max_nnz or "
            "pre-select features"
        )
    values = np.zeros((n, k), dtype=np.float32)
    indices = np.zeros((n, k), dtype=np.int32)
    _scatter_ell(rows, cols, vals, counts, values, indices)
    return values, indices


def pack_ell_into(rows, cols, vals, values_out, indices_out, num_cols=None) -> None:
    """In-place :func:`pack_ell_host`: scatter COO triplets into
    caller-owned, zero-initialized ``[n, k]`` staging arrays (copy of the
    reference's). The streaming block assembler packs each file piece of a
    block as it arrives; pieces are row-disjoint, so piecewise packing
    equals packing the whole block at once. Rows written by an earlier
    call must not be revisited."""
    n, k = values_out.shape
    rows, cols, vals, counts = coalesce_coo(rows, cols, vals, n, num_cols)
    needed = int(counts.max()) if rows.size else 0
    if needed > k:
        raise ValueError(
            f"row with {needed} nonzeros exceeds max_nnz={k}; raise max_nnz or "
            "pre-select features"
        )
    _scatter_ell(rows, cols, vals, counts, values_out, indices_out)


def from_scipy_like(
    rows, cols, vals, shape, device: DeviceLike = DEFAULT_DEVICE
) -> EllFeatures:
    """EllFeatures from COO triplets on ``device``, k = the longest row
    (duplicates coalesced by summation, as scipy's COO does)."""
    dev = resolve_device(device)
    values, indices = pack_ell_host(rows, cols, vals, shape)
    return EllFeatures(
        values=torch.from_numpy(values).to(dev),
        indices=torch.from_numpy(indices).to(dev, torch.int64),
        num_cols=int(shape[1]),
    )

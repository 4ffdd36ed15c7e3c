"""Feature-matrix representations and their linear maps, on tensors.

Port of ``photon_ml_tpu/ops/features.py``:

- :class:`DenseFeatures` — plain ``[n, d]`` matrix.
- :class:`EllFeatures` — padded row-sparse (ELL) layout ``values/indices
  [n, k]`` with k = max nnz per row; padding slots carry value 0.0 so they
  are algebraic no-ops. ``matvec`` is ``torch.gather`` plus a sum over the
  slot axis.

Scoring needs only ``matvec``; the transposed maps arrive with training.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from photon_ml_tpu_torch.device import DEFAULT_DEVICE, DeviceLike, resolve_device


@dataclasses.dataclass
class DenseFeatures:
    """Dense ``[n, d]`` feature matrix."""

    matrix: torch.Tensor

    @property
    def num_rows(self) -> int:
        return self.matrix.shape[0]

    @property
    def dim(self) -> int:
        return self.matrix.shape[1]

    def matvec(self, w: torch.Tensor) -> torch.Tensor:
        return self.matrix @ w


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


def from_scipy_like(
    rows, cols, vals, shape, device: DeviceLike = DEFAULT_DEVICE
) -> EllFeatures:
    """EllFeatures from COO triplets on ``device``, k = the longest row
    (duplicates coalesced by summation, as scipy's COO does)."""
    dev = resolve_device(device)
    n, d = shape
    rows, cols, vals, counts = coalesce_coo(rows, cols, vals, n, d)
    k = max(int(counts.max()) if rows.size else 1, 1)
    values = np.zeros((n, k), dtype=np.float32)
    indices = np.zeros((n, k), dtype=np.int64)
    if rows.size:
        starts = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        slots = np.arange(rows.size, dtype=np.int64) - starts[rows]
        values[rows, slots] = vals
        indices[rows, slots] = cols
    return EllFeatures(
        values=torch.from_numpy(values).to(dev),
        indices=torch.from_numpy(indices).to(dev),
        num_cols=int(shape[1]),
    )

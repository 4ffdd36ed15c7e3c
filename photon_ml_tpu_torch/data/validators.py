"""Fail-fast input sanity checks.

Port of ``photon_ml_tpu/data/validators.py`` (reference photon-client
data/DataValidators.scala:29): per-task row checks — finite features,
labels, offsets and weights, task label ranges, non-negative weights — on
every row (VALIDATE_FULL), a 10 % sample of rows (VALIDATE_SAMPLE) or none
(VALIDATE_DISABLED). Every failed check is reported together, as the
reference accumulates and then throws.

The features are read from the port's layouts: dense, ELL, the fused
engine's CSR copy (both entry sets of a bfloat16 payload, which keep
non-finite values non-finite), and the Benes engine's slots, hot columns
and spilled entries. Each layout gives a per-row flag "holds a non-finite
value", so sampling picks rows, as the reference's row sample does.
"""

from __future__ import annotations

import enum
from typing import List

import numpy as np
import torch

from photon_ml_tpu_torch.ops.data import LabeledData
from photon_ml_tpu_torch.ops.features import DenseFeatures, EllFeatures
from photon_ml_tpu_torch.types import TaskType


class DataValidationType(enum.Enum):
    """Reference DataValidationType (data/DataValidators.scala)."""

    VALIDATE_FULL = "validate_full"
    VALIDATE_SAMPLE = "validate_sample"
    VALIDATE_DISABLED = "validate_disabled"


class DataValidationError(ValueError):
    """Raised with ALL failed checks listed, one per line."""

    def __init__(self, failures: List[str]):
        self.failures = failures
        super().__init__(
            "Data validation failed:\n" + "\n".join(f"  - {f}" for f in failures)
        )


_SAMPLE_FRACTION = 0.10  # VALIDATE_SAMPLE fraction


def _rows_with_nonfinite(rows: torch.Tensor, values: torch.Tensor, n: int) -> torch.Tensor:
    """bool [n]: the rows that hold a non-finite value among ``values``
    (entries at ``rows``)."""
    bad = torch.zeros(n, dtype=torch.bool, device=values.device)
    bad[rows[~torch.isfinite(values)]] = True
    return bad


def _nonfinite_rows(feats) -> torch.Tensor:
    """bool [n] of one layout: rows with a non-finite stored value (padding
    slots hold 0.0 and never mask one)."""
    from photon_ml_tpu_torch.ops.fused_perm import FusedSparseFeatures, csr_rows_of_nonzeros
    from photon_ml_tpu_torch.ops.sparse_perm import (
        BenesSparseFeatures,
        ColumnSplitFeatures,
        _ZeroColumnsBlock,
    )

    n = feats.num_rows
    if isinstance(feats, DenseFeatures):
        return ~torch.isfinite(feats.matrix).all(-1)
    if isinstance(feats, EllFeatures):
        return ~torch.isfinite(feats.values).all(-1)
    if isinstance(feats, FusedSparseFeatures):
        rows = csr_rows_of_nonzeros(feats.row_ptr, feats.row_blocks)
        return _rows_with_nonfinite(rows, feats.vals, n)
    if isinstance(feats, _ZeroColumnsBlock):
        return torch.zeros(n, dtype=torch.bool, device=feats.device)
    if isinstance(feats, (ColumnSplitFeatures, BenesSparseFeatures)):
        if isinstance(feats, ColumnSplitFeatures):
            parts = [_nonfinite_rows(blk) for blk in feats.blocks]
        else:
            parts = [~torch.isfinite(feats.ell_values).all(-1)]
            if feats.spill_rows is not None:
                parts.append(_rows_with_nonfinite(feats.spill_rows, feats.spill_vals, n))
        if feats.hot_matrix is not None:
            parts.append(~torch.isfinite(feats.hot_matrix).all(-1))
        return torch.stack(parts).any(0)
    raise TypeError(f"unknown feature matrix type {type(feats)!r}")


def validate_labeled_data(
    data: LabeledData,
    task: TaskType,
    mode: DataValidationType = DataValidationType.VALIDATE_FULL,
    seed: int = 0,
) -> None:
    """Run the reference's per-task checks; raise DataValidationError listing
    every failed check (DataValidators.sanityCheckData)."""
    if mode is DataValidationType.VALIDATE_DISABLED:
        return
    labels = data.labels.cpu().numpy()
    weights = data.weights.cpu().numpy()
    offsets = data.offsets.cpu().numpy()
    bad_rows = _nonfinite_rows(data.features).cpu().numpy()
    if mode is DataValidationType.VALIDATE_SAMPLE:
        n = labels.shape[0]
        take = max(1, int(n * _SAMPLE_FRACTION))
        idx = np.random.default_rng(seed).choice(n, size=take, replace=False)
        labels, weights, offsets, bad_rows = labels[idx], weights[idx], offsets[idx], bad_rows[idx]

    # padding rows (weight 0) are synthetic: no label checks
    live = weights > 0
    failures: List[str] = []
    if bad_rows.any():
        failures.append("features contain NaN or Inf")
    if not np.all(np.isfinite(labels[live])):
        failures.append("labels contain NaN or Inf")
    if not np.all(np.isfinite(offsets)):
        failures.append("offsets contain NaN or Inf")
    if not np.all(np.isfinite(weights)):
        failures.append("weights contain NaN or Inf")
    elif np.any(weights < 0):
        failures.append("weights contain negative values")

    finite_live = labels[live][np.isfinite(labels[live])]
    if task.is_classification:
        if finite_live.size and not np.all((finite_live == 0.0) | (finite_live == 1.0)):
            failures.append(f"labels for {task.value} must be 0 or 1")
    elif task is TaskType.POISSON_REGRESSION:
        if finite_live.size and np.any(finite_live < 0):
            failures.append("labels for poisson_regression must be non-negative")
    if failures:
        raise DataValidationError(failures)

"""Struct-of-arrays labeled data batch.

Port of ``photon_ml_tpu/ops/data.py`` (reference data/LabeledPoint.scala:32
— label, features, offset, weight — batched). Padding rows are weight 0, an
algebraic no-op in every objective term.

The reference carries one problem per batch and batches per-entity problems
with ``jax.vmap``. Here an optional leading entity axis takes vmap's place:
labels/offsets/weights ``[E, s]`` with dense features ``[E, s, d]`` hold a
whole random-effect bucket, one problem per entity lane.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_ml_tpu_torch.normalization import NormalizationContext


@dataclasses.dataclass
class LabeledData:
    """A batch of (label, features, offset, weight) examples.

    labels/offsets/weights: [n], or [E, s] for a batch of E problems;
    padding rows have weight 0. ``norm`` is folded into any objective
    evaluated over this batch (None = identity).
    """

    features: object  # DenseFeatures | EllFeatures | FusedSparseFeatures
    labels: torch.Tensor
    offsets: torch.Tensor
    weights: torch.Tensor
    norm: Optional[NormalizationContext] = None

    @classmethod
    def create(
        cls,
        features,
        labels: torch.Tensor,
        offsets: Optional[torch.Tensor] = None,
        weights: Optional[torch.Tensor] = None,
        norm: Optional[NormalizationContext] = None,
    ) -> "LabeledData":
        labels = torch.as_tensor(labels, dtype=torch.float32)
        offsets = (
            torch.zeros_like(labels)
            if offsets is None
            else torch.as_tensor(offsets, dtype=torch.float32, device=labels.device)
        )
        weights = (
            torch.ones_like(labels)
            if weights is None
            else torch.as_tensor(weights, dtype=torch.float32, device=labels.device)
        )
        return cls(features, labels, offsets, weights, norm)

    @property
    def batched(self) -> bool:
        """True when the batch holds one problem per leading-axis lane."""
        return self.labels.dim() == 2

    @property
    def dim(self) -> int:
        return self.features.dim

    def with_offsets(self, offsets: torch.Tensor) -> "LabeledData":
        """Replace offsets (the residual trick: Coordinate.scala:59-62)."""
        return dataclasses.replace(self, offsets=offsets)

    def take_lanes(self, idx: torch.Tensor) -> "LabeledData":
        """The problems at lanes ``idx`` of a batched (dense) batch."""
        return dataclasses.replace(
            self,
            features=dataclasses.replace(self.features, matrix=self.features.matrix[idx]),
            labels=self.labels[idx],
            offsets=self.offsets[idx],
            weights=self.weights[idx],
        )

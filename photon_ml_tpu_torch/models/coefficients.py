"""Model coefficients: means + optional variances, as tensors.

Port of ``photon_ml_tpu/models/coefficients.py`` (reference
model/Coefficients.scala:31). Sparsity of a model is represented by zeros;
the IO layer writes only nonzeros.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class Coefficients:
    means: torch.Tensor                       # [d]
    variances: Optional[torch.Tensor] = None  # [d] or None

    @property
    def dim(self) -> int:
        return self.means.shape[-1]

    def compute_score(self, features) -> torch.Tensor:
        """Dot product with a feature matrix (reference Coefficients.scala:53)."""
        return features.matvec(self.means)

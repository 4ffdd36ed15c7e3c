"""Matrix-factorization model: row/col latent factor scoring.

Copy of ``photon_ml_tpu/models/matrix_factorization.py`` (numpy only).
Reference parity: model/MatrixFactorizationModel.scala:36 —
rowLatentFactors/colLatentFactors keyed by entity id; score(rowId, colId) =
dot(rowFactor, colFactor). The reference has no standalone MF trainer (the
FactoredRandomEffectCoordinate is the training path); this model exists for
scoring and tests, mirroring that.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np


@dataclasses.dataclass
class MatrixFactorizationModel:
    """Latent factors as dense blocks + host-side id maps."""

    row_effect_type: str
    col_effect_type: str
    row_factors: np.ndarray  # [num_rows, k]
    col_factors: np.ndarray  # [num_cols, k]
    row_index: Dict[str, int]
    col_index: Dict[str, int]

    @property
    def num_latent_factors(self) -> int:
        return int(self.row_factors.shape[1])

    def to_summary_string(self) -> str:
        """Reference Summarizable.toSummaryString (MatrixFactorizationModel)."""
        return (
            f"matrix factorization '{self.row_effect_type}' x "
            f"'{self.col_effect_type}': {self.row_factors.shape[0]} x "
            f"{self.col_factors.shape[0]} entities, "
            f"{self.num_latent_factors} latent factors"
        )

    def __post_init__(self) -> None:
        if self.row_factors.shape[1] != self.col_factors.shape[1]:
            raise ValueError(
                "row and column factors must share the latent dimension "
                f"({self.row_factors.shape[1]} vs {self.col_factors.shape[1]})"
            )

    def score(self, row_id: str, col_id: str) -> float:
        """dot(rowFactor, colFactor); unknown ids score 0 (the reference's
        left-join default for unseen entities)."""
        r = self.row_index.get(str(row_id))
        c = self.col_index.get(str(col_id))
        if r is None or c is None:
            return 0.0
        return float(self.row_factors[r] @ self.col_factors[c])

    def score_batch(
        self, row_ids: Sequence[str], col_ids: Sequence[str]
    ) -> np.ndarray:
        """Vectorized pairwise scoring of aligned (row_id, col_id) lists."""
        r = np.array([self.row_index.get(str(i), -1) for i in row_ids])
        c = np.array([self.col_index.get(str(i), -1) for i in col_ids])
        known = (r >= 0) & (c >= 0)
        out = np.zeros(len(r), dtype=np.float32)
        if known.any():
            out[known] = np.einsum(
                "nk,nk->n",
                self.row_factors[r[known]],
                self.col_factors[c[known]],
            )
        return out

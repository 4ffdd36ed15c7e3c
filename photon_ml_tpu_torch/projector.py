"""Random-effect projection types: ProjectorType and the shared Gaussian
random projection.

Copy of the parts of ``photon_ml_tpu/projector.py`` that scoring and the
random-effect dataset builder need
(reference projector/ProjectorType.scala, ProjectionMatrix.scala:32,95).
The random projection matrix is never materialized over the full feature
space: rows are generated deterministically per column id from a seeded
counter RNG, so any subset of columns is regenerated identically at build,
export or scoring time, in either package.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np


class ProjectorType(enum.Enum):
    """Reference projector/ProjectorType.scala."""

    INDEX_MAP = "index_map"
    RANDOM = "random"
    IDENTITY = "identity"


@dataclasses.dataclass(frozen=True)
class RandomProjectionMatrix:
    """Gaussian random projection shared by all entities (reference
    ProjectionMatrix.scala:32,95 + ProjectionMatrixBroadcast.scala:31).

    B has shape [global_dim, projected_dim] with entries
    N(0, 1/projected_dim); x_projected = Bᵀ x. Rows are generated lazily and
    deterministically from (seed, column), never materializing B.
    """

    projected_dim: int
    global_dim: int
    seed: int = 0

    # Columns are generated in fixed chunks so any subset can be produced with
    # one vectorized standard_normal call per TOUCHED chunk (not per column):
    # chunk i is the deterministic stream Philox(key=(seed, i)), and column c
    # is row c % CHUNK of chunk c // CHUNK.
    _CHUNK = 4096

    def rows(self, cols: np.ndarray) -> np.ndarray:
        """B[cols, :] — [len(cols), projected_dim], deterministic per col."""
        cols = np.asarray(cols, dtype=np.int64)
        out = np.empty((cols.size, self.projected_dim), dtype=np.float32)
        chunk_of = cols // self._CHUNK
        for chunk in np.unique(chunk_of):
            sel = chunk_of == chunk
            block = np.random.Generator(
                np.random.Philox(key=(self.seed, int(chunk)))
            ).standard_normal((self._CHUNK, self.projected_dim), dtype=np.float32)
            out[sel] = block[cols[sel] % self._CHUNK]
        return out / np.float32(np.sqrt(self.projected_dim))

    def project_coo(
        self,
        sample_idx: np.ndarray,
        cols: np.ndarray,
        vals: np.ndarray,
        num_samples: int,
    ) -> np.ndarray:
        """COO features → dense projected [num_samples, projected_dim]:
        out[s] = Σ_nz v · B[c]."""
        cols = np.asarray(cols, dtype=np.int64)
        uniq, inv = np.unique(cols, return_inverse=True)
        b_sub = self.rows(uniq)
        out = np.zeros((num_samples, self.projected_dim), dtype=np.float32)
        np.add.at(
            out,
            np.asarray(sample_idx, dtype=np.int64),
            np.asarray(vals, dtype=np.float32)[:, None] * b_sub[inv],
        )
        return out

"""Stationary covariance kernels for GP hyperparameter search.

Reference parity: estimators/kernels/StationaryKernel.scala:* (pairwise
squared distances over length-scaled inputs; params stored in log space),
RBF.scala:* (K = exp(-r²/2)), Matern52.scala:* (K = (1 + √(5r²) + 5r²/3)·
exp(-√(5r²))). The reference computed distances with element loops; here
they are vectorized.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


def _pairwise_sq_dists(x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
    """m×p matrix of squared Euclidean distances between row-points."""
    d = x1[:, None, :] - x2[None, :, :]
    return np.einsum("mpk,mpk->mp", d, d)


@dataclasses.dataclass(frozen=True)
class Kernel:
    """Stationary kernel with per-dimension length scales.

    ``length_scale`` may have one entry (isotropic, broadcast over input
    dimensions like the reference's ``expandDimensions``) or one per input
    dimension (ARD).
    """

    length_scale: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(1)
    )
    length_scale_bounds: Tuple[float, float] = (1e-5, 1e5)

    def _scaled(self, x: np.ndarray) -> np.ndarray:
        ls = np.broadcast_to(
            np.asarray(self.length_scale, dtype=float), (x.shape[1],)
        )
        return x / ls

    def _from_sq_dists(self, sq_dists: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def __call__(self, x1: np.ndarray, x2: np.ndarray = None) -> np.ndarray:
        x1 = np.atleast_2d(np.asarray(x1, dtype=float))
        if x1.size == 0:
            raise ValueError("empty kernel input")
        a = self._scaled(x1)
        if x2 is None:
            b = a
        else:
            x2 = np.atleast_2d(np.asarray(x2, dtype=float))
            if x2.shape[1] != x1.shape[1]:
                raise ValueError("inputs must have the same number of columns")
            b = self._scaled(x2)
        return self._from_sq_dists(_pairwise_sq_dists(a, b))

    def diag(self, x: np.ndarray) -> np.ndarray:
        """k(x_i, x_i) per row — constant for stationary kernels; avoids
        building the full q×q matrix when only the diagonal is needed."""
        x = np.atleast_2d(np.asarray(x, dtype=float))
        return self._from_sq_dists(np.zeros(x.shape[0]))

    # --- log-space parameterization (StationaryKernel.scala getParams etc.)

    def get_params(self) -> np.ndarray:
        return np.log(np.asarray(self.length_scale, dtype=float))

    def get_param_bounds(self) -> Tuple[float, float]:
        lo, hi = self.length_scale_bounds
        return (np.log(lo), np.log(hi))

    def with_params(self, theta: np.ndarray) -> "Kernel":
        return dataclasses.replace(self, length_scale=np.exp(np.asarray(theta)))

    def expand_dims(self, dim: int) -> np.ndarray:
        """Initial log-params expanded to one per input dimension
        (Kernel.expandDimensions in the reference)."""
        return np.broadcast_to(self.get_params(), (dim,)).copy() if (
            self.get_params().shape[0] == 1
        ) else self.get_params()


@dataclasses.dataclass(frozen=True)
class RBF(Kernel):
    def _from_sq_dists(self, sq_dists: np.ndarray) -> np.ndarray:
        return np.exp(-0.5 * sq_dists)


@dataclasses.dataclass(frozen=True)
class Matern52(Kernel):
    def _from_sq_dists(self, sq_dists: np.ndarray) -> np.ndarray:
        f = np.sqrt(5.0 * sq_dists)
        return (1.0 + f + (5.0 / 3.0) * sq_dists) * np.exp(-f)

"""Gaussian Process regression with kernel params integrated out by MCMC.

Reference parity: estimators/GaussianProcessEstimator.scala:38 (slice-sampled
kernel length scales, burn-in + samples, GPML Alg. 2.1 log-likelihood) and
GaussianProcessModel.scala:* (per-sampled-kernel Cholesky precompute; predict
averages mean/variance over sampled kernels; predictTransformed averages the
acquisition value per kernel).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
from scipy.linalg import cho_factor, cho_solve, solve_triangular

from photon_ml_tpu_torch.hyperparameter.criteria import PredictionTransformation
from photon_ml_tpu_torch.hyperparameter.kernels import Kernel, RBF
from photon_ml_tpu_torch.hyperparameter.slice_sampler import SliceSampler

# Diagonal jitter for numerical positive-definiteness (the reference relies
# on catching Cholesky failures instead; jitter is standard GP practice).
_JITTER = 1e-9


class GaussianProcessModel:
    def __init__(
        self,
        x_train: np.ndarray,
        y_train: np.ndarray,
        y_mean: float,
        kernels: List[Kernel],
        prediction_transformation: Optional[PredictionTransformation] = None,
    ) -> None:
        x_train = np.atleast_2d(np.asarray(x_train, dtype=float))
        y_train = np.asarray(y_train, dtype=float)
        if x_train.shape[0] != y_train.shape[0]:
            raise ValueError("features and labels must have the same length")
        self.x_train = x_train
        self.y_train = y_train
        self.y_mean = y_mean
        self.kernels = kernels
        self.prediction_transformation = prediction_transformation
        self.feature_dimension = x_train.shape[1]
        # GPML Alg 2.1 lines 2-3, precomputed per sampled kernel
        self._precomputed = []
        n = x_train.shape[0]
        for kernel in kernels:
            k = kernel(x_train) + _JITTER * np.eye(n)
            chol = np.linalg.cholesky(k)
            alpha = cho_solve((chol, True), y_train)
            self._precomputed.append((kernel, chol, alpha))

    def _predict_with(
        self, x: np.ndarray, kernel: Kernel, chol: np.ndarray, alpha: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        ktrans = kernel(self.x_train, x)  # n_train × n_query
        y_pred = ktrans.T @ alpha  # line 4
        v = solve_triangular(chol, ktrans, lower=True)  # line 5
        # line 6, diagonal only: var_i = k(x_i,x_i) - ||v_i||² — no q×q matrices
        y_var = np.maximum(
            kernel.diag(x) - np.einsum("ij,ij->j", v, v), 0.0
        )
        return y_pred + self.y_mean, y_var

    def predict(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Mean and variance of the response, averaged over sampled kernels."""
        x = np.atleast_2d(np.asarray(x, dtype=float))
        means, variances = zip(
            *(self._predict_with(x, k, c, a) for k, c, a in self._precomputed)
        )
        return np.mean(means, axis=0), np.mean(variances, axis=0)

    def predict_transformed(self, x: np.ndarray) -> np.ndarray:
        """Acquisition value per query point, averaged over sampled kernels."""
        x = np.atleast_2d(np.asarray(x, dtype=float))
        out = []
        for k, c, a in self._precomputed:
            mean, var = self._predict_with(x, k, c, a)
            if self.prediction_transformation is not None:
                out.append(self.prediction_transformation(mean, var))
            else:
                out.append(mean)
        return np.mean(out, axis=0)


class GaussianProcessEstimator:
    def __init__(
        self,
        kernel: Kernel = None,
        normalize_labels: bool = False,
        prediction_transformation: Optional[PredictionTransformation] = None,
        num_burn_in_samples: int = 100,
        num_samples: int = 100,
        rng: np.random.Generator = None,
    ) -> None:
        self.kernel = kernel if kernel is not None else RBF()
        self.normalize_labels = normalize_labels
        self.prediction_transformation = prediction_transformation
        self.num_burn_in_samples = num_burn_in_samples
        self.num_samples = num_samples
        self.rng = rng if rng is not None else np.random.default_rng()

    def fit(self, x: np.ndarray, y: np.ndarray) -> GaussianProcessModel:
        x = np.atleast_2d(np.asarray(x, dtype=float))
        y = np.asarray(y, dtype=float)
        if x.shape[0] == 0 or x.shape[0] != y.shape[0]:
            raise ValueError("bad training data shapes")
        y_mean = float(np.mean(y)) if self.normalize_labels else 0.0
        y_train = y - y_mean
        kernels = self._estimate_kernel_params(x, y_train)
        return GaussianProcessModel(
            x, y_train, y_mean, kernels, self.prediction_transformation
        )

    def _estimate_kernel_params(
        self, x: np.ndarray, y: np.ndarray
    ) -> List[Kernel]:
        """Slice-sample length scales from l(θ|x,y) ∝ p(y|θ,x) under a
        uniform prior; each sample becomes one kernel to average over."""
        sampler = SliceSampler(
            lambda theta: self._log_likelihood(x, y, theta),
            range_=self.kernel.get_param_bounds(),
            rng=self.rng,
        )
        theta = self.kernel.expand_dims(x.shape[1])
        for _ in range(self.num_burn_in_samples):
            theta = sampler.draw(theta)
        samples = []
        for _ in range(self.num_samples):
            theta = sampler.draw(theta)
            samples.append(theta)
        return [self.kernel.with_params(t) for t in samples]

    def _log_likelihood(
        self, x: np.ndarray, y: np.ndarray, theta: np.ndarray
    ) -> float:
        """GPML Alg 2.1 / Eq 2.30 marginal likelihood; -inf when the kernel
        matrix is not PD (reference catches the Cholesky exception)."""
        kern = self.kernel.with_params(theta)
        k = kern(x) + _JITTER * np.eye(x.shape[0])
        try:
            chol, lower = cho_factor(k, lower=True)
        except np.linalg.LinAlgError:
            return -np.inf
        except ValueError:
            return -np.inf
        alpha = cho_solve((chol, lower), y)
        logdet_half = float(np.sum(np.log(np.diag(chol))))
        if not np.isfinite(logdet_half):
            return -np.inf
        return float(
            -0.5 * (y @ alpha) - logdet_half - 0.5 * len(y) * math.log(2 * math.pi)
        )

"""Bayesian/random hyperparameter search (driver-side math).

Reference parity: photon-lib hyperparameter/ — RandomSearch.scala:30,
GaussianProcessSearch.scala:54, GaussianProcessEstimator.scala:38,
SliceSampler.scala:53, kernels/{RBF,Matern52}, criteria/{ExpectedImprovement,
ConfidenceBound}, EvaluationFunction.scala:25.

This runs on the host between (expensive, device-resident) training
trials, so plain NumPy is the right tool — matrices are #trials × #trials.

Own copy of ``photon_ml_tpu/hyperparameter/*`` (numpy and scipy only): the
same seeds and observations give the same candidates bit for bit.
"""

from photon_ml_tpu_torch.hyperparameter.kernels import RBF, Kernel, Matern52
from photon_ml_tpu_torch.hyperparameter.slice_sampler import SliceSampler
from photon_ml_tpu_torch.hyperparameter.gp import (
    GaussianProcessEstimator,
    GaussianProcessModel,
)
from photon_ml_tpu_torch.hyperparameter.criteria import (
    ConfidenceBound,
    ExpectedImprovement,
    PredictionTransformation,
)
from photon_ml_tpu_torch.hyperparameter.search import (
    EvaluationFunction,
    GaussianProcessSearch,
    RandomSearch,
)

__all__ = [
    "RBF",
    "Kernel",
    "Matern52",
    "SliceSampler",
    "GaussianProcessEstimator",
    "GaussianProcessModel",
    "ConfidenceBound",
    "ExpectedImprovement",
    "PredictionTransformation",
    "EvaluationFunction",
    "GaussianProcessSearch",
    "RandomSearch",
]

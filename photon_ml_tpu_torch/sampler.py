"""Down-samplers: pre-optimization data reduction.

Copy of ``photon_ml_tpu/sampler.py`` (numpy only, so the same seed gives
the same weights bitwise in both packages). Reference parity:
sampler/DownSampler.scala:27 (interface), DefaultDownSampler.scala:27
(uniform sampling with weight re-scale) and
BinaryClassificationDownSampler.scala:32 (samples only negatives, keeps
every positive, and re-scales surviving negative weights so the objective
stays an unbiased estimate).

Every objective treats weight-0 rows as algebraic no-ops (ops/data.py), and
a batch keeps its shapes (the device layouts are built once). So a
"down-sampled dataset" here is the SAME batch with dropped rows' weights set
to 0 and survivors' weights re-scaled — no compaction, no layout rebuilt. The
reference instead materializes a smaller RDD; the weight algebra is identical
(DownSampler re-scales by 1/rate in both designs).
"""

from __future__ import annotations

import abc
import dataclasses

import numpy as np

from photon_ml_tpu_torch.types import POSITIVE_RESPONSE_THRESHOLD, TaskType


class DownSampler(abc.ABC):
    """Weight-masking down-sampler (reference DownSampler.scala:27)."""

    @abc.abstractmethod
    def sample_weights(
        self, labels: np.ndarray, weights: np.ndarray, seed: int
    ) -> np.ndarray:
        """Return new per-row weights: 0 for dropped rows, re-scaled for
        survivors, untouched for rows outside the sampled class."""


@dataclasses.dataclass(frozen=True)
class DefaultDownSampler(DownSampler):
    """Uniform row sampling at ``rate`` with 1/rate weight re-scale
    (reference DefaultDownSampler.scala:27)."""

    down_sampling_rate: float

    def __post_init__(self) -> None:
        if not 0.0 < self.down_sampling_rate < 1.0:
            raise ValueError(
                f"down_sampling_rate must be in (0, 1), got {self.down_sampling_rate}"
            )

    def sample_weights(
        self, labels: np.ndarray, weights: np.ndarray, seed: int
    ) -> np.ndarray:
        rng = np.random.default_rng(seed)
        keep = rng.random(labels.shape[0]) < self.down_sampling_rate
        return np.where(keep, weights / self.down_sampling_rate, 0.0).astype(
            np.float32
        )


@dataclasses.dataclass(frozen=True)
class BinaryClassificationDownSampler(DownSampler):
    """Negatives-only sampling for class-imbalanced binary tasks (reference
    BinaryClassificationDownSampler.scala:32): positives always survive with
    unchanged weight; negatives survive with probability ``rate`` and weight
    scaled by 1/rate."""

    down_sampling_rate: float

    def __post_init__(self) -> None:
        if not 0.0 < self.down_sampling_rate < 1.0:
            raise ValueError(
                f"down_sampling_rate must be in (0, 1), got {self.down_sampling_rate}"
            )

    def sample_weights(
        self, labels: np.ndarray, weights: np.ndarray, seed: int
    ) -> np.ndarray:
        rng = np.random.default_rng(seed)
        negative = labels < POSITIVE_RESPONSE_THRESHOLD
        keep_negative = rng.random(labels.shape[0]) < self.down_sampling_rate
        out = np.where(
            negative,
            np.where(keep_negative, weights / self.down_sampling_rate, 0.0),
            weights,
        )
        return out.astype(np.float32)


def down_sampler_for(task: TaskType, rate: float) -> DownSampler:
    """Pick the sampler the reference picks (DistributedOptimizationProblem
    factory :172-197: binary-classification sampler for classification tasks,
    default otherwise)."""
    if task.is_classification:
        return BinaryClassificationDownSampler(rate)
    return DefaultDownSampler(rate)

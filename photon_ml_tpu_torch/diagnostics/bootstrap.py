"""Bootstrap training: coefficient and metric confidence intervals.

Port of ``photon_ml_tpu/diagnostics/bootstrap.py`` (reference
BootstrapTraining.scala:29): ``num_samples`` with-replacement resamples,
each fit by a caller-supplied train function, then per-coefficient
summaries (CoefficientSummary.scala: min/max/mean/std and quartiles) and
per-metric distributions (BootstrapTrainingDiagnostic.scala:26).

The JAX module builds one summary object per coefficient, a percentile
call each: at 2^24 + 1 coefficients that is minutes of host time. Here the
statistics are computed column-wise over the [S, d] stack once, by the
same numpy reductions along rows, so each value is bitwise the
per-column call's (column blocks on a thread pool); :class:`CoefficientSummaries`
builds a summary object only when one is read.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Sequence, Tuple, Union

import numpy as np

from photon_ml_tpu_torch.diagnostics.evaluation import MetricsMap


@dataclasses.dataclass(frozen=True)
class CoefficientSummary:
    """Distribution summary of one scalar across bootstrap fits
    (reference supervised/model/CoefficientSummary.scala; quartiles exact
    over the sample set rather than streaming estimates)."""

    min: float
    max: float
    mean: float
    std: float
    q1: float
    median: float
    q3: float

    @classmethod
    def from_samples(cls, samples: np.ndarray) -> "CoefficientSummary":
        s = np.asarray(samples, dtype=np.float64)
        q1, med, q3 = np.percentile(s, [25, 50, 75])
        return cls(
            min=float(s.min()), max=float(s.max()), mean=float(s.mean()),
            std=float(s.std(ddof=1)) if len(s) > 1 else 0.0,
            q1=float(q1), median=float(med), q3=float(q3),
        )

    def interval_contains_zero(self) -> bool:
        return self.min <= 0.0 <= self.max


class CoefficientSummaries(Sequence):
    """The per-coefficient summaries of an [S, d] stack of bootstrap fits:
    the seven statistics of every column computed at once, a
    :class:`CoefficientSummary` built when an item is read. Values, ``len``
    and equality are those of the list of per-column summaries.

    Columns go in blocks of :data:`BLOCK_COLUMNS` over a thread pool (numpy
    releases the interpreter lock in these loops); each column's
    arithmetic is the same whatever block or thread computes it."""

    BLOCK_COLUMNS = 1 << 16

    def __init__(self, coefs: np.ndarray):
        s = np.asarray(coefs, dtype=np.float64)
        d = s.shape[1]
        stats = ("min", "max", "mean", "std", "q1", "median", "q3")
        for name in stats:
            setattr(self, name, np.empty(d))
        blocks = range(0, d, self.BLOCK_COLUMNS)
        workers = max(1, min(8, os.cpu_count() or 1, len(blocks)))
        with ThreadPoolExecutor(workers) as pool:
            for lo, values in zip(blocks, pool.map(
                    lambda lo: self._block(s[:, lo:lo + self.BLOCK_COLUMNS]), blocks)):
                for name, v in zip(stats, values):
                    getattr(self, name)[lo:lo + v.shape[0]] = v

    @staticmethod
    def _block(s: np.ndarray) -> tuple:
        """(min, max, mean, std, q1, median, q3) of each column of ``s``."""
        # one contiguous row a column: numpy reduces each row as it reduces
        # one 1-D column (the same pairwise sum), so each value is bitwise
        # np.mean / np.std(ddof=1) / np.percentile of that column
        t = np.ascontiguousarray(s.T)
        std = t.std(axis=1, ddof=1) if t.shape[1] > 1 else np.zeros(t.shape[0])
        q1, median, q3 = np.percentile(t, [25, 50, 75], axis=1)
        return t.min(axis=1), t.max(axis=1), t.mean(axis=1), std, q1, median, q3

    def __len__(self) -> int:
        return self.min.shape[0]

    def __getitem__(self, j: Union[int, slice]):
        if isinstance(j, slice):
            return [self[i] for i in range(*j.indices(len(self)))]
        j = range(len(self))[j]  # negative indices and bounds, as a list's
        return CoefficientSummary(
            min=float(self.min[j]), max=float(self.max[j]), mean=float(self.mean[j]),
            std=float(self.std[j]), q1=float(self.q1[j]), median=float(self.median[j]),
            q3=float(self.q3[j]),
        )

    def __eq__(self, other) -> bool:
        if not isinstance(other, Sequence) or len(other) != len(self):
            return False
        return all(a == b for a, b in zip(self, other))

    def __repr__(self) -> str:
        return f"CoefficientSummaries({len(self)} coefficients)"

    def zero_crossing(self) -> np.ndarray:
        """Indices whose interval [min, max] holds zero, ascending."""
        return np.flatnonzero((self.min <= 0.0) & (0.0 <= self.max)).astype(np.int64)


@dataclasses.dataclass
class BootstrapReport:
    """Per-coefficient intervals, metric distributions and the coefficients
    whose interval straddles zero (reference bootstrap/BootstrapReport.scala)."""

    coefficient_summaries: Sequence[CoefficientSummary]
    metric_summaries: Dict[str, CoefficientSummary]
    # coefficients whose bootstrap interval straddles zero: candidates for
    # removal (the reference's importance analysis)
    zero_crossing_indices: np.ndarray


def bootstrap_training(
    train_fn: Callable[[np.ndarray], Tuple[np.ndarray, MetricsMap]],
    num_rows: int,
    num_samples: int = 16,
    portion: float = 1.0,
    seed: int = 0,
) -> BootstrapReport:
    """Run ``train_fn`` on ``num_samples`` with-replacement row resamples.

    ``train_fn(row_indices) -> (coefficient_vector, metrics)`` wraps the
    model fit and its evaluation (the reference curries
    ModelTraining.trainGeneralizedLinearModel the same way).
    """
    if num_samples < 2:
        raise ValueError("bootstrapping needs at least 2 samples")
    rng = np.random.default_rng(seed)
    n_draw = max(1, int(portion * num_rows))
    coef_rows: List[np.ndarray] = []
    metric_rows: List[MetricsMap] = []
    for _ in range(num_samples):
        idx = rng.integers(0, num_rows, size=n_draw)
        w, metrics = train_fn(idx)
        coef_rows.append(np.asarray(w, dtype=np.float64))
        metric_rows.append(metrics)

    summaries = CoefficientSummaries(np.stack(coef_rows))  # [S, d]
    metric_summaries = {
        name: CoefficientSummary.from_samples(np.array([m[name] for m in metric_rows]))
        for name in metric_rows[0]
    }
    return BootstrapReport(
        coefficient_summaries=summaries,
        metric_summaries=metric_summaries,
        zero_crossing_indices=summaries.zero_crossing(),
    )

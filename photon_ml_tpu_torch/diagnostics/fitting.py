"""Learning-curve (under/over-fit) diagnostic.

Port of ``photon_ml_tpu/diagnostics/fitting.py``, host numpy as there.

Reference parity: diagnostics/fitting/FittingDiagnostic.scala:33 — rows are
randomly tagged into NUM_TRAINING_PARTITIONS=10 slices; the last slice is
the hold-out; models are trained on growing prefixes of the rest (warm-
started across portions) and train-vs-holdout metric curves per λ reveal
fit problems. Requires numSamples > dim · MIN_SAMPLES_PER_PARTITION_PER_
DIMENSION (=1) to produce a report.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch.diagnostics.evaluation import MetricsMap

NUM_TRAINING_PARTITIONS = 10
MIN_SAMPLES_PER_PARTITION_PER_DIMENSION = 1


@dataclasses.dataclass
class FittingReport:
    """Per-λ learning curves: metric name → (portions %, train values,
    holdout values) (reference fitting/FittingReport.scala)."""

    metrics: Dict[str, Tuple[List[float], List[float], List[float]]]
    message: str = ""


def fitting_diagnostic(
    train_fn: Callable[[np.ndarray, Dict[float, object]], Dict[float, object]],
    eval_fn: Callable[[object, np.ndarray], MetricsMap],
    num_rows: int,
    dim: int,
    seed: int = 0,
) -> Dict[float, FittingReport]:
    """``train_fn(row_indices, warm_start) -> {λ: model}``;
    ``eval_fn(model, row_indices) -> metrics``. Returns λ → FittingReport
    (empty when the dataset is too small, like the reference)."""
    min_samples = dim * MIN_SAMPLES_PER_PARTITION_PER_DIMENSION
    if num_rows <= min_samples:
        return {}

    rng = np.random.default_rng(seed)
    tags = rng.integers(0, NUM_TRAINING_PARTITIONS, size=num_rows)
    holdout = np.flatnonzero(tags == NUM_TRAINING_PARTITIONS - 1)

    curves: Dict[float, Dict[str, Tuple[List[float], List[float], List[float]]]] = {}
    warm: Dict[float, object] = {}
    for max_tag in range(NUM_TRAINING_PARTITIONS - 1):
        subset = np.flatnonzero(tags <= max_tag)
        portion = 100.0 * len(subset) / num_rows
        models = train_fn(subset, warm)
        warm = models
        for lam, model in models.items():
            test_metrics = eval_fn(model, holdout)
            train_metrics = eval_fn(model, subset)
            by_metric = curves.setdefault(lam, {})
            for name, test_val in test_metrics.items():
                portions, train_vals, test_vals = by_metric.setdefault(
                    name, ([], [], [])
                )
                portions.append(portion)
                train_vals.append(train_metrics.get(name, float("nan")))
                test_vals.append(test_val)

    return {lam: FittingReport(metrics=m) for lam, m in curves.items()}

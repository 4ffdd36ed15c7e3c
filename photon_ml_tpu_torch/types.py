"""Core shared types.

Copy of ``TaskType`` from ``photon_ml_tpu/types.py`` (reference
TaskType.scala:20-24); the port's other enums arrive with the slices that
use them.
"""

from __future__ import annotations

import enum


class TaskType(enum.Enum):
    """Training task (reference TaskType.scala:20-24)."""

    LINEAR_REGRESSION = "linear_regression"
    LOGISTIC_REGRESSION = "logistic_regression"
    POISSON_REGRESSION = "poisson_regression"
    SMOOTHED_HINGE_LOSS_LINEAR_SVM = "smoothed_hinge_loss_linear_svm"

    @property
    def is_classification(self) -> bool:
        return self in (
            TaskType.LOGISTIC_REGRESSION,
            TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM,
        )

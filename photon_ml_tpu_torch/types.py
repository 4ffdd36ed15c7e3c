"""Core shared types.

Copy of the enums of ``photon_ml_tpu/types.py`` (reference
TaskType.scala:20-24, NormalizationType, RegularizationType,
util/ConvergenceReason.scala:21).
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


class NormalizationType(enum.Enum):
    """Feature normalization modes (reference NormalizationType)."""

    NONE = "none"
    SCALE_WITH_MAX_MAGNITUDE = "scale_with_max_magnitude"
    SCALE_WITH_STANDARD_DEVIATION = "scale_with_standard_deviation"
    STANDARDIZATION = "standardization"


class RegularizationType(enum.Enum):
    """Regularization family (reference RegularizationType)."""

    NONE = "none"
    L1 = "l1"
    L2 = "l2"
    ELASTIC_NET = "elastic_net"


class ConvergenceReason(enum.Enum):
    """Why an optimizer stopped (reference util/ConvergenceReason.scala:21);
    kept as an int64 code per solver lane on the device."""

    NOT_CONVERGED = 0
    MAX_ITERATIONS = 1
    FUNCTION_VALUES_CONVERGED = 2
    GRADIENT_CONVERGED = 3
    OBJECTIVE_NOT_IMPROVING = 4

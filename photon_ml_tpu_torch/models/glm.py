"""Per-task generalized linear model.

Port of ``photon_ml_tpu/models/glm.py`` (reference
GeneralizedLinearModel.scala:33, computeScore :68): one class parametrized
by TaskType.
"""

from __future__ import annotations

import dataclasses

import torch

from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.types import TaskType


@dataclasses.dataclass
class GeneralizedLinearModel:
    coefficients: Coefficients
    task: TaskType = TaskType.LOGISTIC_REGRESSION

    @property
    def dim(self) -> int:
        return self.coefficients.dim

    @property
    def device(self) -> torch.device:
        return self.coefficients.means.device

    def compute_score(self, features) -> torch.Tensor:
        """Margin z = X @ w (no offset; reference computeScore)."""
        return self.coefficients.compute_score(features)

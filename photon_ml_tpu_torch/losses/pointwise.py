"""Pointwise GLM losses: l(z, y) and its first/second derivatives w.r.t. the
margin z, on tensors.

Port of ``photon_ml_tpu/losses/pointwise.py`` (reference
PointwiseLossFunction.scala:36 and its four implementations). Labels follow
the reference conventions: logistic/hinge labels are {0, 1} (hinge converts
to ±1 internally).
"""

from __future__ import annotations

from typing import Type

import torch
import torch.nn.functional as F

from photon_ml_tpu_torch.types import TaskType


class PointwiseLoss:
    """Interface: value(z, y), d1(z, y), d2(z, y) — all elementwise."""

    #: whether d2 is available (the smoothed hinge has no Hessian)
    has_hessian: bool = True

    @staticmethod
    def value(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @staticmethod
    def d1(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @staticmethod
    def d2(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class LogisticLoss(PointwiseLoss):
    """l(z, y) = log(1 + e^z) - y*z, y in {0, 1} (stable through softplus)."""

    @staticmethod
    def value(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return F.softplus(z) - y * z

    @staticmethod
    def d1(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(z) - y

    @staticmethod
    def d2(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        s = torch.sigmoid(z)
        return s * (1.0 - s)


class SquaredLoss(PointwiseLoss):
    """l(z, y) = (z - y)^2 / 2."""

    @staticmethod
    def value(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        d = z - y
        return 0.5 * d * d

    @staticmethod
    def d1(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return z - y

    @staticmethod
    def d2(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return torch.ones_like(z)


class PoissonLoss(PointwiseLoss):
    """l(z, y) = e^z - y*z."""

    @staticmethod
    def value(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return torch.exp(z) - y * z

    @staticmethod
    def d1(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return torch.exp(z) - y

    @staticmethod
    def d2(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return torch.exp(z)


class SmoothedHingeLoss(PointwiseLoss):
    """Rennie smoothed hinge, labels {0,1} mapped to t=±1. With u = t*z:

        l = 0          if u >= 1
        l = (1-u)^2/2  if 0 < u < 1
        l = 1/2 - u    if u <= 0
    """

    has_hessian = False

    @staticmethod
    def _t(y: torch.Tensor) -> torch.Tensor:
        return torch.where(y > 0.5, 1.0, -1.0).to(y.dtype)

    @staticmethod
    def value(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        u = SmoothedHingeLoss._t(y) * z
        quad = 0.5 * (1.0 - u) * (1.0 - u)
        zero = torch.zeros_like(u)
        return torch.where(u >= 1.0, zero, torch.where(u <= 0.0, 0.5 - u, quad))

    @staticmethod
    def d1(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        t = SmoothedHingeLoss._t(y)
        u = t * z
        dz_du = torch.where(
            u >= 1.0, torch.zeros_like(u),
            torch.where(u <= 0.0, -torch.ones_like(u), u - 1.0),
        )
        return dz_du * t

    @staticmethod
    def d2(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        u = SmoothedHingeLoss._t(y) * z
        return ((u > 0.0) & (u < 1.0)).to(z.dtype)


def loss_for_task(task: TaskType) -> Type[PointwiseLoss]:
    """TaskType -> loss class (reference ModelTraining.scala:127-149)."""
    return {
        TaskType.LOGISTIC_REGRESSION: LogisticLoss,
        TaskType.LINEAR_REGRESSION: SquaredLoss,
        TaskType.POISSON_REGRESSION: PoissonLoss,
        TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: SmoothedHingeLoss,
    }[task]


def mean_function(task: TaskType, z: torch.Tensor) -> torch.Tensor:
    """Link-inverse posterior mean: logistic -> sigmoid, poisson -> exp,
    linear/SVM -> identity margin."""
    if task is TaskType.LOGISTIC_REGRESSION:
        return torch.sigmoid(z)
    if task is TaskType.POISSON_REGRESSION:
        return torch.exp(z)
    return z

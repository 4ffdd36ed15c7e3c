"""Numerically stable scalar math on tensors.

Port of ``photon_ml_tpu/utils/math_utils.py`` (reference photon-lib
util/MathUtils.scala log1pExp, plus the small helpers the objectives use).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def log1p_exp(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) without overflow (reference MathUtils.log1pExp):
    ``F.softplus``, the stable ``max(x, 0) + log1p(exp(-|x|))``."""
    return F.softplus(x)


def is_almost_zero(x: torch.Tensor, eps: float = 1e-15) -> torch.Tensor:
    """|x| < eps (reference MathUtils.isAlmostZero)."""
    return torch.abs(x) < eps


def safe_div(num: torch.Tensor, den: torch.Tensor, eps: float = 1e-15) -> torch.Tensor:
    """num / den, 0 where |den| < eps (masked means)."""
    tiny = torch.abs(den) < eps
    return torch.where(tiny, 0.0, num / torch.where(tiny, 1.0, den))

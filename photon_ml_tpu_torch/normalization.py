"""Feature normalization folded into the objective algebraically.

Port of ``NormalizationContext`` from ``photon_ml_tpu/normalization.py``
(reference normalization/NormalizationContext.scala:39): the transform
x -> (x - shift) .* factor is never materialized on the data; the objective
uses effective coefficients ``ew = factor .* w`` and a scalar margin
correction ``- dot(shift, ew)`` (ValueAndGradientAggregator.scala:35-79), so
sparse feature batches stay sparse. ``transform_model_coefficients`` maps
coefficients trained in the normalized space back to the original one
(NormalizationContext.scala:71-82); ``build_normalization_context`` makes a
context from feature statistics (``stat/summary.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_ml_tpu_torch.types import NormalizationType


@dataclasses.dataclass
class NormalizationContext:
    """factor/shift are [d] tensors or None (no-op). With a shift, the
    intercept's slot has factor 1 and shift 0 (reference
    NormalizationContext.scala:95-145)."""

    factor: Optional[torch.Tensor] = None
    shift: Optional[torch.Tensor] = None

    @property
    def is_identity(self) -> bool:
        return self.factor is None and self.shift is None

    def effective_coefficients(self, w: torch.Tensor) -> torch.Tensor:
        return w * self.factor if self.factor is not None else w

    def margin_shift(self, ew: torch.Tensor) -> torch.Tensor:
        """Correction subtracted from every margin: a scalar for [d]
        coefficients, one per lane for [E, d]."""
        if self.shift is None:
            return torch.zeros(ew.shape[:-1], dtype=ew.dtype, device=ew.device)
        return (self.shift * ew).sum(-1)

    def apply_to_gradient(self, raw: torch.Tensor, csum: torch.Tensor) -> torch.Tensor:
        """Map d(loss)/d(ew) pieces to d(loss)/dw.

        raw = X^T c, csum = sum(c); grad_j = factor_j * (raw_j - shift_j*csum).
        """
        g = raw
        if self.shift is not None:
            g = g - self.shift * csum.unsqueeze(-1)
        if self.factor is not None:
            g = g * self.factor
        return g

    def _require_intercept(self, intercept_index: Optional[int]) -> int:
        if intercept_index is None:
            raise ValueError("shift normalization requires an intercept")
        return intercept_index

    def transform_model_coefficients(
        self, w: torch.Tensor, intercept_index: Optional[int]
    ) -> torch.Tensor:
        """Normalized-space w -> original-space coefficients (reference
        NormalizationContext.scala:71-82): w_orig = factor .* w,
        intercept_orig = intercept - dot(shift, factor .* w)."""
        w_orig = self.effective_coefficients(w)
        if self.shift is not None:
            icpt = self._require_intercept(intercept_index)
            w_orig = w_orig.clone()
            w_orig[icpt] -= (self.shift * w_orig).sum()
        return w_orig

    def inverse_transform_model_coefficients(
        self, w_orig: torch.Tensor, intercept_index: Optional[int]
    ) -> torch.Tensor:
        """Original-space coefficients -> normalized space (the exact inverse
        of :meth:`transform_model_coefficients`; warm-starts a normalized
        solve from an original-space model)."""
        w = w_orig
        if self.shift is not None:
            icpt = self._require_intercept(intercept_index)
            w = w.clone()
            w[icpt] += (self.shift * w_orig).sum()
        if self.factor is not None:
            w = w / self.factor
        return w

    def transform_model_variances(
        self, v: torch.Tensor, intercept_index: Optional[int]
    ) -> torch.Tensor:
        """Normalized-space coefficient variances -> original space, by the
        delta method on w_orig = factor .* w and the intercept's shift
        correction (coefficients treated as independent):
        var_orig = factor^2 .* var; var_intercept += sum((shift*factor)^2 var)
        over the other coefficients."""
        v_orig = v * self.factor * self.factor if self.factor is not None else v
        if self.shift is not None:
            icpt = self._require_intercept(intercept_index)
            extra = (self.shift * self.shift * v_orig).sum() - (
                self.shift[icpt] ** 2 * v_orig[icpt]
            )
            v_orig = v_orig.clone()
            v_orig[icpt] += extra
        return v_orig


def build_normalization_context(
    norm_type: NormalizationType,
    mean: torch.Tensor,
    variance: torch.Tensor,
    max_magnitude: torch.Tensor,
    intercept_index: Optional[int],
) -> NormalizationContext:
    """The context for ``norm_type`` from feature summary statistics
    (reference NormalizationContext.scala:95-145):

    - SCALE_WITH_STANDARD_DEVIATION: factor = 1/std
    - SCALE_WITH_MAX_MAGNITUDE:      factor = 1/max|x|
    - STANDARDIZATION:               factor = 1/std, shift = mean (needs an
      intercept)

    A feature with zero spread keeps factor 1; the intercept keeps factor 1
    and shift 0."""
    if norm_type is NormalizationType.NONE:
        return NormalizationContext()
    std = torch.sqrt(variance)
    one = torch.ones_like(std)
    inv_std = torch.where(std > 0, 1.0 / torch.clamp(std, min=1e-30), one)
    if norm_type is NormalizationType.SCALE_WITH_STANDARD_DEVIATION:
        factor, shift = inv_std, None
    elif norm_type is NormalizationType.SCALE_WITH_MAX_MAGNITUDE:
        mm = max_magnitude.abs()
        factor, shift = torch.where(mm > 0, 1.0 / torch.clamp(mm, min=1e-30), one), None
    elif norm_type is NormalizationType.STANDARDIZATION:
        if intercept_index is None:
            raise ValueError("STANDARDIZATION requires an intercept feature")
        factor, shift = inv_std, mean.clone()
    else:
        raise ValueError(f"unknown normalization type {norm_type}")
    if intercept_index is not None:
        factor[intercept_index] = 1.0
        if shift is not None:
            shift[intercept_index] = 0.0
    return NormalizationContext(factor=factor, shift=shift)

"""Feature normalization folded into the objective algebraically.

Port of ``NormalizationContext`` from ``photon_ml_tpu/normalization.py``
(reference normalization/NormalizationContext.scala:39): the transform
x -> (x - shift) .* factor is never materialized on the data; the objective
uses effective coefficients ``ew = factor .* w`` and a scalar margin
correction ``- dot(shift, ew)`` (ValueAndGradientAggregator.scala:35-79), so
sparse feature batches stay sparse.

Building a context from feature statistics (``build_normalization_context``)
needs ``stat/summary.py`` and is not ported yet (ROADMAP.md, Queue A:
"build_normalization_context with stat/summary.py").
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


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

"""The GLM objective: value / gradient / Hessian-vector / Hessian-diagonal.

Port of ``photon_ml_tpu/losses/objective.py`` (reference
function/glm/{ValueAndGradient,HessianVector,HessianDiagonal}Aggregator
.scala fused with function/L2Regularization.scala):

- objective(w) = Σ_i weight_i·l(z_i, y_i) + ½·l2·‖w‖²
- z_i = x_i·(factor∘w) − shift·(factor∘w) + offset_i
- weight-0 rows are exact no-ops even where l overflows (``where``, never
  0·inf); L1 is not part of the smooth objective (OWL-QN's business).

Every function takes either one problem — w [d] over data with [n] rows —
or a batch of them — w [E, d] over batched data ([E, s] rows, dense
[E, s, d] features) — and reduces over the last axis, so one definition
serves the fixed effect and a whole random-effect bucket. ``value_and_grad``
sends a batch of dense problems with identity normalization through the
fused kernel ``ops.pallas_kernels.fused_value_grad_batched_f32`` (the
reference's ``fused_value_grad_auto`` route); everything else goes through
the features' ``matvec``/``rmatvec``, which on the fused sparse engine are
the ``csr_matvec_f32`` and ``csc_rmatvec_f32`` kernels.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple, Type

import torch

from photon_ml_tpu_torch.losses.pointwise import PointwiseLoss
from photon_ml_tpu_torch.normalization import NormalizationContext
from photon_ml_tpu_torch.ops import pallas_kernels
from photon_ml_tpu_torch.ops.data import LabeledData
from photon_ml_tpu_torch.ops.features import DenseFeatures

_IDENTITY_NORM = NormalizationContext()


def _norm_of(data: LabeledData) -> NormalizationContext:
    return data.norm if data.norm is not None else _IDENTITY_NORM


def _wmask(weights: torch.Tensor, terms: torch.Tensor) -> torch.Tensor:
    # weight-0 padding rows must be exact no-ops even when the unweighted
    # term overflows to inf (0 * inf = NaN would poison the sum)
    return torch.where(weights > 0, weights * terms, torch.zeros_like(terms))


def _sq_norm(w: torch.Tensor) -> torch.Tensor:
    return (w * w).sum(-1)


class GlmObjective(NamedTuple):
    value: Callable          # (w, data, l2) -> [] or [E]
    value_and_grad: Callable  # (w, data, l2) -> (value, grad like w)
    hessian_vec: Callable    # (w, v, data, l2) -> like w
    hessian_diag: Callable   # (w, data, l2) -> like w
    has_hessian: bool


def make_glm_objective(loss: Type[PointwiseLoss]) -> GlmObjective:
    def margins(w: torch.Tensor, data: LabeledData) -> torch.Tensor:
        norm = _norm_of(data)
        ew = norm.effective_coefficients(w)
        return (
            data.features.matvec(ew) - norm.margin_shift(ew).unsqueeze(-1) + data.offsets
        )

    def value(w: torch.Tensor, data: LabeledData, l2) -> torch.Tensor:
        z = margins(w, data)
        loss_sum = _wmask(data.weights, loss.value(z, data.labels)).sum(-1)
        return loss_sum + 0.5 * l2 * _sq_norm(w)

    def value_and_grad(
        w: torch.Tensor, data: LabeledData, l2
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        norm = _norm_of(data)
        if isinstance(data.features, DenseFeatures) and norm.is_identity:
            # one pass over X for value + gradient (the fused kernel on the
            # card); None: not a batch of small dense problems
            fused = pallas_kernels.fused_value_grad_auto(
                data.features.matrix.contiguous(), data.labels.contiguous(),
                data.offsets.contiguous(), data.weights.contiguous(),
                w.contiguous(), loss,
            )
            if fused is not None:
                loss_sum, raw, _ = fused
                return loss_sum + 0.5 * l2 * _sq_norm(w), raw + l2 * w
        z = margins(w, data)
        loss_sum = _wmask(data.weights, loss.value(z, data.labels)).sum(-1)
        c = _wmask(data.weights, loss.d1(z, data.labels))
        raw = data.features.rmatvec(c)
        grad = norm.apply_to_gradient(raw, c.sum(-1))
        return loss_sum + 0.5 * l2 * _sq_norm(w), grad + l2 * w

    def hessian_vec(w: torch.Tensor, v: torch.Tensor, data: LabeledData, l2) -> torch.Tensor:
        """Hv = Jᵀ diag(weight_i·l″_i) J v, J the normalized feature map
        (reference HessianVectorAggregator.scala:36)."""
        norm = _norm_of(data)
        z = margins(w, data)
        ev = norm.effective_coefficients(v)
        zv = data.features.matvec(ev) - norm.margin_shift(ev).unsqueeze(-1)
        c2 = _wmask(data.weights, loss.d2(z, data.labels) * zv)
        raw = data.features.rmatvec(c2)
        return norm.apply_to_gradient(raw, c2.sum(-1)) + l2 * v

    def hessian_diag(w: torch.Tensor, data: LabeledData, l2) -> torch.Tensor:
        """diag(H)_j = Σ_i a_i·((x_ij − s_j)·f_j)² + l2, a_i = weight_i·l″_i
        (reference HessianDiagonalAggregator.scala:33), expanded so sparse
        layouts never densify: Σ a(x−s)² = (X∘X)ᵀa − 2s·(Xᵀa) + s²·Σa."""
        norm = _norm_of(data)
        z = margins(w, data)
        a = _wmask(data.weights, loss.d2(z, data.labels))
        sq = data.features.rmatvec_sq(a)
        if norm.shift is not None:
            lin = data.features.rmatvec(a)
            sq = sq - 2.0 * norm.shift * lin + norm.shift * norm.shift * a.sum(-1).unsqueeze(-1)
        if norm.factor is not None:
            sq = sq * norm.factor * norm.factor
        return sq + l2

    return GlmObjective(
        value=value,
        value_and_grad=value_and_grad,
        hessian_vec=hessian_vec,
        hessian_diag=hessian_diag,
        has_hessian=loss.has_hessian,
    )

"""Solver result containers and convergence bookkeeping.

Port of ``photon_ml_tpu/opt/state.py`` (reference optimization/Optimizer.scala:
convergence checks :131-145, absolute tolerances derived from the initial
state :68-71; OptimizationStatesTracker.scala:31). Every field carries a
leading lane axis: one lane per random-effect entity, or one lane for a
fixed effect. The value history is [E, max_iterations+1], NaN-padded; the
convergence reason is an int64 code per lane (types.ConvergenceReason).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from photon_ml_tpu_torch.types import ConvergenceReason


@dataclasses.dataclass
class SolveResult:
    """Outcome of one batched optimizer run."""

    w: torch.Tensor              # [E, d] final coefficients
    value: torch.Tensor          # [E] final objective (incl. L2)
    grad_norm: torch.Tensor      # [E] ||grad||
    iterations: torch.Tensor     # [E] int64 outer iterations performed
    reason: torch.Tensor         # [E] int64 ConvergenceReason code
    value_history: torch.Tensor  # [E, max_iterations+1] objective per iteration
    # [E, max_iterations+1, d] per-iteration coefficients, NaN-padded — only
    # when OptimizerConfig.track_coefficients (reference ModelTracker)
    w_history: Optional[torch.Tensor] = None

    def converged(self) -> torch.Tensor:
        return self.reason != ConvergenceReason.NOT_CONVERGED.value


class LaneObjective(NamedTuple):
    """The objective over solver lanes (``opt.solve.lane_objective``):
    ``value_and_grad(w [E, d]) -> (f [E], g [E, d])`` and
    ``hessian_vec(w [E, d], v [E, d]) -> [E, d]``."""

    value_and_grad: Callable
    hessian_vec: Callable
    has_hessian: bool


class LaneState:
    """Base of the resumable solver states: a dataclass whose every field
    has a leading lane axis, so the adaptive random-effect driver can
    gather the lanes it keeps."""

    def take_lanes(self, idx: torch.Tensor):
        return type(self)(**{
            f.name: getattr(self, f.name)[idx] for f in dataclasses.fields(self)
        })


def function_values_converged(f_prev, f, abs_tol) -> torch.Tensor:
    """|f_prev - f| <= abs_tol (reference Optimizer.scala:131-138)."""
    return (f_prev - f).abs() <= abs_tol


def gradient_converged(grad_norm, abs_tol) -> torch.Tensor:
    """||g|| <= abs_tol (reference Optimizer.scala:140-145)."""
    return grad_norm <= abs_tol


def absolute_tolerances(f0: torch.Tensor, g0_norm: torch.Tensor, rel_tol: float):
    """Absolute tolerances from the initial state (reference
    Optimizer.scala:68-71: relative tolerance times the magnitude of the
    zero-model loss / gradient, floored to avoid degenerate zeros)."""
    abs_f_tol = rel_tol * torch.clamp(f0.abs(), min=1e-15)
    abs_g_tol = rel_tol * torch.clamp(g0_norm, min=1e-15)
    return abs_f_tol, abs_g_tol


# The solvers' vector operations. The solvers hold their vectors (w,
# gradients, directions, the s/y rings) as plain [E, d] tensors or, for the
# fixed effect of a device grid, as ``parallel.mesh.BlockVector``s of d_loc
# blocks on the grid's feat columns. Arithmetic operators and ``sum(-1)``
# work on either; the few operations that are torch functions go through
# these helpers. On plain tensors each is exactly the torch call the
# solvers made before, so the batched random-effect path computes what it
# did, bit for bit.

def _blocked(args):
    return next((a for a in args if hasattr(a, "blockwise")), None)


def blockwise(fn: Callable, *args):
    """``fn(*args)``; with a block vector among ``args``, block by block."""
    bv = _blocked(args)
    return fn(*args) if bv is None else bv.blockwise(fn, *args)


def select(cond: torch.Tensor, a, b):
    """``torch.where(cond, a, b)`` with a per-lane ``cond``."""
    return blockwise(torch.where, cond, a, b)


def dot(a, b) -> torch.Tensor:
    return (a * b).sum(-1)


def norm(x) -> torch.Tensor:
    """The 2-norm over the vector axis, per lane."""
    if isinstance(x, torch.Tensor):
        return torch.linalg.vector_norm(x, dim=-1)
    return torch.sqrt(dot(x, x))


def zeros_like(x):
    return torch.zeros_like(x) if isinstance(x, torch.Tensor) else x.zeros_like()

"""Solver dispatch: pick L-BFGS, OWL-QN or TRON from configuration.

Port of ``photon_ml_tpu/opt/solve.py`` (reference OptimizerFactory.scala:27:
OWL-QN whenever the regularization has a positive L1 component; TRON on
request, never with L1).

Besides the one-shot ``solve``, the resumable ``solve_init`` /
``solve_chunk`` / ``solve_finalize`` triple serves the convergence-adaptive
random-effect driver; ``solve(...)`` is exactly
``solve_finalize(solve_chunk(solve_init(...)))`` with no iteration cap.
Every entry takes w0 [E, d]: E lanes over batched data (one problem a
lane), or one lane over an unbatched problem (the fixed effect).
``box=(lower [d], upper [d])`` bounds each coefficient (either side None);
without it the configuration's scalar bounds apply.
"""

from __future__ import annotations

from typing import Tuple

import torch

from photon_ml_tpu_torch.losses.objective import GlmObjective
from photon_ml_tpu_torch.ops.data import LabeledData
from photon_ml_tpu_torch.opt.config import GlmOptimizationConfiguration, OptimizerType
from photon_ml_tpu_torch.opt.lbfgs import LbfgsState, lbfgs_chunk, lbfgs_finalize, lbfgs_init
from photon_ml_tpu_torch.opt.owlqn import OwlqnState, owlqn_chunk, owlqn_finalize, owlqn_init
from photon_ml_tpu_torch.opt.state import LaneObjective, SolveResult
from photon_ml_tpu_torch.opt.tron import TronState, tron_chunk, tron_finalize, tron_init


def lane_objective(objective: GlmObjective, data: LabeledData, l2) -> LaneObjective:
    """The objective over the lanes: batched data gives each lane its own
    problem; unbatched data is one problem, one lane."""
    if data.batched:
        return LaneObjective(
            value_and_grad=lambda w: objective.value_and_grad(w, data, l2),
            hessian_vec=lambda w, v: objective.hessian_vec(w, v, data, l2),
            has_hessian=objective.has_hessian,
        )

    def one(w: torch.Tensor) -> torch.Tensor:
        if w.shape[0] != 1:
            raise ValueError(f"one unbatched problem takes one lane, got {w.shape[0]}")
        return w[0]

    def value_and_grad(w: torch.Tensor):
        f, g = objective.value_and_grad(one(w), data, l2)
        return f.reshape(1), g.unsqueeze(0)

    def hessian_vec(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return objective.hessian_vec(one(w), one(v), data, l2).unsqueeze(0)

    return LaneObjective(value_and_grad, hessian_vec, objective.has_hessian)


def _resolve_l1(configuration: GlmOptimizationConfiguration, l1_weight) -> Tuple[bool, float]:
    """(use OWL-QN, l1 value): None → the configuration's own L1 weight; an
    explicit weight is authoritative, and an explicit 0 pins L-BFGS/TRON
    even where the configuration implies L1."""
    l1 = configuration.l1_weight if l1_weight is None else float(l1_weight)
    return l1 > 0, l1


def solver_kind(configuration: GlmOptimizationConfiguration, l1_weight=None) -> str:
    """The solver a configuration selects: 'owlqn' | 'tron' | 'lbfgs'.
    Raises for TRON with L1."""
    tron = configuration.optimizer_config.optimizer is OptimizerType.TRON
    if _resolve_l1(configuration, l1_weight)[0]:
        if tron:
            raise ValueError("TRON does not support L1 regularization (use LBFGS/OWL-QN)")
        return "owlqn"
    return "tron" if tron else "lbfgs"


def _l2(configuration: GlmOptimizationConfiguration, l2_weight) -> float:
    return float(configuration.l2_weight if l2_weight is None else l2_weight)


def solve(
    objective: GlmObjective,
    w0: torch.Tensor,
    data: LabeledData,
    configuration: GlmOptimizationConfiguration,
    l2_weight=None,
    l1_weight=None,
    box=None,
) -> SolveResult:
    """Run the configured solver from w0 [E, d]. ``l2_weight`` and
    ``l1_weight`` override the configuration's (a λ sweep)."""
    state = solve_init(objective, w0, data, configuration, l2_weight, l1_weight)
    state = solve_chunk(objective, state, data, configuration, l2_weight, box=box)
    return solve_finalize(state, configuration)


def solve_init(
    objective: GlmObjective,
    w0: torch.Tensor,
    data: LabeledData,
    configuration: GlmOptimizationConfiguration,
    l2_weight=None,
    l1_weight=None,
):
    """The resumable state of the configured solver."""
    cfg = configuration.optimizer_config
    lanes = lane_objective(objective, data, _l2(configuration, l2_weight))
    kind = solver_kind(configuration, l1_weight)
    if kind == "owlqn":
        l1 = _resolve_l1(configuration, l1_weight)[1]
        return owlqn_init(lanes.value_and_grad, w0, l1, cfg)
    if kind == "tron":
        return tron_init(lanes, w0, cfg)
    return lbfgs_init(lanes.value_and_grad, w0, cfg)


def solve_chunk(
    objective: GlmObjective,
    state,
    data: LabeledData,
    configuration: GlmOptimizationConfiguration,
    l2_weight=None,
    box=None,
    num_iters=None,
):
    """Advance a ``solve_init`` state by at most ``num_iters`` outer
    iterations (None = to convergence / max_iterations); dispatches on the
    state's type."""
    cfg = configuration.optimizer_config
    lanes = lane_objective(objective, data, _l2(configuration, l2_weight))
    if isinstance(state, OwlqnState):
        return owlqn_chunk(lanes.value_and_grad, state, cfg, num_iters, box)
    if isinstance(state, TronState):
        return tron_chunk(lanes, state, cfg, num_iters, box)
    if isinstance(state, LbfgsState):
        return lbfgs_chunk(lanes.value_and_grad, state, cfg, num_iters, box)
    raise TypeError(f"unknown solver state type {type(state).__name__}")


def solve_finalize(state, configuration: GlmOptimizationConfiguration) -> SolveResult:
    cfg = configuration.optimizer_config
    if isinstance(state, OwlqnState):
        return owlqn_finalize(state, cfg)
    if isinstance(state, TronState):
        return tron_finalize(state, cfg)
    if isinstance(state, LbfgsState):
        return lbfgs_finalize(state, cfg)
    raise TypeError(f"unknown solver state type {type(state).__name__}")

"""Solver dispatch: pick the optimizer from configuration.

Port of ``photon_ml_tpu/opt/solve.py`` (reference OptimizerFactory.scala:27:
OWL-QN whenever the regularization has a positive L1 component; TRON on
request). L-BFGS is ported; TRON and OWL-QN raise (ROADMAP.md, Queue A:
"TRON and OWL-QN").

Besides the one-shot ``solve``, the resumable ``solve_init`` /
``solve_chunk`` / ``solve_finalize`` triple serves the convergence-adaptive
random-effect driver; ``solve(...)`` is exactly
``solve_finalize(solve_chunk(solve_init(...)))`` with no iteration cap.
Every entry takes w0 [E, d]: E lanes over batched data (one problem a
lane), or one lane over an unbatched problem (the fixed effect).
"""

from __future__ import annotations

import torch

from photon_ml_tpu_torch.losses.objective import GlmObjective
from photon_ml_tpu_torch.ops.data import LabeledData
from photon_ml_tpu_torch.opt.config import GlmOptimizationConfiguration, OptimizerType
from photon_ml_tpu_torch.opt.lbfgs import (
    LbfgsState,
    lbfgs_chunk,
    lbfgs_finalize,
    lbfgs_init,
    lbfgs_solve,
)
from photon_ml_tpu_torch.opt.state import SolveResult


def lane_objective(objective: GlmObjective, data: LabeledData, l2):
    """``w [E, d] -> (f [E], g [E, d])`` over the lanes: batched data gives
    each lane its own problem; unbatched data is one problem, one lane."""
    if data.batched:
        return lambda w: objective.value_and_grad(w, data, l2)

    def one_lane(w: torch.Tensor):
        if w.shape[0] != 1:
            raise ValueError(f"one unbatched problem takes one lane, got {w.shape[0]}")
        f, g = objective.value_and_grad(w[0], data, l2)
        return f.reshape(1), g.unsqueeze(0)

    return one_lane


def solver_kind(configuration: GlmOptimizationConfiguration, l1_weight=None) -> str:
    """The solver a configuration selects: 'lbfgs', else raise for the
    solvers not ported yet. An explicit ``l1_weight`` overrides the
    configuration's own (0 pins L-BFGS)."""
    l1 = configuration.l1_weight if l1_weight is None else float(l1_weight)
    if l1 > 0:
        raise NotImplementedError(
            "L1 regularization needs OWL-QN, which is not ported yet "
            "(ROADMAP.md, Queue A: TRON and OWL-QN)"
        )
    if configuration.optimizer_config.optimizer is OptimizerType.TRON:
        raise NotImplementedError(
            "optimizer TRON is not ported yet (ROADMAP.md, Queue A: TRON and OWL-QN)"
        )
    return "lbfgs"


def _l2(configuration: GlmOptimizationConfiguration, l2_weight) -> float:
    return float(configuration.l2_weight if l2_weight is None else l2_weight)


def solve(
    objective: GlmObjective,
    w0: torch.Tensor,
    data: LabeledData,
    configuration: GlmOptimizationConfiguration,
    l2_weight=None,
    l1_weight=None,
) -> SolveResult:
    """Run the configured solver from w0 [E, d]."""
    solver_kind(configuration, l1_weight)
    evaluate = lane_objective(objective, data, _l2(configuration, l2_weight))
    return lbfgs_solve(evaluate, w0, configuration.optimizer_config)


def solve_init(
    objective: GlmObjective,
    w0: torch.Tensor,
    data: LabeledData,
    configuration: GlmOptimizationConfiguration,
    l2_weight=None,
    l1_weight=None,
) -> LbfgsState:
    """The resumable state of the configured solver."""
    solver_kind(configuration, l1_weight)
    evaluate = lane_objective(objective, data, _l2(configuration, l2_weight))
    return lbfgs_init(evaluate, w0, configuration.optimizer_config)


def solve_chunk(
    objective: GlmObjective,
    state: LbfgsState,
    data: LabeledData,
    configuration: GlmOptimizationConfiguration,
    l2_weight=None,
    num_iters=None,
) -> LbfgsState:
    """Advance a ``solve_init`` state by at most ``num_iters`` outer
    iterations (None = to convergence / max_iterations)."""
    evaluate = lane_objective(objective, data, _l2(configuration, l2_weight))
    return lbfgs_chunk(evaluate, state, configuration.optimizer_config, num_iters=num_iters)


def solve_finalize(state: LbfgsState, configuration: GlmOptimizationConfiguration) -> SolveResult:
    return lbfgs_finalize(state, configuration.optimizer_config)

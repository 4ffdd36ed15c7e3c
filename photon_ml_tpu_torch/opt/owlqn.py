"""OWL-QN (orthant-wise limited-memory quasi-Newton) for L1 and elastic net,
batched over solver lanes.

Port of ``photon_ml_tpu/opt/owlqn.py`` (reference optimization/OWLQN.scala:40,
Breeze's OWLQN; Andrew & Gao 2007). The L1 weight is the optimizer's
business, never the smooth objective's (the L2 part of elastic net stays in
the objective):

- the pseudo-gradient of f + l1·‖w‖₁, steepest-descent tie-breaking at 0;
- the two-loop direction from the smooth gradients' history, aligned with
  -pseudo-gradient, and the orthant to search in;
- backtracking over orthant-projected points with sufficient decrease on
  F = f + l1·‖w‖₁;
- box constraints as in the reference (OWLQN.scala:46 → LBFGS.scala:72):
  the accepted point is projected into the box and f, g recomputed where
  the projection clipped.

The lanes advance together as in ``opt/lbfgs.py``; the line search runs
until no lane is searching, and the post-step recomputation runs only when
some lane clipped, selected per lane (the reference's ``lax.cond`` under
``vmap``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_ml_tpu_torch.opt.config import OptimizerConfig
from photon_ml_tpu_torch.opt.lbfgs import (
    _NOT_CONVERGED,
    Evaluate,
    _project_box,
    dot,
    empty_memory,
    finalize_reason,
    init_histories,
    record_iteration,
    resolve_box,
    running_lanes,
    select_reason,
    two_loop_direction,
    update_history,
)
from photon_ml_tpu_torch.opt.state import (
    LaneState,
    SolveResult,
    absolute_tolerances,
    function_values_converged,
    gradient_converged,
)
from photon_ml_tpu_torch.types import ConvergenceReason

GAMMA = 1e-4     # sufficient-decrease constant (Andrew & Gao)
BACKTRACK = 0.5


def pseudo_gradient(w: torch.Tensor, g: torch.Tensor, l1: torch.Tensor) -> torch.Tensor:
    """Subgradient of f + l1·‖w‖₁ with steepest-descent tie-breaking at 0:
    at w_j = 0 the subdifferential is [g - l1, g + l1], whose least-norm
    element is 0 if it holds 0, else the nearer end. ``l1`` broadcasts
    against w ([E, 1] for per-lane weights)."""
    pg_zero = torch.where(g + l1 < 0, g + l1, torch.where(g - l1 > 0, g - l1, 0.0))
    return torch.where(w == 0, pg_zero, g + l1 * torch.sign(w))


def _project_orthant(w: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """pi(w; xi): zero the coordinates that left the orthant xi."""
    return torch.where(torch.sign(w) == xi, w, 0.0)


def _l1_value(f, w, l1):
    return f + l1 * w.abs().sum(-1)


@dataclasses.dataclass
class OwlqnState(LaneState):
    """Resumable OWL-QN state (see ``LbfgsState``); carries each lane's L1
    weight."""

    w: torch.Tensor          # [E, d]
    f: torch.Tensor          # [E] smooth f (no L1)
    g: torch.Tensor          # [E, d] smooth gradient
    F: torch.Tensor          # [E] f + l1·‖w‖₁
    s_hist: torch.Tensor     # [E, m, d]
    y_hist: torch.Tensor     # [E, m, d]
    rho: torch.Tensor        # [E, m]
    count: torch.Tensor      # [E] int64
    it: torch.Tensor         # [E] int64
    reason: torch.Tensor     # [E] int64
    history: torch.Tensor    # [E, max_iter+1] F per iteration
    w_hist: torch.Tensor     # [E, max_iter+1, d], or [E, 0] when off
    l1: torch.Tensor         # [E]
    abs_f_tol: torch.Tensor  # [E]
    abs_g_tol: torch.Tensor  # [E]


def owlqn_init(evaluate: Evaluate, w0: torch.Tensor, l1_weight: float,
               config: OptimizerConfig) -> OwlqnState:
    E = w0.shape[0]
    l1 = torch.full((E,), float(l1_weight), dtype=w0.dtype, device=w0.device)
    f0, g0 = evaluate(w0)
    F0 = _l1_value(f0, w0, l1)
    pg0 = pseudo_gradient(w0, g0, l1.unsqueeze(-1))
    abs_f_tol, abs_g_tol = absolute_tolerances(
        F0, torch.linalg.vector_norm(pg0, dim=-1), config.tolerance
    )
    history, w_hist = init_histories(w0, F0, config)
    zeros_i = torch.zeros(E, dtype=torch.int64, device=w0.device)
    return OwlqnState(
        w=w0, f=f0, g=g0, F=F0, **empty_memory(w0, config),
        count=zeros_i, it=zeros_i.clone(), reason=zeros_i + _NOT_CONVERGED,
        history=history, w_hist=w_hist, l1=l1, abs_f_tol=abs_f_tol, abs_g_tol=abs_g_tol,
    )


def _owlqn_step(evaluate: Evaluate, s: OwlqnState, lanes: torch.Tensor,
                config: OptimizerConfig, box) -> OwlqnState:
    """One outer iteration for the running ``lanes``; the others keep their
    state."""
    box_lo, box_hi, has_box = box
    l1 = s.l1.unsqueeze(-1)
    pg = pseudo_gradient(s.w, s.g, l1)
    d = two_loop_direction(pg, s.s_hist, s.y_hist, s.rho, s.count)
    d = torch.where(d * pg < 0, d, 0.0)  # align with -pg
    # orthant to search in: sign(w), or sign(-pg) where w = 0
    xi = torch.where(s.w != 0, torch.sign(s.w), torch.sign(-pg))
    t = torch.where(
        s.count == 0,
        1.0 / torch.clamp(torch.linalg.vector_norm(d, dim=-1), min=1e-12),
        torch.ones_like(s.f),
    )

    # backtracking line search: every searching lane tries its point, the
    # lanes that found sufficient decrease (or were not searching) keep theirs
    w_t, f_t, g_t, F_t = s.w, s.f, s.g, s.F
    ok = torch.zeros_like(lanes)
    for _ in range(config.max_line_search_iterations):
        active = lanes & ~ok
        if not bool(active.any()):
            break
        w_c = _project_orthant(s.w + t.unsqueeze(-1) * d, xi)
        f_c, g_c = evaluate(w_c)
        F_c = _l1_value(f_c, w_c, s.l1)
        # sufficient decrease against F's directional derivative along the
        # projected step (Andrew & Gao)
        ok_c = F_c <= s.F + GAMMA * dot(pg, w_c - s.w)
        a2 = active.unsqueeze(-1)
        w_t = torch.where(a2, w_c, w_t)
        f_t = torch.where(active, f_c, f_t)
        g_t = torch.where(a2, g_c, g_t)
        F_t = torch.where(active, F_c, F_t)
        t = torch.where(active & ~ok_c, t * BACKTRACK, t)
        ok = ok | (active & ok_c)

    ok2 = ok.unsqueeze(-1)
    w_new = torch.where(ok2, w_t, s.w)
    f_new = torch.where(ok, f_t, s.f)
    g_new = torch.where(ok2, g_t, s.g)
    F_new = torch.where(ok, F_t, s.F)
    if has_box:
        # post-step projection (reference LBFGS.scala:72, inherited by
        # OWLQN); f and g recomputed at the projected point, so the
        # curvature pairs see the true state, only where it clipped
        w_proj = _project_box(w_new, box_lo, box_hi)
        clipped = lanes & (w_proj != w_new).any(-1)
        if bool(clipped.any()):
            f_p, g_p = evaluate(w_proj)
            f_new = torch.where(clipped, f_p, f_new)
            g_new = torch.where(clipped.unsqueeze(-1), g_p, g_new)
            F_new = torch.where(clipped, _l1_value(f_p, w_proj, s.l1), F_new)
        w_new = w_proj

    count = update_history(
        s.s_hist, s.y_hist, s.rho, s.count, w_new - s.w, g_new - s.g, lanes
    )
    it = s.it + 1
    pg_new = pseudo_gradient(w_new, g_new, l1)
    g_conv = gradient_converged(torch.linalg.vector_norm(pg_new, dim=-1), s.abs_g_tol)
    f_conv = ok & function_values_converged(s.F, F_new, s.abs_f_tol)
    reason = select_reason(it, config.max_iterations, [
        (g_conv, ConvergenceReason.GRADIENT_CONVERGED),
        (f_conv, ConvergenceReason.FUNCTION_VALUES_CONVERGED),
        (~ok, ConvergenceReason.OBJECTIVE_NOT_IMPROVING),
    ])
    lane2 = lanes.unsqueeze(-1)
    it = torch.where(lanes, it, s.it)
    record_iteration(s.history, s.w_hist, lanes, it, F_new, w_new, config)
    return dataclasses.replace(
        s,
        w=torch.where(lane2, w_new, s.w),
        f=torch.where(lanes, f_new, s.f),
        g=torch.where(lane2, g_new, s.g),
        F=torch.where(lanes, F_new, s.F),
        count=count,
        it=it,
        reason=torch.where(lanes, reason, s.reason),
    )


def owlqn_chunk(
    evaluate: Evaluate,
    state: OwlqnState,
    config: OptimizerConfig,
    num_iters: Optional[int] = None,
    box=None,
) -> OwlqnState:
    """Advance every lane by at most ``num_iters`` outer iterations (None =
    to the end); the chunking contract of ``lbfgs_chunk``."""
    it_stop = None if num_iters is None else state.it + num_iters
    bounds = resolve_box(box, config, state.w)
    s = state
    while True:
        running = running_lanes(s.reason, s.it, config, it_stop)
        if not bool(running.any()):
            return s
        s = _owlqn_step(evaluate, s, running, config, bounds)


def owlqn_finalize(state: OwlqnState, config: OptimizerConfig) -> SolveResult:
    pg = pseudo_gradient(state.w, state.g, state.l1.unsqueeze(-1))
    return SolveResult(
        w=state.w,
        value=state.F,
        grad_norm=torch.linalg.vector_norm(pg, dim=-1),
        iterations=state.it,
        reason=finalize_reason(state.reason),
        value_history=state.history,
        w_history=state.w_hist if config.track_coefficients else None,
    )


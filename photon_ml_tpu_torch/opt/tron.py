"""TRON, the trust-region Newton method, batched over solver lanes.

Port of ``photon_ml_tpu/opt/tron.py`` (reference optimization/TRON.scala:80,
itself LIBLINEAR's tron.cpp): an outer trust-region loop (:148-250) around
Steihaug's truncated conjugate gradient over Hessian-vector products
(:275-335), the eta/sigma trust-radius constants (:97-98), initial radius
‖g₀‖, ``max_improvement_failures``; defaults maxIter=15, ≤ 20 CG steps,
tol=1e-5 (:253-259).

The reference runs ``vmap(while_loop(… while_loop …))``. Here the state
holds E lanes; the outer Python loop advances every running lane and the
CG loop keeps a per-lane done mask of its own, freezing finished lanes with
``torch.where`` as the batched while-loops do, so lane e follows the
trajectory of problem e solved alone. The CG loop ends when no lane is
active: one host synchronisation a CG step. Every Hv recomputes the margins
at w, as the reference's ``hessian_vec`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_ml_tpu_torch.opt.config import OptimizerConfig
from photon_ml_tpu_torch.opt.lbfgs import (
    _NOT_CONVERGED,
    _project_box,
    dot,
    finalize_reason,
    init_histories,
    record_iteration,
    resolve_box,
    running_lanes,
    select_reason,
)
from photon_ml_tpu_torch.opt.state import (
    LaneObjective,
    LaneState,
    SolveResult,
    absolute_tolerances,
    function_values_converged,
    gradient_converged,
    norm,
    select,
    zeros_like,
)
from photon_ml_tpu_torch.types import ConvergenceReason

# Trust-region update constants (reference TRON.scala:97-98 / LIBLINEAR).
ETA0, ETA1, ETA2 = 1e-4, 0.25, 0.75
SIGMA1, SIGMA2, SIGMA3 = 0.25, 0.5, 4.0


def truncated_cg(hess_vec, g, delta, max_cg: int, cg_tol: float, lanes: torch.Tensor):
    """Steihaug truncated CG over the ``lanes``: approximately solve
    H s = -g with ‖s‖ ≤ delta, per lane. Returns (s, r), r the final
    residual -g - H s (the predicted-reduction formula's, reference
    TRON.scala:275-335). Lanes outside ``lanes`` return s = 0."""
    r = -g
    s = zeros_like(g)
    d = r
    rtr = dot(r, r)
    stop_norm = cg_tol * norm(g)
    done = (~lanes) | (torch.sqrt(rtr) <= stop_norm)
    for _ in range(max_cg):
        active = ~done
        if not bool(active.any()):
            break
        hd = hess_vec(d)
        dhd = dot(d, hd)
        alpha = rtr / torch.where(dhd <= 0, 1e-30, dhd)
        s_try = s + alpha.unsqueeze(-1) * d
        # negative curvature or a boundary hit: move to the trust-region
        # edge along d and stop
        hit = (dhd <= 0) | (norm(s_try) > delta)
        std, dd, ss = dot(s, d), dot(d, d), dot(s, s)
        rad = torch.sqrt(torch.clamp(std * std + dd * (delta * delta - ss), min=0.0))
        tau = (-std + rad) / torch.clamp(dd, min=1e-30)
        hit2 = hit.unsqueeze(-1)
        s_new = select(hit2, s + tau.unsqueeze(-1) * d, s_try)
        r_new = select(hit2, r - tau.unsqueeze(-1) * hd, r - alpha.unsqueeze(-1) * hd)
        rtr_new = dot(r_new, r_new)
        converged = torch.sqrt(rtr_new) <= stop_norm
        beta = rtr_new / torch.clamp(rtr, min=1e-30)
        d_new = select((hit | converged).unsqueeze(-1), d, r_new + beta.unsqueeze(-1) * d)
        a2 = active.unsqueeze(-1)
        s = select(a2, s_new, s)
        r = select(a2, r_new, r)
        d = select(a2, d_new, d)
        rtr = torch.where(active, rtr_new, rtr)
        done = done | (active & (hit | converged))
    return s, r


@dataclasses.dataclass
class TronState(LaneState):
    """Resumable TRON state, every field with a leading lane axis: the trust
    radius and the tolerances from the initial point included, so chunked
    execution (``tron_chunk``) follows the one-shot trajectory exactly."""

    w: torch.Tensor          # [E, d]
    f: torch.Tensor          # [E]
    g: torch.Tensor          # [E, d]
    delta: torch.Tensor      # [E] trust radius
    it: torch.Tensor         # [E] int64
    failures: torch.Tensor   # [E] int64 rejected steps
    reason: torch.Tensor     # [E] int64 ConvergenceReason
    history: torch.Tensor    # [E, max_iter+1]
    w_hist: torch.Tensor     # [E, max_iter+1, d], or [E, 0] when off
    abs_f_tol: torch.Tensor  # [E]
    abs_g_tol: torch.Tensor  # [E]


def tron_init(objective: LaneObjective, w0: torch.Tensor, config: OptimizerConfig) -> TronState:
    if not objective.has_hessian:
        raise ValueError(
            "TRON requires a twice-differentiable objective; smoothed hinge "
            "is first-order only (use LBFGS, reference OptimizerFactory.scala)"
        )
    f0, g0 = objective.value_and_grad(w0)
    g0_norm = norm(g0)
    abs_f_tol, abs_g_tol = absolute_tolerances(f0, g0_norm, config.tolerance)
    history, w_hist = init_histories(w0, f0, config)
    zeros_i = torch.zeros(w0.shape[0], dtype=torch.int64, device=w0.device)
    return TronState(
        w=w0, f=f0, g=g0,
        delta=g0_norm,  # initial radius ‖g₀‖ (reference TRON.scala:112)
        it=zeros_i, failures=zeros_i.clone(),
        reason=torch.where(
            g0_norm <= abs_g_tol, ConvergenceReason.GRADIENT_CONVERGED.value, _NOT_CONVERGED
        ),
        history=history, w_hist=w_hist, abs_f_tol=abs_f_tol, abs_g_tol=abs_g_tol,
    )


def _tron_step(objective: LaneObjective, s: TronState, lanes: torch.Tensor,
               config: OptimizerConfig, box) -> TronState:
    """One outer iteration for the running ``lanes``; the others keep their
    state."""
    box_lo, box_hi, has_box = box
    step, resid = truncated_cg(
        lambda v: objective.hessian_vec(s.w, v), s.g, s.delta,
        config.max_cg_iterations, config.cg_tolerance, lanes,
    )
    w_try = s.w + step
    if has_box:
        w_try = _project_box(w_try, box_lo, box_hi)
        step = w_try - s.w
    f_try, g_try = objective.value_and_grad(w_try)

    gs = dot(s.g, step)
    prered = -0.5 * (gs - dot(step, resid))
    actred = s.f - f_try
    snorm = norm(step)

    # trust-radius update (reference TRON.scala:200-240 / LIBLINEAR)
    denom = f_try - s.f - gs
    alpha = torch.where(
        -actred <= gs,
        SIGMA3,
        torch.clamp(-0.5 * (gs / torch.where(denom.abs() < 1e-30, 1e-30, denom)), min=SIGMA1),
    )
    delta = torch.where(
        actred < ETA0 * prered,
        torch.minimum(torch.clamp(alpha, min=SIGMA1) * snorm, SIGMA2 * s.delta),
        torch.where(
            actred < ETA1 * prered,
            torch.maximum(SIGMA1 * s.delta, torch.minimum(alpha * snorm, SIGMA2 * s.delta)),
            torch.where(
                actred < ETA2 * prered,
                torch.maximum(SIGMA1 * s.delta, torch.minimum(alpha * snorm, SIGMA3 * s.delta)),
                torch.maximum(s.delta, torch.minimum(alpha * snorm, SIGMA3 * s.delta)),
            ),
        ),
    )

    accept = actred > ETA0 * prered
    failures = torch.where(accept, s.failures, s.failures + 1)
    acc2 = accept.unsqueeze(-1)
    w_new = select(acc2, w_try, s.w)
    f_new = torch.where(accept, f_try, s.f)
    g_new = select(acc2, g_try, s.g)

    it = s.it + 1
    g_conv = gradient_converged(norm(g_new), s.abs_g_tol)
    f_conv = accept & function_values_converged(s.f, f_new, s.abs_f_tol)
    not_improving = (failures >= config.max_improvement_failures) | (
        (prered <= 0) & (actred <= 0)
    )
    reason = select_reason(it, config.max_iterations, [
        (g_conv, ConvergenceReason.GRADIENT_CONVERGED),
        (f_conv, ConvergenceReason.FUNCTION_VALUES_CONVERGED),
        (not_improving, ConvergenceReason.OBJECTIVE_NOT_IMPROVING),
    ])
    lane2 = lanes.unsqueeze(-1)
    it = torch.where(lanes, it, s.it)
    record_iteration(s.history, s.w_hist, lanes, it, f_new, w_new, config)
    return dataclasses.replace(
        s,
        w=select(lane2, w_new, s.w),
        f=torch.where(lanes, f_new, s.f),
        g=select(lane2, g_new, s.g),
        delta=torch.where(lanes, delta, s.delta),
        it=it,
        failures=torch.where(lanes, failures, s.failures),
        reason=torch.where(lanes, reason, s.reason),
    )


def tron_chunk(
    objective: LaneObjective,
    state: TronState,
    config: OptimizerConfig,
    num_iters: Optional[int] = None,
    box=None,
) -> TronState:
    """Advance every lane by at most ``num_iters`` outer iterations (None =
    to the end); the chunking contract of ``lbfgs_chunk``."""
    it_stop = None if num_iters is None else state.it + num_iters
    bounds = resolve_box(box, config, state.w)
    s = state
    while True:
        running = running_lanes(s.reason, s.it, config, it_stop)
        if not bool(running.any()):
            return s
        s = _tron_step(objective, s, running, config, bounds)


def tron_finalize(state: TronState, config: OptimizerConfig) -> SolveResult:
    return SolveResult(
        w=state.w,
        value=state.f,
        grad_norm=norm(state.g),
        iterations=state.it,
        reason=finalize_reason(state.reason),
        value_history=state.history,
        w_history=state.w_hist if config.track_coefficients else None,
    )


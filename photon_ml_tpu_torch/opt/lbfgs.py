"""L-BFGS, batched over solver lanes.

Port of ``photon_ml_tpu/opt/lbfgs.py`` (reference optimization/LBFGS.scala:39,
defaults maxIter=100, m=10, tol=1e-7, LBFGS.scala:147-152; box constraints
by projection after each accepted step, LBFGS.scala:72: the config's scalar
bounds, or per-coefficient ``box=(lower [d], upper [d])`` arrays, the
reference's per-feature constraint map). The reference runs
one ``lax.while_loop`` per problem and batches entities with ``vmap``. Here
the state holds E lanes — w [E, d], ring buffers [E, m, d], per-lane
``count``/``it``/``reason`` — and one Python loop advances every lane that
is still running, freezing the others, as the batched while-loop does. The
fixed effect runs the same solver with one lane.

``evaluate(w [E, d]) -> (f [E], g [E, d])`` is the objective's
value-and-gradient over the lanes (``opt.solve.lane_objective`` builds it).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from photon_ml_tpu_torch.opt.config import OptimizerConfig
from photon_ml_tpu_torch.opt.linesearch import strong_wolfe_search
from photon_ml_tpu_torch.opt.state import (
    LaneState,
    SolveResult,
    absolute_tolerances,
    blockwise,
    function_values_converged,
    gradient_converged,
    norm,
    select,
)
from photon_ml_tpu_torch.types import ConvergenceReason

Evaluate = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]

_NOT_CONVERGED = ConvergenceReason.NOT_CONVERGED.value


@dataclasses.dataclass
class LbfgsState(LaneState):
    """Resumable L-BFGS state, every field with a leading lane axis: all
    the next outer iteration needs, the absolute tolerances from the initial
    point included, so a solve split into chunks (``lbfgs_chunk``) follows
    the same trajectory as an uninterrupted one."""

    w: torch.Tensor          # [E, d]
    f: torch.Tensor          # [E]
    g: torch.Tensor          # [E, d]
    s_hist: torch.Tensor     # [E, m, d] steps ring buffer
    y_hist: torch.Tensor     # [E, m, d] gradient-difference ring buffer
    rho: torch.Tensor        # [E, m] 1/(s.y)
    count: torch.Tensor      # [E] int64 valid history pairs
    it: torch.Tensor         # [E] int64 outer iteration
    reason: torch.Tensor     # [E] int64 ConvergenceReason
    history: torch.Tensor    # [E, max_iter+1] objective values
    w_hist: torch.Tensor     # [E, max_iter+1, d] coefficients, or [E, 0] when off
    abs_f_tol: torch.Tensor  # [E]
    abs_g_tol: torch.Tensor  # [E]


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-lane inner product (block vectors too: ``opt/state.py``)."""
    return (a * b).sum(-1)


def two_loop_direction(g, s_hist, y_hist, rho, count) -> torch.Tensor:
    """Two-loop recursion over each lane's masked ring buffer.

    Slots are ordered oldest→newest modulo m; slot i of a lane is valid iff
    i < count. Invalid slots weigh 0 (alpha = 0), so every lane runs the same
    branch-free loop. History rows are cast to the working dtype on read.
    """
    m = rho.shape[-1]
    lane = torch.arange(g.shape[0], device=g.device)
    wd = g.dtype
    q = g
    alphas = torch.zeros_like(rho)
    for i in range(m):
        idx = torch.remainder(count - 1 - i, m)  # newest first
        r = torch.where(i < count, rho[lane, idx], torch.zeros_like(rho[:, 0]))
        a = r * dot(s_hist[lane, idx].to(wd), q)
        q = q - a.unsqueeze(-1) * y_hist[lane, idx].to(wd)
        alphas[lane, idx] = a

    # initial Hessian scaling gamma = (s.y)/(y.y) of the newest valid pair
    newest = torch.remainder(count - 1, m)
    s_new = s_hist[lane, newest].to(wd)
    y_new = y_hist[lane, newest].to(wd)
    sy, yy = dot(s_new, y_new), dot(y_new, y_new)
    gamma = torch.where(
        (count > 0) & (yy > 0), sy / torch.clamp(yy, min=1e-30), torch.ones_like(sy)
    )
    r_vec = gamma.unsqueeze(-1) * q
    for i in range(m):
        idx = torch.remainder(count - m + i, m)  # oldest first among the last m
        valid = i >= (m - torch.clamp(count, max=m))
        r = torch.where(valid, rho[lane, idx], torch.zeros_like(rho[:, 0]))
        beta = r * dot(y_hist[lane, idx].to(wd), r_vec)
        step = torch.where(valid, alphas[lane, idx] - beta, torch.zeros_like(beta))
        r_vec = r_vec + step.unsqueeze(-1) * s_hist[lane, idx].to(wd)
    return -r_vec


def update_history(s_hist, y_hist, rho, count, s_vec, y_vec, lanes=None) -> torch.Tensor:
    """Curvature-guarded ring-buffer insert (skipped when s.y is too small)
    for the ``lanes`` that advanced (None: every lane), in place; returns
    the new counts."""
    m = rho.shape[-1]
    lane = torch.arange(s_vec.shape[0], device=s_vec.device)
    sy = dot(s_vec, y_vec)
    good = sy > 1e-10 * torch.clamp(dot(y_vec, y_vec), min=1e-30)
    if lanes is not None:
        good = lanes & good
    slot = torch.remainder(count, m)
    g2 = good.unsqueeze(-1)
    s_hist[lane, slot] = select(g2, s_vec.to(s_hist.dtype), s_hist[lane, slot])
    y_hist[lane, slot] = select(g2, y_vec.to(y_hist.dtype), y_hist[lane, slot])
    rho[lane, slot] = torch.where(good, 1.0 / torch.clamp(sy, min=1e-30), rho[lane, slot])
    return torch.where(good, count + 1, count)


def two_loop_direction_one(g, s_hist, y_hist, rho, count) -> torch.Tensor:
    """:func:`two_loop_direction` of one problem: g [d], s_hist / y_hist
    [m, d], rho [m], count a 0-d tensor."""
    return two_loop_direction(
        g.unsqueeze(0), s_hist.unsqueeze(0), y_hist.unsqueeze(0),
        rho.unsqueeze(0), count.reshape(1),
    )[0]


def update_history_one(s_hist, y_hist, rho, count, s_vec, y_vec) -> torch.Tensor:
    """:func:`update_history` of one problem, in place on s_hist / y_hist
    [m, d] and rho [m]; returns the new count (0-d)."""
    return update_history(
        s_hist.unsqueeze(0), y_hist.unsqueeze(0), rho.unsqueeze(0),
        count.reshape(1), s_vec.unsqueeze(0), y_vec.unsqueeze(0),
    )[0]


def resolve_history_dtype(config: OptimizerConfig, working_dtype: torch.dtype) -> torch.dtype:
    """The storage dtype of the s/y ring buffers: ``config.history_dtype``
    or the working dtype; shared by L-BFGS, OWL-QN and the streamed
    solver."""
    return getattr(torch, config.history_dtype) if config.history_dtype else working_dtype


def _as_bound(b, like):
    """A bound as a tensor on ``like``'s device and dtype; a block vector
    (a grid's per-coefficient bound) as it is."""
    if hasattr(b, "blockwise"):
        return b
    return torch.as_tensor(b, dtype=like.dtype, device=like.device)


def _project_box(w: torch.Tensor, lower, upper) -> torch.Tensor:
    """Clip w into [lower, upper] (either side None = unbounded); bounds are
    scalars or [d] arrays, broadcast over the lanes."""
    if lower is not None:
        w = blockwise(torch.maximum, w, _as_bound(lower, w))
    if upper is not None:
        w = blockwise(torch.minimum, w, _as_bound(upper, w))
    return w


def resolve_box(box, config: OptimizerConfig, like: torch.Tensor):
    """(lower, upper, has_box) from a per-coefficient ``box`` override or
    the config's scalar bounds, as tensors on ``like``'s device and dtype
    (made once a chunk, not once an iteration); shared by the three
    solvers."""
    lo, hi = box if box is not None else (config.constraint_lower, config.constraint_upper)

    def bound(b):
        return None if b is None else _as_bound(b, like)

    return bound(lo), bound(hi), lo is not None or hi is not None


def init_histories(w0: torch.Tensor, f0: torch.Tensor, config: OptimizerConfig):
    """The objective history [E, max_iter+1] (f0 first, NaN after) and the
    coefficient history [E, max_iter+1, d] (or [E, 0] when not tracking);
    shared by the three solvers."""
    E, d = w0.shape
    max_iter = config.max_iterations
    history = torch.full((E, max_iter + 1), float("nan"), dtype=w0.dtype, device=w0.device)
    history[:, 0] = f0
    if config.track_coefficients:
        if isinstance(w0, torch.Tensor):
            w_hist = torch.full(
                (E, max_iter + 1, d), float("nan"), dtype=w0.dtype, device=w0.device
            )
        else:
            w_hist = w0.new_full((E, max_iter + 1), float("nan"))
        w_hist[:, 0] = w0
    else:
        w_hist = torch.zeros((E, 0), dtype=w0.dtype, device=w0.device)
    return history, w_hist


def record_iteration(history, w_hist, lanes, it, f_new, w_new, config: OptimizerConfig) -> None:
    """Write the advanced ``lanes``' objective (and coefficients when
    tracking) at their iteration ``it``, in place."""
    rows = torch.nonzero(lanes).flatten()
    history[rows, it[rows]] = f_new[rows]
    if config.track_coefficients:
        w_hist[rows, it[rows]] = w_new[rows]


def finalize_reason(reason: torch.Tensor) -> torch.Tensor:
    """A lane still NOT_CONVERGED is reported as MAX_ITERATIONS (callers
    finalize once the iteration budget is spent)."""
    return torch.where(
        reason == _NOT_CONVERGED,
        torch.full_like(reason, ConvergenceReason.MAX_ITERATIONS.value),
        reason,
    )


def select_reason(it: torch.Tensor, max_iter: int, checks) -> torch.Tensor:
    """Per lane, the reason of the first ``(condition, reason)`` of
    ``checks`` that holds; else MAX_ITERATIONS once ``it`` reaches
    ``max_iter``; else NOT_CONVERGED (reference Optimizer.scala:131-145)."""
    def code(reason: ConvergenceReason) -> torch.Tensor:
        return torch.full_like(it, reason.value)

    out = torch.where(
        it >= max_iter, code(ConvergenceReason.MAX_ITERATIONS), code(ConvergenceReason.NOT_CONVERGED)
    )
    for cond, reason in reversed(checks):
        out = torch.where(cond, code(reason), out)
    return out


def running_lanes(reason, it, config: OptimizerConfig, it_stop) -> torch.Tensor:
    """Lanes that still iterate: not converged, under max_iterations and
    under the chunk's stop."""
    running = (reason == _NOT_CONVERGED) & (it < config.max_iterations)
    if it_stop is not None:
        running = running & (it < it_stop)
    return running


def empty_memory(w0: torch.Tensor, config: OptimizerConfig) -> dict:
    """Zeroed s/y ring buffers [E, m, d] (in ``config.history_dtype``) and
    rho [E, m]; shared by L-BFGS and OWL-QN."""
    E, d = w0.shape
    m = config.history_length
    hdtype = resolve_history_dtype(config, w0.dtype)
    if isinstance(w0, torch.Tensor):
        s_hist, y_hist = (torch.zeros((E, m, d), dtype=hdtype, device=w0.device)
                          for _ in range(2))
    else:
        # a grid's rings: [E, m, d_loc] blocks on the feat columns' devices
        s_hist, y_hist = (w0.new_full((E, m), 0.0, hdtype) for _ in range(2))
    return {
        "s_hist": s_hist,
        "y_hist": y_hist,
        "rho": torch.zeros((E, m), dtype=w0.dtype, device=w0.device),
    }


def lbfgs_init(evaluate: Evaluate, w0: torch.Tensor, config: OptimizerConfig) -> LbfgsState:
    """Evaluate the initial point and build the resumable state (absolute
    tolerances included — reference Optimizer.scala:68-71)."""
    f0, g0 = evaluate(w0)
    abs_f_tol, abs_g_tol = absolute_tolerances(f0, norm(g0), config.tolerance)
    history, w_hist = init_histories(w0, f0, config)
    zeros_i = torch.zeros(w0.shape[0], dtype=torch.int64, device=w0.device)
    return LbfgsState(
        w=w0, f=f0, g=g0, **empty_memory(w0, config),
        count=zeros_i, it=zeros_i.clone(), reason=zeros_i + _NOT_CONVERGED,
        history=history, w_hist=w_hist, abs_f_tol=abs_f_tol, abs_g_tol=abs_g_tol,
    )


def _lbfgs_step(evaluate: Evaluate, s: LbfgsState, lanes: torch.Tensor,
                config: OptimizerConfig, box) -> LbfgsState:
    """One outer iteration for the ``lanes`` still running; the other lanes
    keep their state. ``box`` is ``resolve_box``'s triple."""
    max_iter = config.max_iterations
    box_lo, box_hi, has_box = box
    d = two_loop_direction(s.g, s.s_hist, s.y_hist, s.rho, s.count)
    dphi0 = dot(d, s.g)
    # not a descent direction (box projection can perturb the pairs):
    # restart from -g
    bad = dphi0 >= 0
    d = select(bad.unsqueeze(-1), -s.g, d)
    dphi0 = torch.where(bad, -dot(s.g, s.g), dphi0)

    def eval_step(t):
        f_t, g_t = evaluate(s.w + t.unsqueeze(-1) * d)
        return f_t, g_t, dot(g_t, d)

    # first iteration: t ~ 1/||d|| (Breeze's firstStepSize); then t = 1
    t_init = torch.where(
        s.count == 0,
        1.0 / torch.clamp(norm(d), min=1e-12),
        torch.ones_like(dphi0),
    )
    ls = strong_wolfe_search(
        eval_step, s.f, s.g, dphi0, t_init, config.max_line_search_iterations, lanes
    )
    w_new = _project_box(s.w + ls.t.unsqueeze(-1) * d, box_lo, box_hi)
    if has_box:
        # projection may have moved the point
        f_new, g_new = evaluate(w_new)
    else:
        f_new, g_new = ls.f, ls.g

    count = update_history(
        s.s_hist, s.y_hist, s.rho, s.count, w_new - s.w, g_new - s.g, lanes
    )
    it = s.it + 1
    # convergence checks (reference Optimizer.scala:131-145); a failed line
    # search that produced no movement is OBJECTIVE_NOT_IMPROVING, never
    # reported as converged
    no_step = (~ls.success) | (ls.t <= 0)
    f_conv = ls.success & function_values_converged(s.f, f_new, s.abs_f_tol)
    g_conv = gradient_converged(norm(g_new), s.abs_g_tol)

    reason = select_reason(it, max_iter, [
        (g_conv, ConvergenceReason.GRADIENT_CONVERGED),
        (no_step, ConvergenceReason.OBJECTIVE_NOT_IMPROVING),
        (f_conv, ConvergenceReason.FUNCTION_VALUES_CONVERGED),
    ])
    lane2 = lanes.unsqueeze(-1)
    it = torch.where(lanes, it, s.it)
    record_iteration(s.history, s.w_hist, lanes, it, f_new, w_new, config)
    return dataclasses.replace(
        s,
        w=select(lane2, w_new, s.w),
        f=torch.where(lanes, f_new, s.f),
        g=select(lane2, g_new, s.g),
        count=count,
        it=it,
        reason=torch.where(lanes, reason, s.reason),
    )


def lbfgs_chunk(
    evaluate: Evaluate,
    state: LbfgsState,
    config: OptimizerConfig,
    num_iters: Optional[int] = None,
    box=None,
) -> LbfgsState:
    """Advance every lane by at most ``num_iters`` outer iterations (None =
    to convergence or max_iterations). The whole solver state is carried in
    ``state``, so chunked execution follows exactly the per-lane trajectory
    of one uninterrupted run. The history buffers of ``state`` are updated
    in place (the reference donates them to its chunk program). ``box`` =
    (lower, upper) per-coefficient bounds (either None), else the config's
    scalars."""
    it_stop = None if num_iters is None else state.it + num_iters
    bounds = resolve_box(box, config, state.w)
    s = state
    while True:
        running = running_lanes(s.reason, s.it, config, it_stop)
        if not bool(running.any()):
            return s
        s = _lbfgs_step(evaluate, s, running, config, bounds)


def lbfgs_finalize(state: LbfgsState, config: OptimizerConfig) -> SolveResult:
    """The state as a SolveResult (``finalize_reason``)."""
    return SolveResult(
        w=state.w,
        value=state.f,
        grad_norm=norm(state.g),
        iterations=state.it,
        reason=finalize_reason(state.reason),
        value_history=state.history,
        w_history=state.w_hist if config.track_coefficients else None,
    )


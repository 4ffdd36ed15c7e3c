"""Strong-Wolfe line search, batched over solver lanes.

Port of ``photon_ml_tpu/opt/linesearch.py`` (Breeze's StrongWolfeLineSearch
as used by the reference's LBFGS, LBFGS.scala:59-106): bracket-then-zoom
(Nocedal & Wright alg. 3.5/3.6) with bisection zoom, c1 = 1e-4, c2 = 0.9.
Each trial evaluates value-and-gradient once; the gradient at the accepted
point is carried out so the caller does not re-evaluate.

The reference is one ``lax.while_loop`` state machine run under ``vmap``.
Here every lane keeps its own stage (0 bracketing, 1 zoom, 2 done), trial
step, bracket and best point in [E] tensors; one Python loop evaluates all
lanes at their trial steps and freezes the lanes that are done, which is
what the batched while-loop does. The loop ends when no lane is searching
(one host synchronisation a trial).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from photon_ml_tpu_torch.opt.state import select

C1 = 1e-4
C2 = 0.9


class LineSearchResult(NamedTuple):
    t: torch.Tensor        # [E] accepted step
    f: torch.Tensor        # [E] phi(t)
    g: torch.Tensor        # [E, d] full gradient at w + t*d
    success: torch.Tensor  # [E] bool: Wolfe conditions met


def strong_wolfe_search(
    eval_step: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    f0: torch.Tensor,
    g0: torch.Tensor,
    dphi0: torch.Tensor,
    t_init: torch.Tensor,
    max_iters: int = 25,
    lanes: Optional[torch.Tensor] = None,
) -> LineSearchResult:
    """eval_step(t [E]) -> (phi(t) [E], gradient at the point [E, d],
    dphi(t) [E]).

    ``g0`` is the gradient at t = 0. ``lanes`` (bool [E]) selects the lanes
    that search; the others start done. A lane that cannot satisfy Wolfe
    within ``max_iters`` evaluations returns the best sufficient-decrease
    point it saw (success False if none; then t = 0 with f0 and g0).
    """
    where = torch.where
    zero = torch.zeros_like(t_init)
    stage = torch.zeros_like(t_init, dtype=torch.int64)
    if lanes is not None:
        stage = where(lanes, stage, torch.full_like(stage, 2))
    i = torch.zeros_like(stage)
    t, t_lo, f_lo, d_lo, t_hi, f_hi = t_init, zero, f0, dphi0, zero, f0
    t_best, f_best, g_best = zero, f0, g0
    has_best = torch.zeros_like(stage, dtype=torch.bool)
    t_acc, f_acc, g_acc = zero, f0, g0
    success = torch.zeros_like(has_best)
    one, two = torch.ones_like(stage), torch.full_like(stage, 2)

    while True:
        active = (stage != 2) & (i < max_iters)
        if not bool(active.any()):
            break
        f_t, g_t, d_t = eval_step(t)
        armijo_fail = (f_t > f0 + C1 * t * dphi0) | (
            (i > 0) & (f_t >= f_lo) & (stage == 0)
        )
        wolfe_ok = (~armijo_fail) & (d_t.abs() <= -C2 * dphi0)

        # best sufficient-decrease point seen (the fallback)
        suff = f_t <= f0 + C1 * t * dphi0
        better = active & suff & ((~has_best) | (f_t < f_best))
        t_best = where(better, t, t_best)
        f_best = where(better, f_t, f_best)
        g_best = select(better.unsqueeze(-1), g_t, g_best)
        has_best = has_best | (active & suff)

        # bracketing step
        enter_hi = armijo_fail
        enter_swap = (~armijo_fail) & (~wolfe_ok) & (d_t >= 0)
        b_stage = where(wolfe_ok, two, where(enter_hi | enter_swap, one, stage * 0))
        b_t_lo = where(enter_hi, t_lo, t)
        b_f_lo = where(enter_hi, f_lo, f_t)
        b_d_lo = where(enter_hi, d_lo, d_t)
        b_t_hi = where(enter_hi, t, where(enter_swap, t_lo, t_hi))
        b_f_hi = where(enter_hi, f_t, where(enter_swap, f_lo, f_hi))
        b_t = where(b_stage == 1, 0.5 * (b_t_lo + b_t_hi), t * 2.0)

        # zoom step
        shrink_hi = armijo_fail | (f_t >= f_lo)
        z_stage = where(wolfe_ok, two, one)
        swap = (~shrink_hi) & (d_t * (t_hi - t_lo) >= 0)
        z_t_hi = where(shrink_hi, t, where(swap, t_lo, t_hi))
        z_f_hi = where(shrink_hi, f_t, where(swap, f_lo, f_hi))
        z_t_lo = where(shrink_hi, t_lo, t)
        z_f_lo = where(shrink_hi, f_lo, f_t)
        z_d_lo = where(shrink_hi, d_lo, d_t)
        z_t = 0.5 * (z_t_lo + z_t_hi)

        zoom = stage == 1
        new_stage = where(zoom, z_stage, b_stage)
        accepted = active & (new_stage == 2)
        t_acc = where(accepted, t, t_acc)
        f_acc = where(accepted, f_t, f_acc)
        g_acc = select(accepted.unsqueeze(-1), g_t, g_acc)
        success = success | accepted

        def step(zoomed, bracketed, old):
            return where(active, where(zoom, zoomed, bracketed), old)

        t_lo, f_lo, d_lo, t_hi, f_hi, t_next = (
            step(z_t_lo, b_t_lo, t_lo), step(z_f_lo, b_f_lo, f_lo),
            step(z_d_lo, b_d_lo, d_lo), step(z_t_hi, b_t_hi, t_hi),
            step(z_f_hi, b_f_hi, f_hi), step(z_t, b_t, t),
        )
        t = t_next
        stage = where(active, new_stage, stage)
        i = where(active, i + 1, i)

    # fallback: the best sufficient-decrease point seen (t = 0 if none)
    return LineSearchResult(
        t=where(success, t_acc, where(has_best, t_best, zero)),
        f=where(success, f_acc, where(has_best, f_best, f0)),
        g=select(success.unsqueeze(-1), g_acc, g_best),
        success=success | has_best,
    )

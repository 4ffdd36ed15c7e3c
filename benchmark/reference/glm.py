"""Plain reference of the logistic GLM with L2 regularization, in plain
PyTorch, independent of the program under test.

    f(w) = sum_i [log(1 + exp(z_i)) - y_i z_i] + lam/2 ||w||^2,
    z_i = x_i . w + offset_i,

over a shard of k nonzeros a row (``cols``, ``vals`` [n, k], as the
benchmark made them). Every function takes the dtype to compute in from
``w``: float64 to judge the program, bfloat16 for the control. A sum over
many terms in bfloat16 accumulates in float32 and rounds its result to
bfloat16, as PyTorch's own reductions and the tensor cores do. Rows go in
blocks so that float64 copies of a block, not of the whole matrix, are
made.
"""

from __future__ import annotations

import math

import torch

BLOCK_ROWS = 1 << 21


def margins(cols: torch.Tensor, vals: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """z = X w in w's dtype."""
    n = cols.shape[0]
    z = torch.empty(n, dtype=w.dtype, device=w.device)
    for lo in range(0, n, BLOCK_ROWS):
        hi = min(n, lo + BLOCK_ROWS)
        z[lo:hi] = (vals[lo:hi].to(w.dtype) * w[cols[lo:hi]]).sum(1)
    return z


def accumulator(dtype: torch.dtype) -> torch.dtype:
    """The dtype a scattered sum in ``dtype`` accumulates in."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def rmatvec(cols: torch.Tensor, vals: torch.Tensor, c: torch.Tensor, dim: int) -> torch.Tensor:
    """g = X^T c in c's dtype (each product in c's dtype)."""
    g = torch.zeros(dim, dtype=accumulator(c.dtype), device=c.device)
    for lo in range(0, cols.shape[0], BLOCK_ROWS):
        hi = min(cols.shape[0], lo + BLOCK_ROWS)
        g.index_add_(0, cols[lo:hi].reshape(-1),
                     (vals[lo:hi].to(c.dtype) * c[lo:hi, None]).reshape(-1).to(g.dtype))
    return g.to(c.dtype)


def loss_sum(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (torch.nn.functional.softplus(z) - y.to(z.dtype) * z).sum()


def value_and_grad(cols, vals, y, w, lam: float, offsets=None):
    """(f(w), grad f(w)) in w's dtype."""
    z = margins(cols, vals, w)
    if offsets is not None:
        z = z + offsets.to(w.dtype)
    c = torch.sigmoid(z) - y.to(w.dtype)
    return loss_sum(z, y) + 0.5 * lam * (w * w).sum(), rmatvec(cols, vals, c, w.numel()) + lam * w


def auc(scores: torch.Tensor, labels: torch.Tensor) -> float:
    """Area under the ROC curve by the rank sum, ties given their mean
    rank, in float64."""
    s = scores.double()
    order = torch.argsort(s)
    s_sorted = s[order]
    pos = (labels[order] > 0.5).double()
    _, inverse, counts = torch.unique_consecutive(s_sorted, return_inverse=True,
                                                  return_counts=True)
    ends = torch.cumsum(counts, 0).double()
    mean_rank = ends - (counts.double() - 1) / 2  # 1-based
    n_pos = pos.sum()
    n_neg = pos.numel() - n_pos
    rank_sum = (mean_rank[inverse] * pos).sum()
    return float((rank_sum - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def lbfgs(fun, w0: torch.Tensor, max_iterations: int, tolerance: float, history: int):
    """Plain L-BFGS (two-loop recursion, backtracking Armijo line search),
    in w0's dtype. Stops after ``max_iterations``, or when the objective
    improves by less than ``tolerance`` relative to its value. Returns
    (w, f(w), ||grad f(w)||, iterations)."""
    w = w0.clone()
    f, g = fun(w)
    ss, ys = [], []
    it = 0
    for it in range(1, max_iterations + 1):
        q = g.clone()
        alphas = []
        for s, y in zip(reversed(ss), reversed(ys)):
            rho = 1.0 / float((y * s).sum())
            a = rho * float((s * q).sum())
            alphas.append((a, rho))
            q -= a * y
        if ys:
            q *= float((ss[-1] * ys[-1]).sum()) / float((ys[-1] * ys[-1]).sum())
        else:
            q /= max(float(g.float().norm()), 1e-30)
        for (a, rho), s, y in zip(reversed(alphas), ss, ys):
            b = rho * float((y * q).sum())
            q += (a - b) * s
        direction = -q
        slope = float((g * direction).sum())
        if not slope < 0:
            direction, slope = -g, -float((g * g).sum())
        step = 1.0
        for _ in range(20):
            w_new = w + step * direction
            f_new, g_new = fun(w_new)
            if float(f_new) <= float(f) + 1e-4 * step * slope:
                break
            step *= 0.5
        else:
            break
        s, y = w_new - w, g_new - g
        if float((s * y).sum()) > 0:
            ss.append(s)
            ys.append(y)
            if len(ss) > history:
                ss.pop(0)
                ys.pop(0)
        improvement = abs(float(f) - float(f_new)) / max(abs(float(f_new)), 1e-30)
        w, f, g = w_new, f_new, g_new
        if improvement < tolerance or not math.isfinite(float(f)):
            break
    return w, float(f), float(g.float().norm()), it

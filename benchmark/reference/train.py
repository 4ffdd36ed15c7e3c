"""The reference as a trainer: the same jobs as the program's, in plain
PyTorch, in a dtype of the caller's choosing. In float64 it is the
trajectory the program's solves are held against (``judge.py``); put in
the program's place and run in bfloat16, it is the control of
``benchmark/control.py``, whose answers go through the same comparison and
have to come out not correct. Its answers have the format of the jobs'
answers.

The solver is L-BFGS as Photon-ML runs it (Breeze's LBFGS: history m, the
two-loop recursion scaled by s.y / y.y of the newest pair, a first step of
1 / ||d||, a strong-Wolfe line search with c1 = 1e-4 and c2 = 0.9, pairs
kept only where s.y > 1e-10 y.y), with the line search of Nocedal and
Wright, algorithms 3.5 and 3.6: steps doubled while bracketing, the
bracket halved while zooming, at most 25 evaluations, else the lowest
point of sufficient decrease seen. It runs over lanes, independent
problems side by side: one for a fixed effect, one an entity for a random
effect, whose problem is that entity's rows alone.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from benchmark.reference import glm, glmix

C1, C2 = 1e-4, 0.9
LINE_SEARCH_EVALUATIONS = 25

Lanes = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _direction(g: torch.Tensor, pairs: list) -> torch.Tensor:
    """-H g by the two-loop recursion over each lane's valid pairs (a pair
    is (s, y, rho, valid [E]))."""
    q = g
    alphas = []
    for s, y, rho, valid in reversed(pairs):
        a = torch.where(valid, rho * _dot(s, q), torch.zeros_like(rho))
        q = q - a[:, None] * y
        alphas.append(a)
    gamma = torch.ones_like(g[:, 0])
    for s, y, _, valid in pairs:
        yy = _dot(y, y)
        gamma = torch.where(valid & (yy > 0), _dot(s, y) / yy.clamp(min=1e-30), gamma)
    r = gamma[:, None] * q
    for (s, y, rho, valid), a in zip(pairs, reversed(alphas)):
        b = torch.where(valid, a - rho * _dot(y, r), torch.zeros_like(rho))
        r = r + b[:, None] * s
    return -r


def _line_search(fun: Lanes, w, d, f0, dphi0, t, searching):
    """Per lane, a step along ``d`` meeting the strong Wolfe conditions;
    returns (t, f, g, moved) at the accepted step. Lanes not ``searching``
    keep t = 0."""
    zero = torch.zeros_like(t)
    lo_t, lo_f, hi_t = zero, f0, zero
    zooming = torch.zeros_like(searching)
    done, accepted = ~searching, torch.zeros_like(searching)
    acc_t, acc_f, acc_g = zero, f0, torch.zeros_like(d)
    best_t, best_f, best_g = zero, f0, torch.zeros_like(d)
    has_best = torch.zeros_like(searching)
    for i in range(LINE_SEARCH_EVALUATIONS):
        if bool(done.all()):
            break
        f, g = fun(w + t[:, None] * d)
        dphi = _dot(g, d)
        live = ~done
        armijo = f <= f0 + C1 * t * dphi0
        curvature = dphi.abs() <= -C2 * dphi0
        better = live & armijo & (~has_best | (f < best_f))
        best_t, best_f = torch.where(better, t, best_t), torch.where(better, f, best_f)
        best_g = torch.where(better[:, None], g, best_g)
        has_best = has_best | (live & armijo)
        # bracketing (algorithm 3.5)
        to_hi = ~armijo | ((i > 0) & (f >= lo_f))
        accept_b = ~to_hi & curvature
        flip_b = ~to_hi & ~curvature & (dphi >= 0)
        # zooming (algorithm 3.6)
        to_hi_z = ~armijo | (f >= lo_f)
        accept_z = ~to_hi_z & curvature
        flip_z = ~to_hi_z & ~curvature & (dphi * (hi_t - lo_t) >= 0)
        accept = live & torch.where(zooming, accept_z, accept_b)
        acc_t, acc_f = torch.where(accept, t, acc_t), torch.where(accept, f, acc_f)
        acc_g = torch.where(accept[:, None], g, acc_g)
        done, accepted = done | accept, accepted | accept
        move = live & ~accept
        to_hi = torch.where(zooming, to_hi_z, to_hi)
        flip = torch.where(zooming, flip_z, flip_b)
        # the new bracket: [lo, t] where t is too far; else t the new lo,
        # with the old lo the new hi where the slope turned
        new_hi_t = torch.where(to_hi, t, torch.where(flip, lo_t, hi_t))
        new_lo_t = torch.where(to_hi, lo_t, t)
        new_lo_f = torch.where(to_hi, lo_f, f)
        now_zooming = zooming | to_hi | flip
        hi_t = torch.where(move, new_hi_t, hi_t)
        lo_t, lo_f = torch.where(move, new_lo_t, lo_t), torch.where(move, new_lo_f, lo_f)
        zooming = torch.where(move, now_zooming, zooming)
        t = torch.where(move, torch.where(zooming, 0.5 * (lo_t + hi_t), 2.0 * t), t)
    use_best = searching & ~accepted & has_best
    t_out = torch.where(accepted, acc_t, torch.where(use_best, best_t, zero))
    f_out = torch.where(accepted, acc_f, torch.where(use_best, best_f, f0))
    g_out = torch.where(accepted[:, None], acc_g, best_g)
    return t_out, f_out, g_out, accepted | use_best


def lbfgs(fun: Lanes, w0: torch.Tensor, max_iterations: int, tolerance: float, history: int):
    """L-BFGS over the lanes of ``w0`` [E, d] in its dtype; ``fun(w)`` gives
    each lane's objective [E] and gradient [E, d]. A lane stops after
    ``max_iterations``, where a step moves nothing, where its objective
    changes by at most ``tolerance`` times its first value, or its gradient
    norm falls to ``tolerance`` times its first. Returns (w, f, the first
    gradient's norm [E], iterations [E])."""
    w = w0.clone()
    f, g = fun(w)
    f_tol, g_tol = tolerance * f.abs(), tolerance * g.norm(dim=-1)
    g0_norm = g.norm(dim=-1)
    running = torch.ones_like(f, dtype=torch.bool)
    iterations = torch.zeros_like(f, dtype=torch.int64)
    pairs = []
    for _ in range(max_iterations):
        if not bool(running.any()):
            break
        d = _direction(g, pairs)
        dphi0 = _dot(g, d)
        descent = dphi0 < 0
        d = torch.where(descent[:, None], d, -g)
        dphi0 = torch.where(descent, dphi0, -_dot(g, g))
        fresh = torch.zeros_like(running)
        if pairs:
            for _, _, _, valid in pairs:
                fresh = fresh | valid
        t0 = torch.where(fresh, torch.ones_like(f), 1.0 / d.norm(dim=-1).clamp(min=1e-12))
        t, f_new, g_new, moved = _line_search(fun, w, d, f, dphi0, t0, running)
        step = running & moved
        s, y = t[:, None] * d, g_new - g
        sy, yy = _dot(s, y), _dot(y, y)
        keep = step & (sy > 1e-10 * yy.clamp(min=1e-30))
        if bool(keep.any()):
            pairs.append((s, y, torch.where(keep, 1.0 / sy.clamp(min=1e-30), torch.zeros_like(sy)),
                          keep))
            # each lane keeps its newest ``history`` pairs
            kept = torch.zeros_like(f, dtype=torch.int64)
            for k in range(len(pairs) - 1, -1, -1):
                s_k, y_k, rho_k, valid_k = pairs[k]
                kept = kept + valid_k.long()
                pairs[k] = (s_k, y_k, rho_k, valid_k & (kept <= history))
            pairs = [p for p in pairs if bool(p[3].any())]
        iterations = iterations + running.long()
        f_conv = step & ((f - f_new).abs() <= f_tol)
        w = torch.where(step[:, None], w + s, w)
        f = torch.where(step, f_new, f)
        g = torch.where(step[:, None], g_new, g)
        running = running & moved & ~f_conv & (g.norm(dim=-1) > g_tol)
    return w, f, g0_norm, iterations


def _optimizer(config: dict) -> dict:
    o = config["optimizer"]
    return dict(max_iterations=o["max_iterations"], tolerance=o["tolerance"],
                history=o["history_length"])


def glm_sweep(data, config: dict, dtype) -> dict:
    """The λ sweep, high to low and warm-started, with the held-out scores
    and AUC of each λ, and each solve's first gradient norm."""
    fe = data.train.shards["global"]
    ho = data.heldout.shards["global"]
    w = torch.zeros(fe.dim, dtype=dtype, device=fe.cols.device)
    out = {"w": {}, "value": {}, "scores": {}, "auc": {}, "grad0": {}}
    for lam in sorted(config["lambdas"], reverse=True):
        def fun(v, lam=lam):
            f, g = glm.value_and_grad(fe.cols, fe.vals, data.train.labels, v[0], lam)
            return f.reshape(1), g[None]

        w, f, g0, _ = lbfgs(fun, w[None], **_optimizer(config))
        w = w[0]
        out["w"][lam], out["value"][lam], out["grad0"][lam] = w, float(f[0]), float(g0[0])
        out["scores"][lam] = glm.margins(ho.cols, ho.vals, w)
        out["auc"][lam] = glm.auc(out["scores"][lam].float(), data.heldout.labels)
    return out


class _EntityLanes:
    """A random effect's problem as one lane an entity that has training
    rows: the entity's keys (``glmix.train_keys``) laid out [E, D], D the
    most keys an entity holds; slots past an entity's own keys stay 0."""

    def __init__(self, rows, shard: str):
        sh = rows.shards[shard]
        self.keys, inverse = glmix.train_keys(rows, shard)
        entity_of_key = self.keys // sh.dim
        self.entities, lane_of_key, per_lane = torch.unique(
            entity_of_key, return_inverse=True, return_counts=True)
        first = torch.cumsum(per_lane, 0) - per_lane
        slot_of_key = torch.arange(self.keys.numel(), device=self.keys.device) - first[lane_of_key]
        self.E, self.D = self.entities.numel(), int(per_lane.max())
        self.flat_of_key = lane_of_key * self.D + slot_of_key
        self.flat = self.flat_of_key[inverse]           # [n, k] of each nonzero
        self.lane_of_row = lane_of_key[inverse[:, 0]]   # [n]
        self.vals = sh.vals

    def dense(self, coef: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(self.E * self.D, dtype=coef.dtype, device=coef.device)
        out[self.flat_of_key] = coef
        return out.reshape(self.E, self.D)

    def coefficients(self, v: torch.Tensor) -> torch.Tensor:
        return v.reshape(-1)[self.flat_of_key]

    def objective(self, labels, offsets, lam: float) -> Lanes:
        acc = glm.accumulator

        def fun(v):
            dtype = v.dtype
            z = offsets + (self.vals.to(dtype) * v.reshape(-1)[self.flat]).sum(1)
            c = torch.sigmoid(z) - labels.to(dtype)
            loss = torch.nn.functional.softplus(z) - labels.to(dtype) * z
            f = torch.zeros(self.E, dtype=acc(dtype), device=v.device).index_add_(
                0, self.lane_of_row, loss.to(acc(dtype)))
            g = torch.zeros(self.E * self.D, dtype=acc(dtype), device=v.device).index_add_(
                0, self.flat.reshape(-1), (self.vals.to(dtype) * c[:, None]).reshape(-1).to(acc(dtype)))
            return (f.to(dtype) + 0.5 * lam * _dot(v, v),
                    g.to(dtype).reshape(self.E, self.D) + lam * v)

        return fun


def glmix_fit(data, config: dict, dtype) -> dict:
    """Coordinate descent over the fixed effect and the random effects in
    the configured order, ``outer_iterations`` times, each coordinate solved
    by L-BFGS against the others' margins (a random effect entity by
    entity), warm-started; validated after every update. Returns every
    update's model, objective, AUC and coordinate (``updates``), each
    coordinate's first gradient norm (``grad0``: the fixed effect's, the
    random effects' over all their lanes), and the best update's fields,
    the best kept once every coordinate has trained."""
    tr, lam = data.train, config["lambda"]
    fe = tr.shards["global"]
    dev = fe.cols.device
    lanes = {s: _EntityLanes(tr, s) for s in config["random_effects"]}
    model = {"fe": torch.zeros(fe.dim, dtype=dtype, device=dev),
             "re": {s: (ln.keys, torch.zeros(ln.keys.numel(), dtype=dtype, device=dev))
                    for s, ln in lanes.items()}}
    updates, grad0 = [], {}
    for _ in range(config["outer_iterations"]):
        for cid in config["update_order"]:
            offsets = glmix.margins(tr, model, dtype, skip=cid)
            if cid == "fixed":
                def fun(v):
                    f, g = glm.value_and_grad(fe.cols, fe.vals, tr.labels, v[0], lam, offsets)
                    return f.reshape(1), g[None]

                w, _, g0, _ = lbfgs(fun, model["fe"][None], **_optimizer(config))
                model["fe"] = w[0]
            else:
                ln = lanes[cid]
                v, _, g0, _ = lbfgs(ln.objective(tr.labels, offsets, lam),
                                    ln.dense(model["re"][cid][1]), **_optimizer(config))
                model["re"][cid] = (ln.keys, ln.coefficients(v))
            grad0.setdefault(cid, float(g0.norm()))
            updates.append({"model": {"fe": model["fe"], "re": dict(model["re"])},
                            "objective": glmix.objective(tr, model, lam, dtype),
                            "auc": glmix.heldout_auc(data.heldout, model, dtype),
                            "coordinate": cid})
    start = len(config["update_order"]) - 1
    best = max(range(start, len(updates)), key=lambda i: (updates[i]["auc"], -i))
    return dict(updates[best], update=best, updates=updates, grad0=grad0)

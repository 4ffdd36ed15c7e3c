"""Plain reference of the logistic GLMix model (a fixed effect plus per-user
and per-item random effects, each with L2), in plain PyTorch, independent
of the program under test.

A random effect's coefficients are keyed by (entity, feature) as
``entity * dim + feature``: a model is, per random-effect shard, the sorted
int64 keys it holds and their coefficients. A row's random-effect margin
sums vals * coefficient over its nonzeros; a key the model lacks, or a row
whose entity is unseen, contributes 0 (the left join of GLMix scoring).

    F = sum_i [log(1 + exp(z_i)) - y_i z_i] + lam/2 (||w_fe||^2 + sum_c ||w_c||^2),
    z_i = x_i . w_fe + sum_c (random-effect margin of shard c).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from benchmark.reference import glm

Model = Dict[str, object]  # {"fe": w [d], "re": {shard: (keys, coefficients)}}


def row_keys(data_rows, shard: str) -> torch.Tensor:
    """[n, k] keys of a shard's nonzeros; -1 where the row's entity is unseen."""
    sh = data_rows.shards[shard]
    keys = data_rows.entity[shard][:, None] * sh.dim + sh.cols
    return torch.where(data_rows.unseen[shard][:, None], torch.full_like(keys, -1), keys)


def lookup(keys: torch.Tensor, model_keys: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """The coefficient of each key, 0 where the model has none."""
    if model_keys.numel() == 0:
        return torch.zeros(keys.shape, dtype=coef.dtype, device=keys.device)
    pos = torch.searchsorted(model_keys, keys).clamp(max=model_keys.numel() - 1)
    hit = model_keys[pos] == keys
    return torch.where(hit, coef[pos], torch.zeros((), dtype=coef.dtype, device=coef.device))


def re_margins(data_rows, shard: str, model_keys, coef) -> torch.Tensor:
    sh = data_rows.shards[shard]
    return (sh.vals.to(coef.dtype) * lookup(row_keys(data_rows, shard), model_keys, coef)).sum(1)


def margins(data_rows, model: Model, dtype, skip: str = "") -> torch.Tensor:
    """z of every row in ``dtype``, without coordinate ``skip``."""
    fe = data_rows.shards["global"]
    z = torch.zeros(data_rows.num_rows, dtype=dtype, device=fe.cols.device)
    if skip != "fixed":
        z += glm.margins(fe.cols, fe.vals, model["fe"].to(dtype))
    for shard, (keys, coef) in model["re"].items():
        if shard != skip:
            z += re_margins(data_rows, shard, keys, coef.to(dtype))
    return z


def objective(data_rows, model: Model, lam: float, dtype=torch.float64) -> float:
    z = margins(data_rows, model, dtype)
    reg = (model["fe"].to(dtype) ** 2).sum() + sum(
        (c.to(dtype) ** 2).sum() for _, c in model["re"].values())
    return float(glm.loss_sum(z, data_rows.labels) + 0.5 * lam * reg)


def train_keys(data_rows, shard: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The distinct keys of a shard's training nonzeros (sorted) and the
    position of each nonzero's key among them."""
    return torch.unique(row_keys(data_rows, shard), sorted=True, return_inverse=True)


def coordinate_gradient(data_rows, model: Model, lam: float, coordinate: str,
                        z: torch.Tensor) -> torch.Tensor:
    """The gradient of F in one coordinate at margins ``z`` (float64 or the
    model's dtype): the fixed effect over all its columns, a random effect
    over every key its training nonzeros hold."""
    c = torch.sigmoid(z) - data_rows.labels.to(z.dtype)
    if coordinate == "fixed":
        fe = data_rows.shards["global"]
        w = model["fe"].to(z.dtype)
        return glm.rmatvec(fe.cols, fe.vals, c, w.numel()) + lam * w
    sh = data_rows.shards[coordinate]
    keys, inverse = train_keys(data_rows, coordinate)
    g = torch.zeros(keys.numel(), dtype=glm.accumulator(z.dtype), device=z.device)
    g.index_add_(0, inverse.reshape(-1),
                 (sh.vals.to(z.dtype) * c[:, None]).reshape(-1).to(g.dtype))
    mk, mc = model["re"][coordinate]
    return g.to(z.dtype) + lam * lookup(keys, mk, mc.to(z.dtype))


def grad_ratios(data_rows, model: Model, lam: float) -> Dict[str, float]:
    """For each coordinate, ||grad_c F(model)|| over ||grad_c F(model with
    coordinate c set to 0)||: near 0 where the coordinate's last solve
    converged against the others, 1 where its solve left it at 0."""
    z = margins(data_rows, model, torch.float64)
    out = {}
    for cid in ["fixed", *model["re"]]:
        g = coordinate_gradient(data_rows, model, lam, cid, z)
        zeroed = dict(model, re=dict(model["re"]))
        if cid == "fixed":
            zeroed["fe"] = torch.zeros_like(model["fe"])
        else:
            keys, coef = model["re"][cid]
            zeroed["re"][cid] = (keys, torch.zeros_like(coef))
        g0 = coordinate_gradient(data_rows, zeroed, lam, cid,
                                 margins(data_rows, zeroed, torch.float64))
        out[cid] = float(g.norm() / g0.norm())
    return out


def heldout_auc(heldout_rows, model: Model, dtype=torch.float64) -> float:
    return glm.auc(margins(heldout_rows, model, dtype), heldout_rows.labels)

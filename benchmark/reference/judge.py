"""The comparison that decides ``correct``: what the jobs of a run answered,
held against the plain reference computed again, in float64, from the
inputs the benchmark made.

A job's answers are judged by what they say. Of every job in the window
the answers are kept (each λ's objective, held-out scores and AUC; a GLMix
fit's objective and validation AUC at its best model); of the last job
also its coefficients, at which the reference evaluates, and which it
holds against the reference trainer's run through the same job. Every job
runs the same inputs from the same start, so each job's answers are held
against the reference's values at the last job's coefficients. Each
function returns one dict of numbers a job (``trained``, where given, is
the float64 reference trainer's run of the same data, made once for
several judgements); a number that has no limit is
printed beside the others and decides nothing.

Numbers (each compared with its limit in ``limits/<workload>.json``):

- ``objective_gap``: |reported objective - reference objective at the
  reported coefficients| / |reference objective| (the largest over λ);
- ``grad_ratio``: the reference gradient norm at the answer over the one
  at zero, the largest over the solves (sweep: each λ's coefficients
  against all zeros; GLMix: each coordinate of the returned model against
  the model with that coordinate at zero): 1 for solvers that leave their
  state unchanged;
- ``score_gap`` (sweep): the largest |reported held-out score - reference
  score| over every held-out row and λ, each over the row's sum of
  |x_ij w_j|: rounding of the row's terms, not of its score;
- ``auc_gap``: |reported held-out AUC - reference AUC of the reported
  coefficients| (the largest over λ);
- ``loss_gap``: |F(program's coefficients) - F(reference trainer's)| /
  |F(reference trainer's)|, F the training objective in float64, the
  reference trainer (``reference/train.py``) run in float64 through the
  same job from the same start (sweep: the largest over the first
  ``FOLLOWED`` λ of the sweep; GLMix: at the update that gave the
  program's best model);
- ``change_gap``: by the worst leaf, |norm of the program's change - norm
  of the reference trainer's| over the larger of the reference's norm of
  that leaf and of the median leaf. A leaf is a solve's change (sweep: each
  of the first ``FOLLOWED`` λ's coefficients less the previous λ's) or a
  coordinate's coefficients (GLMix, from the job's start at zero, at the
  best model's update); leaves whose first gradient in the reference is
  under a thousandth of the median leaf's are left out (none is, in the
  cells as configured).

The sweep's later solves (λ = 10, 1, 0.1) end their 10 iterations far
from their optimum (gradient ratios 0.01-0.04), where float32 rounding can
turn one decision of the solver (a line search's, or the stop on an
objective that changed by less than its ulp) and the paths part: there
the program and the float64 trainer end apart, and their gaps are
printed, not compared. The first solve (λ = 100) ends near its optimum
and its path is compared.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

from benchmark.reference import glm, glmix, train

# a leaf whose first reference gradient is under this share of the median
# leaf's moves by round-off alone, and is not compared
STILL_LEAF = 1e-3
# the sweep's solves, from the first, that the reference trainer's path is
# compared over
FOLLOWED = 1


def change_gap(program: Dict[str, float], reference: Dict[str, float],
               grad0: Dict[str, float]) -> float:
    """The worst leaf's gap between the norms of the program's change and
    the reference's, over the larger of the reference's norm of that leaf
    and of the median leaf."""
    floor = STILL_LEAF * statistics.median(grad0.values())
    leaves = [k for k in reference if grad0[k] >= floor]
    median = statistics.median(reference[k] for k in leaves)
    return max(abs(program[k] - reference[k]) / max(reference[k], median) for k in leaves)


def glm_sweep(data, config: dict, jobs: List[dict], trained: dict = None) -> List[Dict[str, float]]:
    last = jobs[-1]
    fe = data.train.shards["global"]
    ho = data.heldout.shards["global"]
    y = data.train.labels
    zero = torch.zeros(fe.dim, dtype=torch.float64, device=fe.cols.device)
    g0 = float(glm.value_and_grad(fe.cols, fe.vals, y, zero, 0.0)[1].norm())
    trained = trained or train.glm_sweep(data, config, torch.float64)
    ref, ratio, scores, moved, moved_ref = {}, {}, {}, {}, {}
    w_prev, w_prev_ref = zero, zero
    for lam in sorted(config["lambdas"], reverse=True):
        w, w_ref = last["w"][lam].to(torch.float64), trained["w"][lam]
        f, g = glm.value_and_grad(fe.cols, fe.vals, y, w, lam)
        ratio[lam] = float(g.norm()) / g0
        z = glm.margins(ho.cols, ho.vals, w)
        scores[lam] = (z, glm.margins(ho.cols, ho.vals.abs(), w.abs()).clamp(min=1e-30))
        ref[lam] = (float(f), glm.auc(z, data.heldout.labels))
        moved[lam], moved_ref[lam] = float((w - w_prev).norm()), float((w_ref - w_prev_ref).norm())
        w_prev, w_prev_ref = w, w_ref
    followed = sorted(config["lambdas"], reverse=True)[:FOLLOWED]
    loss = {lam: abs(ref[lam][0] - trained["value"][lam]) / abs(trained["value"][lam])
            for lam in ref}
    trajectory = {
        "loss_gap": max(loss[lam] for lam in followed),
        "change_gap": change_gap({lam: moved[lam] for lam in followed},
                                 {lam: moved_ref[lam] for lam in followed}, trained["grad0"]),
        **{f"loss.{lam:g}": gap for lam, gap in loss.items()},
        **{f"change.{lam:g}": moved[lam] / moved_ref[lam] - 1 for lam in moved},
    }
    return [{
        "objective_gap": max(abs(j["value"][lam] - f) / abs(f) for lam, (f, _) in ref.items()),
        "grad_ratio": max(ratio.values()),
        **{f"grad_ratio.{lam:g}": r for lam, r in ratio.items()},
        "score_gap": max(float(((j["scores"][lam].to(z.device, torch.float64) - z).abs()
                                / scale).max()) for lam, (z, scale) in scores.items()),
        "auc_gap": max(abs(j["auc"][lam] - a) for lam, (_, a) in ref.items()),
        **trajectory,
    } for j in jobs]


def _norms(model) -> Dict[str, float]:
    return {"fixed": float(model["fe"].double().norm()),
            **{cid: float(coef.double().norm()) for cid, (_, coef) in model["re"].items()}}


def glmix_fit(data, config: dict, jobs: List[dict], trained: dict = None) -> List[Dict[str, float]]:
    model, update = jobs[-1]["model"], jobs[-1]["update"]
    lam = config["lambda"]
    f = glmix.objective(data.train, model, lam)
    auc = glmix.heldout_auc(data.heldout, model)
    ratios = glmix.grad_ratios(data.train, model, lam)
    trained = trained or train.glmix_fit(data, config, torch.float64)
    at = trained["updates"][update]
    norms, norms_ref = _norms(model), _norms(at["model"])
    trajectory = {
        "loss_gap": abs(f - at["objective"]) / abs(at["objective"]),
        "change_gap": change_gap(norms, norms_ref, trained["grad0"]),
        **{f"change.{cid}": norms[cid] / norms_ref[cid] - 1 for cid in norms},
        "reference_best_update": trained["update"],
    }
    return [{"objective_gap": abs(j["objective"] - f) / abs(f),
             "grad_ratio": max(ratios.values()), "auc_gap": abs(j["auc"] - auc),
             **{f"grad_ratio.{cid}": r for cid, r in ratios.items()},
             **trajectory} for j in jobs]

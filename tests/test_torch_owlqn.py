"""The port's batched OWL-QN against the JAX solver under vmap, on the same
seeded problems (the tolerances of ``test_torch_lbfgs.py``):

- w after 3 iterations (tolerance 0): rtol 2e-4, the same iterations and
  reasons, for L1 and elastic net, with and without a box;
- the converged objective F = f + l1·‖w‖₁: rtol 1e-4;
- on a lasso problem whose optimum lies well inside its orthants (every
  zero coefficient's |∂f/∂w_j| at most 0.8·l1, every nonzero one far from
  0) the support equals the JAX package's: f32 sums in another order can
  move a coefficient across an orthant edge only near one;
- chunked solving and lane compaction follow the one-shot trajectory.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import dense_bucket, jax_vmapped_solve, solver_configs
from photon_ml_tpu.losses import pointwise as jax_pointwise
from photon_ml_tpu.losses.objective import make_glm_objective as jax_objective
from photon_ml_tpu.ops.data import LabeledData as JaxData
from photon_ml_tpu.ops.features import from_scipy_like as jax_ell
from photon_ml_tpu.opt.owlqn import pseudo_gradient as jax_pseudo_gradient
from photon_ml_tpu.opt.solve import solve as jax_solve
from photon_ml_tpu_torch.losses import pointwise
from photon_ml_tpu_torch.losses.objective import make_glm_objective
from photon_ml_tpu_torch.ops.data import LabeledData
from photon_ml_tpu_torch.ops.features import from_scipy_like
from photon_ml_tpu_torch.opt.owlqn import OwlqnState, pseudo_gradient
from photon_ml_tpu_torch.opt.solve import solve, solve_chunk, solve_finalize, solve_init

LOSSES = ["LogisticLoss", "SquaredLoss", "PoissonLoss"]
REGS = [("L1", None), ("ELASTIC_NET", 0.5)]


def _bucket(seed, loss="LogisticLoss"):
    return dense_bucket(seed, s=80, d=10,
                        labels="binary" if loss == "LogisticLoss" else "counts")


def _solve(loss, td, w0, cfg, box=None):
    return solve(make_glm_objective(getattr(pointwise, loss)), torch.from_numpy(w0), td, cfg,
                 box=box)


@pytest.mark.parametrize("reg,alpha", REGS)
@pytest.mark.parametrize("loss", LOSSES)
def test_three_iterations_match_jax_vmap(loss, reg, alpha):
    jd, td, w0 = _bucket(LOSSES.index(loss), loss)
    jcfg, tcfg = solver_configs("LBFGS", reg, 4.0, alpha, max_iterations=3, tolerance=0.0)
    jr = jax_vmapped_solve(loss, jd, w0, jcfg)
    tr = _solve(loss, td, w0, tcfg)
    np.testing.assert_allclose(tr.w.numpy(), np.asarray(jr.w), rtol=2e-4, atol=1e-6)
    np.testing.assert_array_equal(tr.iterations.numpy(), np.asarray(jr.iterations))
    np.testing.assert_array_equal(tr.reason.numpy(), np.asarray(jr.reason))
    np.testing.assert_allclose(tr.value_history.numpy(), np.asarray(jr.value_history),
                               rtol=2e-4)


@pytest.mark.parametrize("loss", LOSSES)
def test_converged_objective_matches_jax_vmap(loss):
    jd, td, w0 = _bucket(10 + LOSSES.index(loss), loss)
    jcfg, tcfg = solver_configs("LBFGS", "ELASTIC_NET", 4.0, 0.5)
    jr = jax_vmapped_solve(loss, jd, w0, jcfg)
    tr = _solve(loss, td, w0, tcfg)
    np.testing.assert_allclose(tr.value.numpy(), np.asarray(jr.value), rtol=1e-4, atol=1e-6)
    assert bool(tr.converged().all())


def test_box_with_elastic_net_matches_jax():
    jd, td, w0 = _bucket(21)
    d = w0.shape[1]
    lo = np.full(d, -np.inf, np.float32)
    hi = np.full(d, np.inf, np.float32)
    lo[:4], hi[:4] = -0.03, 0.03
    jcfg, tcfg = solver_configs("LBFGS", "ELASTIC_NET", 2.0, 0.5, max_iterations=3,
                                tolerance=0.0)
    jr = jax_vmapped_solve("LogisticLoss", jd, w0, jcfg, box=(jnp.asarray(lo), jnp.asarray(hi)))
    tr = _solve("LogisticLoss", td, w0, tcfg, box=(lo, hi))
    np.testing.assert_allclose(tr.w.numpy(), np.asarray(jr.w), rtol=2e-4, atol=1e-6)
    assert float(tr.w[:, :4].abs().max()) <= 0.03
    assert float(tr.w[:, 4:].abs().max()) > 0.03  # the box clipped


def test_lasso_support_matches_jax():
    """One unbatched sparse least-squares problem (the fixed effect's
    one-lane path) with a planted sparse optimum."""
    rng = np.random.default_rng(4)
    n, d, k = 400, 24, 8
    rows = np.repeat(np.arange(n), k)
    cols = np.stack([rng.choice(d, k, replace=False) for _ in range(n)]).reshape(-1)
    vals = rng.standard_normal(n * k).astype(np.float32)
    w_true = np.zeros(d, np.float32)
    w_true[[1, 5, 9, 13, 20]] = [2.0, -1.5, 1.0, -2.5, 1.8]
    X = np.zeros((n, d), np.float32)
    X[rows, cols] = vals
    y = (X @ w_true + 0.05 * rng.standard_normal(n)).astype(np.float32)
    jd = JaxData.create(jax_ell(rows, cols, vals, (n, d)), jnp.asarray(y))
    td = LabeledData.create(from_scipy_like(rows, cols, vals, (n, d), device="cpu"),
                            torch.from_numpy(y))
    l1 = 40.0
    jcfg, tcfg = solver_configs("LBFGS", "L1", l1, max_iterations=200, tolerance=1e-9)
    jr = jax_solve(jax_objective(jax_pointwise.SquaredLoss, use_pallas=False),
                   jnp.zeros(d), jd, jcfg)
    obj = make_glm_objective(pointwise.SquaredLoss)
    tr = solve(obj, torch.zeros(1, d), td, tcfg)
    w = tr.w[0]
    support = w != 0
    # the optimum is well separated from the orthant edges
    _, g = obj.value_and_grad(w, td, 0.0)
    assert float(g[~support].abs().max()) <= 0.8 * l1
    assert float(w[support].abs().min()) > 0.3
    np.testing.assert_array_equal(support.numpy(), np.asarray(jr.w) != 0)
    assert int(support.sum()) == 5
    np.testing.assert_allclose(float(tr.value[0]), float(jr.value), rtol=1e-4)


def test_pseudo_gradient_matches_jax():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((4, 30)).astype(np.float32)
    w[rng.random((4, 30)) < 0.5] = 0.0
    g = (rng.standard_normal((4, 30)) * 2).astype(np.float32)
    got = pseudo_gradient(torch.from_numpy(w), torch.from_numpy(g), torch.tensor(0.7))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_pseudo_gradient(w, g, jnp.float32(0.7))))


def test_chunked_solve_and_lane_compaction_follow_the_one_shot_trajectory():
    """Pieces of 2 iterations equal one uninterrupted solve bitwise, lane
    for lane; lanes taken out mid-solve go on as in the full batch (to rtol
    1e-5: the CPU's elementwise kernels round a lane differently in a batch
    of another size)."""
    _, td, w0 = _bucket(5)
    obj = make_glm_objective(pointwise.LogisticLoss)
    _, tcfg = solver_configs("LBFGS", "L1", 4.0, max_iterations=9, tolerance=1e-7)
    one = solve(obj, torch.from_numpy(w0), td, tcfg)
    state = solve_init(obj, torch.from_numpy(w0), td, tcfg)
    assert isinstance(state, OwlqnState)
    for _ in range(5):
        state = solve_chunk(obj, state, td, tcfg, num_iters=2)
    chunked = solve_finalize(state, tcfg)
    for f in dataclasses.fields(one):
        a, b = getattr(one, f.name), getattr(chunked, f.name)
        assert (a is None and b is None) or torch.equal(a.nan_to_num(), b.nan_to_num()), f.name

    _, tcfg = solver_configs("LBFGS", "L1", 4.0, max_iterations=3, tolerance=0.0)
    full = solve(obj, torch.from_numpy(w0), td, tcfg)
    keep = torch.tensor([4, 1, 2])
    state = solve_chunk(obj, solve_init(obj, torch.from_numpy(w0), td, tcfg), td, tcfg,
                        num_iters=1).take_lanes(keep)
    part = solve_finalize(solve_chunk(obj, state, td.take_lanes(keep), tcfg), tcfg)
    np.testing.assert_allclose(part.w.numpy(), full.w[keep].numpy(), rtol=1e-5, atol=1e-7)
    for e in range(w0.shape[0]):
        lane = torch.tensor([e])
        alone = solve(obj, torch.from_numpy(w0[e:e + 1]), td.take_lanes(lane), tcfg)
        np.testing.assert_allclose(alone.w.numpy(), full.w[lane].numpy(), rtol=1e-5, atol=1e-7)

"""The port's batched TRON against the JAX solver under vmap, on the same
seeded problems (the tolerances of ``test_torch_lbfgs.py``):

- w after 3 iterations (tolerance 0, so no lane stops early): rtol 2e-4,
  the same iterations and reasons. The problems have 80 rows and 10
  features: on 24 × 5 Newton steps reach the optimum within 3 iterations,
  where TRON's acceptance test (actred > 1e-4·prered) compares differences
  of f at f32's rounding noise and one package may reject a step the other
  accepts;
- the converged objective: rtol 1e-4;
- chunked solving, lane compaction and lanes solved alone follow the
  one-shot batch's trajectory, inside the port.
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
from photon_ml_tpu.opt.solve import solve as jax_solve
from photon_ml_tpu_torch.losses import pointwise
from photon_ml_tpu_torch.losses.objective import make_glm_objective
from photon_ml_tpu_torch.ops.data import LabeledData
from photon_ml_tpu_torch.ops.features import from_scipy_like
from photon_ml_tpu_torch.opt.solve import solve, solve_chunk, solve_finalize, solve_init
from photon_ml_tpu_torch.opt.tron import TronState

LOSSES = ["LogisticLoss", "SquaredLoss", "PoissonLoss"]


def _labels(loss):
    return "binary" if loss == "LogisticLoss" else "counts"


def _bucket(seed, labels="binary"):
    return dense_bucket(seed, s=80, d=10, labels=labels)


def _solve(loss, td, w0, cfg, box=None):
    return solve(make_glm_objective(getattr(pointwise, loss)), torch.from_numpy(w0), td, cfg,
                 box=box)


@pytest.mark.parametrize("loss", LOSSES)
def test_three_iterations_match_jax_vmap(loss):
    jd, td, w0 = _bucket(LOSSES.index(loss), _labels(loss))
    jcfg, tcfg = solver_configs("TRON", max_iterations=3, tolerance=0.0)
    jr = jax_vmapped_solve(loss, jd, w0, jcfg)
    tr = _solve(loss, td, w0, tcfg)
    np.testing.assert_allclose(tr.w.numpy(), np.asarray(jr.w), rtol=2e-4, atol=1e-6)
    np.testing.assert_array_equal(tr.iterations.numpy(), np.asarray(jr.iterations))
    np.testing.assert_array_equal(tr.reason.numpy(), np.asarray(jr.reason))
    np.testing.assert_allclose(tr.value_history.numpy(), np.asarray(jr.value_history),
                               rtol=2e-4)


@pytest.mark.parametrize("loss", LOSSES)
def test_converged_objective_matches_jax_vmap(loss):
    jd, td, w0 = _bucket(10 + LOSSES.index(loss), _labels(loss))
    jcfg, tcfg = solver_configs("TRON")
    jr = jax_vmapped_solve(loss, jd, w0, jcfg)
    tr = _solve(loss, td, w0, tcfg)
    np.testing.assert_allclose(tr.value.numpy(), np.asarray(jr.value), rtol=1e-4, atol=1e-6)
    assert bool(tr.converged().all())


def test_fixed_effect_single_lane_matches_jax():
    """One unbatched sparse problem, one lane, its Hv through the one-lane
    ``hessian_vec``: the fixed effect's path."""
    rng = np.random.default_rng(3)
    n, d = 300, 40
    rows = np.repeat(np.arange(n), 6)
    cols = rng.integers(0, d, n * 6)
    vals = rng.standard_normal(n * 6).astype(np.float32)
    y = (rng.random(n) < 0.4).astype(np.float32)
    jd = JaxData.create(jax_ell(rows, cols, vals, (n, d)), jnp.asarray(y))
    td = LabeledData.create(from_scipy_like(rows, cols, vals, (n, d), device="cpu"),
                            torch.from_numpy(y))
    for iters, tol in ((3, 0.0), (15, 1e-5)):
        jcfg, tcfg = solver_configs("TRON", max_iterations=iters, tolerance=tol)
        jr = jax_solve(jax_objective(jax_pointwise.LogisticLoss, use_pallas=False),
                       jnp.zeros(d), jd, jcfg)
        tr = solve(make_glm_objective(pointwise.LogisticLoss), torch.zeros(1, d), td, tcfg)
        assert tr.w.shape == (1, d)
        if tol == 0.0:
            np.testing.assert_allclose(tr.w[0].numpy(), np.asarray(jr.w), rtol=2e-4, atol=1e-6)
            assert int(tr.iterations[0]) == int(jr.iterations)
        else:
            np.testing.assert_allclose(float(tr.value[0]), float(jr.value), rtol=1e-4)


@pytest.mark.parametrize("box", ["scalar", "per_coefficient"])
def test_box_constraints_match_jax(box):
    jd, td, w0 = _bucket(21)
    d = w0.shape[1]
    if box == "scalar":
        opt, jbox, tbox = {"constraint_lower": -0.05, "constraint_upper": 0.05}, None, None
    else:
        lo = np.full(d, -np.inf, np.float32)
        hi = np.full(d, np.inf, np.float32)
        lo[1], hi[1], hi[3] = -0.02, 0.02, 0.01
        opt, jbox, tbox = {}, (jnp.asarray(lo), jnp.asarray(hi)), (lo, hi)
    jcfg, tcfg = solver_configs("TRON", max_iterations=3, tolerance=0.0, **opt)
    jr = jax_vmapped_solve("LogisticLoss", jd, w0, jcfg, box=jbox)
    tr = _solve("LogisticLoss", td, w0, tcfg, box=tbox)
    np.testing.assert_allclose(tr.w.numpy(), np.asarray(jr.w), rtol=2e-4, atol=1e-6)
    if box == "per_coefficient":
        assert float(tr.w[:, 1].abs().max()) <= 0.02 and float(tr.w[:, 3].max()) <= 0.01


def test_chunked_solve_and_lane_compaction_follow_the_one_shot_trajectory():
    """solve_chunk in pieces of 2 equals one uninterrupted solve bitwise,
    lane for lane; lanes taken out with ``take_lanes`` mid-solve go on as in
    the full batch (the adaptive random-effect driver relies on both)."""
    _, td, w0 = _bucket(5)
    _, tcfg = solver_configs("TRON", max_iterations=9, tolerance=1e-7)
    obj = make_glm_objective(pointwise.LogisticLoss)
    one = solve(obj, torch.from_numpy(w0), td, tcfg)
    state = solve_init(obj, torch.from_numpy(w0), td, tcfg)
    assert isinstance(state, TronState)
    for _ in range(5):
        state = solve_chunk(obj, state, td, tcfg, num_iters=2)
    chunked = solve_finalize(state, tcfg)
    for f in dataclasses.fields(one):
        a, b = getattr(one, f.name), getattr(chunked, f.name)
        assert (a is None and b is None) or torch.equal(a.nan_to_num(), b.nan_to_num()), f.name

    # the CPU's elementwise kernels round a lane differently in a batch of
    # another size (vector body against scalar tail), so lanes taken out or
    # solved alone are held to rtol 1e-5 over iterations that cannot stop
    # early
    _, tcfg = solver_configs("TRON", max_iterations=3, tolerance=0.0)
    full = solve(obj, torch.from_numpy(w0), td, tcfg)
    keep = torch.tensor([4, 1, 2])
    state = solve_chunk(obj, solve_init(obj, torch.from_numpy(w0), td, tcfg), td, tcfg,
                        num_iters=1)
    state = state.take_lanes(keep)
    part = solve_finalize(solve_chunk(obj, state, td.take_lanes(keep), tcfg), tcfg)
    np.testing.assert_allclose(part.w.numpy(), full.w[keep].numpy(), rtol=1e-5, atol=1e-7)
    assert torch.equal(part.iterations, full.iterations[keep])


def test_lane_matches_the_problem_solved_alone():
    _, td, w0 = _bucket(7, "counts")
    obj = make_glm_objective(pointwise.PoissonLoss)
    for opt in ({"max_iterations": 3, "tolerance": 0.0}, {}):
        _, tcfg = solver_configs("TRON", **opt)
        batch = solve(obj, torch.from_numpy(w0), td, tcfg)
        for e in range(w0.shape[0]):
            lane = torch.tensor([e])
            alone = solve(obj, torch.from_numpy(w0[e:e + 1]), td.take_lanes(lane), tcfg)
            if opt:
                np.testing.assert_allclose(alone.w.numpy(), batch.w[lane].numpy(), rtol=1e-5,
                                           atol=1e-7)
            else:
                np.testing.assert_allclose(alone.value.numpy(), batch.value[lane].numpy(),
                                           rtol=1e-5)


def test_tracked_coefficients_match_jax():
    jd, td, w0 = _bucket(8)
    jcfg, tcfg = solver_configs("TRON", max_iterations=3, tolerance=0.0,
                                track_coefficients=True)
    jr = jax_vmapped_solve("LogisticLoss", jd, w0, jcfg)
    tr = _solve("LogisticLoss", td, w0, tcfg)
    assert tr.w_history.shape == (w0.shape[0], 4, w0.shape[1])
    np.testing.assert_allclose(tr.w_history.numpy(), np.asarray(jr.w_history), rtol=2e-4,
                               atol=1e-6)
    # the all-padding last lane converged at its initial point
    assert torch.equal(tr.w_history[:-1, 3], tr.w[:-1])

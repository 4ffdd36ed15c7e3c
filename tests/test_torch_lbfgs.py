"""The port's batched L-BFGS against the JAX solver under vmap, on the same
seeded problems.

- w after 3 iterations (tolerance 0, so no lane stops early): rtol 2e-4
  (f32 sums in another order; a few iterations keep the trajectories
  close);
- the converged objective: rtol 1e-4 (a flat optimum leaves w less
  determined than the objective);
- chunked solving follows the one-shot trajectory exactly, inside the port.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from photon_ml_tpu.losses import pointwise as jax_pointwise
from photon_ml_tpu.losses.objective import make_glm_objective as jax_objective
from photon_ml_tpu.ops.data import LabeledData as JaxData
from photon_ml_tpu.ops.features import DenseFeatures as JaxDense
from photon_ml_tpu.ops.features import from_scipy_like as jax_ell
from photon_ml_tpu.opt import config as jax_config
from photon_ml_tpu.opt.solve import solve as jax_solve
from photon_ml_tpu.types import RegularizationType as JaxReg
from photon_ml_tpu_torch.losses import pointwise
from photon_ml_tpu_torch.losses.objective import make_glm_objective
from photon_ml_tpu_torch.ops.data import LabeledData
from photon_ml_tpu_torch.ops.features import DenseFeatures, from_scipy_like
from photon_ml_tpu_torch.opt import config
from photon_ml_tpu_torch.opt.solve import solve, solve_chunk, solve_finalize, solve_init
from photon_ml_tpu_torch.types import ConvergenceReason, RegularizationType

LOSSES = ["LogisticLoss", "SquaredLoss", "PoissonLoss", "SmoothedHingeLoss"]


def _configs(**opt):
    """The same optimization configuration in both packages (L2, λ = 1)."""
    return (
        jax_config.GlmOptimizationConfiguration(
            optimizer_config=jax_config.OptimizerConfig(**opt),
            regularization=jax_config.RegularizationContext(JaxReg.L2),
            regularization_weight=1.0,
        ),
        config.GlmOptimizationConfiguration(
            optimizer_config=config.OptimizerConfig(**opt),
            regularization=config.RegularizationContext(RegularizationType.L2),
            regularization_weight=1.0,
        ),
    )


def _bucket(seed, E=6, s=24, d=5):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((E, s, d)).astype(np.float32)
    y = (rng.random((E, s)) < 0.5).astype(np.float32)
    off = (rng.standard_normal((E, s)) * 0.2).astype(np.float32)
    wt = (rng.random((E, s)) + 0.5).astype(np.float32)
    wt[:, -4:] = 0.0  # padding rows
    wt[-1] = 0.0      # an all-padding entity
    jd = JaxData.create(JaxDense(jnp.asarray(X)), jnp.asarray(y), jnp.asarray(off),
                        jnp.asarray(wt))
    td = LabeledData.create(DenseFeatures(torch.from_numpy(X)), torch.from_numpy(y),
                            torch.from_numpy(off), torch.from_numpy(wt))
    return jd, td, np.zeros((E, d), np.float32)


def _jax_vmapped(loss, jd, w0, cfg):
    obj = jax_objective(getattr(jax_pointwise, loss), use_pallas=False)
    return jax.vmap(lambda w, dd: jax_solve(obj, w, dd, cfg))(jnp.asarray(w0), jd)


@pytest.mark.parametrize("loss", LOSSES)
def test_three_iterations_match_jax_vmap(loss):
    jd, td, w0 = _bucket(LOSSES.index(loss))
    jcfg, tcfg = _configs(max_iterations=3, tolerance=0.0)
    jr = _jax_vmapped(loss, jd, w0, jcfg)
    tr = solve(make_glm_objective(getattr(pointwise, loss)), torch.from_numpy(w0), td, tcfg)
    np.testing.assert_allclose(tr.w.numpy(), np.asarray(jr.w), rtol=2e-4, atol=1e-6)
    np.testing.assert_array_equal(tr.iterations.numpy(), np.asarray(jr.iterations))
    np.testing.assert_array_equal(tr.reason.numpy(), np.asarray(jr.reason))
    np.testing.assert_allclose(tr.value_history.numpy(), np.asarray(jr.value_history),
                               rtol=2e-4)


@pytest.mark.parametrize("loss", LOSSES)
def test_converged_objective_matches_jax_vmap(loss):
    jd, td, w0 = _bucket(10 + LOSSES.index(loss))
    jcfg, tcfg = _configs(max_iterations=100)
    jr = _jax_vmapped(loss, jd, w0, jcfg)
    tr = solve(make_glm_objective(getattr(pointwise, loss)), torch.from_numpy(w0), td, tcfg)
    np.testing.assert_allclose(tr.value.numpy(), np.asarray(jr.value), rtol=1e-4, atol=1e-6)
    assert bool(tr.converged().all())
    assert np.all(tr.reason.numpy() != ConvergenceReason.NOT_CONVERGED.value)


def test_fixed_effect_single_lane_matches_jax():
    """One unbatched sparse problem, one lane: the fixed effect's path."""
    rng = np.random.default_rng(3)
    n, d = 300, 40
    rows = np.repeat(np.arange(n), 6)
    cols = rng.integers(0, d, n * 6)
    vals = rng.standard_normal(n * 6).astype(np.float32)
    y = (rng.random(n) < 0.4).astype(np.float32)
    jd = JaxData.create(jax_ell(rows, cols, vals, (n, d)), jnp.asarray(y))
    td = LabeledData.create(from_scipy_like(rows, cols, vals, (n, d), device="cpu"),
                            torch.from_numpy(y))
    for iters, rtol in ((3, 2e-4), (100, None)):
        jcfg, tcfg = _configs(max_iterations=iters, tolerance=0.0 if rtol else 1e-7)
        jr = jax_solve(jax_objective(jax_pointwise.LogisticLoss, use_pallas=False),
                       jnp.zeros(d), jd, jcfg)
        tr = solve(make_glm_objective(pointwise.LogisticLoss), torch.zeros(1, d), td, tcfg)
        assert tr.w.shape == (1, d)
        if rtol:
            np.testing.assert_allclose(tr.w[0].numpy(), np.asarray(jr.w), rtol=rtol, atol=1e-6)
        else:
            np.testing.assert_allclose(float(tr.value[0]), float(jr.value), rtol=1e-4)


def test_box_constraints_and_bf16_history_match_jax():
    jd, td, w0 = _bucket(21)
    for opt in ({"constraint_lower": -0.05, "constraint_upper": 0.05},
                {"history_dtype": "bfloat16"}):
        jcfg, tcfg = _configs(max_iterations=3, tolerance=0.0, **opt)
        jr = _jax_vmapped("LogisticLoss", jd, w0, jcfg)
        tr = solve(make_glm_objective(pointwise.LogisticLoss), torch.from_numpy(w0), td, tcfg)
        np.testing.assert_allclose(tr.w.numpy(), np.asarray(jr.w), rtol=2e-3, atol=1e-5)
    assert float(tr.w.abs().max()) > 0.05  # the bf16 run is unconstrained


def test_chunked_solve_follows_the_one_shot_trajectory():
    """solve_chunk in pieces of 2 iterations equals one uninterrupted solve,
    bitwise, lane for lane (the adaptive random-effect driver relies on it)."""
    _, td, w0 = _bucket(5)
    _, tcfg = _configs(max_iterations=9, tolerance=1e-7)
    obj = make_glm_objective(pointwise.LogisticLoss)
    one = solve(obj, torch.from_numpy(w0), td, tcfg)
    state = solve_init(obj, torch.from_numpy(w0), td, tcfg)
    for _ in range(5):
        state = solve_chunk(obj, state, td, tcfg, num_iters=2)
    chunked = solve_finalize(state, tcfg)
    for f in dataclasses.fields(one):
        a, b = getattr(one, f.name), getattr(chunked, f.name)
        assert (a is None and b is None) or torch.equal(a.nan_to_num(), b.nan_to_num()), f.name


def test_unported_solvers_raise():
    """The refusals the solvers keep (as the JAX package's): TRON with L1,
    and TRON on the first-order smoothed hinge. TRON and L1 (OWL-QN) alone
    now solve."""
    _, td, w0 = _bucket(1)
    obj = make_glm_objective(pointwise.LogisticLoss)
    tron_l1 = config.GlmOptimizationConfiguration(
        optimizer_config=config.OptimizerConfig.tron(),
        regularization=config.RegularizationContext(RegularizationType.L1),
        regularization_weight=0.5,
    )
    with pytest.raises(ValueError, match="TRON does not support L1"):
        solve(obj, torch.from_numpy(w0), td, tron_l1)
    tron = config.GlmOptimizationConfiguration(optimizer_config=config.OptimizerConfig.tron())
    with pytest.raises(ValueError, match="twice-differentiable"):
        solve(make_glm_objective(pointwise.SmoothedHingeLoss), torch.from_numpy(w0), td, tron)
    l1 = dataclasses.replace(tron_l1, optimizer_config=config.OptimizerConfig())
    for cfg in (tron, l1):
        assert bool(solve(obj, torch.from_numpy(w0), td, cfg).converged().all())

"""TRON and OWL-QN on the card: the solvers over the fused sparse engine's
kernels (csr_matvec_f32, csc_rmatvec_f32) and over batched dense lanes
(fused_value_grad_batched_f32), against the same solves on the CPU through
the plain versions (converged objectives rtol 1e-4: f32 sums in another
order), and against themselves (bitwise repeats on one card); and one
factored random-effect update on the card against the CPU's.

Run on a machine with a card: ``python -m pytest --noconftest
tests/test_torch_solvers_cuda.py``. Without one, every test here skips.
"""

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.losses import pointwise
from photon_ml_tpu_torch.losses.objective import make_glm_objective
from photon_ml_tpu_torch.ops import fused_perm, launches
from photon_ml_tpu_torch.ops.data import LabeledData
from photon_ml_tpu_torch.ops.features import DenseFeatures, from_scipy_like
from photon_ml_tpu_torch.opt.config import (
    GlmOptimizationConfiguration,
    OptimizerConfig,
    RegularizationContext,
)
from photon_ml_tpu_torch.opt.solve import solve, solve_chunk, solve_finalize, solve_init
from photon_ml_tpu_torch.types import RegularizationType

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _config(optimizer, reg, alpha=None, **opt):
    make = OptimizerConfig.tron if optimizer == "TRON" else OptimizerConfig.lbfgs
    return GlmOptimizationConfiguration(
        optimizer_config=make(**opt),
        regularization=RegularizationContext(reg, alpha=alpha), regularization_weight=1.0,
    )


CASES = {
    "tron_logistic": ("LogisticLoss", _config("TRON", RegularizationType.L2)),
    "owlqn_poisson_box": ("PoissonLoss", _config("LBFGS", RegularizationType.ELASTIC_NET, 0.5,
                                                 constraint_lower=-2.0, constraint_upper=2.0)),
}
# the fixed-effect problem's own box, active at its optimum; the dense
# lanes keep [-2, 2], inactive there: an active box can stop a small lane's
# backtracking (OBJECTIVE_NOT_IMPROVING) at a point that depends on f32
# rounding, in the reference as here
FE_BOX = {"constraint_lower": -0.5, "constraint_upper": 0.5}


def _sparse_problem(n=1 << 16, dim=1 << 12, k=8, seed=0):
    rng = np.random.default_rng(seed)
    cols = np.concatenate([rng.integers(0, dim, (n, k)), np.full((n, 1), dim)], 1)
    vals = np.concatenate([rng.standard_normal((n, k)) / np.sqrt(k), np.ones((n, 1))], 1)
    w = rng.standard_normal(dim + 1) * 0.5
    z = (vals * w[cols]).sum(1)
    y = {"LogisticLoss": (rng.random(n) < 1 / (1 + np.exp(-z))),
         "PoissonLoss": rng.poisson(np.exp(0.5 * z))}
    rows = np.repeat(np.arange(n), k + 1)
    return rows, cols.ravel(), vals.ravel().astype(np.float32), (n, dim + 1), y


@pytest.mark.parametrize("case", list(CASES))
def test_fixed_effect_solve_on_the_fused_engine(card, case):
    loss, cfg = CASES[case]
    if case == "owlqn_poisson_box":
        cfg = _config("LBFGS", RegularizationType.ELASTIC_NET, 0.5, **FE_BOX)
    rows, cols, vals, shape, ys = _sparse_problem()
    y = ys[loss].astype(np.float32)
    obj = make_glm_objective(getattr(pointwise, loss))
    cuda = LabeledData.create(fused_perm.from_coo(rows, cols, vals, shape, device=card),
                              torch.from_numpy(y).to(card))
    cpu = LabeledData.create(from_scipy_like(rows, cols, vals, shape, device="cpu"),
                             torch.from_numpy(y))
    before = launches.counts()
    res = solve(obj, torch.zeros(1, shape[1], device=card), cuda, cfg)
    torch.cuda.synchronize()
    after = launches.counts()
    for kernel in ("csr_matvec_f32", "csc_rmatvec_f32"):
        assert after[kernel] > before[kernel], kernel
    again = solve(obj, torch.zeros(1, shape[1], device=card), cuda, cfg)
    assert torch.equal(res.w, again.w) and torch.equal(res.value, again.value)
    ref = solve(obj, torch.zeros(1, shape[1]), cpu, cfg)
    np.testing.assert_allclose(float(res.value[0]), float(ref.value[0]), rtol=1e-4)
    if case == "owlqn_poisson_box":
        assert float(res.w.abs().max()) <= 0.5


@pytest.mark.parametrize("case", list(CASES))
def test_batched_lanes_on_the_card(card, case):
    """Dense lanes (the random-effect path: fused_value_grad_batched_f32 for
    value and gradient): the batch against the CPU, and lanes taken out
    mid-solve against the full batch."""
    loss, cfg = CASES[case]
    rng = np.random.default_rng(1)
    E, s, d = 512, 24, 8
    X = rng.standard_normal((E, s, d)).astype(np.float32)
    y = (rng.random((E, s)) < 0.5).astype(np.float32) if loss == "LogisticLoss" else \
        rng.poisson(1.5, (E, s)).astype(np.float32)
    wt = np.ones((E, s), np.float32)
    wt[:, -3:] = 0.0

    def data(dev):
        return LabeledData.create(DenseFeatures(torch.from_numpy(X).to(dev)),
                                  torch.from_numpy(y).to(dev),
                                  weights=torch.from_numpy(wt).to(dev))

    obj = make_glm_objective(getattr(pointwise, loss))
    before = launches.counts()["fused_value_grad_batched_f32"]
    res = solve(obj, torch.zeros(E, d, device=card), data(card), cfg)
    torch.cuda.synchronize()
    assert launches.counts()["fused_value_grad_batched_f32"] > before
    ref = solve(obj, torch.zeros(E, d), data("cpu"), cfg)
    np.testing.assert_allclose(res.value.cpu().numpy(), ref.value.numpy(), rtol=1e-4)
    keep = torch.arange(0, E, 5, device=card)
    state = solve_chunk(obj, solve_init(obj, torch.zeros(E, d, device=card), data(card), cfg),
                        data(card), cfg, num_iters=2).take_lanes(keep)
    part = solve_finalize(solve_chunk(obj, state, data(card).take_lanes(keep), cfg), cfg)
    np.testing.assert_allclose(part.value.cpu().numpy(), res.value[keep].cpu().numpy(),
                               rtol=1e-5)


def _factored_coordinate(dev):
    """A factored coordinate (k = 3, 2 MF iterations) over a seeded
    low-rank problem of 12 entities in 2 buckets, on ``dev``."""
    from photon_ml_tpu_torch.algorithm import factored_random_effect as fre
    from photon_ml_tpu_torch.data.random_effect import (
        RandomEffectDataConfiguration,
        build_random_effect_dataset,
    )
    from photon_ml_tpu_torch.types import TaskType

    rng = np.random.default_rng(0)
    n, d = 400, 15
    X = (rng.standard_normal((n, d)) * (rng.random((n, d)) < 0.3)).astype(np.float32)
    e_of = rng.integers(0, 12, n)
    w = (rng.standard_normal((d, 2)) @ rng.standard_normal((2, 12))).T  # [12, d], rank 2
    z = np.einsum("nd,nd->n", X, w[e_of])
    y = (z > 0).astype(np.float32)
    rows, cols = np.nonzero(X)
    ds = build_random_effect_dataset(
        np.array([f"e{e}" for e in e_of]), rows, cols, X[rows, cols], d, y,
        RandomEffectDataConfiguration("e", num_buckets=2), device=dev,
    )
    cfg = _config("LBFGS", RegularizationType.L2, max_iterations=30)
    return fre.FactoredRandomEffectCoordinate(
        ds, TaskType.LOGISTIC_REGRESSION, cfg, cfg, fre.MFOptimizationConfiguration(3, 2),
        torch.zeros(n, device=dev),
    )


def test_factored_update_on_the_card(card):
    """One factored update on the card (its latent solves through
    fused_value_grad_batched_f32 at width 3, its B solve over KronFeatures'
    segmented sums) against the same update on the CPU (B atol 2e-3), and
    against itself (bitwise)."""
    host, dev = _factored_coordinate("cpu"), _factored_coordinate(card)
    want = host.update_model_device(None, torch.zeros(host.dataset.num_rows))
    before = launches.counts()["fused_value_grad_batched_f32"]
    got = dev.update_model_device(None, torch.zeros(dev.dataset.num_rows, device=card))
    again = dev.update_model_device(None, torch.zeros(dev.dataset.num_rows, device=card))
    assert launches.counts()["fused_value_grad_batched_f32"] > before
    np.testing.assert_allclose(got.projection_matrix.cpu().numpy(),
                               want.projection_matrix.numpy(), rtol=0, atol=2e-3)
    assert torch.equal(got.projection_matrix, again.projection_matrix)
    assert torch.equal(dev.score_device(got), dev.score_device(again))

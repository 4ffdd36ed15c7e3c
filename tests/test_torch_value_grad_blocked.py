"""The port's blocked dense value+gradient pass (``fused_value_grad``, the
reference's K7) against the JAX package's Pallas kernel run by the
interpreter, and the objective's routing of a lone dense problem through
the single-block kernel.

Inputs from a seeded numpy generator: labels mostly 0 and offsets with a
positive mean, so every loss's Σ dz stays well away from 0; a fifth of the
rows weight 0, some with an offset of 1e20 whose unweighted loss overflows.
Tolerances (f32 sums in another order): value rtol 2e-4; gradient rtol
2e-4 with atol 2e-5·max|g|; csum rtol 2e-4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_ml_tpu.losses import pointwise as jax_pointwise
from photon_ml_tpu.losses.objective import make_glm_objective as jax_objective
from photon_ml_tpu.ops import pallas_kernels as jax_kernels
from photon_ml_tpu.ops.data import LabeledData as JaxData
from photon_ml_tpu.ops.features import DenseFeatures as JaxDense
from photon_ml_tpu_torch.losses import pointwise
from photon_ml_tpu_torch.losses.objective import make_glm_objective
from photon_ml_tpu_torch.ops import launches, pallas_kernels
from photon_ml_tpu_torch.ops.data import LabeledData
from photon_ml_tpu_torch.ops.features import DenseFeatures

LOSSES = ["LogisticLoss", "SquaredLoss", "PoissonLoss", "SmoothedHingeLoss"]
# (700, 37): n % 256 and d % 128 both ragged; (1000, 130) over four
# reference row blocks; (513, 129) one row past a block, one column past a lane tile
SHAPES = [(700, 37), (1000, 130), (513, 129)]


def _inputs(seed, n, d):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)
    y = (rng.random(n) < 0.2).astype(np.float32)
    off = (rng.standard_normal(n) * 0.3 + 0.5).astype(np.float32)
    wt = (rng.random(n) + 0.5).astype(np.float32)
    zero = rng.random(n) < 0.2
    wt[zero] = 0.0
    off[zero & (rng.random(n) < 0.25)] = 1e20
    w = (rng.standard_normal(d) * 0.3).astype(np.float32)
    return X, y, off, wt, w


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("loss", LOSSES)
def test_fused_value_grad_matches_jax_blocked_kernel(loss, shape):
    n, d = shape
    inputs = _inputs(LOSSES.index(loss) * 10 + SHAPES.index(shape), n, d)
    jv, jg, jc = (np.asarray(t) for t in jax_kernels.fused_value_grad(
        *(jnp.asarray(a) for a in inputs), kind=getattr(jax_pointwise, loss), interpret=True))
    before = launches.counts()[pallas_kernels.KERNEL_BLOCKED]
    tv, tg, tc = pallas_kernels.fused_value_grad(
        *(torch.from_numpy(a) for a in inputs), kind=getattr(pointwise, loss))
    assert launches.counts()[pallas_kernels.KERNEL_BLOCKED] == before  # CPU: plain version
    assert tv.shape == () and tc.shape == () and tg.shape == (d,)
    for t in (tv, tg, tc):
        assert bool(torch.isfinite(t).all())
    np.testing.assert_allclose(tv.numpy(), jv, rtol=2e-4)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=2e-4, atol=2e-5 * np.abs(jg).max())
    np.testing.assert_allclose(tc.numpy(), jc, rtol=2e-4)


def test_fused_value_grad_checks_its_operands():
    X, y, off, wt, w = (torch.from_numpy(a) for a in _inputs(0, 40, 6))
    with pytest.raises(ValueError, match="kind"):
        pallas_kernels.fused_value_grad(X, y, off, wt, w)
    with pytest.raises(ValueError, match=r"\[n, d\]"):
        pallas_kernels.fused_value_grad_f32(X[None], y, off, wt, w, pointwise.LogisticLoss)
    with pytest.raises(ValueError, match="shape"):
        pallas_kernels.fused_value_grad_f32(X, y, off, wt, w[:5], pointwise.LogisticLoss)
    # the public entry casts and packs, as the reference's does
    v64 = pallas_kernels.fused_value_grad(X.double(), y, off, wt, w, kind=pointwise.SquaredLoss)
    v32 = pallas_kernels.fused_value_grad(X, y, off, wt, w, kind=pointwise.SquaredLoss)
    assert all(torch.equal(a, b) for a, b in zip(v64, v32))


@pytest.mark.parametrize("loss", LOSSES)
def test_lone_dense_problem_routes_through_the_single_block_kernel(loss, monkeypatch):
    """A 2-D dense problem under LONE_PROBLEM_MAX_ELEMENTS takes the fused
    route (a batch of one), as in the reference; its value and gradient
    equal the plain maps' and the JAX objective's."""
    X, y, off, wt, w = _inputs(50 + LOSSES.index(loss), 300, 24)
    data = LabeledData.create(DenseFeatures(torch.from_numpy(X)), torch.from_numpy(y),
                              torch.from_numpy(off), torch.from_numpy(wt))
    obj = make_glm_objective(getattr(pointwise, loss))
    calls = []
    routed = pallas_kernels.fused_value_grad_auto
    monkeypatch.setattr(pallas_kernels, "fused_value_grad_auto",
                        lambda *a: calls.append(a[0].shape) or routed(*a))
    fv, fg = obj.value_and_grad(torch.from_numpy(w), data, 0.7)
    assert calls == [(300, 24)]
    monkeypatch.setattr(pallas_kernels, "fused_value_grad_auto", lambda *a: None)
    pv, pg = obj.value_and_grad(torch.from_numpy(w), data, 0.7)
    np.testing.assert_allclose(fv.numpy(), pv.numpy(), rtol=2e-4)
    np.testing.assert_allclose(fg.numpy(), pg.numpy(), rtol=2e-4,
                               atol=2e-5 * float(pg.abs().max()))
    jd = JaxData.create(JaxDense(jnp.asarray(X)), jnp.asarray(y), jnp.asarray(off),
                        jnp.asarray(wt))
    jv, jg = jax_objective(getattr(jax_pointwise, loss), use_pallas=False).value_and_grad(
        jnp.asarray(w), jd, jnp.float32(0.7))
    np.testing.assert_allclose(fv.numpy(), np.asarray(jv), rtol=2e-4)
    np.testing.assert_allclose(fg.numpy(), np.asarray(jg), rtol=2e-4,
                               atol=2e-5 * float(np.abs(np.asarray(jg)).max()))

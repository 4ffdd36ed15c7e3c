"""Feature statistics (stat/summary.py) and normalization contexts of the
port against the JAX package's.

``summarize`` over the dense, ELL, Benes, column-split and fused layouts
of one seeded matrix, with integer row weights (zeros among them): mean to
rtol 1e-5 of the column's mean |x| (a sum of a few f32 terms of either sign
in another order can cancel, so its own magnitude is no scale), variance
rtol 1e-4, min / max / nonzero counts / count exactly (the weighted counts
are sums of small integers). ``build_normalization_context`` for all three
types and the coefficient back- and inverse transforms to rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu import normalization as jax_norm
from photon_ml_tpu.ops import features as jax_features
from photon_ml_tpu.ops import sparse_perm as jax_sparse_perm
from photon_ml_tpu.ops.data import LabeledData as JaxLabeledData
from photon_ml_tpu.stat.summary import summarize as jax_summarize
from photon_ml_tpu.types import NormalizationType as JaxNormType
from photon_ml_tpu_torch import normalization
from photon_ml_tpu_torch.convert import normalization_context_from_numpy
from photon_ml_tpu_torch.ops import features, fused_perm, sparse_perm
from photon_ml_tpu_torch.ops.data import LabeledData
from photon_ml_tpu_torch.stat.summary import summarize
from photon_ml_tpu_torch.types import NormalizationType

N, D = 240, 400


def _coo(seed):
    """8 nonzeros a row over columns 1..D-60 (the last 60 columns empty),
    an intercept column 0, a column of constant 3.0, exact zeros stored."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(N), 8)
    cols = rng.integers(2, D - 60, N * 8)
    vals = rng.standard_normal(N * 8).astype(np.float32)
    vals[::11] = 0.0
    rows = np.concatenate([rows, np.arange(N), np.arange(0, N, 3)])
    cols = np.concatenate([cols, np.zeros(N, np.int64), np.ones(N // 3, np.int64)])
    vals = np.concatenate([vals, np.ones(N, np.float32), np.full(N // 3, 3.0, np.float32)])
    weights = rng.integers(0, 3, N).astype(np.float32)  # 0, 1, 2
    return rows, cols, vals, weights


def _layouts(rows, cols, vals):
    """(port features, JAX features) of each layout; the port's fused engine
    is held against the JAX ELL layout."""
    shape = (N, D)
    dense = np.zeros(shape, np.float32)
    np.add.at(dense, (rows, cols), vals)
    return {
        "dense": (features.DenseFeatures(torch.from_numpy(dense)),
                  jax_features.DenseFeatures(jnp.asarray(dense))),
        "ell": (features.from_scipy_like(rows, cols, vals, shape, device="cpu"),
                jax_features.from_scipy_like(rows, cols, vals, shape)),
        "benes": (sparse_perm.from_coo(rows, cols, vals, shape, plan_cache="", device="cpu",
                                       col_split=1, kp_cap=2),
                  jax_sparse_perm.from_coo(rows, cols, vals, shape, plan_cache="",
                                           col_split=1, kp_cap=2)),
        "split": (sparse_perm.from_coo(rows, cols, vals, shape, plan_cache="", device="cpu",
                                       col_split=4),
                  jax_sparse_perm.from_coo(rows, cols, vals, shape, plan_cache="",
                                           col_split=4)),
        "fused": (fused_perm.from_coo(rows, cols, vals, shape, device="cpu"),
                  jax_features.from_scipy_like(rows, cols, vals, shape)),
    }


def _assert_summaries_equal(got, want):
    g = {k: getattr(got, k).numpy() for k in
         ("mean", "variance", "num_nonzeros", "max_abs", "min_val", "max_val", "mean_abs")}
    w = {k: np.asarray(getattr(want, k)) for k in g}
    assert np.all(np.abs(g["mean"] - w["mean"]) <= 1e-5 * np.maximum(w["mean_abs"], 1e-30))
    np.testing.assert_allclose(g["mean_abs"], w["mean_abs"], rtol=1e-5)
    np.testing.assert_allclose(g["variance"], w["variance"], rtol=1e-4, atol=1e-12)
    for k in ("num_nonzeros", "max_abs", "min_val", "max_val"):
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert float(got.count) == float(want.count)


@pytest.mark.parametrize("layout", ["dense", "ell", "benes", "split", "fused"])
def test_summarize_equals_jax(layout):
    rows, cols, vals, weights = _coo(1)
    tf, jf = _layouts(rows, cols, vals)[layout]
    labels = np.zeros(N, np.float32)
    got = summarize(LabeledData.create(tf, torch.from_numpy(labels),
                                       weights=torch.from_numpy(weights)))
    want = jax_summarize(JaxLabeledData.create(jf, jnp.asarray(labels),
                                               weights=jnp.asarray(weights)))
    _assert_summaries_equal(got, want)
    # the intercept: mean 1, no spread; the constant column 3.0 with zeros
    assert float(got.mean[0]) == 1.0 and float(got.variance[0]) == 0.0
    assert float(got.max_val[1]) == 3.0 and float(got.min_val[1]) == 0.0
    # empty columns summarize to zeros
    assert not got.max_abs[-60:].any() and not got.num_nonzeros[-60:].any()


def test_layouts_agree_with_each_other():
    rows, cols, vals, weights = _coo(2)
    labels = torch.zeros(N)
    w = torch.from_numpy(weights)
    out = {name: summarize(LabeledData.create(tf, labels, weights=w))
           for name, (tf, _) in _layouts(rows, cols, vals).items()}
    for name in ("ell", "benes", "split", "fused"):
        for k in ("num_nonzeros", "min_val", "max_val"):
            assert torch.equal(getattr(out[name], k), getattr(out["dense"], k)), (name, k)
        np.testing.assert_allclose(out[name].variance.numpy(), out["dense"].variance.numpy(),
                                   rtol=1e-4, atol=1e-12)


def _stats(seed, d=30):
    rng = np.random.default_rng(seed)
    mean = rng.standard_normal(d).astype(np.float32)
    var = rng.random(d).astype(np.float32) + 0.1
    var[3] = 0.0  # a constant feature keeps factor 1
    mm = (np.abs(rng.standard_normal(d)) + 0.1).astype(np.float32)
    mm[5] = 0.0
    return mean, var, mm


@pytest.mark.parametrize("kind", ["SCALE_WITH_STANDARD_DEVIATION", "SCALE_WITH_MAX_MAGNITUDE",
                                  "STANDARDIZATION"])
@pytest.mark.parametrize("intercept", [None, 7])
def test_normalization_context_equals_jax(kind, intercept):
    if kind == "STANDARDIZATION" and intercept is None:
        with pytest.raises(ValueError, match="intercept"):
            normalization.build_normalization_context(
                NormalizationType[kind], *map(torch.from_numpy, _stats(0)), None)
        return
    mean, var, mm = _stats(1)
    got = normalization.build_normalization_context(
        NormalizationType[kind], torch.from_numpy(mean), torch.from_numpy(var),
        torch.from_numpy(mm), intercept)
    want = jax_norm.build_normalization_context(
        JaxNormType[kind], jnp.asarray(mean), jnp.asarray(var), jnp.asarray(mm), intercept)
    for name in ("factor", "shift"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if g is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    # carried across from the JAX context, it is the same context
    carried = normalization_context_from_numpy(
        np.asarray(want.factor), None if want.shift is None else np.asarray(want.shift),
        device="cpu")
    np.testing.assert_allclose(carried.factor.numpy(), got.factor.numpy(), rtol=1e-6)

    rng = np.random.default_rng(2)
    w_norm = rng.standard_normal(mean.size).astype(np.float32)
    v_norm = (rng.random(mean.size) + 0.5).astype(np.float32)
    w_orig = got.transform_model_coefficients(torch.from_numpy(w_norm), intercept)
    np.testing.assert_allclose(
        w_orig.numpy(),
        np.asarray(want.transform_model_coefficients(jnp.asarray(w_norm), intercept)), rtol=1e-6)
    np.testing.assert_allclose(
        got.inverse_transform_model_coefficients(w_orig, intercept).numpy(), w_norm,
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        got.inverse_transform_model_coefficients(torch.from_numpy(w_norm), intercept).numpy(),
        np.asarray(want.inverse_transform_model_coefficients(jnp.asarray(w_norm), intercept)),
        rtol=1e-6)
    np.testing.assert_allclose(
        got.transform_model_variances(torch.from_numpy(v_norm), intercept).numpy(),
        np.asarray(want.transform_model_variances(jnp.asarray(v_norm), intercept)), rtol=1e-6)


def test_none_normalization_is_the_identity():
    ctx = normalization.build_normalization_context(
        NormalizationType.NONE, torch.zeros(3), torch.ones(3), torch.ones(3), None)
    assert ctx.is_identity
    w = torch.tensor([1.0, -2.0, 3.0])
    assert torch.equal(ctx.transform_model_coefficients(w, None), w)
    assert torch.equal(ctx.inverse_transform_model_coefficients(w, None), w)

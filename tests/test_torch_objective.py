"""The port's GLM objective, its sparse rmatvec maps and the fused
value+gradient pass against the JAX package, on the same seeded inputs.

- value / gradient / Hv / diag(H) for the four losses, with and without a
  normalization context, over dense and ELL features, with weight-0 rows
  whose loss overflows: rtol 2e-4 (Hessian terms 1e-2), f32 sums taken in
  another order.
- ``FusedSparseFeatures._rmatvec_impl`` (all four transforms) and the ELL
  rmatvec maps against the JAX fused engine run through the Pallas
  interpreter: atol 1e-5·max(1, Σ|t(v)·c|) per column.
- the fused kernel's plain version against ``fused_value_grad_single``
  (interpret mode) under ``jax.vmap``: rtol 2e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from photon_ml_tpu.losses import pointwise as jax_pointwise
from photon_ml_tpu.losses.objective import make_glm_objective as jax_objective
from photon_ml_tpu.normalization import NormalizationContext as JaxNorm
from photon_ml_tpu.ops import fused_perm as jax_fused
from photon_ml_tpu.ops import pallas_kernels as jax_kernels
from photon_ml_tpu.ops.data import LabeledData as JaxData
from photon_ml_tpu.ops.features import DenseFeatures as JaxDense
from photon_ml_tpu.ops.features import from_scipy_like as jax_ell
from photon_ml_tpu_torch.losses import pointwise
from photon_ml_tpu_torch.losses.objective import make_glm_objective
from photon_ml_tpu_torch.normalization import NormalizationContext
from photon_ml_tpu_torch.ops import fused_perm, launches, pallas_kernels
from photon_ml_tpu_torch.ops.data import LabeledData
from photon_ml_tpu_torch.ops.features import DenseFeatures, from_scipy_like

RTOL, ATOL = 2e-4, 1e-5
LOSSES = ["LogisticLoss", "SquaredLoss", "PoissonLoss", "SmoothedHingeLoss"]
NORMS = ["none", "factor", "factor_shift"]


def _problem(seed, n=64, d=12, k=5):
    """COO features (intercept in column 0), labels, offsets, weights with a
    few weight-0 rows whose offset makes the squared/Poisson loss overflow,
    coefficients and a direction."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), k)
    cols = np.concatenate([np.zeros((n, 1), int), rng.integers(1, d, (n, k - 1))], 1).ravel()
    vals = np.concatenate(
        [np.ones((n, 1)), rng.standard_normal((n, k - 1)) * 0.5], 1
    ).ravel().astype(np.float32)
    labels = (rng.random(n) < 0.5).astype(np.float32)
    offsets = (rng.standard_normal(n) * 0.3).astype(np.float32)
    weights = (rng.random(n) + 0.5).astype(np.float32)
    weights[:6] = 0.0
    offsets[:3] = 1e20
    w = (rng.standard_normal(d) * 0.3).astype(np.float32)
    v = rng.standard_normal(d).astype(np.float32)
    factor = (rng.random(d) + 0.5).astype(np.float32)
    shift = (rng.standard_normal(d) * 0.2).astype(np.float32)
    factor[0], shift[0] = 1.0, 0.0
    return dict(rows=rows, cols=cols, vals=vals, shape=(n, d), labels=labels,
                offsets=offsets, weights=weights, w=w, v=v, factor=factor, shift=shift)


def _both(p, layout, norm):
    """The same batch as JAX LabeledData and as the port's."""
    n, d = p["shape"]
    if layout == "dense":
        dense = np.zeros((n, d), np.float32)
        np.add.at(dense, (p["rows"], p["cols"]), p["vals"])
        jf = JaxDense(jnp.asarray(dense))
        tf = DenseFeatures(torch.from_numpy(dense))
    else:
        jf = jax_ell(p["rows"], p["cols"], p["vals"], p["shape"])
        tf = from_scipy_like(p["rows"], p["cols"], p["vals"], p["shape"], device="cpu")
    jn = tn = None
    if norm != "none":
        shift = p["shift"] if norm == "factor_shift" else None
        jn = JaxNorm(factor=jnp.asarray(p["factor"]),
                     shift=None if shift is None else jnp.asarray(shift))
        tn = NormalizationContext(factor=torch.from_numpy(p["factor"]),
                                  shift=None if shift is None else torch.from_numpy(shift))
    jd = JaxData.create(jf, jnp.asarray(p["labels"]), jnp.asarray(p["offsets"]),
                        jnp.asarray(p["weights"]), norm=jn)
    td = LabeledData.create(tf, torch.from_numpy(p["labels"]), torch.from_numpy(p["offsets"]),
                            torch.from_numpy(p["weights"]), norm=tn)
    return jd, td


@pytest.mark.parametrize("layout", ["dense", "ell"])
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("loss", LOSSES)
def test_objective_matches_jax(loss, norm, layout):
    p = _problem(LOSSES.index(loss) * 10 + NORMS.index(norm) * 2 + (layout == "ell"))
    jd, td = _both(p, layout, norm)
    jobj = jax_objective(getattr(jax_pointwise, loss), use_pallas=False)
    tobj = make_glm_objective(getattr(pointwise, loss))
    l2 = 0.7
    jw, tw = jnp.asarray(p["w"]), torch.from_numpy(p["w"])
    jv, tv = jnp.asarray(p["v"]), torch.from_numpy(p["v"])

    tval = tobj.value(tw, td, l2)
    tf, tg = tobj.value_and_grad(tw, td, l2)
    jf, jg = jobj.value_and_grad(jw, jd, l2)
    assert np.isfinite(float(tf)) and bool(torch.isfinite(tg).all())
    np.testing.assert_allclose(float(tval), float(jobj.value(jw, jd, l2)), rtol=RTOL)
    np.testing.assert_allclose(float(tf), float(jf), rtol=RTOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(
        tobj.hessian_vec(tw, tv, td, l2).numpy(),
        np.asarray(jobj.hessian_vec(jw, jv, jd, l2)), rtol=1e-2, atol=1e-4,
    )
    np.testing.assert_allclose(
        tobj.hessian_diag(tw, td, l2).numpy(),
        np.asarray(jobj.hessian_diag(jw, jd, l2)), rtol=1e-2, atol=1e-4,
    )


@pytest.mark.parametrize("loss", LOSSES)
def test_batched_dense_objective_matches_jax_vmap(loss):
    """A bucket of dense problems [E, s, d] through the port's batched
    objective (the fused kernel's plain version on the CPU) against the JAX
    objective under vmap; its Hv and diag(H) through the batched maps."""
    rng = np.random.default_rng(7)
    E, s, d = 5, 9, 4
    X = rng.standard_normal((E, s, d)).astype(np.float32)
    y = (rng.random((E, s)) < 0.5).astype(np.float32)
    off = (rng.standard_normal((E, s)) * 0.3).astype(np.float32)
    wt = (rng.random((E, s)) + 0.5).astype(np.float32)
    wt[:, -2:] = 0.0
    off[:, -1] = 1e20
    w = rng.standard_normal((E, d)).astype(np.float32)
    v = rng.standard_normal((E, d)).astype(np.float32)
    jobj = jax_objective(getattr(jax_pointwise, loss), use_pallas=False)
    tobj = make_glm_objective(getattr(pointwise, loss))
    jd = JaxData.create(JaxDense(jnp.asarray(X)), jnp.asarray(y), jnp.asarray(off),
                        jnp.asarray(wt))
    td = LabeledData.create(DenseFeatures(torch.from_numpy(X)), torch.from_numpy(y),
                            torch.from_numpy(off), torch.from_numpy(wt))
    jf, jg = jax.vmap(jobj.value_and_grad, in_axes=(0, 0, None))(jnp.asarray(w), jd, 0.5)
    tf, tg = tobj.value_and_grad(torch.from_numpy(w), td, 0.5)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=RTOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL, atol=1e-5)
    jh = jax.vmap(jobj.hessian_vec, in_axes=(0, 0, 0, None))(jnp.asarray(w), jnp.asarray(v), jd, 0.5)
    th = tobj.hessian_vec(torch.from_numpy(w), torch.from_numpy(v), td, 0.5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-2, atol=1e-5)
    jdg = jax.vmap(jobj.hessian_diag, in_axes=(0, 0, None))(jnp.asarray(w), jd, 0.5)
    tdg = tobj.hessian_diag(torch.from_numpy(w), td, 0.5)
    np.testing.assert_allclose(tdg.numpy(), np.asarray(jdg), rtol=1e-2, atol=1e-5)


@pytest.fixture
def interpret_kernels():
    old = jax_fused._INTERPRET
    jax_fused._INTERPRET = True
    yield
    jax_fused._INTERPRET = old


def _sparse_case(seed, case):
    rng = np.random.default_rng(seed)
    n, d, nnz = 1024, 600, 6000
    rows = rng.integers(0, n, nnz)
    cols = rng.integers(0, d, nnz)
    if case == "duplicates":
        rows = np.concatenate([rows, rows[:500]])
        cols = np.concatenate([cols, cols[:500]])
    elif case == "long_column":  # a column holding every row, like an intercept
        rows = np.concatenate([rows, np.arange(n)])
        cols = np.concatenate([cols, np.full(n, 7)])
    elif case == "empty_columns":
        keep = cols % 4 != 0
        rows, cols = rows[keep], cols[keep]
    vals = rng.standard_normal(rows.size).astype(np.float32)
    vals[::97] = 0.0  # stored zeros: the "nnz" transform counts them out
    c = rng.standard_normal(n).astype(np.float32)
    return rows, cols, vals, (n, d), c


TRANSFORMS = {"id": lambda v: v, "sq": lambda v: v * v, "abs": np.abs,
              "nnz": lambda v: (v != 0).astype(v.dtype)}


@pytest.mark.parametrize("transform", list(TRANSFORMS))
@pytest.mark.parametrize("case", ["plain", "duplicates", "long_column", "empty_columns"])
def test_rmatvec_matches_jax_fused_engine(interpret_kernels, case, transform):
    rows, cols, vals, shape, c = _sparse_case(23, case)
    jf = jax_fused.from_coo(rows, cols, vals, shape, size_floor=128 * 128, plan_cache="",
                            max_hot_cols=0)
    assert jf._fused_ok()  # the Pallas kernels run, not the XLA fallback
    g_jax = np.asarray(jf._rmatvec_impl(jnp.asarray(c), transform))

    feats = fused_perm.from_coo(rows, cols, vals, shape, device="cpu")
    before = launches.counts()[fused_perm.KERNEL_T]
    g = feats._rmatvec_impl(torch.from_numpy(c), transform).numpy()
    assert launches.counts()[fused_perm.KERNEL_T] == before  # CPU: plain version

    dense = np.zeros(shape, np.float64)
    np.add.at(dense, (rows, cols), vals.astype(np.float64))
    t_dense = TRANSFORMS[transform](dense)
    col_abs = np.abs(t_dense).T @ np.abs(c.astype(np.float64))
    tol = 1e-5 * np.maximum(1.0, col_abs)
    assert np.all(np.abs(g - g_jax) <= tol)
    assert np.all(np.abs(g - t_dense.T @ c) <= tol)
    if transform in ("id", "sq"):
        ell = from_scipy_like(rows, cols, vals, shape, device="cpu")
        g_ell = (ell.rmatvec if transform == "id" else ell.rmatvec_sq)(torch.from_numpy(c))
        je = jax_ell(rows, cols, vals, shape)
        g_jell = (je.rmatvec if transform == "id" else je.rmatvec_sq)(jnp.asarray(c))
        assert np.all(np.abs(g_ell.numpy() - np.asarray(g_jell)) <= tol)
        assert np.all(np.abs(g_ell.numpy() - g) <= tol)


def test_csc_layout_and_segments():
    rows = np.array([2, 0, 2, 2, 1])
    cols = np.array([1, 3, 1, 0, 1])
    vals = np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32)
    f = fused_perm.from_coo(rows, cols, vals, (3, 5), device="cpu")
    assert f.col_ptr.tolist() == [0, 1, 3, 3, 4, 4]
    assert f.row_idx.tolist() == [2, 1, 2, 0]
    assert f.vals_csc.tolist() == [4.0, 5.0, 4.0, 2.0]
    assert f.row_idx.dtype == torch.int32 and f.col_ptr.dtype == torch.int64
    # one column past SHORT_MAX, cut into two segments
    long = fused_perm.SEGMENT + 1
    col_ptr = torch.tensor([0, 3, 3 + long, 3 + long + fused_perm.SHORT_MAX])
    seg = fused_perm.CscSegments.of(col_ptr)
    assert seg.long_cols.tolist() == [1]
    assert seg.seg_begin.tolist() == [3, 3 + fused_perm.SEGMENT]
    assert seg.seg_end.tolist() == [3 + fused_perm.SEGMENT, 3 + long]
    assert seg.seg_ptr.tolist() == [0, 2]


def test_csc_wrapper_rejects_bad_operands():
    f = fused_perm.from_coo([0], [1], [1.0], (2, 3), device="cpu")
    with pytest.raises(ValueError, match="entries"):
        f.rmatvec(torch.zeros(3))
    with pytest.raises(TypeError, match="float32"):
        f.rmatvec(torch.zeros(2, dtype=torch.float64))
    with pytest.raises(ValueError, match="transform"):
        f._rmatvec_impl(torch.zeros(2), "cube")


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("shape", [(1, 1, 1), (3, 17, 5), (4, 8, 130)])
def test_fused_value_grad_plain_matches_jax_kernel(loss, shape):
    E, s, d = shape
    rng = np.random.default_rng(E * 100 + s + d)
    X = (rng.standard_normal((E, s, d)) / np.sqrt(d)).astype(np.float32)
    y = (rng.random((E, s)) < 0.5).astype(np.float32)
    off = (rng.standard_normal((E, s)) * 0.3).astype(np.float32)
    wt = (rng.random((E, s)) + 0.5).astype(np.float32)
    if s > 1:
        wt[:, 0] = 0.0
        off[:, 0] = 1e20  # squared / Poisson overflow on a weight-0 row
    w = rng.standard_normal((E, d)).astype(np.float32)
    kernel = jax.vmap(
        lambda *a: jax_kernels.fused_value_grad_single(
            *a, kind=getattr(jax_pointwise, loss), interpret=True
        )
    )
    jv, jg, jc = kernel(*(jnp.asarray(a) for a in (X, y, off, wt, w)))
    tv, tg, tc = pallas_kernels.fused_value_grad_batched_f32(
        *(torch.from_numpy(a) for a in (X, y, off, wt, w)), getattr(pointwise, loss)
    )
    for t, j in ((tv, jv), (tg, jg), (tc, jc)):
        assert bool(torch.isfinite(t).all())
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


def test_fused_value_grad_routing():
    """The reference's routing rule: batched dense problems of at most
    SINGLE_BLOCK_MAX_ELEMENTS elements an entity take the fused pass."""
    X = torch.zeros(2, 3, 4)
    args = (torch.zeros(2, 3), torch.zeros(2, 3), torch.ones(2, 3), torch.zeros(2, 4))
    assert pallas_kernels.fused_value_grad_auto(X, *args, pointwise.LogisticLoss) is not None
    assert pallas_kernels.fused_value_grad_auto(X[0], *(a[0] for a in args),
                                                pointwise.LogisticLoss) is None
    with pytest.raises(ValueError, match="shape"):
        pallas_kernels.fused_value_grad_batched_f32(
            X, args[0], args[1], args[2], torch.zeros(2, 5), pointwise.LogisticLoss
        )

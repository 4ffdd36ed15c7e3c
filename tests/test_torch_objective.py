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
    # one CTA's share of the merge path takes all 5 column ends and 4 nonzeros
    split = fused_perm.merge_path_split(f.col_ptr, 4)
    assert split.dtype == torch.int64 and split.tolist() == [[0, 5], [0, 4]]


def _merge_path_numpy(col_ptr, items):
    """The merged list walked one item at a time: each column's nonzeros,
    then its end; the coordinate (ends, nonzeros) at every multiple of
    ``items`` and at the end."""
    coords, ends, nz = [(0, 0)], 0, 0
    order = []
    for i in range(len(col_ptr) - 1):
        order += ["nz"] * int(col_ptr[i + 1] - col_ptr[i]) + ["end"]
    for k, item in enumerate(order, start=1):
        ends, nz = ends + (item == "end"), nz + (item == "nz")
        if k % items == 0 or k == len(order):
            coords.append((ends, nz))
    if not order:
        coords.append((0, 0))  # one (empty) share
    return np.array(coords).T


@pytest.mark.parametrize("items", [4, 7, 2048])
@pytest.mark.parametrize("lengths", [
    "empty", "one_long_column", "long_last_column", "skewed", "many_empty",
    "rows_with_a_hot_row",
])
def test_merge_path_split_matches_numpy(monkeypatch, items, lengths):
    """The CSC kernel's work split against a numpy merge path: every column
    end and every nonzero in exactly one share, shares of ``items`` items,
    the column left open at each share's end (its carry) in column order;
    and the column sums assembled as the kernel does (each column's part in
    the share where it ends plus the carries of the shares before, in
    order) equal the plain column sums."""
    rng = np.random.default_rng(len(lengths) * 31 + items)
    d = 50
    col_len = {
        "empty": np.zeros(d, np.int64),
        "one_long_column": np.where(np.arange(d) == 7, 300, rng.integers(0, 3, d)),
        "long_last_column": np.where(np.arange(d) == d - 1, 400, 0),
        "skewed": rng.integers(0, 3, d) + np.where(np.arange(d) % 17 == 0, 60, 0),
        "many_empty": np.where(rng.random(d) < 0.8, 0, rng.integers(1, 9, d)),
        # the CSR side's segments: rows of 14-17 nonzeros, one hot row
        "rows_with_a_hot_row": np.where(np.arange(d) == 9, 4096, rng.integers(14, 18, d)),
    }[lengths]
    col_ptr = np.concatenate([[0], np.cumsum(col_len)]).astype(np.int64)
    nnz = int(col_ptr[-1])
    monkeypatch.setattr(fused_perm, "MERGE_ITEMS", items)
    split = fused_perm.merge_path_split(torch.from_numpy(col_ptr), nnz).numpy()
    np.testing.assert_array_equal(split, _merge_path_numpy(col_ptr, items))
    cols, nzs = split
    assert (cols[0], nzs[0]) == (0, 0) and (cols[-1], nzs[-1]) == (d, nnz)
    sizes = np.diff(cols) + np.diff(nzs)
    assert np.all(sizes[:-1] == items) and 0 < sizes[-1] <= items
    assert np.all(np.diff(cols) >= 0) and np.all(np.diff(nzs) >= 0)  # carries in order

    terms = rng.standard_normal(nnz)
    g = np.full(d, np.nan)
    carries = []  # (column, partial), one a share, in share order
    for b in range(len(cols) - 1):
        part, x = 0.0, cols[b]
        for p in range(nzs[b], nzs[b + 1]):
            while col_ptr[x + 1] <= p:  # columns that end before nonzero p
                assert np.isnan(g[x])
                g[x], part, x = part, 0.0, x + 1
            part += terms[p]
        while x < cols[b + 1]:
            assert np.isnan(g[x])
            g[x], part, x = part, 0.0, x + 1
        carries.append((x, part))
    for x, part in carries:  # the carry rounds
        if x < d:
            g[x] += part
    want = np.array([terms[col_ptr[j]:col_ptr[j + 1]].sum() for j in range(d)])
    np.testing.assert_allclose(g, want, atol=1e-12)


def test_csc_wrapper_rejects_bad_operands():
    f = fused_perm.from_coo([0], [1], [1.0], (2, 3), device="cpu")
    with pytest.raises(ValueError, match="entries"):
        f.rmatvec(torch.zeros(3))
    with pytest.raises(TypeError, match="float32"):
        f.rmatvec(torch.zeros(2, dtype=torch.float64))
    with pytest.raises(ValueError, match="transform"):
        f._rmatvec_impl(torch.zeros(2), "cube")


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("shape", [(1, 1, 1), (3, 17, 5), (4, 8, 130), (3, 7, 5), (2, 33, 3),
                                   (64, 38, 16)])
def test_fused_value_grad_plain_matches_jax_kernel(loss, shape):
    """Odd s·d ((3, 17, 5), (3, 7, 5), (2, 33, 3)) and the per-user bucket
    of the full-width fit cut to 64 entities ((64, 38, 16))."""
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
    SINGLE_BLOCK_MAX_ELEMENTS elements each take the single-block fused
    pass, a lone one up to LONE_PROBLEM_MAX_ELEMENTS (2^18, the measured
    crossover); a larger one returns None."""
    assert pallas_kernels.LONE_PROBLEM_MAX_ELEMENTS == 1 << 18
    X = torch.zeros(2, 3, 4)
    args = (torch.zeros(2, 3), torch.zeros(2, 3), torch.ones(2, 3), torch.zeros(2, 4))
    assert pallas_kernels.fused_value_grad_auto(X, *args, pointwise.LogisticLoss) is not None
    one = pallas_kernels.fused_value_grad_auto(X[0], *(a[0] for a in args),
                                               pointwise.LogisticLoss)
    assert [tuple(t.shape) for t in one] == [(), (4,), ()]
    wide = torch.zeros(2, pallas_kernels.SINGLE_BLOCK_MAX_ELEMENTS // 2 + 1)
    assert pallas_kernels.fused_value_grad_auto(
        wide, torch.zeros(2), torch.zeros(2), torch.ones(2), torch.zeros(wide.shape[1]),
        pointwise.LogisticLoss) is None
    assert pallas_kernels.fused_value_grad_auto(
        wide[None], torch.zeros(1, 2), torch.zeros(1, 2), torch.ones(1, 2),
        torch.zeros(1, wide.shape[1]), pointwise.LogisticLoss) is None
    for width, routed in ((pallas_kernels.LONE_PROBLEM_MAX_ELEMENTS // 2, True),
                          (pallas_kernels.LONE_PROBLEM_MAX_ELEMENTS // 2 + 1, False)):
        lone = torch.zeros(2, width)
        out = pallas_kernels.fused_value_grad_auto(
            lone, torch.zeros(2), torch.zeros(2), torch.ones(2), torch.zeros(width),
            pointwise.LogisticLoss)
        assert (out is not None) == routed, width
        # the batch of one at the same size stays routed
        assert pallas_kernels.fused_value_grad_auto(
            lone[None], torch.zeros(1, 2), torch.zeros(1, 2), torch.ones(1, 2),
            torch.zeros(1, width), pointwise.LogisticLoss) is not None
    with pytest.raises(ValueError, match="shape"):
        pallas_kernels.fused_value_grad_batched_f32(
            X, args[0], args[1], args[2], torch.zeros(2, 5), pointwise.LogisticLoss
        )


def _entity_tiling_numpy(E, s, d):
    """The batched kernel's plan by brute force: "warp" for rows wider than
    2048 columns; else the most entities k whose five spans (X, y, off, wt,
    w), each started at the worst offset within a 16-byte line (3 floats)
    and padded to the next line, fit an 8192-float slot in at most 1024
    rows, then the largest multiple of the 8 warps k' <= k (if any), else
    the largest k' <= k that puts every tile start on a 16-byte boundary in
    all five arrays (if any); with no k, chunks of the most rows R (a
    multiple of 4, at most 256) with R d <= 8192."""
    if s < 1 or d < 1 or d > 2048:
        return "warp", 0

    def fits(k):
        used = 0
        for count in (k * s * d, k * s, k * s, k * s, k * d):
            used += -(-(count + 3 + 1) // 4) * 4  # start offset, pad to a line
        return used <= 8192 and k * s <= 1024

    k = 0
    while fits(k + 1):
        k += 1
    if k:
        aligned = [c for c in range(1, k + 1)
                   if all(t * c * n % 4 == 0 for t in range(1, 5) for n in (s, d, s * d))]
        warps = [c for c in aligned if c % 8 == 0]
        return "tiles", max(warps or aligned or [k])
    return "rows", max(r for r in range(4, 257, 4) if r * d <= 8192)


@pytest.mark.parametrize("shape", [
    (65_536, 38, 16), (16_384, 96, 16), (1, 1, 1), (7, 33, 5), (5, 7, 5), (1, 512, 100),
    (3, 1000, 33), (1, 8192, 244), (9, 600, 17), (2, 5, 2100), (4, 3, 2048), (100, 64, 128),
    (3, 0, 4),
])
def test_entity_tiling_matches_numpy(shape):
    """The batched kernel's plan against the brute-force rule, tiles that
    start 16-byte aligned in every array whenever the rule says they can,
    and the CTAs' contiguous runs of tiles (or entities) taking every
    entity exactly once."""
    E, s, d = shape
    plan = pallas_kernels.entity_tiling(E, s, d)
    mode, per_tile = _entity_tiling_numpy(E, s, d)
    assert (plan.mode, plan.per_tile) == (mode, per_tile)
    if mode == "warp":
        return
    assert 1 <= plan.grid <= (pallas_kernels.TILE_GRID if mode == "tiles"
                              else pallas_kernels.RING_GRID)
    if mode == "tiles":
        assert pallas_kernels.tile_floats(per_tile, s, d) <= pallas_kernels.TILE_FLOATS
        units, size = -(-E // per_tile), per_tile  # tiles of per_tile entities
    else:
        units, size = E, 1  # whole entities, each in chunks of per_tile rows
    taken = np.zeros(E, np.int64)
    for b in range(plan.grid):
        first, last = units * b // plan.grid, units * (b + 1) // plan.grid
        taken[first * size:min(E, last * size)] += 1
    assert np.all(taken == 1)
    # the mode, and so every entity's sequence of operations, depends on
    # (s, d) alone
    assert pallas_kernels.entity_tiling(1, s, d).mode == mode

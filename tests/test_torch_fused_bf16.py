"""The port's bfloat16-payload fused engine against the JAX package's, on the
same COO triplets.

The reference rounds each network input once to bf16 (the broadcast
coefficient in the matvec, the product t(vals)·c in the rmatvec) for the
entries its layout routes through the network; its hot columns and each
column block's spill stay f32. On the CPU the JAX engine runs
``unfused_execute``, which carries the same entry rounding; the port's
wrappers take their plain versions.

- partition: the port's hot columns, column bounds and per-block spill
  entries equal the JAX engine's, exactly;
- maps: matvec / rmatvec / rmatvec_sq within 2e-4 × the row's or column's
  Σ|terms| (f32 sums in another order);
- rounding: the port's bf16 maps are at least 10× closer to JAX's bf16 maps
  than to either package's f32 maps, on data whose exact entries are large
  enough that rounding them would show;
- summarize: the feature statistics over both entry sets equal JAX's;
- solve: a bf16 L-BFGS solve agrees with JAX's (objective rtol 1e-4,
  coefficients atol 2e-3) and passes the reference's quality gate (the f32
  objective at the bf16 solution within 1e-4 of the f32 optimum).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_ml_tpu.losses import pointwise as jax_pointwise
from photon_ml_tpu.losses.objective import make_glm_objective as jax_objective
from photon_ml_tpu.ops import fused_perm as jax_fused
from photon_ml_tpu.ops.data import LabeledData as JaxData
from photon_ml_tpu.ops.sparse_perm import ColumnSplitFeatures as JaxSplit
from photon_ml_tpu.stat.summary import summarize as jax_summarize
from photon_ml_tpu.opt import config as jax_config
from photon_ml_tpu.opt.solve import solve as jax_solve
from photon_ml_tpu.types import RegularizationType as JaxReg
from photon_ml_tpu_torch.losses import pointwise
from photon_ml_tpu_torch.losses.objective import make_glm_objective
from photon_ml_tpu_torch.ops import fused_perm, launches, sparse_perm
from photon_ml_tpu_torch.ops.data import LabeledData
from photon_ml_tpu_torch.opt import config
from photon_ml_tpu_torch.opt.solve import solve
from photon_ml_tpu_torch.stat.summary import summarize
from photon_ml_tpu_torch.types import RegularizationType

MAP_TOL = 2e-4


def _coo(seed, n, d, k, hot_scale=1.0):
    """``k`` random columns a row, an intercept-like column 3 holding every
    row (a hot column) with values ``hot_scale`` times larger."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(0, d, n * k)
    vals = rng.standard_normal(n * k).astype(np.float32)
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.full(n, 3)])
    vals = np.concatenate([vals, (hot_scale * (1.0 + rng.random(n))).astype(np.float32)])
    return rows, cols, vals


# (n, d, k, layout arguments): explicit layouts and the planner's own
LAYOUTS = {
    "cap2_split2_forced_hot": (512, 4000, 8, {"kp_cap": 2, "col_split": 2,
                                               "hot_col_threshold": 100}),
    "cap1_one_block": (512, 4000, 8, {"kp_cap": 1, "col_split": 1}),
    "split4_no_hot": (256, 3000, 8, {"kp_cap": 4, "col_split": 4, "max_hot_cols": 0}),
    "size_floor": (256, 3000, 8, {"kp_cap": 2, "col_split": "auto",
                                  "size_floor": 128 * 128}),
    "auto_caps_and_splits": (2048, 70000, 16, {}),
}


def _jax_engine(rows, cols, vals, shape, payload_dtype, kw):
    return jax_fused.from_coo(rows, cols, vals, shape, plan_cache="",
                              payload_dtype=payload_dtype, **kw)


def _jax_layout(feats, d):
    """Hot columns, column bounds, and each block's spill as a set of
    (row, global column)."""
    split = isinstance(feats, JaxSplit)
    blocks = feats.blocks if split else (feats,)
    bounds = tuple(feats.col_bounds) if split else (0, d)
    spills = []
    for b, blk in enumerate(blocks):
        sr = getattr(blk, "spill_rows", None)
        if sr is None:
            spills.append(set())
            continue
        sc = np.asarray(blk.spill_cols) + bounds[b]
        spills.append(set(zip(np.asarray(sr).tolist(), sc.tolist())))
    hot = None if feats.hot_cols is None else np.asarray(feats.hot_cols)
    return hot, bounds, spills


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_partition_equals_jax_fused_layout(case):
    n, d, k, kw = LAYOUTS[case]
    rows, cols, vals = _coo(7, n, d, k)
    jf = _jax_engine(rows, cols, vals, (n, d), "bfloat16", kw)
    hot, bounds, spills = _jax_layout(jf, d)
    part = sparse_perm.fused_payload_partition(rows, cols, vals, (n, d), **kw)

    if hot is None:
        assert part.hot_cols is None
    else:
        np.testing.assert_array_equal(part.hot_cols, hot)
    assert part.col_bounds == bounds
    for b, want in enumerate(spills):
        m = part.spilled & (part.cols >= bounds[b]) & (part.cols < bounds[b + 1])
        assert set(zip(part.rows[m].tolist(), part.cols[m].tolist())) == want, b
    # the three sets cover every entry once
    assert not (part.hot & part.spilled).any()
    assert part.payload.sum() + part.hot.sum() + part.spilled.sum() == part.rows.size
    if case == "auto_caps_and_splits":
        assert len(bounds) > 2 and sum(map(len, spills)) > 0  # the planner split and capped


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_bf16_engine_csr_holds_both_sets(case):
    """The bf16 engine's CSR copy (its one-pass matvec) holds every entry of
    the partition: the rounded ones with their column, the exact ones (hot
    columns, spill) with ~column, row by row; its CSC copy and its exact
    engine split the entries as the partition does."""
    n, d, k, kw = LAYOUTS[case]
    rows, cols, vals = _coo(7, n, d, k)
    part = sparse_perm.fused_payload_partition(rows, cols, vals, (n, d), **kw)
    f = fused_perm.from_coo(rows, cols, vals, (n, d), payload_dtype="bfloat16",
                            device="cpu", **kw)
    want = {(r, c if keep else ~c): v for r, c, v, keep in
            zip(part.rows.tolist(), part.cols.tolist(), part.vals.tolist(),
                part.payload.tolist())}
    got_rows = fused_perm.csr_rows_of_nonzeros(f.row_ptr, f.row_blocks).tolist()
    got = dict(zip(zip(got_rows, f.col_idx.tolist()), f.vals.tolist()))
    assert got == want
    assert f.exact is not None
    assert f.vals_csc.numel() == int(part.payload.sum())
    assert f.exact.vals_csc.numel() == int((~part.payload).sum())
    assert f.nnz == part.rows.size


def test_benes_planner_defaults_unchanged():
    """The fused variants are opt-in: without them the planner is the Benes
    engine's (its plans are held bitwise by test_torch_benes.py)."""
    rng = np.random.default_rng(0)
    rows = np.repeat(np.arange(300), 5)
    cols = rng.integers(0, 700, 1500)
    est, est2 = (sparse_perm.make_row_block_k(rows, cols, 300, 700, pow2=p) for p in (False, True))
    assert [est2(t) for t in (2, 4)] == [sparse_perm.next_pow2(est(t)) for t in (2, 4)]
    counts = np.bincount(cols, minlength=700)
    assert sparse_perm.resolve_layout("auto", "auto", counts, 300, 700, 5, 8) == \
        sparse_perm.resolve_layout("auto", "auto", counts, 300, 700, 5, 8, size_floor=0)


def _dense(rows, cols, vals, shape):
    dense = np.zeros(shape, np.float64)
    np.add.at(dense, (rows, cols), vals)
    return dense


def _maps(engine, w, c, torch_side):
    if torch_side:
        w_, c_ = torch.from_numpy(w), torch.from_numpy(c)
        return [engine.matvec(w_).numpy(), engine.rmatvec(c_).numpy(),
                engine.rmatvec_sq(c_).numpy()]
    w_, c_ = jnp.asarray(w), jnp.asarray(c)
    return [np.asarray(engine.matvec(w_)), np.asarray(engine.rmatvec(c_)),
            np.asarray(engine.rmatvec_sq(c_))]


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_bf16_maps_match_jax_bf16_engine(case):
    n, d, k, kw = LAYOUTS[case]
    rows, cols, vals = _coo(11, n, d, k)
    rng = np.random.default_rng(12)
    w = rng.standard_normal(d).astype(np.float32)
    c = rng.standard_normal(n).astype(np.float32)
    jf = _jax_engine(rows, cols, vals, (n, d), "bfloat16", kw)
    pf = fused_perm.from_coo(rows, cols, vals, (n, d), payload_dtype="bfloat16",
                             device="cpu", **kw)
    assert pf.payload_dtype == "bfloat16" and pf.layout["rounded_entries"] > 0
    before = launches.counts()
    got = _maps(pf, w, c, True)
    assert launches.counts() == before  # CPU: the plain versions
    want = _maps(jf, w, c, False)
    absx = np.abs(_dense(rows, cols, vals, (n, d)))
    scales = [absx @ np.abs(w), absx.T @ np.abs(c), (absx * absx).T @ np.abs(c)]
    for name, g, j, s in zip(("matvec", "rmatvec", "rmatvec_sq"), got, want, scales):
        assert g.shape == j.shape and np.isfinite(g).all(), name
        assert (np.abs(g - j) <= MAP_TOL * np.maximum(s, 1e-30)).all(), (
            name, float(np.abs(g - j).max()))


def test_rounding_falls_on_the_same_entries():
    """Exact entries (the hot column, the spill) 1000× larger than the rest.
    Distances are taken output by output relative to its Σ|terms|: rounding
    an exact entry would move its outputs by about 2^-9 of that, as much as
    the payload's rounding moves the others, where f32 sums in another
    order differ by about 2^-24."""
    n, d, k, kw = LAYOUTS["cap2_split2_forced_hot"]
    rows, cols, vals = _coo(21, n, d, k, hot_scale=1000.0)
    rng = np.random.default_rng(22)
    w = (rng.standard_normal(d) * 3.0).astype(np.float32)
    c = (rng.standard_normal(n) * 3.0).astype(np.float32)
    shape = (n, d)
    port16 = _maps(fused_perm.from_coo(rows, cols, vals, shape, payload_dtype="bfloat16",
                                       device="cpu", **kw), w, c, True)
    port32 = _maps(fused_perm.from_coo(rows, cols, vals, shape, device="cpu", **kw), w, c, True)
    jax16 = _maps(_jax_engine(rows, cols, vals, shape, "bfloat16", kw), w, c, False)
    jax32 = _maps(_jax_engine(rows, cols, vals, shape, "float32", kw), w, c, False)
    absx = np.abs(_dense(rows, cols, vals, shape))
    scales = [absx @ np.abs(w), absx.T @ np.abs(c), (absx * absx).T @ np.abs(c)]
    for i, name in enumerate(("matvec", "rmatvec", "rmatvec_sq")):
        s = np.maximum(scales[i], 1e-30)
        near = (np.abs(port16[i] - jax16[i]) / s).max()
        far = min((np.abs(port16[i] - jax32[i]) / s).max(),
                  (np.abs(port16[i] - port32[i]) / s).max())
        assert far > 0 and 10 * near <= far, (name, near, far)


def _configs(max_iterations):
    return (
        jax_config.GlmOptimizationConfiguration(
            optimizer_config=jax_config.OptimizerConfig(max_iterations=max_iterations),
            regularization=jax_config.RegularizationContext(JaxReg.L2),
            regularization_weight=1.0,
        ),
        config.GlmOptimizationConfiguration(
            optimizer_config=config.OptimizerConfig(max_iterations=max_iterations),
            regularization=config.RegularizationContext(RegularizationType.L2),
            regularization_weight=1.0,
        ),
    )


def test_bf16_solve_matches_jax_and_passes_the_quality_gate():
    n, d, k, kw = LAYOUTS["auto_caps_and_splits"]
    rows, cols, vals = _coo(31, n, d, k)
    rng = np.random.default_rng(32)
    w_true = rng.standard_normal(d) * 0.5
    margin = _dense(rows, cols, vals, (n, d)) @ w_true
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-margin))).astype(np.float32)
    jcfg, tcfg = _configs(100)
    jobj = jax_objective(jax_pointwise.LogisticLoss, use_pallas=False)
    tobj = make_glm_objective(pointwise.LogisticLoss)

    jd16 = JaxData.create(_jax_engine(rows, cols, vals, (n, d), "bfloat16", kw), jnp.asarray(y))
    jr = jax_solve(jobj, jnp.zeros(d), jd16, jcfg)
    td = {dt: LabeledData.create(
        fused_perm.from_coo(rows, cols, vals, (n, d), payload_dtype=dt, device="cpu", **kw),
        torch.from_numpy(y)) for dt in ("float32", "bfloat16")}
    r16 = solve(tobj, torch.zeros(1, d), td["bfloat16"], tcfg)
    r32 = solve(tobj, torch.zeros(1, d), td["float32"], tcfg)

    np.testing.assert_allclose(float(r16.value[0]), float(jr.value), rtol=1e-4)
    np.testing.assert_allclose(r16.w[0].numpy(), np.asarray(jr.w), atol=2e-3)
    # the reference's gate (bench.py): the exact objective at the bf16 solution
    f32_at_bf16 = float(tobj.value(r16.w[0], td["float32"], 1.0))
    assert abs(f32_at_bf16 - float(r32.value[0])) <= 1e-4 * abs(float(r32.value[0]))


def test_float32_engine_ignores_the_layout_arguments():
    n, d, k, kw = LAYOUTS["cap2_split2_forced_hot"]
    rows, cols, vals = _coo(41, n, d, k)
    plain = fused_perm.from_coo(rows, cols, vals, (n, d), device="cpu")
    laid = fused_perm.from_coo(rows, cols, vals, (n, d), device="cpu", **kw)
    assert laid.exact is None and laid.layout is None and laid.nnz == plain.nnz
    for a, b in ((plain.row_ptr, laid.row_ptr), (plain.col_idx, laid.col_idx),
                 (plain.vals, laid.vals), (plain.vals_csc, laid.vals_csc)):
        assert torch.equal(a, b)


def test_bf16_wrappers_round_as_the_reference_does():
    """The plain versions: the coefficient rounds in the matvec, the f32
    product (never its factors) in the rmatvec, to nearest even."""
    row_ptr = torch.tensor([0, 2], dtype=torch.int64)
    col_idx = torch.tensor([0, 1], dtype=torch.int32)
    vals = torch.tensor([3.0, 1.0])
    w = torch.tensor([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8])  # ties: to even
    z = fused_perm.csr_matvec_bf16(row_ptr, col_idx, vals, w, 2)
    assert z.tolist() == [3.0 * 1.0 + 1.0 * (1.0 + 2.0 ** -6)]
    # an exact entry (column stored as ~1) takes w unrounded
    z = fused_perm.csr_matvec_bf16(row_ptr, torch.tensor([0, ~1], dtype=torch.int32), vals, w, 2)
    assert z.tolist() == [float(torch.tensor(3.0) + torch.tensor(1.0 + 3 * 2.0 ** -8))]
    # 1.5 * (1 + 2^-7) = 1.5 + 1.5 * 2^-7 is not a bf16; its factors are
    g = fused_perm.csc_rmatvec_bf16(torch.tensor([0, 1], dtype=torch.int64),
                                    torch.tensor([0], dtype=torch.int32),
                                    torch.tensor([1.5]), torch.tensor([1.0 + 2.0 ** -7]), 1)
    assert g.tolist() == [float(torch.tensor(1.5 * (1.0 + 2.0 ** -7)).to(torch.bfloat16))]


@pytest.mark.parametrize("case", ["cap2_split2_forced_hot", "auto_caps_and_splits"])
def test_summarize_bf16_engine_equals_jax(case):
    """summarize() over both entry sets: the hot column's and the spilled
    entries' min/max come from the exact set. Sums of bf16-rounded terms
    in another order: mean and mean |x| within MAP_TOL of the column's
    mean |x|; min / max / nonzero counts exact (integer weights)."""
    n, d, k, kw = LAYOUTS[case]
    rows, cols, vals = _coo(51, n, d, k)
    rng = np.random.default_rng(52)
    weights = rng.integers(0, 3, n).astype(np.float32)  # 0, 1, 2
    labels = np.zeros(n, np.float32)
    pf = fused_perm.from_coo(rows, cols, vals, (n, d), payload_dtype="bfloat16",
                             device="cpu", **kw)
    assert pf.exact is not None and pf.layout["spilled_entries"] > 0
    got = summarize(LabeledData.create(pf, torch.from_numpy(labels),
                                       weights=torch.from_numpy(weights)))
    want = jax_summarize(JaxData.create(_jax_engine(rows, cols, vals, (n, d), "bfloat16", kw),
                                        jnp.asarray(labels), weights=jnp.asarray(weights)))
    scale = np.maximum(np.asarray(want.mean_abs), 1e-30)
    for name in ("mean", "mean_abs"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert (np.abs(g - w) <= MAP_TOL * scale).all(), name
    for name in ("num_nonzeros", "max_abs", "min_val", "max_val"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    # the hot column (3) holds every row, with values of at least 1
    assert float(got.max_val[3]) >= 1.0

"""The port's Benes sparse engine (ops/sparse_perm.py) against the JAX
package's ``BenesSparseFeatures`` on the same seeded COO data.

The layout (hot columns, KP cap, spill, column split) and the routing plans
must be the same as the reference's, index for index. The four maps agree
to atol 1e-5 plus rtol 1e-5: sums of up to a few hundred f32 terms (the
hot intercept column) taken in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_game_data, torch_game_data
from photon_ml_tpu.ops import sparse_perm as jax_sparse_perm
from photon_ml_tpu_torch.ops import routing, sparse_perm
from photon_ml_tpu_torch.ops.features import from_scipy_like

ATOL, RTOL = 1e-5, 1e-5


def _coo(seed, n=300, d=2000, k=6, intercept=True, col_hi=None):
    """k nonzeros a row (duplicates included), plus an intercept column 0
    holding every row."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(1, col_hi or d, n * k)
    grid = cols.reshape(n, k)
    grid[::5, 1] = grid[::5, 0]  # duplicate (row, col) pairs, summed
    vals = rng.standard_normal(n * k).astype(np.float32)
    if intercept:
        rows = np.concatenate([rows, np.arange(n)])
        cols = np.concatenate([cols, np.zeros(n, np.int64)])
        vals = np.concatenate([vals, np.ones(n, np.float32)])
    return rows, cols, vals, (n, d)


def _assert_maps_equal(tf, jf, seed):
    rng = np.random.default_rng(seed)
    n, d = tf.num_rows, tf.dim
    w = rng.standard_normal(d).astype(np.float32)
    c = rng.standard_normal(n).astype(np.float32)
    pairs = [
        (tf.matvec(torch.from_numpy(w)), jf.matvec(jnp.asarray(w))),
        (tf.rmatvec(torch.from_numpy(c)), jf.rmatvec(jnp.asarray(c))),
        (tf.rmatvec_sq(torch.from_numpy(c)), jf.rmatvec_sq(jnp.asarray(c))),
        (tf.row_norms_sq(), jf.row_norms_sq()),
    ]
    for got, want in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def _assert_same_layout(tf, jf):
    assert type(tf).__name__ == type(jf).__name__
    if isinstance(tf, sparse_perm.ColumnSplitFeatures):
        assert tf.col_bounds == jf.col_bounds
        for tb, jb in zip(tf.blocks, jf.blocks):
            _assert_same_layout(tb, jb)
    for name in ("hot_cols", "spill_rows", "spill_cols"):
        tv, jv = getattr(tf, name, None), getattr(jf, name, None)
        assert (tv is None) == (jv is None), name
        if tv is not None:
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if isinstance(tf, sparse_perm.BenesSparseFeatures):
        assert tf.ell_values.shape == jf.ell_values.shape
        assert tf.csc_values.shape == jf.csc_values.shape
        np.testing.assert_array_equal(tf.ell_values.numpy(), np.asarray(jf.ell_values))
        np.testing.assert_array_equal(tf.csc_values.numpy(), np.asarray(jf.csc_values))
        for tp, jp in ((tf.plan, jf.plan), (tf.plan_inv, jf.plan_inv)):
            assert tp.kinds == jp.kinds and tp.size == jp.size
            for a, b in zip(tp.idx, jp.idx):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


CASES = {
    "default": ({}, {}),
    "kp_cap_spill": ({}, {"kp_cap": 1, "col_split": 1}),
    "col_split_2": ({}, {"col_split": 2}),
    "col_split_4_spill": ({}, {"col_split": 4, "kp_cap": 2}),
    "empty_column_block": ({"col_hi": 900}, {"col_split": 4}),
    "no_intercept": ({"intercept": False}, {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_maps_and_layout_equal_jax(case):
    coo_kw, build_kw = CASES[case]
    rows, cols, vals, shape = _coo(len(case), **coo_kw)
    tf = sparse_perm.from_coo(rows, cols, vals, shape, plan_cache="", device="cpu", **build_kw)
    jf = jax_sparse_perm.from_coo(rows, cols, vals, shape, plan_cache="", **build_kw)
    _assert_same_layout(tf, jf)
    _assert_maps_equal(tf, jf, seed=len(case))
    if case == "empty_column_block":
        assert any(isinstance(b, sparse_perm._ZeroColumnsBlock) for b in tf.blocks)
    if case in ("kp_cap_spill", "col_split_4_spill"):
        spilled = [b for b in getattr(tf, "blocks", (tf,))
                   if getattr(b, "spill_rows", None) is not None]
        assert spilled
    if case == "default":
        assert tf.hot_cols.tolist() == [0]  # the intercept went to the dense side


def test_maps_match_the_ell_engine():
    rows, cols, vals, shape = _coo(11)
    benes = sparse_perm.from_coo(rows, cols, vals, shape, plan_cache="", device="cpu")
    ell = from_scipy_like(rows, cols, vals, shape, device="cpu")
    rng = np.random.default_rng(11)
    w = torch.from_numpy(rng.standard_normal(shape[1]).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal(shape[0]).astype(np.float32))
    np.testing.assert_allclose(benes.matvec(w).numpy(), ell.matvec(w).numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(benes.rmatvec(c).numpy(), ell.rmatvec(c).numpy(), atol=ATOL, rtol=RTOL)
    # from_ell round-trips to the same engine
    again = sparse_perm.from_ell(ell, plan_cache="", device="cpu")
    np.testing.assert_array_equal(again.matvec(w).numpy(), benes.matvec(w).numpy())


def test_plan_cache_round_trip(tmp_path, monkeypatch):
    rows, cols, vals, shape = _coo(12)
    first = sparse_perm.from_coo(rows, cols, vals, shape, plan_cache=str(tmp_path), device="cpu")
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files and all(f.startswith("benesplan_v2_") and f.endswith(".npz") for f in files)

    def refuse(_perm):
        raise AssertionError("routed again although the plan was cached")

    monkeypatch.setattr(routing, "build_plan", refuse)
    second = sparse_perm.from_coo(rows, cols, vals, shape, plan_cache=str(tmp_path), device="cpu")
    for a, b in ((first.plan, second.plan), (first.plan_inv, second.plan_inv)):
        assert a.kinds == b.kinds
        for x, y in zip(a.idx, b.idx):
            assert torch.equal(x, y)
    # an unreadable entry is rebuilt and overwritten
    monkeypatch.undo()
    for f in tmp_path.iterdir():
        f.write_bytes(b"not a plan")
    third = sparse_perm.from_coo(rows, cols, vals, shape, plan_cache=str(tmp_path), device="cpu")
    assert third.plan.kinds == first.plan.kinds


def test_default_plan_cache_follows_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("PHOTON_ML_TPU_TORCH_PLAN_CACHE", str(tmp_path / "plans"))
    assert sparse_perm.default_plan_cache() == str(tmp_path / "plans")
    monkeypatch.setenv("PHOTON_ML_TPU_TORCH_PLAN_CACHE", "")
    assert sparse_perm.default_plan_cache() is None
    monkeypatch.delenv("PHOTON_ML_TPU_TORCH_PLAN_CACHE")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    path = sparse_perm.default_plan_cache()
    assert path.startswith(str(tmp_path)) and "photon_ml_tpu_torch_plan_cache" in path


def test_game_data_benes_engine_equals_jax():
    rng = np.random.default_rng(13)
    n, d = 250, 700
    rows, cols, vals, _ = _coo(13, n=n, d=d)
    labels = (rng.random(n) < 0.5).astype(np.float32)
    shards = {"global": (rows, cols, vals, d)}
    tf = torch_game_data(labels, shards, {}).sparse_features("global", engine="benes",
                                                              device="cpu")
    jf = jax_game_data(labels, shards, {}).sparse_features("global", engine="benes")
    _assert_same_layout(tf, jf)
    _assert_maps_equal(tf, jf, seed=13)


@pytest.mark.parametrize("case", list(CASES))
def test_maps_through_the_compiled_plans_equal_stage_by_stage(case, monkeypatch):
    """The engine's four maps run each plan as compiled groups; run stage
    by stage instead, they are bitwise the same (the groups only move
    values)."""
    from photon_ml_tpu_torch.ops import permute_net

    coo_kw, build_kw = CASES[case]
    rows, cols, vals, shape = _coo(len(case) + 100, **coo_kw)
    tf = sparse_perm.from_coo(rows, cols, vals, shape, plan_cache="", device="cpu", **build_kw)
    rng = np.random.default_rng(len(case))
    w = torch.from_numpy(rng.standard_normal(shape[1]).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal(shape[0]).astype(np.float32))

    def maps():
        return [tf.matvec(w), tf.rmatvec(c), tf.rmatvec_sq(c), tf.row_norms_sq()]

    grouped = maps()
    monkeypatch.setattr(permute_net, "plan_plain", permute_net.plan_stages_plain)
    for got, want in zip(maps(), grouped):
        assert torch.equal(got, want)
    kernels = {g.kernel for b in getattr(tf, "blocks", (tf,))
               if isinstance(b, sparse_perm.BenesSparseFeatures)
               for p in (b.plan, b.plan_inv) for g in p.groups}
    assert permute_net.INNER_KERNEL in kernels

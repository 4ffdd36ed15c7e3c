"""The port's FusedSparseFeatures.matvec against the JAX package's fused
Benes engine, on the same COO triplets.

The JAX side runs its three Pallas kernels (descend → base → ascend) through
the Pallas interpreter, with a plan large enough to have a recursion level;
the port's wrapper takes its plain version on CPU tensors. Tolerance: rtol
2e-4, atol 1e-5 (f32 sums taken in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_ml_tpu.ops import fused_perm as jax_fused
from photon_ml_tpu.ops.features import from_scipy_like as jax_ell
from photon_ml_tpu_torch.ops import fused_perm, launches
from photon_ml_tpu_torch.ops.features import from_scipy_like

RTOL, ATOL = 2e-4, 1e-5


@pytest.fixture
def interpret_kernels():
    old = jax_fused._INTERPRET
    jax_fused._INTERPRET = True
    yield
    jax_fused._INTERPRET = old


def _coo(seed, case):
    rng = np.random.default_rng(seed)
    n, d, nnz = 1024, 600, 6000
    rows = rng.integers(0, n, nnz)
    cols = rng.integers(0, d, nnz)
    kw = {"max_hot_cols": 0}
    if case == "empty_rows":
        keep = rows % 3 != 0  # a third of the rows hold nothing
        rows, cols = rows[keep], cols[keep]
    elif case == "duplicates":
        rows = np.concatenate([rows, rows[:500]])
        cols = np.concatenate([cols, cols[:500]])
    elif case == "hot_columns":
        rows = np.concatenate([rows, np.arange(n)])
        cols = np.concatenate([cols, np.zeros(n, dtype=cols.dtype)])
        kw = {"hot_col_threshold": n // 2}
    elif case == "long_column":
        rows = np.concatenate([rows, rng.choice(n, 300, replace=False)])
        cols = np.concatenate([cols, np.full(300, 7)])
    elif case == "long_row":
        rows = np.concatenate([rows, np.full(300, 5)])
        cols = np.concatenate([cols, rng.choice(d, 300, replace=False)])
        kw = {"max_hot_cols": 0, "col_split": 1}  # one flat plan, K = 512
    vals = rng.standard_normal(rows.size).astype(np.float32)
    dense = np.zeros((n, d), dtype=np.float64)
    np.add.at(dense, (rows, cols), vals)
    w = rng.standard_normal(d).astype(np.float32)
    return rows, cols, vals, (n, d), kw, dense, w


CASES = ["plain", "empty_rows", "duplicates", "hot_columns", "long_column", "long_row"]


@pytest.mark.parametrize("blocks", [1, 5])
@pytest.mark.parametrize("case", CASES)
def test_matvec_matches_jax_fused_engine(interpret_kernels, monkeypatch, case, blocks):
    """blocks: the CSR copy in that many column blocks (its block size cut
    to 4·⌈600 / 5⌉ bytes, whatever the row density; a shard of 2^24 columns
    takes 5 at the default)."""
    monkeypatch.setattr(fused_perm, "CSR_BLOCK_BYTES", 4 * -(-600 // blocks))
    monkeypatch.setattr(fused_perm, "CSR_BLOCK_MIN_ROW_NNZ", 0)
    rows, cols, vals, shape, kw, dense, w = _coo(11, case)
    jf = jax_fused.from_coo(
        rows, cols, vals, shape, size_floor=128 * 128, plan_cache="", **kw
    )
    if case == "hot_columns":
        assert jf.hot_matrix is not None
    else:
        assert jf._fused_ok()  # the Pallas kernels run, not the XLA fallback
    z_jax = np.asarray(jf.matvec(jnp.asarray(w)))

    feats = fused_perm.from_coo(rows, cols, vals, shape, device="cpu")
    assert feats.row_blocks == blocks
    before = launches.counts()[fused_perm.KERNEL]
    z = feats.matvec(torch.from_numpy(w)).numpy()
    assert launches.counts()[fused_perm.KERNEL] == before  # CPU: plain version

    np.testing.assert_allclose(z, z_jax, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(z, dense @ w, rtol=RTOL, atol=ATOL)
    z_ell = np.asarray(jax_ell(rows, cols, vals, shape).matvec(jnp.asarray(w)))
    np.testing.assert_allclose(z, z_ell, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["plain", "duplicates", "empty_rows", "long_row"])
def test_port_ell_matches_jax_ell(case):
    rows, cols, vals, shape, _, dense, w = _coo(5, case)
    je = jax_ell(rows, cols, vals, shape)
    pe = from_scipy_like(rows, cols, vals, shape, device="cpu")
    assert pe.values.shape == tuple(je.values.shape)
    np.testing.assert_allclose(
        pe.matvec(torch.from_numpy(w)).numpy(), np.asarray(je.matvec(jnp.asarray(w))),
        rtol=RTOL, atol=ATOL,
    )
    np.testing.assert_allclose(pe.matvec(torch.from_numpy(w)).numpy(), dense @ w,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dim,block_bytes", [(50, 1 << 24), (50, 4 * 7), (50, 4 * 13),
                                             ((1 << 24) + 1, 16 << 20)])
def test_csr_column_blocks_match_numpy(monkeypatch, dim, block_bytes):
    """The CSR copy's column blocks against a numpy rule: B = ⌈4·dim /
    block_bytes⌉ blocks of ⌈dim / B⌉ columns (5 for the full-width shard of
    2^24 + 1 columns); block b, one after another, holds for each row in
    turn the row's coalesced entries with columns in the block, in column
    order. (13 nonzeros a row here; below 8 a row the copy stays one block,
    see test_csr_keeps_one_block_below_the_row_density.)"""
    monkeypatch.setattr(fused_perm, "CSR_BLOCK_BYTES", block_bytes)
    rng = np.random.default_rng(dim % 1000 + block_bytes % 997)
    n = 37
    rows = rng.integers(0, n, 500)
    cols = np.concatenate([rng.integers(0, dim, 499), [dim - 1]])
    vals = rng.standard_normal(500).astype(np.float32)
    f = fused_perm.from_coo(rows, cols, vals, (n, dim), device="cpu")
    B = max(1, -(-4 * dim // block_bytes))
    width = -(-dim // B)
    assert f.row_blocks == fused_perm.csr_blocks(dim, f.vals.numel(), n) == B
    coalesced = {}
    for r, c, v in zip(rows, cols, vals):
        coalesced[(r, c)] = coalesced.get((r, c), np.float32(0)) + v
    ptr, want_cols, want_vals = [0], [], []
    for b in range(B):
        for r in range(n):
            row = sorted(c for (rr, c) in coalesced if rr == r and c // width == b)
            want_cols += row
            want_vals += [coalesced[(r, c)] for c in row]
            ptr.append(len(want_cols))
    np.testing.assert_array_equal(f.row_ptr.numpy(), ptr)
    np.testing.assert_array_equal(f.col_idx.numpy(), want_cols)
    # duplicates coalesced: their sum may round in another order
    np.testing.assert_allclose(f.vals.numpy(), np.array(want_vals, np.float32), rtol=1e-6)
    np.testing.assert_array_equal(
        fused_perm.csr_rows_of_nonzeros(f.row_ptr, B).numpy(),
        [r for b in range(B) for r in range(n) for _ in range(ptr[b * n + r + 1]
                                                             - ptr[b * n + r])])
    w = rng.standard_normal(dim).astype(np.float32)
    want = np.zeros(n)
    for (r, c), v in coalesced.items():
        want[r] += float(v) * float(w[c])
    np.testing.assert_allclose(f.matvec(torch.from_numpy(w)).numpy(), want, rtol=RTOL,
                               atol=ATOL)


def test_csr_keeps_one_block_below_the_row_density(monkeypatch):
    """A matrix of fewer than CSR_BLOCK_MIN_ROW_NNZ nonzeros a row (the
    bf16 engine's exact set) keeps one CSR block whatever its width."""
    monkeypatch.setattr(fused_perm, "CSR_BLOCK_BYTES", 4 * 7)
    n, dim = 40, 50
    rng = np.random.default_rng(3)
    for per_row, blocks in ((7, 1), (8, 8)):
        rows = np.repeat(np.arange(n), per_row)
        cols = np.concatenate([rng.choice(dim, per_row, replace=False) for _ in range(n)])
        f = fused_perm.from_coo(rows, cols, np.ones(rows.size, np.float32), (n, dim),
                                device="cpu")
        assert f.row_blocks == blocks and f.row_ptr.numel() == blocks * n + 1


def test_csr_layout_coalesces_and_keeps_empty_rows():
    rows = np.array([2, 0, 2, 2])
    cols = np.array([1, 3, 1, 0])
    vals = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    f = fused_perm.from_coo(rows, cols, vals, (4, 5), device="cpu")
    assert f.row_ptr.tolist() == [0, 1, 1, 3, 3]
    assert f.col_idx.tolist() == [3, 0, 1]
    assert f.vals.tolist() == [2.0, 4.0, 4.0]
    assert f.col_idx.dtype == torch.int32 and f.row_ptr.dtype == torch.int64


def test_wrapper_rejects_bad_operands():
    f = fused_perm.from_coo([0], [1], [1.0], (1, 3), device="cpu")
    with pytest.raises(ValueError, match="entries"):
        f.matvec(torch.zeros(4))
    with pytest.raises(TypeError, match="float32"):
        f.matvec(torch.zeros(3, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        f.matvec(torch.zeros(6)[::2])
    with pytest.raises(TypeError, match="int32"):
        fused_perm.csr_matvec_f32(f.row_ptr, f.col_idx.long(), f.vals, torch.zeros(3), 3)


def test_training_maps_raise():
    """The training maps are ported (rmatvec, rmatvec_sq on the CSC copy);
    a payload dtype the reference has no engine for raises."""
    f = fused_perm.from_coo([0, 0], [1, 2], [2.0, -3.0], (1, 3), device="cpu")
    assert f.rmatvec(torch.full((1,), 0.5)).tolist() == [0.0, 1.0, -1.5]
    assert f.rmatvec_sq(torch.full((1,), 0.5)).tolist() == [0.0, 2.0, 4.5]
    with pytest.raises(ValueError, match="payload_dtype"):
        fused_perm.from_coo([0], [1], [1.0], (1, 3), payload_dtype="float16", device="cpu")

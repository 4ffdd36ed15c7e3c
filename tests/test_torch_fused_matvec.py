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


@pytest.mark.parametrize("case", CASES)
def test_matvec_matches_jax_fused_engine(interpret_kernels, case):
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
    the bf16 payload still raises."""
    f = fused_perm.from_coo([0, 0], [1, 2], [2.0, -3.0], (1, 3), device="cpu")
    assert f.rmatvec(torch.full((1,), 0.5)).tolist() == [0.0, 1.0, -1.5]
    assert f.rmatvec_sq(torch.full((1,), 0.5)).tolist() == [0.0, 2.0, 4.5]
    with pytest.raises(NotImplementedError, match="bf16 payload"):
        fused_perm.from_coo([0], [1], [1.0], (1, 3), payload_dtype="bfloat16", device="cpu")

"""The port's (data x feat) tiled fixed-effect features
(``photon_ml_tpu_torch/parallel/grid_features.py``) against the JAX
package's grid on conftest's 8 forced host devices, on the CPU:

- matvec, rmatvec, rmatvec_sq and row_norms_sq of ``ell``, ``fused`` and
  ``benes`` tiles against the JAX grid and the dense matrix (atol 1e-3, as
  JAX ``tests/test_grid_features.py``), whole or sharded vectors;
- the padded shapes equal the JAX package's, rows and columns that do not
  divide included; a 1 x 1 grid is the single-device engine;
- L-BFGS and TRON over a 2 x 2 grid against one device: value rtol 1e-4,
  w atol 2e-3;
- the reductions repeat bitwise.
"""

import functools

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.parallel.grid_features import (
    GridShardedFeatures,
    grid_from_coo,
    grid_mesh,
    shard_vector_data,
    shard_vector_feat,
)
from photon_ml_tpu_torch.parallel.mesh import fetch_global


def _problem(rng, n=96, d=40, k=5, intercept=True):
    rows = np.repeat(np.arange(n), k + int(intercept))
    blocks = [rng.integers(1, d, (n, k))]
    if intercept:
        blocks.append(np.zeros((n, 1), np.int64))
    cols = np.concatenate(blocks, axis=1).reshape(-1)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return rows, cols, vals, (n, d)


def _dense(rows, cols, vals, shape):
    m = np.zeros(shape, np.float32)
    np.add.at(m, (rows, cols), vals)
    return m


def _jax_grid(rows, cols, vals, shape, grid, engine):
    import jax.numpy as jnp

    from photon_ml_tpu.parallel import grid_features as jg

    mesh = jg.grid_mesh(*grid)
    gf = jg.grid_from_coo(rows, cols, vals, shape, mesh, engine=engine)
    return gf, mesh, jg, jnp


@functools.lru_cache(maxsize=None)
def _jax_maps(grid, jax_engine):
    """The seeded problem, its vectors, and the JAX grid's four maps of
    them (built once a grid and JAX engine: the port's fused tiles are held
    against the JAX package's Benes grid, the same maps)."""
    rows, cols, vals, shape = _problem(np.random.default_rng(42))
    jgf, jmesh, jg, jnp = _jax_grid(rows, cols, vals, shape, grid, jax_engine)
    w = np.random.default_rng(1).standard_normal(jgf.dim).astype(np.float32)
    c = np.random.default_rng(2).standard_normal(jgf.num_rows).astype(np.float32)
    maps = {
        "z": np.asarray(jgf.matvec(jg.shard_vector_feat(jnp.asarray(w), jmesh))),
        "g": np.asarray(jgf.rmatvec(jg.shard_vector_data(jnp.asarray(c), jmesh))),
        "gsq": np.asarray(jgf.rmatvec_sq(jg.shard_vector_data(jnp.asarray(c), jmesh))),
        "rn": np.asarray(jgf.row_norms_sq()),
    }
    return (rows, cols, vals, shape), w, c, maps, (jgf.num_rows, jgf.dim)


@pytest.mark.parametrize("engine", ["ell", "fused", "benes"])
@pytest.mark.parametrize("grid", [(2, 2), (4, 1), (1, 4)])
def test_maps_match_jax_grid_and_dense(engine, grid):
    (rows, cols, vals, shape), w, c, jmaps, jshape = _jax_maps(
        grid, "benes" if engine == "fused" else engine)
    n, d = shape
    dense = _dense(rows, cols, vals, shape)
    gf = grid_from_coo(rows, cols, vals, shape, grid_mesh(*grid, device="cpu"), engine=engine)
    assert (gf.num_rows, gf.dim) == jshape
    ours = {
        "z": gf.matvec(torch.from_numpy(w)).numpy(),
        "g": gf.rmatvec(torch.from_numpy(c)).numpy(),
        "gsq": gf.rmatvec_sq(torch.from_numpy(c)).numpy(),
        "rn": gf.row_norms_sq().numpy(),
    }
    for key in ours:
        np.testing.assert_allclose(ours[key], jmaps[key], atol=1e-3, err_msg=key)
    z, g, gsq, rn = (ours[k] for k in ("z", "g", "gsq", "rn"))
    np.testing.assert_allclose(z[:n], dense @ w[:d], atol=1e-3)
    np.testing.assert_allclose(z[n:], 0.0, atol=1e-6)
    np.testing.assert_allclose(g[:d], dense.T @ c[:n], atol=1e-3)
    np.testing.assert_allclose(g[d:], 0.0, atol=1e-6)
    np.testing.assert_allclose(gsq[:d], (dense * dense).T @ c[:n], atol=1e-3)
    np.testing.assert_allclose(rn[:n], (dense * dense).sum(1), atol=1e-3)


@pytest.mark.parametrize("engine", ["ell", "fused", "benes"])
def test_sharded_vectors_and_bitwise_repeats(rng, engine):
    rows, cols, vals, shape = _problem(rng, n=77, d=29)
    mesh = grid_mesh(2, 2, device="cpu")
    gf = grid_from_coo(rows, cols, vals, shape, mesh, engine=engine)
    w = torch.from_numpy(rng.standard_normal(gf.dim).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal(gf.num_rows).astype(np.float32))
    z = gf.matvec(w)
    zs = gf.matvec(shard_vector_feat(w, mesh))
    gs = gf.rmatvec(shard_vector_data(c, mesh))
    np.testing.assert_array_equal(fetch_global(zs), z.numpy())
    np.testing.assert_array_equal(fetch_global(gs), gf.rmatvec(c).numpy())
    assert torch.equal(gf.matvec(w), z) and torch.equal(gf.rmatvec(c), gf.rmatvec(c))
    # [lanes, d] coefficients map lane by lane
    w2 = torch.stack([w, 2 * w])
    assert torch.equal(gf.matvec(w2)[1], gf.matvec(2 * w))


def test_padded_shapes_equal_jax_for_non_divisible(rng):
    rows, cols, vals, shape = _problem(rng, n=97, d=41)
    for grid in [(2, 2), (4, 2), (1, 4), (3, 1), (1, 1)]:
        for engine in ("benes", "ell", "fused"):
            gf = grid_from_coo(rows, cols, vals, shape, grid_mesh(*grid, device="cpu"),
                               engine=engine)
            jgf, *_ = _jax_grid(rows, cols, vals, shape, grid,
                                "benes" if engine == "fused" else engine)
            assert (gf.num_rows, gf.dim) == (jgf.num_rows, jgf.dim), (grid, engine)
            assert gf.num_rows % grid[0] == 0 and gf.dim % grid[1] == 0


def test_single_tile_is_the_single_device_engine(rng):
    from photon_ml_tpu_torch.ops import fused_perm, sparse_perm

    rows, cols, vals, shape = _problem(rng)
    mesh = grid_mesh(1, 1, device="cpu")
    for engine, single in (("fused", fused_perm.from_coo(rows, cols, vals, shape, device="cpu")),
                           ("benes", sparse_perm.from_coo(rows, cols, vals, shape,
                                                          device="cpu"))):
        gf = grid_from_coo(rows, cols, vals, shape, mesh, engine=engine)
        assert type(gf.shards[0][0]) is type(single)
        w = torch.from_numpy(rng.standard_normal(shape[1]).astype(np.float32))
        assert torch.equal(gf.matvec(w), single.matvec(w))
    bf16 = grid_from_coo(rows, cols, vals, shape, mesh, engine="fused",
                         payload_dtype="bfloat16")
    assert bf16.shards[0][0].payload_dtype == "bfloat16"


def test_refusals():
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        grid_mesh(2, 2, devices=["cpu", "cpu"])
    rows, cols, vals, shape = np.zeros(1, np.int64), np.zeros(1, np.int64), np.ones(1), (2, 2)
    mesh = grid_mesh(1, 2, device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        grid_from_coo(rows, cols, vals, shape, mesh, engine="dense")
    with pytest.raises(ValueError, match="payload_dtype applies to the fused engine only"):
        grid_from_coo(rows, cols, vals, shape, mesh, engine="ell", payload_dtype="bfloat16")
    assert isinstance(grid_from_coo(rows, cols, vals, shape, mesh, engine="ell"),
                      GridShardedFeatures)


def _logistic(rng, n=160, d=30):
    rows, cols, vals, shape = _problem(rng, n=n, d=d, k=4)
    dense = _dense(rows, cols, vals, shape)
    w_true = rng.standard_normal(d).astype(np.float32) * 0.5
    y = (rng.random(n) < 1 / (1 + np.exp(-dense @ w_true))).astype(np.float32)
    return rows, cols, vals, shape, y


@pytest.mark.parametrize("optimizer", ["LBFGS", "TRON"])
def test_solvers_on_a_grid_match_one_device(rng, optimizer):
    from photon_ml_tpu_torch.estimators.model_training import train_glm
    from photon_ml_tpu_torch.ops import fused_perm
    from photon_ml_tpu_torch.ops.data import LabeledData
    from photon_ml_tpu_torch.opt.config import (
        GlmOptimizationConfiguration, OptimizerConfig, OptimizerType)
    from photon_ml_tpu_torch.types import TaskType

    rows, cols, vals, shape, y = _logistic(rng)
    n, d = shape
    cfg = GlmOptimizationConfiguration(
        optimizer_config=OptimizerConfig(optimizer=OptimizerType[optimizer], max_iterations=40),
        regularization_weight=1.0)
    single = LabeledData.create(fused_perm.from_coo(rows, cols, vals, shape, device="cpu"),
                                torch.from_numpy(y))
    gf = grid_from_coo(rows, cols, vals, shape, grid_mesh(2, 2, device="cpu"), engine="benes")
    pad_n = gf.num_rows - n
    grid = LabeledData.create(
        gf, torch.nn.functional.pad(torch.from_numpy(y), (0, pad_n)),
        weights=torch.nn.functional.pad(torch.ones(n), (0, pad_n)))
    res_s = train_glm(single, TaskType.LOGISTIC_REGRESSION, cfg)[0]
    res_g = train_glm(grid, TaskType.LOGISTIC_REGRESSION, cfg)[0]
    assert float(res_g.result.value[0]) == pytest.approx(float(res_s.result.value[0]), rel=1e-4)
    w_s = res_s.model.coefficients.means.numpy()
    w_g = res_g.model.coefficients.means.numpy()
    np.testing.assert_allclose(w_g[:d], w_s, atol=2e-3)
    np.testing.assert_allclose(w_g[d:], 0.0, atol=1e-5)

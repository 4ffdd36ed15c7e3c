"""The port's multi-card layouts on the CPU, against the JAX package's
meshes of conftest's forced host devices:

- a grid fixed-effect solve (L-BFGS, TRON, OWL-QN) holds its whole state
  as feat blocks of ``d_loc`` (``parallel.mesh.BlockVector``), the s/y
  rings included, and makes no whole ``[d_pad]`` tensor while it runs (a
  dispatch mode sees every tensor the solve makes); it matches the JAX
  grid solve (objective rtol 1e-4, coefficients atol 2e-3) and repeats
  bitwise;
- ``GameEstimator.fit`` on a 2 x 2 grid keeps the fixed effect's solve
  vector in feat blocks between outer iterations, its random-effect
  slices placed once on their positions, and matches the JAX grid fit
  (objective rtol 1e-4, coefficients atol 2e-3, scores within 2e-4 of
  their largest magnitude) and repeats bitwise.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from photon_ml_tpu_torch.losses.objective import make_glm_objective
from photon_ml_tpu_torch.losses.pointwise import LogisticLoss
from photon_ml_tpu_torch.ops.data import LabeledData
from photon_ml_tpu_torch.opt import lbfgs, owlqn, tron
from photon_ml_tpu_torch.opt.config import (
    GlmOptimizationConfiguration,
    OptimizerConfig,
    RegularizationContext,
    RegularizationType,
)
from photon_ml_tpu_torch.opt.solve import solve
from photon_ml_tpu_torch.parallel.grid_features import (
    FEAT_AXIS,
    grid_from_coo,
    grid_mesh,
    shard_vector_data,
)
from photon_ml_tpu_torch.parallel.mesh import BlockVector, fetch_global

# rows and columns: d_pad (100) is no other size the solve meets
N, D, K = 512, 100, 4


def _problem(seed=3):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(N), K + 1)
    cols = np.concatenate([rng.integers(1, D, (N, K)), np.zeros((N, 1), np.int64)],
                          axis=1).reshape(-1)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    dense = np.zeros((N, D), np.float32)
    np.add.at(dense, (rows, cols), vals)
    w_true = (rng.standard_normal(D) * 0.3).astype(np.float32)
    y = (rng.random(N) < 1.0 / (1.0 + np.exp(-dense @ w_true))).astype(np.float32)
    return rows, cols, vals, y


def _config(optimizer: str) -> GlmOptimizationConfiguration:
    if optimizer == "TRON":
        return GlmOptimizationConfiguration(
            optimizer_config=OptimizerConfig.tron(max_iterations=12), regularization_weight=1.0)
    if optimizer == "OWLQN":
        return GlmOptimizationConfiguration(
            optimizer_config=OptimizerConfig.lbfgs(max_iterations=40), regularization_weight=1.0,
            regularization=RegularizationContext(RegularizationType.ELASTIC_NET, 0.5))
    return GlmOptimizationConfiguration(
        optimizer_config=OptimizerConfig.lbfgs(max_iterations=40), regularization_weight=1.0)


class _WholeVectors(TorchDispatchMode):
    """Records the shape of every tensor an operation returns with a
    dimension of ``size``."""

    def __init__(self, size: int):
        super().__init__()
        self.size, self.seen = size, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and self.size in t.shape:
                self.seen.append((str(func), tuple(t.shape)))
        return out


def _state_layouts(monkeypatch):
    """Wrap each solver's step: the layout of every vector field of every
    state it returns."""
    seen = []

    def wrap(module, name):
        step = getattr(module, name)

        def recorded(*args, **kwargs):
            state = step(*args, **kwargs)
            for field, value in vars(state).items():
                if isinstance(value, torch.Tensor) and value.dim() >= 2 and value.shape[-1] >= D:
                    seen.append((field, "whole", tuple(value.shape)))
                elif isinstance(value, BlockVector):
                    seen.append((field, value.axis, {k: (tuple(b.shape), str(b.device))
                                                     for k, b in value.blocks.items()}))
            return state

        monkeypatch.setattr(module, name, recorded)

    wrap(lbfgs, "_lbfgs_step")
    wrap(tron, "_tron_step")
    wrap(owlqn, "_owlqn_step")
    return seen


def _grid_solve(grid, optimizer, engine="fused"):
    rows, cols, vals, y = _problem()
    mesh = grid_mesh(*grid, device="cpu")
    gf = grid_from_coo(rows, cols, vals, (N, D), mesh, engine=engine)
    pad = gf.num_rows - N
    data = LabeledData(
        features=gf,
        labels=shard_vector_data(np.pad(y, (0, pad)), mesh),
        offsets=shard_vector_data(np.zeros(gf.num_rows, np.float32), mesh),
        weights=shard_vector_data(np.pad(np.ones(N, np.float32), (0, pad)), mesh))
    w0 = gf.feat_full(0.0).unsqueeze(0)
    cfg = _config(optimizer)
    l2 = None if optimizer == "OWLQN" else 1.0
    with _WholeVectors(gf.dim) as whole:
        res = solve(make_glm_objective(LogisticLoss), w0, data, cfg, l2_weight=l2)
    return res, gf, whole.seen


def _jax_grid_solve(grid, optimizer):
    import jax
    import jax.numpy as jnp

    from photon_ml_tpu.losses.objective import make_glm_objective as jax_objective
    from photon_ml_tpu.losses.pointwise import LogisticLoss as JaxLogistic
    from photon_ml_tpu.ops.data import LabeledData as JaxLabeledData
    from photon_ml_tpu.opt import config as jcfg
    from photon_ml_tpu.opt.solve import solve as jax_solve
    from photon_ml_tpu.parallel import grid_features as jg

    rows, cols, vals, y = _problem()
    mesh = jg.grid_mesh(*grid)
    gf = jg.grid_from_coo(rows, cols, vals, (N, D), mesh, engine="ell")
    pad = gf.num_rows - N
    data = JaxLabeledData.create(
        gf, jg.shard_vector_data(jnp.asarray(np.pad(y, (0, pad))), mesh),
        weights=jg.shard_vector_data(jnp.asarray(np.pad(np.ones(N, np.float32), (0, pad))),
                                     mesh))
    if optimizer == "TRON":
        opt = jcfg.OptimizerConfig.tron(max_iterations=12)
    else:
        opt = jcfg.OptimizerConfig.lbfgs(max_iterations=40)
    cfg = jcfg.GlmOptimizationConfiguration(optimizer_config=opt, regularization_weight=1.0)
    w0 = jg.shard_vector_feat(jnp.zeros(gf.dim, jnp.float32), mesh)
    res = jax.jit(lambda w, dd: jax_solve(jax_objective(JaxLogistic), w, dd, cfg,
                                          l2_weight=jnp.float32(1.0)))(w0, data)
    return float(res.value), np.asarray(res.w)


def _assert_feat_blocks(seen, gf, grid):
    d_loc = gf.dim // grid[1]
    assert seen, "no solver step ran"
    for field, axis, layout in seen:
        assert axis == FEAT_AXIS, (field, axis, layout)
        # one block a feat column, one tensor where a column's positions
        # share a device
        assert sorted(layout) == list(range(grid[1])), (field, layout)
        for shape, device in layout.values():
            assert shape[-1] == d_loc and device == "cpu", (field, layout)


@pytest.mark.parametrize("grid", [(2, 2), (1, 4)])
@pytest.mark.parametrize("optimizer", ["LBFGS", "TRON"])
def test_grid_solve_state_is_feat_blocks_and_matches_the_jax_grid(monkeypatch, grid, optimizer):
    seen = _state_layouts(monkeypatch)
    res, gf, whole = _grid_solve(grid, optimizer)
    fields = {f for f, _, _ in seen}
    want = {"w", "g"} | ({"s_hist", "y_hist"} if optimizer == "LBFGS" else set())
    assert want <= fields, fields
    _assert_feat_blocks(seen, gf, grid)
    assert whole == [], whole[:5]
    again, _, _ = _grid_solve(grid, optimizer)
    w, w2 = fetch_global(res.w[0]), fetch_global(again.w[0])
    assert np.array_equal(w.view(np.int32), w2.view(np.int32))
    assert torch.equal(res.value, again.value)
    j_value, j_w = _jax_grid_solve(grid, optimizer)
    assert float(res.value[0]) == pytest.approx(j_value, rel=1e-4)
    np.testing.assert_allclose(w[:D], j_w[:D], atol=2e-3)
    np.testing.assert_allclose(w[D:], 0.0, atol=1e-5)


def test_grid_owlqn_state_is_feat_blocks_and_matches_one_device(monkeypatch):
    from photon_ml_tpu_torch.ops import fused_perm

    seen = _state_layouts(monkeypatch)
    res, gf, whole = _grid_solve((2, 2), "OWLQN")
    assert {"w", "g", "s_hist", "y_hist"} <= {f for f, _, _ in seen}
    _assert_feat_blocks(seen, gf, (2, 2))
    assert whole == [], whole[:5]
    rows, cols, vals, y = _problem()
    single = LabeledData.create(fused_perm.from_coo(rows, cols, vals, (N, D), device="cpu"),
                                torch.from_numpy(y))
    one = solve(make_glm_objective(LogisticLoss), torch.zeros(1, D), single, _config("OWLQN"))
    assert float(res.value[0]) == pytest.approx(float(one.value[0]), rel=1e-4)
    np.testing.assert_allclose(fetch_global(res.w[0])[:D], one.w[0].numpy(), atol=2e-3)


def test_block_vector_reductions_are_in_block_order():
    mesh = grid_mesh(2, 2, device="cpu")
    x = torch.linspace(-3, 5, 12)
    bv = BlockVector.place(x, mesh, FEAT_AXIS)
    assert sorted(bv.blocks) == [0, 1] and bv.blocks[0].shape == (6,)
    assert bv.sum() == x[:6].sum() + x[6:].sum()
    assert torch.equal(bv.full(), x) and torch.equal(bv.full(length=7), x[:7])
    assert float(bv[7]) == float(x[7])
    bv[7] = torch.tensor(9.0)
    assert float(bv.full()[7]) == 9.0
    lanes = bv.unsqueeze(0)
    assert lanes.shape == (1, 12) and torch.equal((lanes * lanes).sum(-1),
                                                  (x[:6] ** 2).sum().reshape(1)
                                                  + (bv.blocks[1] ** 2).sum().reshape(1))
    with pytest.raises(ValueError, match="does not split"):
        BlockVector.place(torch.zeros(7), mesh, FEAT_AXIS)


def test_grid_fit_keeps_its_layouts_and_matches_the_jax_grid_fit():
    from test_torch_parallel_estimator import _coords, _data, _glmix_numpy

    from photon_ml_tpu.data import game_data as jgd
    from photon_ml_tpu.estimators.game import GameEstimator as JGameEstimator
    from photon_ml_tpu.estimators.game import ParallelConfiguration as JParallel
    from photon_ml_tpu.types import TaskType as JTaskType
    from photon_ml_tpu_torch.data import game_data
    from photon_ml_tpu_torch.data.random_effect import PlacedBucket
    from photon_ml_tpu_torch.estimators.game import GameEstimator, ParallelConfiguration
    from photon_ml_tpu_torch.types import TaskType

    y, shards, tags = _glmix_numpy(np.random.default_rng(7))
    data, jdata = _data(game_data, y, shards, tags), _data(jgd, y, shards, tags)
    est = GameEstimator(task=TaskType.LOGISTIC_REGRESSION, coordinates=_coords(),
                        num_outer_iterations=2, device="cpu",
                        parallel=ParallelConfiguration(2, 2, engine="benes"))
    coords = est.build_coordinates(data)
    fit = est.fit(data, coordinates=coords)
    jfit = JGameEstimator(task=JTaskType.LOGISTIC_REGRESSION, coordinates=_coords("jax"),
                          num_outer_iterations=2,
                          parallel=JParallel(n_data=2, n_feat=2, engine="benes")).fit(jdata)

    fe = coords["global"]
    gf = fe.data.features
    _, blocks = fe._w_padded_cache
    assert isinstance(blocks, BlockVector) and blocks.axis == FEAT_AXIS
    assert {k: tuple(b.shape) for k, b in blocks.blocks.items()} == {0: (gf.d_loc,),
                                                                      1: (gf.d_loc,)}
    for arr in (fe.data.labels, fe.data.offsets, fe.data.weights):
        assert isinstance(arr, BlockVector) and arr.axis == "data"
    for bucket in coords["per-user"].dataset.buckets:
        assert isinstance(bucket, PlacedBucket) and len(bucket.local()) == 4
        assert {sl.num_entities for _, sl in bucket.local()} == {bucket.per_slice}

    w = fit.model.models["global"].coefficients.means.numpy()
    jw = np.asarray(jfit.model.models["global"].coefficients.means)
    assert w.shape == jw.shape == (shards["g"][3],)
    np.testing.assert_allclose(w, jw, atol=2e-3)
    assert fit.objective_history[-1][1] == pytest.approx(jfit.objective_history[-1][1],
                                                         rel=1e-4)
    # scores within 2e-4 of the scores' scale (a score near 0 carries the
    # random effects' f32 stop decisions, as on one device)
    s, js = fit.model.score(data).numpy(), np.asarray(jfit.model.score(jdata))
    assert np.abs(s - js).max() <= 2e-4 * np.abs(js).max()
    again = est.fit(data, coordinates=coords)
    assert again.objective_history == fit.objective_history
    assert torch.equal(again.model.models["global"].coefficients.means,
                       fit.model.models["global"].coefficients.means)


def test_factored_coordinate_on_a_grid_projects_its_slices_in_place():
    """A factored coordinate on a 2 x 2 grid: its slices placed once, the
    latent datasets derived from them where they live, and the fit the
    one-device fit's (objective rtol 1e-4, B atol 2e-3)."""
    from _torch_parity import glmix_numpy, solver_configs, torch_game_data

    from photon_ml_tpu_torch.algorithm.factored_random_effect import (
        MFOptimizationConfiguration,
        _latent_dataset,
    )
    from photon_ml_tpu_torch.data.random_effect import (
        PlacedBucket,
        RandomEffectDataConfiguration,
    )
    from photon_ml_tpu_torch.estimators import game
    from photon_ml_tpu_torch.types import TaskType

    _, opt = solver_configs(max_iterations=20)

    def estimator(parallel):
        return game.GameEstimator(TaskType.LOGISTIC_REGRESSION, {
            "fixed": game.FixedEffectCoordinateConfiguration("global", opt),
            "user_item_mf": game.FactoredRandomEffectCoordinateConfiguration(
                "per_item", RandomEffectDataConfiguration("userId"),
                MFOptimizationConfiguration(3, 2), opt),
        }, num_outer_iterations=1, device="cpu", parallel=parallel)

    train = torch_game_data(*glmix_numpy(11)[:3])
    est = estimator(game.ParallelConfiguration(2, 2, engine="ell"))
    coords = est.build_coordinates(train)
    fit = est.fit(train, coordinates=coords)
    one = estimator(None).fit(train)
    mf = coords["user_item_mf"]
    latent = _latent_dataset(mf.dataset, fit.model.models["user_item_mf"].projection_matrix)
    for bucket in latent.buckets:
        assert isinstance(bucket, PlacedBucket) and len(bucket.local()) == 4
        assert all(sl.X.shape[-1] == 3 for _, sl in bucket.local())
    np.testing.assert_allclose([v for _, v in fit.objective_history],
                               [v for _, v in one.objective_history], rtol=1e-4)
    np.testing.assert_allclose(fit.model.models["user_item_mf"].projection_matrix.numpy(),
                               one.model.models["user_item_mf"].projection_matrix.numpy(),
                               atol=2e-3)


def test_grid_fit_with_standardization_and_variances_matches_one_device():
    """The normalization's factor and shift as feat blocks (the intercept's
    shift correction an element of a block) and the variances computed
    block by block: the 2 x 2 grid fit equals the one-device fit
    (coefficients atol 2e-3, variances rtol 1e-2, objective rtol 1e-4)."""
    from test_torch_parallel_estimator import _coords, _data, _glmix_numpy

    from photon_ml_tpu_torch.data import game_data
    from photon_ml_tpu_torch.estimators.game import GameEstimator, ParallelConfiguration
    from photon_ml_tpu_torch.normalization import build_normalization_context
    from photon_ml_tpu_torch.types import NormalizationType, TaskType

    y, shards, tags = _glmix_numpy(np.random.default_rng(7))
    data = _data(game_data, y, shards, tags)
    rows, cols, vals, d = shards["g"]
    dense = np.zeros((y.size, d), np.float32)
    np.add.at(dense, (rows, cols), vals)
    ctx = build_normalization_context(
        NormalizationType.STANDARDIZATION, torch.from_numpy(dense.mean(0)),
        torch.from_numpy(dense.var(0)), torch.from_numpy(np.abs(dense).max(0)), 0)

    def fit(parallel):
        return GameEstimator(
            task=TaskType.LOGISTIC_REGRESSION, coordinates=_coords(), num_outer_iterations=2,
            device="cpu", parallel=parallel, compute_variance=True,
            normalization={"g": ctx}, intercept_indices={"g": 0}).fit(data)

    one, grid = fit(None), fit(ParallelConfiguration(2, 2, engine="ell"))
    a, b = one.model.models["global"].coefficients, grid.model.models["global"].coefficients
    assert b.means.shape == b.variances.shape == (d,)
    np.testing.assert_allclose(b.means.numpy(), a.means.numpy(), atol=2e-3)
    np.testing.assert_allclose(b.variances.numpy(), a.variances.numpy(), rtol=1e-2)
    assert grid.objective_history[-1][1] == pytest.approx(one.objective_history[-1][1],
                                                          rel=1e-4)

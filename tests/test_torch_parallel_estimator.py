"""GameEstimator over a (data x feat) device grid
(``ParallelConfiguration``) on the CPU: a GLMix fit on a 2 x 2 grid (FE
tiles, per-user entity blocks split over the 4 grid devices) against the
port's single-device fit and the JAX package's grid fit on conftest's
forced host devices (w atol 5e-3, scores atol 1e-2, as JAX
``tests/test_parallel_estimator.py``); a single-device checkpoint resuming
on a grid; tuning trials keeping the layout; the host score plane against
the device plane; weights carried across from the JAX package's grid fit.
"""

import numpy as np
import pytest
import torch

from _torch_parity import coordinates_of_jax_model
from photon_ml_tpu_torch.convert import game_model_from_numpy
from photon_ml_tpu_torch.estimators.game import GameEstimator, ParallelConfiguration
from photon_ml_tpu_torch.types import TaskType

N_USERS = 13  # not a multiple of the grid: entity padding runs


def _glmix_numpy(rng, n=400, d=37, k=4, n_users=N_USERS, d_u=3):
    rows = np.repeat(np.arange(n), k + 1)
    cols = np.concatenate([rng.integers(1, d, (n, k)), np.zeros((n, 1), np.int64)],
                          axis=1).reshape(-1)
    vals = np.concatenate([rng.standard_normal((n, k)).astype(np.float32),
                           np.ones((n, 1), np.float32)], axis=1).reshape(-1)
    users = [f"u{i % n_users}" for i in range(n)]
    dense = np.zeros((n, d), np.float32)
    np.add.at(dense, (rows, cols), vals)
    w_true = (rng.standard_normal(d) * 0.4).astype(np.float32)
    xu = np.concatenate([np.ones((n, 1), np.float32),
                         rng.standard_normal((n, d_u - 1)).astype(np.float32)], axis=1)
    wu = {f"u{u}": rng.standard_normal(d_u) * 0.5 for u in range(n_users)}
    z = dense @ w_true + np.array([xu[i] @ wu[users[i]] for i in range(n)], np.float32)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-z))).astype(np.float32)
    shards = {"g": (rows, cols, vals, d),
              "u": (np.repeat(np.arange(n), d_u), np.tile(np.arange(d_u), n),
                    xu.reshape(-1), d_u)}
    return y, shards, {"userId": users}


def _data(pkg_data, y, shards, tags):
    return pkg_data.GameData(
        labels=y, feature_shards={k: pkg_data.FeatureShard(*v) for k, v in shards.items()},
        id_tags=tags, offsets=np.zeros(y.size, np.float32), weights=np.ones(y.size, np.float32))


@pytest.fixture(scope="module")
def problem():
    y, shards, tags = _glmix_numpy(np.random.default_rng(7))
    from photon_ml_tpu_torch.data import game_data

    return {"numpy": (y, shards, tags), "data": _data(game_data, y, shards, tags)}


def _coords(pkg: str = "torch"):
    """FE + per-user RE configurations of ``pkg`` ("torch" or "jax")."""
    if pkg == "torch":
        from photon_ml_tpu_torch.data.random_effect import RandomEffectDataConfiguration as RE
        from photon_ml_tpu_torch.estimators import game as est
        from photon_ml_tpu_torch.opt import config as opt_mod
    else:
        from photon_ml_tpu.data.random_effect import RandomEffectDataConfiguration as RE
        from photon_ml_tpu.estimators import game as est
        from photon_ml_tpu.opt import config as opt_mod
    opt = opt_mod.GlmOptimizationConfiguration(
        optimizer_config=opt_mod.OptimizerConfig.lbfgs(max_iterations=30),
        regularization_weight=1.0)
    re_opt = opt_mod.GlmOptimizationConfiguration(
        optimizer_config=opt_mod.OptimizerConfig.lbfgs(max_iterations=30),
        regularization_weight=5.0)
    return {
        "global": est.FixedEffectCoordinateConfiguration(feature_shard="g", optimizer=opt),
        "per-user": est.RandomEffectCoordinateConfiguration(
            feature_shard="u", data=RE(random_effect_type="userId"), optimizer=re_opt),
    }


def _estimator(parallel=None, outer=2, **kw):
    return GameEstimator(task=TaskType.LOGISTIC_REGRESSION, coordinates=_coords(),
                         num_outer_iterations=outer, device="cpu", parallel=parallel, **kw)


def _w(model):
    w = model.models["global"].coefficients.means
    return w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)


def _scores(model, data):
    s = model.score(data)
    return s.numpy() if isinstance(s, torch.Tensor) else np.asarray(s)


@pytest.mark.parametrize("grid,engine", [((2, 2), "benes"), ((4, 1), "fused"),
                                         ((1, 2), "ell")])
def test_grid_fit_matches_single_device(problem, grid, engine):
    data = problem["data"]
    single = _estimator().fit(data)
    gridded = _estimator(ParallelConfiguration(*grid, engine=engine)).fit(data)
    assert _w(gridded.model).shape == _w(single.model).shape  # trimmed to real d
    np.testing.assert_allclose(_w(gridded.model), _w(single.model), atol=5e-3)
    np.testing.assert_allclose(_scores(gridded.model, data), _scores(single.model, data),
                               atol=1e-2)
    assert gridded.objective_history[-1][1] == pytest.approx(
        single.objective_history[-1][1], rel=1e-4)
    # the entity padding leaves the models' entities as they were
    re_g = gridded.model.models["per-user"]
    assert re_g.entity_ids == single.model.models["per-user"].entity_ids


def test_grid_fit_matches_the_jax_grid_fit(problem):
    from photon_ml_tpu.data import game_data as jgd
    from photon_ml_tpu.estimators.game import GameEstimator as JGameEstimator
    from photon_ml_tpu.estimators.game import ParallelConfiguration as JParallel
    from photon_ml_tpu.types import TaskType as JTaskType

    y, shards, tags = problem["numpy"]
    jdata = _data(jgd, y, shards, tags)
    jfit = JGameEstimator(task=JTaskType.LOGISTIC_REGRESSION, coordinates=_coords("jax"),
                          num_outer_iterations=2,
                          parallel=JParallel(n_data=2, n_feat=2, engine="benes")).fit(jdata)
    tfit = _estimator(ParallelConfiguration(2, 2, engine="benes")).fit(problem["data"])
    np.testing.assert_allclose(_w(tfit.model), _w(jfit.model), atol=5e-3)
    np.testing.assert_allclose(_scores(tfit.model, problem["data"]),
                               _scores(jfit.model, jdata), atol=1e-2)
    # the JAX grid model's arrays (its entity padding trimmed) score as the
    # port's model does
    carried = game_model_from_numpy(coordinates_of_jax_model(jfit.model),
                                    "LOGISTIC_REGRESSION", device="cpu")
    assert carried.models["per-user"].coefficients[0].shape[0] == len(
        carried.models["per-user"].entity_ids[0])
    np.testing.assert_allclose(_scores(carried, problem["data"]), _scores(jfit.model, jdata),
                               atol=1e-5)
    # and warm-starts the port's grid fit (its padded lanes restored) as it
    # warm-starts the single-device fit
    warm_grid = _estimator(ParallelConfiguration(2, 2, engine="benes"), outer=1).fit(
        problem["data"], initial_models=carried.models)
    warm_single = _estimator(outer=1).fit(problem["data"], initial_models=carried.models)
    np.testing.assert_allclose(_w(warm_grid.model), _w(warm_single.model), atol=5e-3)
    np.testing.assert_allclose(_scores(warm_grid.model, problem["data"]),
                               _scores(warm_single.model, problem["data"]), atol=1e-2)


def test_single_device_checkpoint_resumes_on_grid(problem, tmp_path):
    data = problem["data"]
    ckpt = str(tmp_path / "ckpt")
    _estimator(outer=1).fit(data, checkpoint_dir=ckpt)
    resumed = _estimator(ParallelConfiguration(2, 2, engine="benes")).fit(data,
                                                                         checkpoint_dir=ckpt)
    straight = _estimator().fit(data)
    assert len(resumed.objective_history) == len(straight.objective_history)
    np.testing.assert_allclose(_w(resumed.model), _w(straight.model), atol=5e-3)
    np.testing.assert_allclose(_scores(resumed.model, data), _scores(straight.model, data),
                               atol=1e-2)


def test_tuning_trials_keep_the_layout(problem, monkeypatch):
    import photon_ml_tpu_torch.estimators.tuning as tuning_mod

    base = _estimator(ParallelConfiguration(2, 2, engine="ell"), outer=1, score_plane="host")
    fn = tuning_mod.GameEstimatorEvaluationFunction(base, problem["data"], problem["data"])
    captured = {}
    real_cls = tuning_mod.GameEstimator

    def spy(*args, **kwargs):
        captured.update(kwargs)
        return real_cls(*args, **kwargs)

    monkeypatch.setattr(tuning_mod, "GameEstimator", spy)
    value, trial = fn(np.zeros(fn.num_params))
    assert captured["parallel"] is base.parallel
    assert captured["score_plane"] == "host"
    assert np.isfinite(value)


def test_host_score_plane_is_the_device_plane(problem):
    data = problem["data"]
    for parallel in (None, ParallelConfiguration(2, 2, engine="ell")):
        est_d = _estimator(parallel)
        est_h = _estimator(parallel, score_plane="host")
        fit_d, fit_h = est_d.fit(data), est_h.fit(data)
        # the same incremental algebra in numpy: bitwise the same fit
        assert fit_h.objective_history == fit_d.objective_history
        assert torch.equal(fit_h.model.models["global"].coefficients.means,
                           fit_d.model.models["global"].coefficients.means)
        t_h, t_d = est_h.last_transfer_stats, est_d.last_transfer_stats
        assert t_h.score_plane == "host" and t_d.score_plane == "device"
        updates = t_h.coordinate_updates
        assert t_h.row_transfers_h2d == updates and t_h.row_transfers_d2h == updates
        assert t_d.row_transfers_h2d == t_d.row_transfers_d2h == 0
        assert t_d.device_plane_updates == updates and t_h.device_plane_updates == 0
    with pytest.raises(ValueError, match="score_plane"):
        _estimator(score_plane="numpy")


def test_async_falls_back_to_sync_on_the_host_plane(problem):
    est = _estimator(score_plane="host", schedule="async")
    assert est._effective_schedule() == "sync"
    assert _estimator(schedule="async")._effective_schedule() == "async"


def test_streaming_refuses_a_grid(problem):
    with pytest.raises(ValueError, match="device-grid"):
        _estimator(ParallelConfiguration(2, 1, engine="ell")).fit_streaming(object())

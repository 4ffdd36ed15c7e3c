"""Factored random effects (per-entity latent factors and a learned
projection matrix) in the port against the JAX package, on the same seeded
numpy inputs:

- ``KronFeatures``' matvec, rmatvec, rmatvec_sq and row_norms_sq, rtol 2e-4;
- ``_latent_dataset``'s buckets and passive rows;
- one ``FactoredRandomEffectCoordinate`` update (2 MF iterations from the
  same B₀): latent factors and B atol 2e-3, scores rtol 2e-4;
- a RANDOM-projected dataset is rejected;
- ``_score_factored_re_rows`` with unseen entities, rtol 2e-4, atol 1e-5;
- ``GameEstimator.fit`` of a fixed effect, two random effects and a
  factored coordinate (the shape of BASELINE.md configuration 5):
  objectives rtol 1e-4, validation AUC to 1e-4;
- the model files: a full-GAME model saved by the port scores the same in
  the JAX package, and its latent-factor files round-trip;
- the ``train_game`` and ``score_game`` CLIs with a factored coordinate on
  the committed ratings fixture, against the JAX CLI.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import glmix_numpy, jax_game_data, solver_configs, torch_game_data
from photon_ml_tpu.algorithm import factored_random_effect as jax_fre
from photon_ml_tpu.data.random_effect import RandomEffectDataConfiguration as JaxReData
from photon_ml_tpu.data.random_effect import build_random_effect_dataset as jax_build
from photon_ml_tpu.estimators import game as jax_game
from photon_ml_tpu.evaluation.evaluators import AUC as JaxAUC
from photon_ml_tpu.models import game as jax_models_game
from photon_ml_tpu.models.random_effect import RandomEffectModel as JaxReModel
from photon_ml_tpu.types import TaskType as JaxTask
from photon_ml_tpu_torch.algorithm import factored_random_effect as fre
from photon_ml_tpu_torch.cli import score_game, train_game
from photon_ml_tpu_torch.data.game_data import FeatureShard
from photon_ml_tpu_torch.data.random_effect import (
    RandomEffectDataConfiguration,
    build_random_effect_dataset,
)
from photon_ml_tpu_torch.estimators import game
from photon_ml_tpu_torch.io import model_io
from photon_ml_tpu_torch.models import game as models_game
from photon_ml_tpu_torch.models.random_effect import RandomEffectModel
from photon_ml_tpu_torch.projector import ProjectorType
from photon_ml_tpu_torch.types import TaskType

RATINGS = os.path.join(os.path.dirname(__file__), "fixtures", "ratings")
K = 3


def _low_rank(seed=0, n=400, d=15, entities=12):
    """Rows whose per-entity coefficients share a rank-2 matrix, a third of
    the features nonzero; COO triplets, labels and entity ids."""
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((d, 2))
    V = rng.standard_normal((entities, 2))
    X = (rng.standard_normal((n, d)) * (rng.random((n, d)) < 0.3)).astype(np.float32)
    e_of = rng.integers(0, entities, n)
    z = np.einsum("nd,nd->n", X, (B @ V.T).T[e_of])
    y = (z + 0.3 * rng.standard_normal(n) > 0).astype(np.float32)
    rows, cols = np.nonzero(X)
    ids = np.array([f"e{e}" for e in e_of])
    return ids, rows, cols, X[rows, cols], y, d


def _datasets(seed=0, **cfg):
    """The same random-effect dataset in both packages: two buckets, and
    passive rows (entities capped at 30 active rows)."""
    ids, rows, cols, vals, y, d = _low_rank(seed)
    cfg = {"num_buckets": 2, "active_data_upper_bound": 30, "passive_data_lower_bound": 1,
           **cfg}
    jds = jax_build(ids, rows, cols, vals, d, y, JaxReData("e", **cfg))
    tds = build_random_effect_dataset(
        ids, rows, cols, vals, d, y, RandomEffectDataConfiguration("e", **cfg), device="cpu"
    )
    return jds, tds


def _close(a, b, rtol=2e-4, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), b.detach().cpu().numpy() if
                               isinstance(b, torch.Tensor) else b, rtol=rtol, atol=atol)


def test_kron_features_maps_match_jax():
    jds, tds = _datasets()
    assert any(p is not None for p in tds.passive)
    rng = np.random.default_rng(1)
    latents = [rng.standard_normal((b.num_entities, K)).astype(np.float32) for b in tds.buckets]
    d = tds.global_dim
    jk = jax_fre.KronFeatures(
        xs=[b.X for b in jds.buckets], pidxs=[b.proj_indices for b in jds.buckets],
        latents=[jnp.asarray(v) for v in latents], d_global=d, k=K,
    )
    tk = fre.KronFeatures(
        xs=[b.X for b in tds.buckets], pidxs=[b.proj_indices for b in tds.buckets],
        latents=[torch.from_numpy(v) for v in latents], d_global=d, k=K,
    )
    assert (tk.num_rows, tk.dim) == (jk.num_rows, jk.dim)
    w = rng.standard_normal(d * K).astype(np.float32)
    c = rng.standard_normal(tk.num_rows).astype(np.float32)
    _close(jk.matvec(jnp.asarray(w)), tk.matvec(torch.from_numpy(w)))
    _close(jk.rmatvec(jnp.asarray(c)), tk.rmatvec(torch.from_numpy(c)))
    _close(jk.rmatvec_sq(jnp.asarray(c)), tk.rmatvec_sq(torch.from_numpy(c)))
    _close(jk.row_norms_sq(), tk.row_norms_sq())


def test_latent_dataset_matches_jax():
    jds, tds = _datasets()
    B = np.random.default_rng(2).standard_normal((tds.global_dim, K)).astype(np.float32)
    jl = jax_fre._latent_dataset(jds, jnp.asarray(B))
    tl = fre._latent_dataset(tds, torch.from_numpy(B))
    assert tl.global_dim == jl.global_dim == K
    assert tl.config.projector is ProjectorType.IDENTITY
    assert tl.entity_ids == jl.entity_ids
    for jb, tb in zip(jl.buckets, tl.buckets):
        _close(jb.X, tb.X)
        np.testing.assert_array_equal(np.asarray(jb.proj_indices), tb.proj_indices.numpy())
        np.testing.assert_array_equal(np.asarray(jb.proj_valid), tb.proj_valid.numpy())
        np.testing.assert_array_equal(np.asarray(jb.weights), tb.weights.numpy())
    for jp, tp in zip(jl.passive, tl.passive):
        assert (jp is None) == (tp is None)
        if tp is not None:
            _close(jp.X, tp.X)
            np.testing.assert_array_equal(np.asarray(jp.sample_pos), tp.sample_pos.numpy())


def _coordinates(jds, tds, n, iterations=2):
    jo, to = solver_configs(max_iterations=30)
    j = jax_fre.FactoredRandomEffectCoordinate(
        jds, JaxTask.LOGISTIC_REGRESSION, jo, jo,
        jax_fre.MFOptimizationConfiguration(K, iterations), np.zeros(n, np.float32),
    )
    t = fre.FactoredRandomEffectCoordinate(
        tds, TaskType.LOGISTIC_REGRESSION, to, to,
        fre.MFOptimizationConfiguration(K, iterations), torch.zeros(n),
    )
    return j, t


@pytest.fixture(scope="module")
def updated():
    """One update of each package's coordinate from the same B₀, against a
    seeded residual."""
    jds, tds = _datasets()
    n = tds.num_rows
    residual = (np.random.default_rng(3).standard_normal(n) * 0.3).astype(np.float32)
    j, t = _coordinates(jds, tds, n)
    jm = j.update_model(None, residual)
    tm = t.update_model_device(None, torch.from_numpy(residual))
    return j, t, jm, tm


def _port_model(jm) -> fre.FactoredRandomEffectModel:
    """The JAX package's factored model, carried into the port."""
    lat = jm.latent
    return fre.FactoredRandomEffectModel(
        random_effect_type=jm.random_effect_type, task=TaskType.LOGISTIC_REGRESSION,
        latent=RandomEffectModel(
            random_effect_type=lat.random_effect_type, task=TaskType.LOGISTIC_REGRESSION,
            coefficients=[torch.from_numpy(np.array(c)) for c in lat.coefficients],
            variances=[None for _ in lat.coefficients],
            proj_indices=[torch.from_numpy(np.asarray(p, dtype=np.int64))
                          for p in lat.proj_indices],
            proj_valid=[torch.from_numpy(np.array(p)) for p in lat.proj_valid],
            entity_ids=lat.entity_ids, entity_to_loc=lat.entity_to_loc,
            global_dim=lat.global_dim, projector_type=ProjectorType.IDENTITY,
        ),
        projection_matrix=torch.from_numpy(np.array(jm.projection_matrix)),
    )


def test_update_model_matches_jax(updated):
    """The models agree to atol 2e-3. Their scores are compared on one model:
    the two fits' own scores differ by up to 4e-3 on scores of up to 14
    (each solve stops on f32 noise near its optimum, and a score sums about
    15 products of B·latent)."""
    j, t, jm, tm = updated
    np.testing.assert_array_equal(np.asarray(j._init_matrix()), t._init_matrix().numpy())
    _close(jm.projection_matrix, tm.projection_matrix, rtol=0, atol=2e-3)
    for jw, tw in zip(jm.latent.coefficients, tm.latent.coefficients):
        _close(jw, tw, rtol=0, atol=2e-3)
    assert len(t.last_step_seconds) == 2
    _close(j.score(jm), t.score_device(_port_model(jm)), rtol=2e-4, atol=1e-5)
    # a warm-started second update runs from the first's model
    assert t.update_model_device(tm, torch.zeros(t.dataset.num_rows)).latent is not tm.latent


def test_random_projected_dataset_is_rejected():
    ids, rows, cols, vals, y, d = _low_rank()
    tds = build_random_effect_dataset(
        ids, rows, cols, vals, d, y,
        RandomEffectDataConfiguration("e", projector=ProjectorType.RANDOM, projected_dim=4),
        device="cpu",
    )
    _, to = solver_configs()
    with pytest.raises(ValueError, match="INDEX_MAP or IDENTITY"):
        fre.FactoredRandomEffectCoordinate(
            tds, TaskType.LOGISTIC_REGRESSION, to, to, fre.MFOptimizationConfiguration(K),
            torch.zeros(tds.num_rows),
        )


def test_score_factored_rows_matches_jax(updated):
    """The JAX package's fitted factored model scored by both packages on
    new rows, a tenth of them naming unseen entities."""
    _, _, jm, _ = updated
    tm = _port_model(jm)
    ids, rows, cols, vals, _, d = _low_rank(seed=5)
    ids = np.where(np.random.default_rng(6).random(ids.size) < 0.1, "new", ids)
    n = ids.size
    jshard = jax_game_data(np.zeros(n, np.float32), {"s": (rows, cols, vals, d)},
                           {}).feature_shards["s"]
    want = jax_models_game._score_factored_re_rows(jm, jshard, ids, n)
    got = models_game._score_factored_re_rows(tm, FeatureShard(rows, cols, vals, d), ids, n)
    _close(want, got, rtol=2e-4, atol=1e-5)
    assert float(got[torch.from_numpy(ids == "new")].abs().sum()) == 0.0


def _game_estimators(outer=1):
    jo, to = solver_configs(max_iterations=20)
    jmf, tmf = jax_fre.MFOptimizationConfiguration(K, 2), fre.MFOptimizationConfiguration(K, 2)
    j = jax_game.GameEstimator(JaxTask.LOGISTIC_REGRESSION, {
        "fixed": jax_game.FixedEffectCoordinateConfiguration("global", jo, sparse_engine="ell"),
        "per_user": jax_game.RandomEffectCoordinateConfiguration(
            "per_user", JaxReData("userId"), jo),
        "per_item": jax_game.RandomEffectCoordinateConfiguration(
            "per_item", JaxReData("itemId"), jo),
        "user_item_mf": jax_game.FactoredRandomEffectCoordinateConfiguration(
            "per_item", JaxReData("userId"), jmf, jo),
    # the JAX package's factored coordinate runs on its host score plane
    # only: it has neither supports_device_plane nor score_device
    }, evaluator=JaxAUC, num_outer_iterations=outer, score_plane="host")
    t = game.GameEstimator(TaskType.LOGISTIC_REGRESSION, {
        "fixed": game.FixedEffectCoordinateConfiguration("global", to),
        "per_user": game.RandomEffectCoordinateConfiguration(
            "per_user", RandomEffectDataConfiguration("userId"), to),
        "per_item": game.RandomEffectCoordinateConfiguration(
            "per_item", RandomEffectDataConfiguration("itemId"), to),
        "user_item_mf": game.FactoredRandomEffectCoordinateConfiguration(
            "per_item", RandomEffectDataConfiguration("userId"), tmf, to),
    }, num_outer_iterations=outer, device="cpu")
    return j, t


@pytest.fixture(scope="module")
def full_game():
    train, val = glmix_numpy(11), glmix_numpy(12)
    j, t = _game_estimators()
    jfit = j.fit(jax_game_data(*train[:3]), jax_game_data(*val[:3]))
    tfit = t.fit(torch_game_data(*train[:3]), torch_game_data(*val[:3]))
    return train, val, jfit, tfit


def test_full_game_fit_matches_jax(full_game):
    _, _, jfit, tfit = full_game
    assert [c for c, _ in tfit.objective_history] == [c for c, _ in jfit.objective_history]
    np.testing.assert_allclose([v for _, v in tfit.objective_history],
                               [v for _, v in jfit.objective_history], rtol=1e-4)
    assert abs(tfit.validation_metric - jfit.validation_metric) <= 1e-4
    sub = tfit.model.models["user_item_mf"]
    assert isinstance(sub, fre.FactoredRandomEffectModel)
    assert sub.latent.coefficients[0].shape[1] == K
    b, e = sub.latent.entity_to_loc["u3"]
    want = (sub.projection_matrix @ sub.latent.coefficients[b][e]).numpy()
    assert list(sub.coefficients_for("u3").values()) == pytest.approx(want.tolist())
    assert sub.coefficients_for("nobody") is None
    assert f"{K} latent factors" in sub.to_summary_string()
    _close(jfit.model.models["user_item_mf"].projection_matrix, sub.projection_matrix,
           rtol=0, atol=2e-3)


def test_full_game_model_files_score_the_same_in_jax(full_game, tmp_path):
    from photon_ml_tpu.io.model_io import load_game_model as jax_load
    from photon_ml_tpu.io.model_io import load_matrix_factorization_model as jax_load_mf

    _, val, _, tfit = full_game
    model_io.save_game_model(tfit.model, str(tmp_path / "m"))
    loaded, _ = jax_load(str(tmp_path / "m"))
    assert isinstance(loaded.models["user_item_mf"], JaxReModel)
    _close(loaded.score(jax_game_data(*val[:3])), tfit.model.score(torch_game_data(*val[:3])),
           rtol=2e-4, atol=1e-5)
    # the latent factors and B round-trip through their LatentFactorAvro files
    sub = tfit.model.models["user_item_mf"]
    mf_dir = str(tmp_path / "m" / model_io.MATRIX_FACTORIZATION / "user_item_mf")
    for load in (model_io.load_matrix_factorization_model, jax_load_mf):
        mf = load(mf_dir, "userId", "projection")
        np.testing.assert_array_equal(mf.col_factors, sub.projection_matrix.numpy())
        for b, ids in enumerate(sub.latent.entity_ids):
            rows = [mf.row_index[e] for e in ids]
            np.testing.assert_array_equal(mf.row_factors[rows], sub.latent.coefficients[b].numpy())
    # and a matrix-factorization model saves and loads unchanged
    model_io.save_matrix_factorization_model(mf, str(tmp_path / "mf"))
    again = model_io.load_matrix_factorization_model(str(tmp_path / "mf"), "userId", "projection")
    assert again.row_index == mf.row_index and again.col_index == mf.col_index
    np.testing.assert_array_equal(again.row_factors, mf.row_factors)
    assert again.score("u0", "3") == pytest.approx(mf.score("u0", "3"))


def _full_game_config(tmp_path):
    """FE + per_user + per_movie on the ratings fixture, and a factored
    coordinate over userId on the per_user shard (k = 2, one MF iteration,
    L2 λ = 5)."""
    opt = {"optimizer": "LBFGS", "regularization": "L2"}
    cfg = {
        "feature_shards": {
            "global": {"feature_bags": ["features"], "add_intercept": True},
            "per_user": {"feature_bags": ["userFeatures"], "add_intercept": False},
            "per_movie": {"feature_bags": ["movieFeatures"], "add_intercept": False},
        },
        "coordinates": {
            "fixed": {"type": "fixed", "feature_shard": "global",
                      "optimizer": {**opt, "regularization_weight": 10.0}},
            "per_user": {"type": "random", "feature_shard": "per_user",
                         "random_effect_type": "userId",
                         "optimizer": {**opt, "regularization_weight": 1.0}},
            "per_movie": {"type": "random", "feature_shard": "per_movie",
                          "random_effect_type": "movieId",
                          "optimizer": {**opt, "regularization_weight": 1.0}},
            "factored": {"type": "factored_random", "feature_shard": "per_user",
                         "random_effect_type": "userId",
                         "mf": {"num_latent_factors": 2, "num_iterations": 1},
                         "optimizer": {**opt, "regularization_weight": 5.0}},
        },
        "update_order": ["fixed", "per_user", "per_movie", "factored"],
    }
    path = tmp_path / "full_game.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_full_game_cli_matches_jax(tmp_path, monkeypatch):
    from photon_ml_tpu.cli import train_game as jax_train_game

    # the JAX CLI trains a factored coordinate only on the host score plane
    # (see _game_estimators); the two planes give the same models bitwise
    monkeypatch.setattr(jax_game.GameEstimator, "_effective_score_plane", lambda self: "host")

    argv = [
        "--train-data-dirs", os.path.join(RATINGS, "train"),
        "--validation-data-dirs", os.path.join(RATINGS, "test"),
        "--coordinate-config", _full_game_config(tmp_path),
        "--task", "LINEAR_REGRESSION", "--evaluator", "RMSE",
    ]
    fit = train_game.run(train_game.parse_args(
        argv + ["--output-dir", str(tmp_path / "out"), "--device", "cpu"]))
    jfit = jax_train_game.run(jax_train_game.parse_args(
        argv + ["--output-dir", str(tmp_path / "jax_out")]))
    assert fit.validation_metric < 0.45  # the reference's golden gate
    assert abs(fit.validation_metric - jfit.validation_metric) <= 1e-4
    assert os.path.isdir(tmp_path / "out" / "best" / "matrix-factorization" / "factored")
    rmse = score_game.run(score_game.parse_args([
        "--data-dirs", os.path.join(RATINGS, "test"),
        "--model-dir", str(tmp_path / "out" / "best"),
        "--output-dir", str(tmp_path / "scores"), "--evaluator", "RMSE", "--device", "cpu",
    ]))
    assert abs(rmse - fit.validation_metric) <= 1e-5


@pytest.mark.parametrize("n, segments, chunk", [(1000, 7, 4), (50_000, 13, 256), (10, 10, 256),
                                                (3000, 1, 16)])
def test_segment_sums_equal_an_index_add(n, segments, chunk):
    """KronFeatures' fixed-order segmented sum against index_add_ in float64
    (a segment of one term, one segment of every term, levels of chunks)."""
    g = torch.Generator().manual_seed(n)
    keys = torch.randint(0, segments, (n,), generator=g)
    keys[:min(segments, n)] = torch.arange(min(segments, n))
    vals = torch.randn(n, 3, generator=g, dtype=torch.float64)
    cols, order = torch.sort(keys, stable=True)
    uniq, lengths = torch.unique_consecutive(cols, return_counts=True)
    got = fre.segment_sums(vals, fre.segment_plan(order, lengths, chunk))
    want = torch.zeros(segments, 3, dtype=torch.float64).index_add_(0, keys, vals)[uniq]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)


def test_game_json_example_parses_as_in_jax(tmp_path):
    """examples/game.json.example's user-item-mf coordinate, and a
    matrix_optimizer of its own, parse as in the JAX package's CLI."""
    from photon_ml_tpu.cli.common import load_game_config as jax_load
    from photon_ml_tpu_torch.cli.common import load_game_config

    path = os.path.join(os.path.dirname(__file__), "..", "examples", "game.json.example")
    raw = json.load(open(path))
    raw["coordinates"]["user-item-mf"]["matrix_optimizer"] = {"regularization_weight": 3.0}
    (tmp_path / "game.json").write_text(json.dumps(raw))
    for p in (path, str(tmp_path / "game.json")):
        _, coords, order, _ = load_game_config(p)
        _, jcoords, jorder, _ = jax_load(p)
        assert order == jorder
        mf, jmf = coords["user-item-mf"], jcoords["user-item-mf"]
        assert isinstance(mf, game.FactoredRandomEffectCoordinateConfiguration)
        assert (mf.feature_shard, mf.data.random_effect_type) == ("per_item", "userId")
        assert (mf.mf.num_latent_factors, mf.mf.num_iterations) == (
            jmf.mf.num_latent_factors, jmf.mf.num_iterations) == (8, 2)
        assert mf.optimizer.regularization_weight == jmf.optimizer.regularization_weight
        assert (mf.matrix_optimizer is None) == (jmf.matrix_optimizer is None)
    assert mf.matrix_optimizer.regularization_weight == 3.0

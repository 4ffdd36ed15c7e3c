"""GLMix training in the port against the JAX package.

- ``GameEstimator.fit`` (logistic, a fixed effect and two random effects,
  one outer iteration of block coordinate descent) against the JAX fit on
  the same data: coefficients atol 2e-3 (30 L-BFGS iterations per
  coordinate in f32, sums in another order), the training objectives rtol
  1e-4, validation AUC to 1e-4;
- warm starts carried across from the JAX fit with ``convert``;
- the port's ``train_game`` CLI on the committed ratings fixture with
  ``--device cpu``: RMSE under the reference's golden gate of 0.45, and the
  port's ``score_game`` on the saved model reproduces it.
"""

import json
import os

import numpy as np
import pytest
import torch

from _torch_parity import coordinates_of_jax_model, jax_game_data, torch_game_data
from photon_ml_tpu.data.random_effect import RandomEffectDataConfiguration as JaxReData
from photon_ml_tpu.estimators import game as jax_game
from photon_ml_tpu.evaluation.evaluators import AUC as JaxAUC
from photon_ml_tpu.opt import config as jax_config
from photon_ml_tpu.types import RegularizationType as JaxReg
from photon_ml_tpu.types import TaskType as JaxTask
from photon_ml_tpu_torch.cli import score_game, train_game
from photon_ml_tpu_torch.convert import game_model_from_numpy, game_model_to_numpy
from photon_ml_tpu_torch.data.random_effect import RandomEffectDataConfiguration
from photon_ml_tpu_torch.estimators import game
from photon_ml_tpu_torch.opt import config
from photon_ml_tpu_torch.types import RegularizationType, TaskType

RATINGS = os.path.join(os.path.dirname(__file__), "fixtures", "ratings")


def _glmix(seed, n, n_users=24, n_items=9, fe_dim=20, re_dim=12):
    """Rows drawn from one random GLMix logistic model (so the fit has
    signal to find), as the numpy inputs of ``_torch_parity``."""
    rng = np.random.default_rng(seed)
    fe_cols = np.concatenate([np.zeros((n, 1), int), rng.integers(1, fe_dim, (n, 5))], 1)
    fe_vals = np.concatenate([np.ones((n, 1)), rng.standard_normal((n, 5))], 1)
    margin = (fe_vals * (np.random.default_rng(99).standard_normal(fe_dim) * 0.8)[fe_cols]).sum(1)
    shards = {"global": (np.repeat(np.arange(n), 6), fe_cols.ravel(),
                         fe_vals.ravel().astype(np.float32), fe_dim)}
    id_tags = {}
    for tag, shard, count in (("userId", "per_user", n_users), ("itemId", "per_item", n_items)):
        w_true = np.random.default_rng(len(tag)).standard_normal((count, re_dim))
        ent = rng.integers(0, count, n)
        cols = rng.integers(0, re_dim, (n, 3))
        vals = rng.standard_normal((n, 3))
        margin += (vals * w_true[ent[:, None], cols]).sum(1)
        shards[shard] = (np.repeat(np.arange(n), 3), cols.ravel(),
                         vals.ravel().astype(np.float32), re_dim)
        id_tags[tag] = np.array([f"{tag[0]}{e}" for e in ent])
    labels = (rng.random(n) < 1 / (1 + np.exp(-margin))).astype(np.float32)
    return labels, shards, id_tags


def _estimators(max_iterations=30, num_buckets=2, outer=1):
    def opt(c, reg):
        return c.GlmOptimizationConfiguration(
            optimizer_config=c.OptimizerConfig(max_iterations=max_iterations),
            regularization=c.RegularizationContext(reg.L2), regularization_weight=1.0,
        )

    jo, to = opt(jax_config, JaxReg), opt(config, RegularizationType)
    j = jax_game.GameEstimator(JaxTask.LOGISTIC_REGRESSION, {
        "fixed": jax_game.FixedEffectCoordinateConfiguration("global", jo, sparse_engine="ell"),
        "per_user": jax_game.RandomEffectCoordinateConfiguration(
            "per_user", JaxReData("userId", num_buckets=num_buckets), jo),
        "per_item": jax_game.RandomEffectCoordinateConfiguration(
            "per_item", JaxReData("itemId"), jo),
    }, evaluator=JaxAUC, num_outer_iterations=outer)
    t = game.GameEstimator(TaskType.LOGISTIC_REGRESSION, {
        "fixed": game.FixedEffectCoordinateConfiguration("global", to),
        "per_user": game.RandomEffectCoordinateConfiguration(
            "per_user", RandomEffectDataConfiguration("userId", num_buckets=num_buckets), to),
        "per_item": game.RandomEffectCoordinateConfiguration(
            "per_item", RandomEffectDataConfiguration("itemId"), to),
    }, device="cpu")
    return j, t


@pytest.fixture(scope="module")
def fits():
    train = _glmix(1, 600)
    val = _glmix(2, 300)
    j, t = _estimators()
    jfit = j.fit(jax_game_data(*train), jax_game_data(*val))
    tdata = torch_game_data(*train)
    tval = torch_game_data(*val)
    tfit = t.fit(tdata, tval)
    return jfit, tfit, t, tdata, tval


def test_fit_matches_jax(fits):
    jfit, tfit, _, _, _ = fits
    assert [c for c, _ in tfit.objective_history] == ["fixed", "per_user", "per_item"]
    np.testing.assert_allclose([v for _, v in tfit.objective_history],
                               [v for _, v in jfit.objective_history], rtol=1e-4)
    assert abs(tfit.validation_metric - jfit.validation_metric) <= 1e-4
    assert tfit.validation_metric > 0.7  # the fit found the signal
    jm = coordinates_of_jax_model(jfit.model)
    tm = game_model_to_numpy(tfit.model)
    np.testing.assert_allclose(tm["fixed"]["means"], jm["fixed"]["means"], atol=2e-3)
    for cid in ("per_user", "per_item"):
        assert tm[cid]["entity_ids"] == jm[cid]["entity_ids"]
        for a, b in zip(tm[cid]["coefficients"], jm[cid]["coefficients"]):
            np.testing.assert_allclose(a, b, atol=2e-3)
        for a, b in zip(tm[cid]["proj_indices"], jm[cid]["proj_indices"]):
            np.testing.assert_array_equal(a, b)


def test_warm_start_from_the_jax_fit(fits):
    """The JAX fit's models, carried across, warm-start the port's fit: one
    port iteration from them equals the JAX package's second outer
    iteration."""
    jfit, _, t, tdata, tval = fits
    j2, _ = _estimators(outer=2)
    jfit2 = j2.fit(jax_game_data(*_glmix(1, 600)), jax_game_data(*_glmix(2, 300)))
    init = game_model_from_numpy(coordinates_of_jax_model(jfit.model),
                                 "LOGISTIC_REGRESSION", device="cpu")
    warm = t.fit(tdata, tval, initial_models=init.models)
    np.testing.assert_allclose([v for _, v in warm.objective_history],
                               [v for _, v in jfit2.objective_history[3:]], rtol=1e-4)
    assert warm.objective_history[0][1] < jfit.objective_history[-1][1]


def test_fit_is_repeatable_bitwise(fits):
    _, tfit, t, tdata, tval = fits
    again = t.fit(tdata, tval)
    assert again.objective_history == tfit.objective_history
    assert again.validation_metric == tfit.validation_metric


def _ratings_config(tmp_path, fixed_optimizer="LBFGS"):
    opt = {"optimizer": "LBFGS", "regularization": "L2"}
    cfg = {
        "feature_shards": {
            "global": {"feature_bags": ["features"], "add_intercept": True},
            "per_user": {"feature_bags": ["userFeatures"], "add_intercept": False},
            "per_movie": {"feature_bags": ["movieFeatures"], "add_intercept": False},
        },
        "coordinates": {
            "fixed": {"type": "fixed", "feature_shard": "global",
                      "optimizer": {**opt, "optimizer": fixed_optimizer,
                                    "regularization_weight": 10.0}},
            "per_user": {"type": "random", "feature_shard": "per_user",
                         "random_effect_type": "userId",
                         "optimizer": {**opt, "regularization_weight": 1.0}},
            "per_movie": {"type": "random", "feature_shard": "per_movie",
                          "random_effect_type": "movieId",
                          "optimizer": {**opt, "regularization_weight": 1.0}},
        },
        "update_order": ["fixed", "per_user", "per_movie"],
    }
    path = tmp_path / f"game_{fixed_optimizer}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _train_argv(tmp_path, config_path, *extra):
    return [
        "--train-data-dirs", os.path.join(RATINGS, "train"),
        "--validation-data-dirs", os.path.join(RATINGS, "test"),
        "--coordinate-config", config_path, "--task", "LINEAR_REGRESSION",
        "--output-dir", str(tmp_path / "out"), "--evaluator", "RMSE",
        "--num-outer-iterations", "2", "--device", "cpu", *extra,
    ]


def test_train_game_cli_on_ratings_fixture(tmp_path):
    fit = train_game.run(train_game.parse_args(_train_argv(tmp_path, _ratings_config(tmp_path))))
    assert fit.validation_metric < 0.45  # the reference's golden gate (captured 0.3885)
    assert len(fit.objective_history) == 6
    assert os.path.isdir(tmp_path / "out" / "best" / "random-effect" / "per_user")
    rmse = score_game.run(score_game.parse_args([
        "--data-dirs", os.path.join(RATINGS, "test"),
        "--model-dir", str(tmp_path / "out" / "best"),
        "--output-dir", str(tmp_path / "scores"), "--evaluator", "RMSE", "--device", "cpu",
    ]))
    assert abs(rmse - fit.validation_metric) <= 1e-6


def test_train_game_cli_refuses_what_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="TRON"):
        train_game.run(train_game.parse_args(
            _train_argv(tmp_path, _ratings_config(tmp_path, fixed_optimizer="TRON"))
        ))
    with pytest.raises(NotImplementedError, match="normalization"):
        train_game.run(train_game.parse_args(
            _train_argv(tmp_path, _ratings_config(tmp_path),
                        "--normalization-type", "STANDARDIZATION")
        ))


def test_estimator_rejects_unported_coordinate_options():
    opt = config.GlmOptimizationConfiguration(down_sampling_rate=0.5)
    t = game.GameEstimator(TaskType.LOGISTIC_REGRESSION, {
        "fixed": game.FixedEffectCoordinateConfiguration("global", opt),
    }, device="cpu")
    labels, shards, id_tags = _glmix(3, 50)
    with pytest.raises(NotImplementedError, match="sampler"):
        t.fit(torch_game_data(labels, shards, id_tags))
    assert torch.backends.cuda.matmul.allow_tf32 is False

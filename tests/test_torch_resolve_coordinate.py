"""``GameEstimator.resolve_coordinate`` (one coordinate re-solved against
new data, the nearline loop's step) and ``align_warm_start`` against the
JAX package's.

The models come from one JAX fit on a first batch and are carried across
with ``convert``; the second batch drops some entities and brings new ones.
Fixed- and random-effect re-solves match the JAX package's to coefficients
atol 2e-3 (f32 solves, sums in another order); the aligned warm start is
the same copy bit for bit, with new entities at 0; a factored coordinate is
refused with the JAX message.
"""

import numpy as np
import pytest
import torch

from _torch_parity import coordinates_of_jax_model, jax_game_data, torch_game_data
from photon_ml_tpu.algorithm.factored_random_effect import (
    MFOptimizationConfiguration as JaxMF,
)
from photon_ml_tpu.data.random_effect import RandomEffectDataConfiguration as JaxReData
from photon_ml_tpu.data.random_effect import build_random_effect_dataset as jax_build
from photon_ml_tpu.estimators import game as jax_game
from photon_ml_tpu.estimators.random_effect import align_warm_start as jax_align
from photon_ml_tpu.opt import config as jax_config
from photon_ml_tpu.types import RegularizationType as JaxReg
from photon_ml_tpu.types import TaskType as JaxTask
from photon_ml_tpu_torch.algorithm.factored_random_effect import MFOptimizationConfiguration
from photon_ml_tpu_torch.convert import game_model_from_numpy, game_model_to_numpy
from photon_ml_tpu_torch.data.random_effect import (
    RandomEffectDataConfiguration,
    build_random_effect_dataset,
)
from photon_ml_tpu_torch.estimators import game
from photon_ml_tpu_torch.estimators.random_effect import align_warm_start
from photon_ml_tpu_torch.opt import config
from photon_ml_tpu_torch.types import RegularizationType, TaskType


def _batch(seed, users, n=400, fe_dim=15, re_dim=10):
    """Rows of a GLMix logistic model over the named users."""
    rng = np.random.default_rng(seed)
    fe_cols = np.concatenate([np.zeros((n, 1), int), rng.integers(1, fe_dim, (n, 4))], 1)
    fe_vals = np.concatenate([np.ones((n, 1)), rng.standard_normal((n, 4))], 1)
    margin = (fe_vals * np.random.default_rng(7).standard_normal(fe_dim)[fe_cols]).sum(1)
    w_user = np.random.default_rng(8).standard_normal((100, re_dim))
    ent = rng.choice(users, n)
    cols = rng.integers(0, re_dim, (n, 3))
    vals = rng.standard_normal((n, 3))
    margin += (vals * w_user[ent[:, None], cols]).sum(1)
    shards = {
        "global": (np.repeat(np.arange(n), 5), fe_cols.ravel(),
                   fe_vals.ravel().astype(np.float32), fe_dim),
        "per_user": (np.repeat(np.arange(n), 3), cols.ravel(),
                     vals.ravel().astype(np.float32), re_dim),
    }
    labels = (rng.random(n) < 1 / (1 + np.exp(-margin))).astype(np.float32)
    return labels, shards, {"userId": np.array([f"u{e}" for e in ent])}


def _configs(max_iterations=30):
    def opt(c, reg):
        return c.GlmOptimizationConfiguration(
            optimizer_config=c.OptimizerConfig(max_iterations=max_iterations),
            regularization=c.RegularizationContext(reg.L2), regularization_weight=1.0,
        )

    return opt(jax_config, JaxReg), opt(config, RegularizationType)


@pytest.fixture(scope="module")
def setup():
    jo, to = _configs()
    j = jax_game.GameEstimator(JaxTask.LOGISTIC_REGRESSION, {
        "fixed": jax_game.FixedEffectCoordinateConfiguration("global", jo, sparse_engine="ell"),
        "per_user": jax_game.RandomEffectCoordinateConfiguration(
            "per_user", JaxReData("userId", num_buckets=2), jo),
    })
    t = game.GameEstimator(TaskType.LOGISTIC_REGRESSION, {
        "fixed": game.FixedEffectCoordinateConfiguration("global", to),
        "per_user": game.RandomEffectCoordinateConfiguration(
            "per_user", RandomEffectDataConfiguration("userId", num_buckets=2), to),
    }, device="cpu")
    first = _batch(1, np.arange(0, 30))
    jfit = j.fit(jax_game_data(*first))
    tmodels = game_model_from_numpy(coordinates_of_jax_model(jfit.model),
                                    "LOGISTIC_REGRESSION", device="cpu").models
    # the second batch: users 10..29 seen before, 30..39 new
    second = _batch(2, np.arange(10, 40))
    return j, t, jfit.model.models, tmodels, second


@pytest.mark.parametrize("cid", ["fixed", "per_user"])
def test_resolve_coordinate_matches_jax(setup, cid):
    j, t, jmodels, tmodels, second = setup
    jm = j.resolve_coordinate(cid, jax_game_data(*second), jmodels)
    tm = t.resolve_coordinate(cid, torch_game_data(*second), tmodels)
    meta = {cid: t._meta()[cid]}
    got = game_model_to_numpy(game.GameModel(models={cid: tm}, meta=meta,
                                             task=TaskType.LOGISTIC_REGRESSION))[cid]
    from photon_ml_tpu.models.game import GameModel as JaxGameModel

    want = coordinates_of_jax_model(JaxGameModel(models={cid: jm}, meta={cid: j._meta()[cid]},
                                                 task=JaxTask.LOGISTIC_REGRESSION))[cid]
    if cid == "fixed":
        np.testing.assert_allclose(got["means"], want["means"], atol=2e-3)
        return
    assert got["entity_ids"] == want["entity_ids"]
    assert sorted(sum(got["entity_ids"], [])) == sorted(f"u{e}" for e in range(10, 40))
    for a, b in zip(got["coefficients"], want["coefficients"]):
        np.testing.assert_allclose(a, b, atol=2e-3)


def test_align_warm_start_equals_jax(setup):
    j, t, jmodels, tmodels, second = setup
    labels, shards, tags = second
    rows, cols, vals, dim = shards["per_user"]
    jds = jax_build(tags["userId"], rows, cols, vals, dim, labels,
                    JaxReData("userId", num_buckets=3))
    tds = build_random_effect_dataset(tags["userId"], rows, cols, vals, dim, labels,
                                      RandomEffectDataConfiguration("userId", num_buckets=3),
                                      device="cpu")
    ja = jax_align(jmodels["per_user"], jds)
    ta = align_warm_start(tmodels["per_user"], tds)
    assert ta.entity_ids == ja.entity_ids
    for a, b in zip(ta.coefficients, ja.coefficients):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # new entities start at 0, seen ones carry their old coefficients
    old = dict(tmodels["per_user"].items())
    for eid, coefs in ta.items():
        if int(eid[1:]) >= 30:
            assert not any(coefs.values())
        else:
            assert all(old[eid].get(i, 0.0) == v for i, v in coefs.items())
            assert any(coefs.values())
    assert all(v is None for v in ta.variances)
    assert isinstance(ta.coefficients[0], torch.Tensor)


def test_resolve_coordinate_refuses_factored_and_unknown():
    jo, to = _configs()
    jest = jax_game.GameEstimator(JaxTask.LOGISTIC_REGRESSION, {
        "mf": jax_game.FactoredRandomEffectCoordinateConfiguration(
            "per_user", JaxReData("userId"), JaxMF(num_latent_factors=2), jo),
    })
    test = game.GameEstimator(TaskType.LOGISTIC_REGRESSION, {
        "mf": game.FactoredRandomEffectCoordinateConfiguration(
            "per_user", RandomEffectDataConfiguration("userId"),
            MFOptimizationConfiguration(num_latent_factors=2), to),
    }, device="cpu")
    second = _batch(2, np.arange(5))
    for cid, word in (("mf", "factored"), ("nope", "unknown coordinate")):
        with pytest.raises(ValueError, match=word) as theirs:
            jest.resolve_coordinate(cid, jax_game_data(*second), {})
        with pytest.raises(ValueError) as ours:
            test.resolve_coordinate(cid, torch_game_data(*second), {})
        assert str(ours.value) == str(theirs.value)

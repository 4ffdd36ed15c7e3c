"""λ sweeps (``fit_multiple``, ``select_best_fit``) and hyperparameter
tuning (``estimators/tuning.py``) in the port against the JAX package.

- the evaluation function's vector ↔ configuration round trip (sorted
  coordinate ids, log10 λ, a factored coordinate giving two parameters)
  equals the JAX function's;
- ``fit_multiple`` over per_user λ ∈ {10, 1, 0.1}, warm-started, against
  the JAX ``fit_multiple``: coefficients atol 2e-3, objectives rtol 1e-4,
  metrics 1e-4, the same ``select_best_fit`` index; a sweep resumed from
  its per-configuration checkpoints equals the uninterrupted one bitwise;
  ``_replace_optimizer``'s factored rule;
- RANDOM tuning end to end: the trial λ vectors equal the JAX run's, the
  metrics within 1e-4;
- BAYESIAN: the port's searcher, fed the JAX run's observations, proposes
  the JAX run's candidates exactly.
"""

import dataclasses
import os

import numpy as np
import pytest

from _torch_parity import coordinates_of_jax_model, jax_game_data, torch_game_data
from photon_ml_tpu.algorithm.factored_random_effect import (
    MFOptimizationConfiguration as JaxMF,
)
from photon_ml_tpu.data.random_effect import RandomEffectDataConfiguration as JaxReData
from photon_ml_tpu.estimators import game as jax_game
from photon_ml_tpu.estimators.tuning import (
    GameEstimatorEvaluationFunction as JaxEvalFn,
)
from photon_ml_tpu.estimators.tuning import run_hyperparameter_tuning as jax_tuning
from photon_ml_tpu.evaluation.evaluators import AUC as JaxAUC
from photon_ml_tpu.opt import config as jax_config
from photon_ml_tpu.types import RegularizationType as JaxReg
from photon_ml_tpu.types import TaskType as JaxTask
from photon_ml_tpu_torch.algorithm.factored_random_effect import MFOptimizationConfiguration
from photon_ml_tpu_torch.convert import game_model_to_numpy
from photon_ml_tpu_torch.data.random_effect import RandomEffectDataConfiguration
from photon_ml_tpu_torch.estimators import game
from photon_ml_tpu_torch.estimators.tuning import (
    GameEstimatorEvaluationFunction,
    run_hyperparameter_tuning,
)
from photon_ml_tpu_torch.hyperparameter import GaussianProcessSearch
from photon_ml_tpu_torch.opt import config
from photon_ml_tpu_torch.types import RegularizationType, TaskType

LAMBDAS = (10.0, 1.0, 0.1)


def _glmix(seed, n, n_users=20, n_items=8, fe_dim=16, re_dim=10):
    """Rows of one random GLMix logistic model, as ``_torch_parity``
    numpy inputs."""
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


def _opt(c, reg, weight=1.0, max_iterations=30):
    return c.GlmOptimizationConfiguration(
        optimizer_config=c.OptimizerConfig(max_iterations=max_iterations),
        regularization=c.RegularizationContext(reg.L2), regularization_weight=weight,
    )


def _estimators(coordinates=("fixed", "per_user", "per_item"), outer=1):
    jo, to = _opt(jax_config, JaxReg), _opt(config, RegularizationType)
    jall = {
        "fixed": jax_game.FixedEffectCoordinateConfiguration("global", jo, sparse_engine="ell"),
        "per_user": jax_game.RandomEffectCoordinateConfiguration(
            "per_user", JaxReData("userId", num_buckets=2), jo),
        "per_item": jax_game.RandomEffectCoordinateConfiguration(
            "per_item", JaxReData("itemId"), jo),
    }
    tall = {
        "fixed": game.FixedEffectCoordinateConfiguration("global", to),
        "per_user": game.RandomEffectCoordinateConfiguration(
            "per_user", RandomEffectDataConfiguration("userId", num_buckets=2), to),
        "per_item": game.RandomEffectCoordinateConfiguration(
            "per_item", RandomEffectDataConfiguration("itemId"), to),
    }
    j = jax_game.GameEstimator(JaxTask.LOGISTIC_REGRESSION,
                               {c: jall[c] for c in coordinates}, evaluator=JaxAUC,
                               num_outer_iterations=outer)
    t = game.GameEstimator(TaskType.LOGISTIC_REGRESSION, {c: tall[c] for c in coordinates},
                           num_outer_iterations=outer, device="cpu")
    return j, t


def _sweep(c, reg):
    return [{"per_user": _opt(c, reg, w)} for w in LAMBDAS]


@pytest.fixture(scope="module")
def data():
    train, val = _glmix(1, 500), _glmix(2, 300)
    return (jax_game_data(*train), jax_game_data(*val),
            torch_game_data(*train), torch_game_data(*val))


def test_vector_configuration_round_trip_with_factored():
    jo, to = _opt(jax_config, JaxReg, 10.0), _opt(config, RegularizationType, 10.0)
    jm, tm = _opt(jax_config, JaxReg, 0.5), _opt(config, RegularizationType, 0.5)
    j = jax_game.GameEstimator(JaxTask.LINEAR_REGRESSION, {
        "z_fixed": jax_game.FixedEffectCoordinateConfiguration("global", jo),
        "mf": jax_game.FactoredRandomEffectCoordinateConfiguration(
            "per_user", JaxReData("userId"), JaxMF(num_latent_factors=2),
            dataclasses.replace(jo, regularization_weight=1.0), jm),
        "per_item": jax_game.RandomEffectCoordinateConfiguration(
            "per_item", JaxReData("itemId"), dataclasses.replace(jo, regularization_weight=0.1)),
    })
    t = game.GameEstimator(TaskType.LINEAR_REGRESSION, {
        "z_fixed": game.FixedEffectCoordinateConfiguration("global", to),
        "mf": game.FactoredRandomEffectCoordinateConfiguration(
            "per_user", RandomEffectDataConfiguration("userId"),
            MFOptimizationConfiguration(num_latent_factors=2),
            dataclasses.replace(to, regularization_weight=1.0), tm),
        "per_item": game.RandomEffectCoordinateConfiguration(
            "per_item", RandomEffectDataConfiguration("itemId"),
            dataclasses.replace(to, regularization_weight=0.1)),
    }, device="cpu")
    jfn, tfn = JaxEvalFn(j, None, None), GameEstimatorEvaluationFunction(t, None, None)
    assert tfn.num_params == jfn.num_params == 4
    vec = tfn.configuration_to_vector(t.coordinate_configs)
    # sorted ids: mf (latent λ 1, matrix λ 0.5), per_item (0.1), z_fixed (10)
    np.testing.assert_array_equal(vec, jfn.configuration_to_vector(j.coordinate_configs))
    np.testing.assert_allclose(vec, np.log10([1.0, 0.5, 0.1, 10.0]))
    probe = np.array([2.0, -1.0, 0.5, -3.0])
    ours, theirs = tfn.vector_to_configuration(probe), jfn.vector_to_configuration(probe)
    for cid in ours:
        assert ours[cid].optimizer.regularization_weight == \
            theirs[cid].optimizer.regularization_weight
    assert ours["mf"].matrix_optimizer.regularization_weight == 10.0 ** -1.0
    assert ours["mf"].optimizer.regularization_weight == 100.0
    np.testing.assert_array_equal(tfn.configuration_to_vector(ours), probe)
    with pytest.raises(ValueError, match="expected 4 hyperparameters"):
        tfn.vector_to_configuration(probe[:3])


def test_fit_multiple_matches_jax(data):
    jtr, jva, ttr, tva = data
    j, t = _estimators()
    jfits = j.fit_multiple(jtr, jva, configs=_sweep(jax_config, JaxReg))
    tfits = t.fit_multiple(ttr, tva, configs=_sweep(config, RegularizationType))
    assert t.select_best_fit(tfits) == j.select_best_fit(jfits)
    assert len({f.validation_metric for f in tfits}) == 3  # the sweep moved the metric
    for tf, jf in zip(tfits, jfits):
        np.testing.assert_allclose([v for _, v in tf.objective_history],
                                   [v for _, v in jf.objective_history], rtol=1e-4)
        assert abs(tf.validation_metric - jf.validation_metric) <= 1e-4
        tm, jm = game_model_to_numpy(tf.model), coordinates_of_jax_model(jf.model)
        np.testing.assert_allclose(tm["fixed"]["means"], jm["fixed"]["means"], atol=2e-3)
        for cid in ("per_user", "per_item"):
            for a, b in zip(tm[cid]["coefficients"], jm[cid]["coefficients"]):
                np.testing.assert_allclose(a, b, atol=2e-3)
    # each swept fit equals the same fit with the same warm start, bitwise
    coords = t.build_coordinates(ttr)
    again = t.fit(ttr, tva, initial_models=tfits[0].model.models, coordinates={
        **coords, "per_user": t._replace_optimizer(
            coords["per_user"], _sweep(config, RegularizationType)[1]["per_user"])})
    assert again.objective_history == tfits[1].objective_history
    assert again.validation_metric == tfits[1].validation_metric


def test_sweep_resumes_from_its_checkpoints_bitwise(data, tmp_path):
    _, _, ttr, tva = data
    configs = _sweep(config, RegularizationType)
    _, whole = _estimators(outer=2)
    want = whole.fit_multiple(ttr, tva, configs=configs, warm_start=False)
    _, first = _estimators(outer=1)
    first.fit_multiple(ttr, tva, configs=configs, warm_start=False,
                       checkpoint_dir=str(tmp_path))
    names = sorted(os.listdir(tmp_path))
    assert [n[:11] for n in names] == ["config-000-", "config-001-", "config-002-"]
    assert len({n[11:] for n in names}) == 3  # a digest per configuration
    _, resumed = _estimators(outer=2)
    got = resumed.fit_multiple(ttr, tva, configs=configs, warm_start=False,
                               checkpoint_dir=str(tmp_path))
    for g, w in zip(got, want):
        assert g.objective_history == w.objective_history
        assert g.validation_metric == w.validation_metric
    assert sorted(os.listdir(tmp_path)) == names


def test_replace_optimizer_factored_rule(data):
    """B's solve follows the sweep only when it shared the latent solve's
    configuration."""
    _, _, ttr, _ = data
    base, other, new = (_opt(config, RegularizationType, w) for w in (1.0, 3.0, 9.0))
    mf = MFOptimizationConfiguration(num_latent_factors=2)
    t = game.GameEstimator(TaskType.LOGISTIC_REGRESSION, {
        "shared": game.FactoredRandomEffectCoordinateConfiguration(
            "per_user", RandomEffectDataConfiguration("userId"), mf, base),
        "own": game.FactoredRandomEffectCoordinateConfiguration(
            "per_user", RandomEffectDataConfiguration("userId"), mf, base, other),
    }, device="cpu")
    coords = t.build_coordinates(ttr)
    shared = t._replace_optimizer(coords["shared"], new)
    own = t._replace_optimizer(coords["own"], new)
    assert shared.re_configuration == new and shared.matrix_configuration == new
    assert own.re_configuration == new and own.matrix_configuration == other
    assert shared.dataset is coords["shared"].dataset  # the datasets are shared
    # a sweep over a factored coordinate, each fit warm-started from the last
    alone = game.GameEstimator(TaskType.LOGISTIC_REGRESSION,
                               {"shared": t.coordinate_configs["shared"]}, device="cpu")
    fits = alone.fit_multiple(ttr, configs=[{"shared": new}, {"shared": base}],
                              coordinates={"shared": coords["shared"]})
    assert len(fits) == 2 and fits[0].objective_history != fits[1].objective_history
    assert all(np.isfinite(v) for f in fits for _, v in f.objective_history)


def test_random_tuning_matches_jax(data):
    jtr, jva, ttr, tva = data
    j, t = _estimators(("fixed", "per_user"))
    jbase, tbase = j.fit(jtr, jva), t.fit(ttr, tva)
    jtrials = jax_tuning(j, jtr, jva, mode="RANDOM", num_iterations=2,
                         log10_range=(-2.0, 2.0), prior_fits=[jbase])
    ttrials = run_hyperparameter_tuning(t, ttr, tva, mode="RANDOM", num_iterations=2,
                                        log10_range=(-2.0, 2.0), prior_fits=[tbase])
    assert len(ttrials) == len(jtrials) == 2
    for a, b in zip(ttrials, jtrials):
        np.testing.assert_array_equal(a.hyperparameters, b.hyperparameters)
        assert abs(a.value - b.value) <= 1e-4
    # trials on the prebuilt coordinates equal trials that build their own
    shared = run_hyperparameter_tuning(t, ttr, tva, mode="RANDOM", num_iterations=2,
                                       log10_range=(-2.0, 2.0), prior_fits=[tbase],
                                       coordinates=t.build_coordinates(ttr))
    for a, b in zip(shared, ttrials):
        assert a.fit.objective_history == b.fit.objective_history


def test_bayesian_searcher_replays_jax_candidates(data):
    """The JAX BAYESIAN run over FE + per_user (two parameters, so the GP
    takes over at the third observation); the port's searcher, handed the
    JAX trials' values in turn, proposes the same candidates bit for bit."""
    jtr, jva, _, _ = data
    j, _ = _estimators(("fixed", "per_user"))
    jbase = j.fit(jtr, jva)
    jtrials = jax_tuning(j, jtr, jva, mode="BAYESIAN", num_iterations=4,
                         log10_range=(-2.0, 2.0), prior_fits=[jbase], seed=3)
    values = iter([t.value for t in jtrials])

    class Replay:
        def __init__(self):
            self.calls = []

        def __call__(self, h):
            self.calls.append(np.asarray(h))
            v = next(values)
            return v, (np.asarray(h, dtype=float), v)

        def vectorize_params(self, r):
            return r[0]

        def get_evaluation_value(self, r):
            return r[1]

    fn = Replay()
    search = GaussianProcessSearch([(-2.0, 2.0)] * 2, fn, larger_is_better=True, seed=3)
    prior = JaxEvalFn(j, None, None).configuration_to_vector(j.coordinate_configs)
    search.find(4, [(prior, jbase.validation_metric)])
    np.testing.assert_array_equal(np.array(fn.calls),
                                  np.array([t.hyperparameters for t in jtrials]))
    assert search.last_model is not None  # the GP proposed the last candidates


def test_random_trial_vectors_are_pinned():
    """The first two RANDOM trials over three coordinates in the default
    log10 range (-4, 4), seed 0, after one prior observation: scrambled
    Sobol draws, the same in both packages. chip_smoke.py holds its
    full-width tuning run to these values (RANDOM_TRIALS_LOG10)."""
    from photon_ml_tpu.hyperparameter import RandomSearch as JaxRandomSearch
    from photon_ml_tpu_torch.hyperparameter import RandomSearch

    pinned = [[-0.720403291285038, 3.7129617482423782, 2.8612390011548996],
              [1.6987586095929146, 0.6855398789048195, 1.1011880710721016]]
    for cls in (RandomSearch, JaxRandomSearch):
        calls = []

        class Record:
            def __call__(self, h):
                calls.append(h.tolist())
                return 0.0, (h, 0.0)

            def vectorize_params(self, r):
                return r[0]

            def get_evaluation_value(self, r):
                return r[1]

        cls([(-4.0, 4.0)] * 3, Record(), seed=0).find(2, [(np.zeros(3), 0.5)])
        assert calls == pinned

"""GLMix training in the port against the JAX package.

- ``GameEstimator.fit`` (logistic, a fixed effect and two random effects,
  one outer iteration of block coordinate descent) against the JAX fit on
  the same data: coefficients atol 2e-3 (30 L-BFGS iterations per
  coordinate in f32, sums in another order), the training objectives rtol
  1e-4, validation AUC to 1e-4;
- warm starts carried across from the JAX fit with ``convert``;
- the port's ``train_game`` CLI on the committed ratings fixture with
  ``--device cpu``: RMSE under the reference's golden gate of 0.45, and the
  port's ``score_game`` on the saved model reproduces it;
- a normalized fit (STANDARDIZATION, the fixed effect on the Benes engine)
  against the JAX fit under the same normalization context: coefficients
  atol 2e-3, objectives rtol 1e-4; and the ratings CLI under
  ``--normalization-type STANDARDIZATION`` with a Benes fixed effect against
  the JAX CLI: RMSE under 0.45 and equal to 1e-4;
- the flags of slice 9 against the JAX CLI on the ratings fixture: a
  regularization_weights sweep (the same best configuration and saved
  layout under --model-output-mode ALL), RANDOM tuning (the same best and
  saved λ), --schedule async with --updating-sequence and --check-data
  (RMSE to 1e-4), and the date-range flags over a daily layout (bitwise
  the plain-dirs fit; score_game --date-range reproduces it);
- the telemetry, progress, introspection and auto-tune flags on the
  ratings fixture: bitwise the plain run, valid ledgers.
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


def _ratings_config(tmp_path, fixed_optimizer="LBFGS", engine=None):
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
    if engine is not None:
        cfg["coordinates"]["fixed"]["sparse_engine"] = engine
    path = tmp_path / f"game_{fixed_optimizer}_{engine}.json"
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
    """What stays refused: TRON with L1 (as in the JAX package) and the
    flags whose modules are not ported, each naming its ROADMAP item.
    Regularization-weight sweeps, once refused here, now train
    (test_sweep_cli_picks_the_jax_best below), and so do the telemetry,
    introspection and auto-tune flags (test_train_game_cli_telemetry_flags
    below), --offheap-indexmap-dir (tests/test_torch_cli_io.py), and
    --streaming with its flags (tests/test_torch_streaming.py)."""
    path = tmp_path / "bad.json"
    cfg = json.loads(open(_ratings_config(tmp_path)).read())
    cfg["coordinates"]["fixed"]["optimizer"].update(
        optimizer="TRON", regularization="L1")
    path.write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="TRON does not support L1"):
        train_game.run(train_game.parse_args(_train_argv(tmp_path, str(path))))
    config_path = _ratings_config(tmp_path)
    for flags, item in ((("--parallel-data", "2"), "item 8"), (("--hosts", "2"), "item 8"),
                        (("--coordinator-address", "localhost:1"), "item 8")):
        with pytest.raises(NotImplementedError, match=f"{flags[0]} is not ported.*{item}"):
            train_game.run(train_game.parse_args(_train_argv(tmp_path, config_path, *flags)))
    # a sweep needs validation data to pick its best, as in the JAX CLI
    argv = _train_argv(tmp_path, _sweep_config(tmp_path))
    argv.remove(os.path.join(RATINGS, "test"))
    with pytest.raises(ValueError, match="sweeps need --validation-data-dirs"):
        train_game.run(train_game.parse_args(argv))


def _jax_cli(tmp_path, argv):
    from photon_ml_tpu.cli import train_game as jax_train_game

    at = argv.index("--device")
    jargv = argv[:at] + argv[at + 2:] + ["--output-dir", str(tmp_path / "jax_out")]
    return jax_train_game.run(jax_train_game.parse_args(jargv))


def test_golden_fixed_effect_tron_cli_matches_jax(tmp_path):
    """The reference's golden FE-only fit (tests/test_golden_fixture.py:
    FIXED on TRON, L2 λ = 10, RMSE < 0.95, captured 0.8274)."""
    cfg = json.loads(open(_ratings_config(tmp_path, fixed_optimizer="TRON")).read())
    cfg["coordinates"] = {"fixed": cfg["coordinates"]["fixed"]}
    cfg["update_order"] = ["fixed"]
    path = tmp_path / "fe_only.json"
    path.write_text(json.dumps(cfg))
    argv = _train_argv(tmp_path, str(path))
    fit = train_game.run(train_game.parse_args(
        argv + ["--profile-dir", str(tmp_path / "profile")]))
    assert os.path.getsize(tmp_path / "profile" / "trace.json") > 0
    jfit = _jax_cli(tmp_path, argv)
    assert fit.validation_metric < 0.95
    assert abs(fit.validation_metric - jfit.validation_metric) <= 1e-4


def test_tron_and_owlqn_coordinates_cli_matches_jax(tmp_path):
    """The fixed effect on TRON, per_user on OWL-QN (elastic net), per_movie
    on L-BFGS, with the feature statistics written: RMSE equal to the JAX
    CLI's to 1e-4, and the statistics files equal to its records."""
    from photon_ml_tpu.io.avro import read_avro_dir as jax_read_dir
    from photon_ml_tpu_torch.io.avro import read_avro_dir

    cfg = json.loads(open(_ratings_config(tmp_path, fixed_optimizer="TRON")).read())
    cfg["coordinates"]["per_user"]["optimizer"].update(regularization="ELASTIC_NET", alpha=0.5)
    path = tmp_path / "mixed.json"
    path.write_text(json.dumps(cfg))
    argv = _train_argv(tmp_path, str(path), "--save-feature-stats")
    fit = train_game.run(train_game.parse_args(argv))
    jfit = _jax_cli(tmp_path, argv)
    assert fit.validation_metric < 0.45
    assert abs(fit.validation_metric - jfit.validation_metric) <= 1e-4
    for shard in ("global", "per_user", "per_movie"):
        got = list(read_avro_dir(str(tmp_path / "out" / "feature-stats" / shard)))
        want = list(jax_read_dir(str(tmp_path / "jax_out" / "feature-stats" / shard)))
        assert [(r["featureName"], r["featureTerm"]) for r in got] == [
            (r["featureName"], r["featureTerm"]) for r in want]
        for a, b in zip(got, want):
            assert a["metrics"].keys() == b["metrics"].keys()
            np.testing.assert_allclose(list(a["metrics"].values()), list(b["metrics"].values()),
                                       rtol=1e-5, atol=1e-6)


def test_estimator_rejects_unported_coordinate_options():
    """Down-sampling is ported (sampler.py; its parity tests are in
    test_torch_sampler.py): a down-sampled fixed effect trains. What the
    estimator still rejects is TRON with L1, as the JAX package does."""
    labels, shards, id_tags = _glmix(3, 50)
    opt = config.GlmOptimizationConfiguration(down_sampling_rate=0.5)
    t = game.GameEstimator(TaskType.LOGISTIC_REGRESSION, {
        "fixed": game.FixedEffectCoordinateConfiguration("global", opt),
    }, device="cpu")
    assert np.isfinite(t.fit(torch_game_data(labels, shards, id_tags)).objective_history[-1][1])
    tron_l1 = config.GlmOptimizationConfiguration(
        optimizer_config=config.OptimizerConfig.tron(),
        regularization=config.RegularizationContext(RegularizationType.L1),
        regularization_weight=1.0,
    )
    t = game.GameEstimator(TaskType.LOGISTIC_REGRESSION, {
        "fixed": game.FixedEffectCoordinateConfiguration("global", tron_l1),
    }, device="cpu")
    with pytest.raises(ValueError, match="TRON does not support L1"):
        t.fit(torch_game_data(labels, shards, id_tags))
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_standardized_benes_fit_matches_jax():
    """The fixed effect trains on the Benes engine in the standardized space
    (intercept column 0) and its model holds original-space coefficients,
    as the JAX fit's does under the same context."""
    from photon_ml_tpu.normalization import build_normalization_context as jax_context
    from photon_ml_tpu.ops.data import LabeledData as JaxLabeledData
    from photon_ml_tpu.stat.summary import summarize as jax_summarize
    from photon_ml_tpu.types import NormalizationType as JaxNorm
    from photon_ml_tpu_torch.convert import normalization_context_from_numpy

    train, val = _glmix(4, 500), _glmix(5, 400)
    jtrain = jax_game_data(*train)
    jfeats = jtrain.sparse_features("global", engine="benes")
    stats = jax_summarize(JaxLabeledData.create(jfeats, jtrain.labels, weights=jtrain.weights))
    jctx = jax_context(JaxNorm.STANDARDIZATION, stats.mean, stats.variance, stats.max_abs, 0)
    tctx = normalization_context_from_numpy(np.asarray(jctx.factor), np.asarray(jctx.shift),
                                            device="cpu")

    j, t = _estimators()
    fe = j.coordinate_configs["fixed"]
    j.coordinate_configs["fixed"] = jax_game.FixedEffectCoordinateConfiguration(
        "global", fe.optimizer, sparse_engine="benes")
    j.normalization, j.intercept_indices = {"global": jctx}, {"global": 0}
    t = game.GameEstimator(TaskType.LOGISTIC_REGRESSION, {
        **t.coordinate_configs,
        "fixed": game.FixedEffectCoordinateConfiguration(
            "global", t.coordinate_configs["fixed"].optimizer, sparse_engine="benes"),
    }, normalization={"global": tctx}, intercept_indices={"global": 0}, device="cpu")
    jfit = j.fit(jtrain, jax_game_data(*val))
    tfit = t.fit(torch_game_data(*train), torch_game_data(*val))
    np.testing.assert_allclose([v for _, v in tfit.objective_history],
                               [v for _, v in jfit.objective_history], rtol=1e-4)
    assert abs(tfit.validation_metric - jfit.validation_metric) <= 1e-4
    np.testing.assert_allclose(game_model_to_numpy(tfit.model)["fixed"]["means"],
                               coordinates_of_jax_model(jfit.model)["fixed"]["means"], atol=2e-3)


def test_standardized_benes_cli_matches_jax(tmp_path):
    from photon_ml_tpu.cli import train_game as jax_train_game
    from photon_ml_tpu_torch.io.model_io import load_game_model

    argv = _train_argv(tmp_path, _ratings_config(tmp_path, engine="benes"),
                       "--normalization-type", "STANDARDIZATION")
    fit = train_game.run(train_game.parse_args(argv))
    at = argv.index("--device")
    jargv = argv[:at] + argv[at + 2:] + ["--output-dir", str(tmp_path / "jax_out")]
    jfit = jax_train_game.run(jax_train_game.parse_args(jargv))
    assert fit.validation_metric < 0.45  # the reference's gate (captured 0.3875)
    assert abs(fit.validation_metric - jfit.validation_metric) <= 1e-4
    # the saved model remembers its engine: score_game scores through Benes
    model, _ = load_game_model(str(tmp_path / "out" / "best"), device="cpu")
    assert model.meta["fixed"].sparse_engine == "benes"
    rmse = score_game.run(score_game.parse_args([
        "--data-dirs", os.path.join(RATINGS, "test"),
        "--model-dir", str(tmp_path / "out" / "best"),
        "--output-dir", str(tmp_path / "scores"), "--evaluator", "RMSE", "--device", "cpu",
    ]))
    assert abs(rmse - fit.validation_metric) <= 1e-6


@pytest.mark.parametrize("flags", [
    ("--telemetry-out", "run.jsonl", "--trace-out", "trace.json"),
    ("--progress-out", "progress.jsonl", "--introspect-port", "0"),
    ("--auto-tune", "--auto-tune-trials", "1"),
])
def test_train_game_cli_telemetry_flags(tmp_path, flags):
    """The flags refused before the telemetry was ported now run on the
    ratings fixture: the fit is bitwise the plain run's, the ledgers and the
    trace validate, --auto-tune writes auto-tune.json."""
    import photon_ml_tpu_torch.telemetry as tt

    config = _ratings_config(tmp_path)
    plain = train_game.run(train_game.parse_args(_train_argv(tmp_path, config)))
    extra = [str(tmp_path / f) if f.endswith((".jsonl", ".json")) else f for f in flags]
    argv = _train_argv(tmp_path, config, *extra)
    argv[argv.index(str(tmp_path / "out"))] = str(tmp_path / "flags")
    fit = train_game.run(train_game.parse_args(argv))
    assert not tt.get_tracer().enabled
    assert fit.objective_history == plain.objective_history
    assert fit.validation_metric == plain.validation_metric < 0.45
    if "--telemetry-out" in flags:
        spans = {r["name"] for r in tt.validate_ledger(str(tmp_path / "run.jsonl"))
                 if r["type"] == "span"}
        assert {"read training data", "fit", "game/fit", "cd/run", "cd/coordinate",
                "fe/solve", "re/solve_bucket", "save model"} <= spans
        tt.validate_chrome_trace(str(tmp_path / "trace.json"))
    if "--progress-out" in flags:
        progress = tt.extract_progress_records(
            tt.validate_ledger(str(tmp_path / "progress.jsonl")))
        assert [r["kind"] for r in progress].count("coordinate") == 6
    if "--auto-tune" in flags:
        with open(tmp_path / "flags" / "auto-tune.json") as f:
            tuned = json.load(f)
        assert len(tuned["trials"]) == 2 and tuned["judge_metric"] == "autotune.wall_s"


def _sweep_config(tmp_path):
    """The ratings GLMix config with per_user swept over λ ∈ {0.1, 1, 10}."""
    cfg = json.loads(open(_ratings_config(tmp_path)).read())
    opt = cfg["coordinates"]["per_user"]["optimizer"]
    del opt["regularization_weight"]
    opt["regularization_weights"] = [0.1, 1.0, 10.0]
    path = tmp_path / "sweep.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _layout(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _saved_weights(model_dir):
    with open(os.path.join(model_dir, "model-metadata.json")) as f:
        coords = json.load(f)["configurations"]["coordinates"]
    return {cid: c["optimizer"]["regularization_weight"] for cid, c in coords.items()}


def test_sweep_cli_picks_the_jax_best(tmp_path):
    """A regularization_weights sweep (refused before fit_multiple was
    ported) trains one model per λ and picks the JAX CLI's best
    configuration; --model-output-mode ALL saves every swept model under
    all/<i> with its own λ, the same files as the JAX CLI's, RE models in
    --num-output-files-for-random-effect-model 2 part files."""
    argv = _train_argv(tmp_path, _sweep_config(tmp_path), "--model-output-mode", "ALL",
                       "--num-output-files-for-random-effect-model", "2")
    fit = train_game.run(train_game.parse_args(argv))
    jfit = _jax_cli(tmp_path, argv)
    out, jout = tmp_path / "out", tmp_path / "jax_out"
    assert abs(fit.validation_metric - jfit.validation_metric) <= 1e-4
    assert fit.validation_metric < 0.45
    assert _saved_weights(out / "best") == _saved_weights(jout / "best")
    assert _layout(out) == _layout(jout)
    assert "random-effect/per_user/coefficients/part-00001.avro" in _layout(out / "best")
    assert [_saved_weights(out / "all" / str(i))["per_user"] for i in range(3)] == [
        0.1, 1.0, 10.0]


def test_tuning_cli_matches_jax(tmp_path):
    """--hyperparameter-tuning RANDOM (2 trials, warm-started): the best of
    the base fit and the trials, and the λ saved with it, equal the JAX
    CLI's; BAYESIAN runs its GP (3 coordinates: the GP takes over at the
    fourth observation) under --regularization-weight-range."""
    argv = _train_argv(tmp_path, _ratings_config(tmp_path), "--hyperparameter-tuning",
                       "RANDOM", "--hyperparameter-tuning-iter", "2",
                       "--regularization-weight-range", "1e-2,1e2")
    fit = train_game.run(train_game.parse_args(argv))
    jfit = _jax_cli(tmp_path, argv)
    assert abs(fit.validation_metric - jfit.validation_metric) <= 1e-4
    assert _saved_weights(tmp_path / "out" / "best") == _saved_weights(
        tmp_path / "jax_out" / "best")
    bayes = _train_argv(tmp_path, _ratings_config(tmp_path), "--hyperparameter-tuning",
                        "BAYESIAN", "--hyperparameter-tuning-iter", "4",
                        "--regularization-weight-range", "1e-3,1e3", "--no-warm-start",
                        "--model-output-mode", "NONE", "--output-dir", str(tmp_path / "bayes"))
    best = train_game.run(train_game.parse_args(bayes))
    assert best.validation_metric < 0.45
    assert not os.path.exists(tmp_path / "bayes")  # NONE saves nothing


def test_async_schedule_and_order_flags_cli_match_jax(tmp_path):
    """--schedule async --staleness 1 with --updating-sequence reversed and
    --check-data: RMSE equal to the JAX CLI's to 1e-4."""
    argv = _train_argv(tmp_path, _ratings_config(tmp_path), "--schedule", "async",
                       "--staleness", "1", "--updating-sequence", "per_movie", "per_user",
                       "fixed", "--check-data")
    fit = train_game.run(train_game.parse_args(argv))
    jfit = _jax_cli(tmp_path, argv)
    assert [c for c, _ in fit.objective_history][:3] == ["per_movie", "per_user", "fixed"]
    assert abs(fit.validation_metric - jfit.validation_metric) <= 1e-4
    assert fit.validation_metric < 0.45
    with pytest.raises(ValueError, match="unknown coordinates"):
        train_game.run(train_game.parse_args(_train_argv(
            tmp_path, _ratings_config(tmp_path), "--updating-sequence", "nope")))


def _daily_copy(root):
    """The ratings fixture laid out as daily yyyy/MM/dd dirs: training on
    2026-03-01, validation on 2026-03-02, and a decoy day outside each
    range holding the other set."""
    import shutil

    days = {"train": (("2026", "03", "01"), "train"), "train_decoy": (("2026", "02", "20"), "test"),
            "val": (("2026", "03", "02"), "test"), "val_decoy": (("2026", "01", "01"), "train")}
    for name, (ymd, src) in days.items():
        base = root / name.split("_")[0]
        dest = base.joinpath(*ymd)
        dest.mkdir(parents=True)
        shutil.copy(os.path.join(RATINGS, src, "part-00000.avro"), dest)
    return str(root / "train"), str(root / "val")


def test_date_range_flags_cli_match_jax(tmp_path):
    """--train-date-range and --validation-date-range over a daily layout
    read only their days: the fit equals the plain-dirs fit bitwise and the
    JAX CLI's to 1e-4; score_game --date-range reproduces its RMSE."""
    train_dir, val_dir = _daily_copy(tmp_path / "daily")
    config_path = _ratings_config(tmp_path)
    plain = train_game.run(train_game.parse_args(
        _train_argv(tmp_path, config_path, "--output-dir", str(tmp_path / "plain"))))
    argv = [
        "--train-data-dirs", train_dir, "--validation-data-dirs", val_dir,
        "--train-date-range", "20260225-20260301", "--validation-date-range",
        "20260302-20260310", "--coordinate-config", config_path,
        "--task", "LINEAR_REGRESSION", "--output-dir", str(tmp_path / "out"),
        "--evaluator", "RMSE", "--num-outer-iterations", "2", "--device", "cpu",
    ]
    fit = train_game.run(train_game.parse_args(argv))
    jfit = _jax_cli(tmp_path, argv)
    assert fit.objective_history == plain.objective_history
    assert fit.validation_metric == plain.validation_metric
    assert abs(fit.validation_metric - jfit.validation_metric) <= 1e-4
    rmse = score_game.run(score_game.parse_args([
        "--data-dirs", val_dir, "--date-range", "20260302-20260302",
        "--model-dir", str(tmp_path / "out" / "best"),
        "--output-dir", str(tmp_path / "scores"), "--evaluator", "RMSE", "--device", "cpu",
    ]))
    assert abs(rmse - fit.validation_metric) <= 1e-6
    with pytest.raises(FileNotFoundError, match="no input dirs"):
        score_game.run(score_game.parse_args([
            "--data-dirs", val_dir, "--date-range", "20250101-20250102",
            "--model-dir", str(tmp_path / "out" / "best"),
            "--output-dir", str(tmp_path / "scores2"), "--device", "cpu",
        ]))

"""Single-GLM training in the port against the JAX package.

- ``estimators.model_training.train_glm`` (one solver lane over a sparse
  fixed-effect problem): sweep objectives per λ rtol 1e-4, coefficients
  atol 2e-3, variances rtol 1e-2 (Hessian terms), for L-BFGS, TRON and
  OWL-QN; every normalization type reaching the JAX package's optimum;
  per-feature boxes given in the original space; tracked models;
- the ``train_glm`` CLI on Avro and on LibSVM input against the JAX CLI: the
  same best λ, metrics to 1e-4, model-file coefficients atol 2e-3; its
  refusals of flags not ported yet; ``--telemetry-out`` and
  ``--trace-out`` (outputs as the plain run's, the phases as spans);
- ``io/libsvm.py``, ``data/validators.py``, ``opt/tracking.py``,
  ``event.py``, ``utils/timer.py`` and ``cli.common.parse_box_constraints``
  against their JAX counterparts.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_ml_tpu.estimators.model_training import train_glm as jax_train_glm
from photon_ml_tpu.normalization import build_normalization_context as jax_context
from photon_ml_tpu.ops.data import LabeledData as JaxData
from photon_ml_tpu.ops.features import from_scipy_like as jax_ell
from photon_ml_tpu.stat.summary import summarize as jax_summarize
from photon_ml_tpu.types import NormalizationType as JaxNorm
from photon_ml_tpu.types import TaskType as JaxTask
from _torch_parity import solver_configs
from photon_ml_tpu_torch.cli import train_glm as train_glm_cli
from photon_ml_tpu_torch.estimators.model_training import train_glm
from photon_ml_tpu_torch.normalization import build_normalization_context
from photon_ml_tpu_torch.ops.data import LabeledData
from photon_ml_tpu_torch.ops.features import from_scipy_like
from photon_ml_tpu_torch.stat.summary import summarize
from photon_ml_tpu_torch.types import NormalizationType, TaskType

NORMS = ["NONE", "STANDARDIZATION", "SCALE_WITH_STANDARD_DEVIATION", "SCALE_WITH_MAX_MAGNITUDE"]


def _problem(seed, task="LOGISTIC_REGRESSION", n=400, d=24, k=5):
    """Sparse rows with an intercept in column 0 and labels from a seeded
    GLM of the task; features scaled per column so normalization matters."""
    rng = np.random.default_rng(seed)
    cols = np.concatenate([np.zeros((n, 1), int),
                           np.stack([rng.choice(np.arange(1, d), k, replace=False)
                                     for _ in range(n)])], 1)
    scale = rng.uniform(0.5, 3.0, d)
    vals = np.concatenate([np.ones((n, 1)), rng.standard_normal((n, k)) * scale[cols[:, 1:]]
                           + 0.3], 1).astype(np.float32)
    w = rng.standard_normal(d) * 0.4 / scale
    z = (vals * w[cols]).sum(1)
    if task == "LOGISTIC_REGRESSION":
        y = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float32)
    elif task == "POISSON_REGRESSION":
        y = rng.poisson(np.exp(np.clip(z, -3, 2))).astype(np.float32)
    else:
        y = (z + 0.3 * rng.standard_normal(n)).astype(np.float32)
    rows = np.repeat(np.arange(n), k + 1)
    return rows, cols.ravel(), vals.ravel(), (n, d), y


def _both(problem, norm="NONE"):
    rows, cols, vals, shape, y = problem
    jfeats = jax_ell(rows, cols, vals, shape)
    tfeats = from_scipy_like(rows, cols, vals, shape, device="cpu")
    jd = JaxData.create(jfeats, jnp.asarray(y))
    td = LabeledData.create(tfeats, torch.from_numpy(y))
    if norm != "NONE":
        js, ts = jax_summarize(jd), summarize(td)
        jd = JaxData.create(jfeats, jnp.asarray(y), norm=jax_context(
            JaxNorm[norm], js.mean, js.variance, js.max_abs, 0))
        td = LabeledData.create(tfeats, torch.from_numpy(y), norm=build_normalization_context(
            NormalizationType[norm], ts.mean, ts.variance, ts.max_abs, 0))
    return jd, td


def _means(fit):
    return fit.model.coefficients.means


@pytest.mark.parametrize("case", ["lbfgs_sweep", "tron_variances", "owlqn_box"])
def test_train_glm_matches_jax(case):
    task, opt, kw = {
        "lbfgs_sweep": ("LOGISTIC_REGRESSION", ("LBFGS", "L2", 1.0), {}),
        "tron_variances": ("LINEAR_REGRESSION", ("TRON", "L2", 1.0),
                           {"compute_variances": True}),
        "owlqn_box": ("POISSON_REGRESSION", ("LBFGS", "ELASTIC_NET", 1.0, 0.5), {}),
    }[case]
    box = {"constraint_lower": -0.3, "constraint_upper": 0.3} if case == "owlqn_box" else {}
    jcfg, tcfg = solver_configs(*opt, **box)
    weights = [100.0, 10.0, 1.0, 0.1] if case == "lbfgs_sweep" else [1.0]
    jd, td = _both(_problem(1, task))
    jfits = jax_train_glm(jd, JaxTask[task], jcfg, regularization_weights=weights, **kw)
    tfits = train_glm(td, TaskType[task], tcfg, regularization_weights=weights, **kw)
    assert [f.regularization_weight for f in tfits] == weights
    for jf, tf in zip(jfits, tfits):
        np.testing.assert_allclose(float(tf.result.value[0]), float(jf.result.value), rtol=1e-4)
        np.testing.assert_allclose(_means(tf).numpy(), np.asarray(_means(jf)), atol=2e-3)
        if kw:
            np.testing.assert_allclose(tf.model.coefficients.variances.numpy(),
                                       np.asarray(jf.model.coefficients.variances), rtol=1e-2)
    if case == "owlqn_box":
        w = _means(tfits[0])
        assert float(w.abs().max()) <= np.float32(0.3) and bool((w.abs() == np.float32(0.3)).any())


@pytest.mark.parametrize("norm", NORMS)
def test_normalization_types_reach_the_jax_optimum(norm):
    """Each normalization trains in its own space; the models (original
    space) and objectives equal the JAX package's, and every type reaches
    the one optimum of the unnormalized problem (L2 acts on the normalized
    coefficients, so to the regularization's share: atol 0.05)."""
    jcfg, tcfg = solver_configs("LBFGS", "L2", 0.01)
    problem = _problem(2)
    jd, td = _both(problem, norm)
    jf = jax_train_glm(jd, JaxTask.LOGISTIC_REGRESSION, jcfg, intercept_index=0)[0]
    tf = train_glm(td, TaskType.LOGISTIC_REGRESSION, tcfg, intercept_index=0)[0]
    np.testing.assert_allclose(float(tf.result.value[0]), float(jf.result.value), rtol=1e-4)
    np.testing.assert_allclose(_means(tf).numpy(), np.asarray(_means(jf)), atol=2e-3)
    plain = train_glm(_both(problem)[1], TaskType.LOGISTIC_REGRESSION, tcfg)[0]
    np.testing.assert_allclose(_means(tf).numpy(), _means(plain).numpy(), atol=0.05)


def test_per_feature_boxes_in_the_original_space():
    """Bounds arrive in the original space and hold there after a
    factor-only normalization; under a shift a bounded intercept is
    refused, as in the JAX package."""
    d = 24
    lo = np.full(d, -np.inf, np.float32)
    hi = np.full(d, np.inf, np.float32)
    lo[3], hi[3], hi[7] = -0.05, 0.05, 0.0
    jcfg, tcfg = solver_configs("TRON", "L2", 1.0)
    problem = _problem(3)
    jd, td = _both(problem, "SCALE_WITH_STANDARD_DEVIATION")
    jf = jax_train_glm(jd, JaxTask.LOGISTIC_REGRESSION, jcfg, intercept_index=0,
                       box_constraints=(lo, hi))[0]
    tf = train_glm(td, TaskType.LOGISTIC_REGRESSION, tcfg, intercept_index=0,
                   box_constraints=(lo, hi))[0]
    w = _means(tf)
    np.testing.assert_allclose(w.numpy(), np.asarray(_means(jf)), atol=2e-3)
    assert abs(float(w[3])) <= 0.05 + 1e-6 and float(w[7]) <= 1e-6
    _, tds = _both(problem, "STANDARDIZATION")
    lo[0] = -1.0
    with pytest.raises(ValueError, match="intercept box constraint"):
        train_glm(tds, TaskType.LOGISTIC_REGRESSION, tcfg, intercept_index=0,
                  box_constraints=(lo, hi))


def test_tracked_models_match_jax():
    jcfg, tcfg = solver_configs("LBFGS", "L2", 1.0, max_iterations=6, tolerance=0.0)
    jd, td = _both(_problem(4), "STANDARDIZATION")
    jf = jax_train_glm(jd, JaxTask.LOGISTIC_REGRESSION, jcfg, track_models=True,
                       intercept_index=0)[0]
    tf = train_glm(td, TaskType.LOGISTIC_REGRESSION, tcfg, track_models=True,
                   intercept_index=0)[0]
    assert len(tf.tracked_models) == len(jf.tracked_models) == 7
    for jm, tm in zip(jf.tracked_models, tf.tracked_models):
        np.testing.assert_allclose(tm.coefficients.means.numpy(),
                                   np.asarray(jm.coefficients.means), atol=2e-3)
    assert torch.equal(tf.tracked_models[-1].coefficients.means, _means(tf))


# ---- the CLI ---------------------------------------------------------------

def _write_libsvm(path, seed, n, d=30, task="LOGISTIC_REGRESSION", zero_based=False):
    rng = np.random.default_rng(seed)
    w = np.random.default_rng(77).standard_normal(d) * 0.5
    with open(path, "w") as f:
        for _ in range(n):
            idx = np.sort(rng.choice(d, 6, replace=False))
            v = rng.standard_normal(6)
            z = float((v * w[idx]).sum())
            if task == "LOGISTIC_REGRESSION":
                y = "+1" if rng.random() < 1 / (1 + np.exp(-z)) else "-1"
            elif task == "POISSON_REGRESSION":
                y = str(int(rng.poisson(np.exp(min(z, 2.0)))))
            else:
                y = f"{z + 0.2 * rng.standard_normal():.5f}"
            base = 0 if zero_based else 1
            f.write(y + " " + " ".join(f"{j + base}:{x:.5f}" for j, x in zip(idx, v)) + "\n")


def _write_avro(path, seed, n):
    from photon_ml_tpu_torch.io.data_reader import write_training_examples

    rng = np.random.default_rng(seed)
    w = np.random.default_rng(78).standard_normal(20) * 0.6
    records = []
    for _ in range(n):
        idx = rng.choice(20, 5, replace=False)
        v = rng.standard_normal(5)
        z = float((v * w[idx]).sum())
        records.append({
            "label": float(rng.random() < 1 / (1 + np.exp(-z))),
            "features": [(f"f{j}", "a" if j % 3 else "", float(x)) for j, x in zip(idx, v)],
        })
    os.makedirs(path, exist_ok=True)
    write_training_examples(os.path.join(path, "part-00000.avro"), records)


def _model_file(path):
    out = {}
    with open(path) as f:
        for line in f:
            name, term, value, *rest = line.rstrip("\n").split("\t")
            out[(name, term)] = float(value)
    return out


def _run_both(tmp_path, argv):
    from photon_ml_tpu.cli import train_glm as jax_cli

    tres = train_glm_cli.run(train_glm_cli.parse_args(
        argv + ["--output-dir", str(tmp_path / "t"), "--device", "cpu"]))
    jres = jax_cli.run(jax_cli.parse_args(argv + ["--output-dir", str(tmp_path / "j")]))
    assert tres["best_lambda"] == jres["best_lambda"]
    assert set(tres["metrics"]) == set(jres["metrics"])
    for lam, m in jres["metrics"].items():
        assert abs(tres["metrics"][lam] - float(m)) <= 1e-4
    tsel = json.loads((tmp_path / "t" / "selection.json").read_text())
    jsel = json.loads((tmp_path / "j" / "selection.json").read_text())
    assert tsel["best_lambda"] == jsel["best_lambda"] and tsel["evaluator"] == jsel["evaluator"]
    for fit in tres["fits"]:
        name = f"model-lambda-{fit.regularization_weight:g}.txt"
        tm, jm = _model_file(tmp_path / "t" / name), _model_file(tmp_path / "j" / name)
        for key in set(tm) | set(jm):
            assert abs(tm.get(key, 0.0) - jm.get(key, 0.0)) <= 2e-3, key
    assert (tmp_path / "t" / "best-model.avro").exists()
    return tres, jres


def test_cli_on_avro_matches_jax(tmp_path):
    """Configuration 1 of examples/BASELINE_CONFIGS.md on Avro input, with
    feature statistics written as the JAX package writes them."""
    from photon_ml_tpu_torch.io.avro import read_avro_dir

    _write_avro(str(tmp_path / "train"), 1, 500)
    _write_avro(str(tmp_path / "test"), 2, 300)
    argv = ["--training-data-dirs", str(tmp_path / "train"),
            "--validation-data-dirs", str(tmp_path / "test"),
            "--task", "LOGISTIC_REGRESSION", "--regularization-weights", "0.1", "1", "10",
            "100", "--optimizer", "LBFGS", "--regularization", "L2"]
    _run_both(tmp_path, argv + ["--summarization-output-dir", str(tmp_path / "stats")])
    records = list(read_avro_dir(str(tmp_path / "stats")))
    assert len(records) == 21 and {"mean", "variance", "min", "max", "numNonzeros"} == set(
        records[0]["metrics"])


@pytest.mark.parametrize("config", ["tron_standardized", "owlqn_box"])
def test_cli_on_libsvm_matches_jax(tmp_path, config):
    """Configurations 2 and 3 of examples/BASELINE_CONFIGS.md on LibSVM
    input."""
    task = {"tron_standardized": "LINEAR_REGRESSION", "owlqn_box": "POISSON_REGRESSION"}[config]
    _write_libsvm(tmp_path / "train.txt", 3, 400, task=task)
    _write_libsvm(tmp_path / "test.txt", 4, 200, task=task)
    argv = ["--training-data-dirs", str(tmp_path / "train.txt"),
            "--validation-data-dirs", str(tmp_path / "test.txt"),
            "--input-format", "LIBSVM", "--task", task, "--regularization-weights", "1"]
    if config == "tron_standardized":
        argv += ["--optimizer", "TRON", "--regularization", "L2",
                 "--normalization-type", "STANDARDIZATION", "--compute-variances"]
    else:
        argv += ["--regularization", "ELASTIC_NET", "--elastic-net-alpha", "0.5",
                 "--coefficient-box-constraints", '{"lower": -0.2, "upper": 0.2}']
    tres, _ = _run_both(tmp_path, argv)
    w = tres["fits"][0].model.coefficients.means
    if config == "owlqn_box":
        assert float(w.abs().max()) <= np.float32(0.2)
    else:
        assert tres["fits"][0].model.coefficients.variances is not None


def test_cli_refuses_what_is_not_ported(tmp_path):
    _write_libsvm(tmp_path / "train.txt", 5, 50)
    base = ["--training-data-dirs", str(tmp_path / "train.txt"), "--input-format", "LIBSVM",
            "--task", "LOGISTIC_REGRESSION", "--output-dir", str(tmp_path / "o"),
            "--device", "cpu"]
    for extra, item in ((["--diagnostic-mode", "ALL"], "Also still to port"),
                        (["--coordinator-address", "localhost:1"], "The cluster plane"),
                        (["--num-processes", "2"], "The cluster plane"),
                        (["--process-id", "1"], "The cluster plane")):
        with pytest.raises(NotImplementedError, match=item):
            train_glm_cli.run(train_glm_cli.parse_args(base + extra))
    with pytest.raises(ValueError, match="requires --validation-data-dirs"):
        train_glm_cli.run(train_glm_cli.parse_args(base + ["--validate-per-iteration"]))
    # off-heap index maps are ported; with LIBSVM input they are refused, as
    # in the JAX CLI (LIBSVM features are positional)
    with pytest.raises(ValueError, match="--offheap-indexmap-dir applies to AVRO input"):
        train_glm_cli.run(train_glm_cli.parse_args(base + ["--offheap-indexmap-dir", "idx"]))


@pytest.mark.parametrize("flags", [("--telemetry-out",), ("--trace-out",),
                                   ("--telemetry-out", "--trace-out")])
def test_cli_telemetry_flags(tmp_path, flags):
    """--telemetry-out and --trace-out (refused before the telemetry was
    ported): the same outputs as the plain run, a valid ledger and trace
    whose spans are the phases, and the same span names as the JAX CLI's
    ledger."""
    import photon_ml_tpu.telemetry as jt
    from photon_ml_tpu.cli import train_glm as jax_train_glm_cli
    import photon_ml_tpu_torch.telemetry as tt

    _write_libsvm(tmp_path / "train.txt", 5, 120)
    _write_libsvm(tmp_path / "val.txt", 6, 60)
    base = ["--training-data-dirs", str(tmp_path / "train.txt"), "--validation-data-dirs",
            str(tmp_path / "val.txt"), "--input-format", "LIBSVM", "--task",
            "LOGISTIC_REGRESSION", "--regularization-weights", "0.1", "1"]
    files = {"--telemetry-out": "run.jsonl", "--trace-out": "trace.json"}

    def telemetry(root):
        return [a for f in flags for a in (f, str(root / files[f]))]

    plain = train_glm_cli.run(train_glm_cli.parse_args(
        base + ["--output-dir", str(tmp_path / "plain"), "--device", "cpu"]))
    traced = train_glm_cli.run(train_glm_cli.parse_args(
        base + ["--output-dir", str(tmp_path / "t"), "--device", "cpu"]
        + telemetry(tmp_path / "t")))
    assert not tt.get_tracer().enabled
    assert traced["best_lambda"] == plain["best_lambda"] and traced["metrics"] == plain["metrics"]
    for name in ("model-lambda-0.1.txt", "model-lambda-1.txt", "selection.json"):
        assert (tmp_path / "t" / name).read_text() == (tmp_path / "plain" / name).read_text()
    jax_train_glm_cli.main(base + ["--output-dir", str(tmp_path / "j")]
                           + telemetry(tmp_path / "j"))
    jt.disable_tracing()
    if "--telemetry-out" in flags:
        mine = tt.validate_ledger(str(tmp_path / "t" / "run.jsonl"))
        ref = jt.validate_ledger(str(tmp_path / "j" / "run.jsonl"))
        names = sorted(r["name"] for r in mine if r["type"] == "span")
        assert names == ["output", "preprocess", "train", "validate"]
        assert names == sorted(r["name"] for r in ref if r["type"] == "span")
        assert [r["event"] for r in mine if r["type"] == "event"] == [
            r["event"] for r in ref if r["type"] == "event"]
    if "--trace-out" in flags:
        doc = tt.validate_chrome_trace(str(tmp_path / "t" / "trace.json"))
        assert sorted(e["name"] for e in doc["traceEvents"]) == sorted(
            e["name"] for e in jt.validate_chrome_trace(
                str(tmp_path / "j" / "trace.json"))["traceEvents"])


def test_cli_flags_and_event_listener(tmp_path):
    """--validate-per-iteration, --delete-output-dirs-if-exist,
    --selected-features-file, --log-file and --event-listeners."""
    from photon_ml_tpu_torch.io.avro import write_avro_file

    _write_avro(str(tmp_path / "train"), 6, 300)
    _write_avro(str(tmp_path / "test"), 7, 100)
    sel = tmp_path / "selected.avro"
    write_avro_file(str(sel), {"type": "record", "name": "NameTerm", "fields": [
        {"name": "name", "type": "string"}, {"name": "term", "type": "string"}]},
        [{"name": "f1", "term": "a"}, {"name": "f3", "term": ""}, {"name": "f4", "term": "a"}])
    out = tmp_path / "out"
    out.mkdir()
    (out / "stale.txt").write_text("old")
    log = tmp_path / "logs" / "run.log"
    res = train_glm_cli.run(train_glm_cli.parse_args([
        "--training-data-dirs", str(tmp_path / "train"),
        "--validation-data-dirs", str(tmp_path / "test"),
        "--task", "LOGISTIC_REGRESSION", "--output-dir", str(out), "--device", "cpu",
        "--regularization-weights", "1", "--validate-per-iteration",
        "--delete-output-dirs-if-exist", "--selected-features-file", str(sel),
        "--log-file", str(log), "--event-listeners", f"{__name__}.RecordingListener",
    ]))
    assert not (out / "stale.txt").exists()
    keys = set(_model_file(out / "model-lambda-1.txt"))
    assert keys <= {("f1", "a"), ("f3", ""), ("f4", "a"), ("(INTERCEPT)", "")}
    assert "iteration=1 AUC=" in log.read_text()
    assert len(res["fits"][0].tracked_models) == int(res["fits"][0].result.iterations[0]) + 1
    assert [type(e).__name__ for e in RecordingListener.seen] == [
        "PhotonSetupEvent", "TrainingStartEvent", "PhotonOptimizationLogEvent",
        "TrainingFinishEvent"]
    assert RecordingListener.closed


class RecordingListener:
    seen: list = []
    closed = False

    def __init__(self):
        RecordingListener.seen = []
        RecordingListener.closed = False

    def on_event(self, event):
        RecordingListener.seen.append(event)

    def close(self):
        RecordingListener.closed = True


# ---- the supporting modules -------------------------------------------------

@pytest.mark.parametrize("zero_based,binarize,dim", [(False, True, None), (True, False, None),
                                                     (False, True, 12)])
def test_read_libsvm_matches_jax(tmp_path, zero_based, binarize, dim):
    from photon_ml_tpu.io.libsvm import read_libsvm as jax_read
    from photon_ml_tpu_torch.io.libsvm import read_libsvm

    (tmp_path / "d").mkdir()
    _write_libsvm(tmp_path / "d" / "part-0", 8, 40, d=20, zero_based=zero_based)
    _write_libsvm(tmp_path / "d" / "part-1", 9, 30, d=20, zero_based=zero_based,
                  task="LINEAR_REGRESSION")
    (tmp_path / "d" / "_SUCCESS").write_text("")
    kw = dict(zero_based=zero_based, binarize_labels=binarize, feature_dimension=dim)
    jdata, jmap = jax_read(str(tmp_path / "d"), **kw)
    tdata, tmap = read_libsvm(str(tmp_path / "d"), **kw)
    np.testing.assert_array_equal(tdata.labels, jdata.labels)
    js, ts = jdata.feature_shards["features"], tdata.feature_shards["features"]
    assert ts.dim == js.dim
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(ts, f), np.asarray(getattr(js, f)))
    assert dict(tmap.items()) == dict(jmap.items())


def test_libsvm_to_avro_matches_jax(tmp_path):
    from photon_ml_tpu.io.avro import read_avro_file as jax_read_avro
    from photon_ml_tpu.io.libsvm import libsvm_to_training_example_avro as jax_convert
    from photon_ml_tpu_torch.io.avro import read_avro_file
    from photon_ml_tpu_torch.io.libsvm import libsvm_to_training_example_avro

    _write_libsvm(tmp_path / "in.txt", 10, 25)
    assert libsvm_to_training_example_avro(str(tmp_path / "in.txt"), str(tmp_path / "t.avro")) \
        == jax_convert(str(tmp_path / "in.txt"), str(tmp_path / "j.avro")) == 25
    assert list(read_avro_file(str(tmp_path / "t.avro"))) == list(
        jax_read_avro(str(tmp_path / "j.avro")))


def _validation_cases():
    rng = np.random.default_rng(11)
    n, d = 60, 8
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (rng.random(n) < 0.5).astype(np.float32)
    return {
        "clean": (X, y, {}),
        "nan_feature": (np.where(np.arange(n * d).reshape(n, d) == 77, np.nan, X), y, {}),
        "inf_label_negative_weight": (X, np.where(np.arange(n) == 5, np.inf, y),
                                      {"weights": np.where(np.arange(n) == 9, -1.0, 1.0)}),
        "bad_labels_offsets": (X, y * 3.0, {"offsets": np.where(np.arange(n) == 2, np.nan, 0.0)}),
    }


@pytest.mark.parametrize("layout", ["dense", "ell", "fused", "benes"])
@pytest.mark.parametrize("case", list(_validation_cases()))
def test_validators_match_jax(layout, case):
    from photon_ml_tpu.data.validators import DataValidationError as JaxError
    from photon_ml_tpu.data.validators import DataValidationType as JaxMode
    from photon_ml_tpu.data.validators import validate_labeled_data as jax_validate
    from photon_ml_tpu.ops.features import DenseFeatures as JaxDense
    from photon_ml_tpu_torch.data.validators import (
        DataValidationError,
        DataValidationType,
        validate_labeled_data,
    )
    from photon_ml_tpu_torch.ops import fused_perm, sparse_perm
    from photon_ml_tpu_torch.ops.features import DenseFeatures

    X, y, extra = _validation_cases()[case]
    n, d = X.shape
    rows, cols = np.nonzero(np.ones_like(X))
    vals = X[rows, cols]
    shape = (n, d)
    tfeats = {
        "dense": lambda: DenseFeatures(torch.from_numpy(X)),
        "ell": lambda: from_scipy_like(rows, cols, vals, shape, device="cpu"),
        "fused": lambda: fused_perm.from_coo(rows, cols, vals, shape, device="cpu"),
        "benes": lambda: sparse_perm.from_coo(rows, cols, vals, shape, device="cpu"),
    }[layout]()
    kw = {k: v.astype(np.float32) for k, v in extra.items()}
    jd = JaxData.create(JaxDense(jnp.asarray(X)), jnp.asarray(y),
                        **{k: jnp.asarray(v) for k, v in kw.items()})
    td = LabeledData.create(tfeats, torch.from_numpy(y),
                            **{k: torch.from_numpy(v) for k, v in kw.items()})
    for mode in ("VALIDATE_FULL", "VALIDATE_SAMPLE", "VALIDATE_DISABLED"):
        expected = None
        try:
            jax_validate(jd, JaxTask.LOGISTIC_REGRESSION, JaxMode[mode], seed=3)
        except JaxError as e:
            expected = e.failures
        if expected is None:
            validate_labeled_data(td, TaskType.LOGISTIC_REGRESSION, DataValidationType[mode],
                                  seed=3)
        else:
            with pytest.raises(DataValidationError) as got:
                validate_labeled_data(td, TaskType.LOGISTIC_REGRESSION,
                                      DataValidationType[mode], seed=3)
            assert got.value.failures == expected
    if case != "clean":
        with pytest.raises(DataValidationError):
            validate_labeled_data(td, TaskType.LOGISTIC_REGRESSION)


def test_poisson_label_check_matches_jax():
    from photon_ml_tpu.data.validators import DataValidationError as JaxError
    from photon_ml_tpu.data.validators import validate_labeled_data as jax_validate
    from photon_ml_tpu.ops.features import DenseFeatures as JaxDense
    from photon_ml_tpu_torch.data.validators import DataValidationError, validate_labeled_data
    from photon_ml_tpu_torch.ops.features import DenseFeatures

    X = np.ones((4, 2), np.float32)
    y = np.array([0.0, 2.0, -1.0, 1.0], np.float32)
    with pytest.raises(JaxError) as j:
        jax_validate(JaxData.create(JaxDense(jnp.asarray(X)), jnp.asarray(y)),
                     JaxTask.POISSON_REGRESSION)
    with pytest.raises(DataValidationError) as t:
        validate_labeled_data(LabeledData.create(DenseFeatures(torch.from_numpy(X)),
                                                 torch.from_numpy(y)),
                              TaskType.POISSON_REGRESSION)
    assert t.value.failures == j.value.failures == [
        "labels for poisson_regression must be non-negative"]


def test_trackers_match_jax():
    """The trackers' summaries of the same solves (a one-lane fixed-effect
    solve; a batch of random-effect lanes as buckets) equal the JAX
    package's."""
    import jax

    from photon_ml_tpu.opt.solve import solve as jax_solve
    from photon_ml_tpu.opt import tracking as jax_tracking
    from photon_ml_tpu.losses import pointwise as jax_pointwise
    from photon_ml_tpu.losses.objective import make_glm_objective as jax_objective
    from _torch_parity import dense_bucket
    from photon_ml_tpu_torch.losses import pointwise
    from photon_ml_tpu_torch.losses.objective import make_glm_objective
    from photon_ml_tpu_torch.opt import tracking
    from photon_ml_tpu_torch.opt.solve import solve

    jcfg, tcfg = solver_configs("LBFGS", "L2", 1.0, max_iterations=4, tolerance=0.0)
    jd, td = _both(_problem(5))
    jr = jax_solve(jax_objective(jax_pointwise.LogisticLoss, use_pallas=False),
                   jnp.zeros(24), jd, jcfg)
    tr = solve(make_glm_objective(pointwise.LogisticLoss), torch.zeros(1, 24), td, tcfg)
    jt = jax_tracking.OptimizationStatesTracker.from_result(jr)
    tt = tracking.OptimizationStatesTracker.from_result(tr)
    assert (tt.iterations, tt.convergence_reason.name) == (jt.iterations, jt.convergence_reason.name)
    np.testing.assert_allclose(tt.values, jt.values, rtol=2e-4)
    assert tracking.FixedEffectOptimizationTracker(tt).to_summary_string().startswith(
        "fixed-effect solve: 4 iterations, reason=MAX_ITERATIONS")

    jcfg, tcfg = solver_configs("LBFGS", "L2", 1.0)
    jb, tb, w0 = dense_bucket(6)
    obj = jax_objective(jax_pointwise.LogisticLoss, use_pallas=False)
    jres = [jax.vmap(lambda w, dd: jax_solve(obj, w, dd, jcfg))(jnp.asarray(w0), jb)]
    tres = [solve(make_glm_objective(pointwise.LogisticLoss), torch.from_numpy(w0), tb, tcfg)]
    jre = jax_tracking.RandomEffectOptimizationTracker.from_results(jres, real_counts=[5])
    tre = tracking.RandomEffectOptimizationTracker.from_results(tres, real_counts=[5])
    assert tre.num_entities == jre.num_entities == 5
    assert {r.name: c for r, c in tre.reason_counts.items()} == {
        r.name: c for r, c in jre.reason_counts.items()}
    assert tre.iteration_stats == jre.iteration_stats
    assert tre.to_summary_string() == jre.to_summary_string()


def test_solver_stats_match_jax():
    from photon_ml_tpu.opt.tracking import SolverStats as JaxStats
    from photon_ml_tpu_torch.event import SolverStatsEvent
    from photon_ml_tpu_torch.opt.tracking import SolverStats

    its = np.array([3, 9, 4, 12, 0, 7])
    reasons = np.array([2, 2, 3, 1, 3, 0])
    t = SolverStats.of_bucket(1, "tron", 4, (8, 4, 2), 8 * 4 + 4 * 4 + 2 * 4, its, reasons)
    j = JaxStats(bucket=1, optimizer="tron", num_entities=6, rounds=3, chunk_iters=4,
                 dispatch_widths=(8, 4, 2), iterations_p50=float(np.percentile(its, 50)),
                 iterations_p99=float(np.percentile(its, 99)), iterations_max=12,
                 sum_entity_iterations=35, executed_lane_iterations=56,
                 lockstep_lane_iterations=72, converged=5, chunk_retraces=0)
    for f in ("iterations_p50", "iterations_p99", "iterations_max", "sum_entity_iterations",
              "executed_lane_iterations", "lockstep_lane_iterations", "converged",
              "wasted_lane_fraction", "lane_iteration_savings"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.to_summary_string() == j.to_summary_string()
    event = SolverStatsEvent.from_stats("per_user", t)
    assert event.wasted_lane_fraction == t.wasted_lane_fraction and event.rounds == 3


def test_event_emitter_matches_jax():
    import photon_ml_tpu.event as jax_event
    import photon_ml_tpu_torch.event as event

    for cls in ("PhotonSetupEvent", "TrainingStartEvent", "PhotonOptimizationLogEvent",
                "TrainingFinishEvent", "SolverStatsEvent"):
        assert [f.name for f in __import__("dataclasses").fields(getattr(event, cls))] == [
            f.name for f in __import__("dataclasses").fields(getattr(jax_event, cls))]
    for name in ("nodots", "no_such_module_xyz.Listener", "json.NoSuchListener",
                 "json.JSONDecodeError", "json.JSONEncoder"):
        messages = []
        for emitter in (jax_event.EventEmitter(), event.EventEmitter()):
            try:
                emitter.register_listener_class(name)
                messages.append(None)
            except ValueError as e:
                messages.append(str(e))
        assert messages[0] is not None and messages[0] == messages[1], name

    class Boom(event.EventListener):
        def on_event(self, e):
            raise RuntimeError("listener fault")

        def close(self):
            raise RuntimeError("close fault")

    emitter = event.EventEmitter()
    emitter.register_listener(Boom())
    emitter.send_event(event.TrainingStartEvent(task="x"))
    emitter.clear_listeners()
    assert emitter.listener_errors == 2


def test_timer_accumulates_and_counts_failures():
    from photon_ml_tpu_torch.utils.timer import Timer

    timer = Timer()
    for _ in range(2):
        with timer.time("a"):
            pass
    with pytest.raises(KeyError):
        with timer.time("b"):
            raise KeyError("x")
    assert set(timer.durations) == {"a", "b"} and timer.durations["a"] >= 0.0
    assert timer.failed("b") and not timer.failed("a")


@pytest.mark.parametrize("spec", [
    None,
    '{"lower": -1.0, "upper": 2.0}',
    '[{"name": "*", "term": "*", "lowerBound": -0.5, "upperBound": 0.5}]',
    '[{"name": "*", "term": "*", "lowerBound": -0.5, "upperBound": 0.5},'
    ' {"name": "(INTERCEPT)", "term": "", "upperBound": 3.0}]',
    '[{"name": "f1", "term": "*", "lowerBound": 0.0}, {"name": "f2", "term": "", "upperBound": 1}]',
    '[{"name": "g9", "term": "", "lowerBound": 0.0}]',
    '[{"name": "f1", "term": "a", "lowerBound": 1.0, "upperBound": 1.0}]',
    '[{"name": "f1", "term": "a"}]',
    '[{"name": "*", "term": "a", "lowerBound": 0.0}]',
    '[{"name": "f1", "term": "*", "lowerBound": 0.0}, {"name": "f1", "term": "a", "upperBound": 1}]',
    '[{"name": "f2", "term": "", "upperBound": 1}, {"name": "*", "term": "*", "upperBound": 1}]',
    '[{"name": "f1", "lowerBound": 0.0}]',
    '3',
])
def test_parse_box_constraints_matches_jax(spec):
    from photon_ml_tpu.cli.common import parse_box_constraints as jax_parse
    from photon_ml_tpu.indexmap import DefaultIndexMap as JaxMap
    from photon_ml_tpu_torch.cli.common import parse_box_constraints
    from photon_ml_tpu_torch.indexmap import DefaultIndexMap

    keys = {"(INTERCEPT)": 0, "f1\x01a": 1, "f1\x01b": 2, "f1": 3, "f2": 4, "f3\x01a": 5}
    out = []
    for parse, imap in ((jax_parse, JaxMap(keys)), (parse_box_constraints, DefaultIndexMap(keys))):
        try:
            out.append(parse(spec, imap, len(keys), intercept_index=0))
        except ValueError as e:
            out.append(str(e))
    j, t = out
    if isinstance(j, str) or j[2] is None:
        assert t == j
    else:
        assert t[:2] == j[:2]
        for a, b in zip(t[2], j[2]):
            np.testing.assert_array_equal(a, b)

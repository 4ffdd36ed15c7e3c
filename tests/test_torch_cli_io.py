"""The port's data-plane CLIs against the JAX package's, on the tiny GLMix
fixture (``_torch_parity.write_tiny_glmix``):

- ``build_index`` writes stores byte-equal to the JAX CLI's (the JAX
  builder on its plain writer; against its native builder, every byte a
  reader sees);
- ``score_game --offheap-indexmap-dir`` scores as the JAX CLI does (rtol
  2e-4, atol 1e-5) and refuses a model whose metadata names no feature
  shards;
- ``train_game`` and ``train_glm`` with ``--offheap-indexmap-dir`` train the
  JAX CLIs' models (coefficients atol 2e-3);
- ``score_game --model-id --log-data-and-model-stats --event-listeners
  --log-file``: the id on every record, the stats lines in the log file,
  the listener's scoring events;
- the run ledgers of both ``train_game`` CLIs hold the same
  ``TransferStatsEvent`` fields, and ``analyze_run`` gives both the same
  transfer section;
- the RE solver's ``SolverStatsEvent`` fields of both CLIs (strict xfail:
  the f32 objective differs in its last bits between the packages, and
  the L-BFGS stop test |Δf| ≤ 1e-7·|f₀| sits within 2 ulps of it).
"""

import json
import os
import re

import numpy as np
import pytest

import photon_ml_tpu.telemetry as jt
import photon_ml_tpu_torch.telemetry as tt
from _torch_parity import tiny_glmix_argv, write_tiny_glmix
from photon_ml_tpu.cli import build_index as jax_build_index
from photon_ml_tpu.cli import score_game as jax_score_game
from photon_ml_tpu.cli import train_game as jax_train_game
from photon_ml_tpu.cli import train_glm as jax_train_glm
from photon_ml_tpu.indexmap import offheap as joffheap
from photon_ml_tpu_torch.cli import analyze_run, build_index, score_game, train_game, train_glm
from photon_ml_tpu_torch.io.avro import read_avro_dir
from photon_ml_tpu_torch.io.data_reader import write_training_examples
from photon_ml_tpu_torch.io.scores_io import load_scores

RTOL, ATOL = 2e-4, 1e-5


@pytest.fixture(autouse=True)
def _clean():
    for pkg in (tt, jt):
        pkg.disable_tracing()
        pkg.get_registry().reset()
    yield
    for pkg in (tt, jt):
        pkg.disable_tracing()
        pkg.get_registry().reset()


@pytest.fixture(scope="module")
def glmix(tmp_path_factory):
    return write_tiny_glmix(tmp_path_factory.mktemp("tiny"))


def _index_argv(paths, out, *extra):
    return ["--data-dirs", paths["train"], "--output-dir", str(out),
            "--feature-shard", "global=features", "--feature-shard", "per_user=userFeatures",
            *extra]


@pytest.fixture(scope="module")
def stores(glmix, tmp_path_factory):
    out = tmp_path_factory.mktemp("stores")
    assert build_index.main(_index_argv(glmix, out, "--num-partitions", "2")) == 0
    return str(out)


def _files(root):
    return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
            for d, _, fs in os.walk(root) for f in fs}


@pytest.mark.parametrize("partitions", ["1", "4"])
def test_build_index_stores_are_byte_equal(glmix, tmp_path, monkeypatch, partitions):
    argv = ("--num-partitions", partitions, "--log-file", str(tmp_path / "log"))
    sizes = build_index.run(build_index.parse_args(_index_argv(glmix, tmp_path / "t", *argv)))
    monkeypatch.setattr(joffheap, "_lib", None)
    monkeypatch.setattr(joffheap, "_lib_failed", True)
    jsizes = jax_build_index.run(jax_build_index.parse_args(
        _index_argv(glmix, tmp_path / "j", "--num-partitions", partitions)))
    assert sizes == jsizes == {"global": 5, "per_user": 3}
    port, jax = _files(tmp_path / "t"), _files(tmp_path / "j")
    assert len(port) == 2 * (1 + int(partitions))
    assert port == jax
    assert "shard global: 5 features" in (tmp_path / "log").read_text()


def _scores(path):
    items = sorted(load_scores(str(path)), key=lambda s: s.uid)
    return np.array([s.prediction_score for s in items]), items


@pytest.fixture(scope="module")
def model_dir(glmix, tmp_path_factory):
    out = tmp_path_factory.mktemp("model")
    argv = tiny_glmix_argv(glmix, out, "--device", "cpu")
    argv[argv.index("--num-outer-iterations") + 1] = "1"
    assert train_game.main(argv) == 0
    return str(out / "best")


def test_score_game_offheap_matches_jax(glmix, stores, model_dir, tmp_path):
    argv = ["--data-dirs", glmix["test"], "--model-dir", model_dir, "--evaluator", "AUC",
            "--offheap-indexmap-dir", stores]
    auc = score_game.run(score_game.parse_args(
        argv + ["--output-dir", str(tmp_path / "t"), "--device", "cpu"]))
    jauc = jax_score_game.run(jax_score_game.parse_args(argv + ["--output-dir",
                                                               str(tmp_path / "j")]))
    assert abs(auc - jauc) <= 1e-6
    t, titems = _scores(tmp_path / "t")
    j, jitems = _scores(tmp_path / "j")
    assert [s.uid for s in titems] == [s.uid for s in jitems]
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    # the same scores as the maps rebuilt from the model
    plain = score_game.run(score_game.parse_args(
        argv[:-2] + ["--output-dir", str(tmp_path / "p"), "--device", "cpu"]))
    np.testing.assert_allclose(_scores(tmp_path / "p")[0], t, rtol=RTOL, atol=ATOL)
    assert abs(plain - auc) <= 1e-6


def test_score_game_offheap_refuses_a_model_without_feature_shards(glmix, stores, model_dir,
                                                                   tmp_path):
    import shutil

    bare = tmp_path / "bare"
    shutil.copytree(model_dir, bare)
    meta_path = next(os.path.join(d, f) for d, _, fs in os.walk(bare) for f in fs
                     if f == "model-metadata.json")
    meta = json.loads(open(meta_path).read())
    meta["configurations"] = {}
    open(meta_path, "w").write(json.dumps(meta))
    argv = ["--data-dirs", glmix["test"], "--model-dir", str(bare), "--offheap-indexmap-dir",
            stores]
    with pytest.raises(ValueError, match="configurations.feature_shards"):
        score_game.run(score_game.parse_args(argv + ["--output-dir", str(tmp_path / "t"),
                                                     "--device", "cpu"]))
    with pytest.raises(ValueError, match="configurations.feature_shards"):
        jax_score_game.run(jax_score_game.parse_args(argv + ["--output-dir",
                                                             str(tmp_path / "j")]))


class ScoringListener:
    seen: list = []
    closed = False

    def __init__(self):
        ScoringListener.seen = []
        ScoringListener.closed = False

    def on_event(self, event):
        ScoringListener.seen.append(event)

    def close(self):
        ScoringListener.closed = True


def test_score_game_model_id_stats_listeners_and_log_file(glmix, model_dir, tmp_path):
    log = tmp_path / "score.log"
    score_game.run(score_game.parse_args([
        "--data-dirs", glmix["test"], "--model-dir", model_dir, "--output-dir",
        str(tmp_path / "t"), "--model-id", "tiny-glmix-7", "--log-data-and-model-stats",
        "--event-listeners", f"{__name__}.ScoringListener", "--log-file", str(log),
        "--device", "cpu",
    ]))
    records = list(read_avro_dir(str(tmp_path / "t")))
    assert len(records) == 24 and {r["modelId"] for r in records} == {"tiny-glmix-7"}
    text = log.read_text()
    assert "dataset stats: numSamples: 24" in text
    assert re.search(r"dataset stats: samples per userId: entities=6 mean=4\.00", text)
    assert "model stats [fixed]: fixed effect, 5 coefficients" in text
    assert "model stats [per_user]: random effect 'userId', 6 entities" in text
    assert [type(e).__name__ for e in ScoringListener.seen] == [
        "ScoringStartEvent", "ScoringFinishEvent"]
    assert ScoringListener.seen[0].model_id == "tiny-glmix-7"
    assert ScoringListener.seen[0].num_requests == 24
    assert ScoringListener.closed


def _coefficients(model_root):
    """{(coordinate, modelId, name, term): value} of every coefficient Avro
    file under a saved GAME model."""
    out = {}
    for d, _, fs in os.walk(model_root):
        if not d.endswith("coefficients"):
            continue
        cid = os.path.basename(os.path.dirname(d))
        for rec in read_avro_dir(d):
            for m in rec["means"]:
                out[(cid, rec.get("modelId"), m["name"], m["term"])] = m["value"]
    return out


def test_train_game_offheap_matches_jax(glmix, stores, tmp_path):
    argv = tiny_glmix_argv(glmix, tmp_path / "t", "--offheap-indexmap-dir", stores,
                           "--device", "cpu")
    assert train_game.main(argv) == 0
    assert jax_train_game.main(tiny_glmix_argv(glmix, tmp_path / "j", "--offheap-indexmap-dir",
                                               stores)) == 0
    t, j = _coefficients(tmp_path / "t" / "best"), _coefficients(tmp_path / "j" / "best")
    assert set(t) == set(j) and len(t) == 5 + 6 * 2
    for key in t:
        assert abs(t[key] - j[key]) <= 2e-3, key


def test_train_glm_offheap_matches_jax(tmp_path):
    rng = np.random.default_rng(11)
    w = rng.standard_normal(12) * 0.7
    records = []
    for _ in range(160):
        idx = rng.choice(12, 4, replace=False)
        v = rng.standard_normal(4)
        records.append({"label": float(rng.random() < 1 / (1 + np.exp(-(v * w[idx]).sum()))),
                        "features": [(f"f{j}", "t" if j % 2 else "", float(x))
                                     for j, x in zip(idx, v)]})
    os.makedirs(tmp_path / "train")
    write_training_examples(str(tmp_path / "train" / "part-00000.avro"), records)
    assert build_index.main(["--data-dirs", str(tmp_path / "train"), "--output-dir",
                             str(tmp_path / "idx"), "--feature-shard", "features=features",
                             "--num-partitions", "3"]) == 0
    argv = ["--training-data-dirs", str(tmp_path / "train"), "--task", "LOGISTIC_REGRESSION",
            "--regularization-weights", "0.1", "1", "--offheap-indexmap-dir",
            str(tmp_path / "idx")]
    tres = train_glm.run(train_glm.parse_args(argv + ["--output-dir", str(tmp_path / "t"),
                                                      "--device", "cpu"]))
    jres = jax_train_glm.run(jax_train_glm.parse_args(argv + ["--output-dir",
                                                              str(tmp_path / "j")]))
    assert len(tres["fits"]) == len(jres["fits"]) == 2
    for lam in ("0.1", "1"):
        def read(side):
            out = {}
            with open(tmp_path / side / f"model-lambda-{lam}.txt") as f:
                for line in f:
                    name, term, value, *_ = line.rstrip("\n").split("\t")
                    out[(name, term)] = float(value)
            return out
        t, j = read("t"), read("j")
        assert set(t) == set(j) and len(t) == 13
        for key in t:
            assert abs(t[key] - j[key]) <= 2e-3, key


@pytest.fixture(scope="module")
def ledgers(glmix, tmp_path_factory):
    """Both train_game CLIs on the tiny fixture with --telemetry-out."""
    out = tmp_path_factory.mktemp("ledgers")
    for pkg in (tt, jt):
        pkg.disable_tracing()
        pkg.get_registry().reset()
    assert train_game.main(tiny_glmix_argv(glmix, out / "t", "--device", "cpu",
                                           "--telemetry-out", str(out / "t.jsonl"))) == 0
    for pkg in (tt, jt):
        pkg.disable_tracing()
        pkg.get_registry().reset()
    assert jax_train_game.main(tiny_glmix_argv(glmix, out / "j", "--telemetry-out",
                                               str(out / "j.jsonl"))) == 0
    return out


def _events(path, name):
    return [rec["fields"] for rec in map(json.loads, open(path))
            if rec.get("type") == "event" and rec.get("event") == name]


def test_transfer_stats_events_equal_jax(ledgers):
    port = _events(ledgers / "t.jsonl", "TransferStatsEvent")
    jax = _events(ledgers / "j.jsonl", "TransferStatsEvent")
    assert port == jax
    assert len(port) == 2 and [e["outer_iteration"] for e in port] == [0, 1]
    assert sum(e["device_plane_updates"] for e in port) == 4
    assert sum(e["row_transfers_h2d"] + e["row_transfers_d2h"] for e in port) == 0
    reports = {}
    for side in ("t", "j"):
        assert analyze_run.main([str(ledgers / f"{side}.jsonl"), "--json",
                                 str(ledgers / f"{side}.report.json")]) == 0
        reports[side] = json.loads((ledgers / f"{side}.report.json").read_text())
    assert reports["t"]["transfers"] == reports["j"]["transfers"]
    assert reports["t"]["transfers"]["device_plane_updates"] == 4


@pytest.mark.xfail(strict=True, reason=(
    "RE L-BFGS stop decisions differ at the f32 ulp: on the same bucket "
    "inputs the first differing quantity is the per-entity gradient "
    "X^T(wt*l') (torch's and XLA's f32 row reductions round differently, "
    "-3.1221595 against -3.1221597 for entity 5 at w0), with the loss "
    "values l(z) of 3 of 10 rows one ulp apart (log1p/exp); the stop test "
    "|f_prev - f| <= 1e-7*|f0| is about 1.5 ulp of f here, so entity 5 of "
    "outer iteration 1 stops after 6 iterations instead of 5"))
def test_solver_stats_events_equal_jax(ledgers):
    port = _events(ledgers / "t.jsonl", "SolverStatsEvent")
    jax = _events(ledgers / "j.jsonl", "SolverStatsEvent")
    assert len(port) == len(jax) == 2
    for p, j in zip(port, jax):
        for key in ("executed_lane_iterations", "lockstep_lane_iterations", "rounds"):
            assert p[key] == j[key], key
        for key in ("iterations_p50", "iterations_p99"):
            assert abs(p[key] - j[key]) <= 1e-6, key

"""The port's knob auto-tuning (``photon_ml_tpu_torch/tuning``,
``train_game --auto-tune``) against the JAX package's.

- the knob registry is equal: every knob (train, serving and stream) with
  its kind, default, scope, phase, evidence and ladder;
- ``propose`` and ``ab_candidates`` give equal output on the same
  ``RunReport`` evidence, for several synthetic ledgers;
- ``run_ab_trials`` with a judge that reads a registry counter picks the
  same winner, with the same scores, and falls back to wall clock alike;
- ``train_game --auto-tune`` on the tiny GLMix (its per-user coordinate on
  the adaptive driver down to 2 lanes, 2 iterations a chunk) picks the JAX CLI's winner under a
  counter judge (the RE solver's chunked rounds, which the chunk size
  sets), writes
  ``auto-tune.json`` with the JAX CLI's keys and the winner into the saved
  metadata's ``tuned_config``; ``--auto-tune-report`` draws its candidates
  from an ``analyze_run --json`` report as the JAX CLI does.
"""

import dataclasses
import json
import os

import pytest

import photon_ml_tpu.telemetry as jt
import photon_ml_tpu.tuning as jtune
import photon_ml_tpu_torch.telemetry as tt
import photon_ml_tpu_torch.tuning as ttune
from _torch_parity import tiny_glmix_argv, write_tiny_glmix
from photon_ml_tpu.cli import train_game as jax_train_game
from photon_ml_tpu_torch.cli import train_game

JUDGE = "solver.per_user.rounds"


@pytest.fixture(autouse=True)
def _clean():
    for pkg in (tt, jt):
        pkg.disable_tracing()
        pkg.get_registry().reset()
    yield
    for pkg in (tt, jt):
        pkg.disable_tracing()
        pkg.get_registry().reset()


def _records(gauges=None, counters=None, solver_fields=None, phases=None):
    """A minimal synthetic 10 s ledger (the JAX package's tests/test_tuning.py
    shape): phase spans, a solver event and a registry snapshot."""
    records = [{"type": "meta", "ts": 0.0, "phase": "start", "label": "t"}]
    for sid, (name, dur) in enumerate((phases or {}).items(), start=1):
        records.append({"type": "span", "ts": dur, "name": name, "path": name,
                        "span_id": sid, "parent_id": None, "start_unix": 0.0,
                        "duration_s": dur, "failed": False})
    if solver_fields:
        records.append({"type": "event", "ts": 5.0, "event": "SolverStatsEvent",
                        "fields": solver_fields})
    records.append({"type": "metrics", "ts": 9.9, "snapshot": {
        "counters": dict(counters or {}),
        "gauges": {k: {"last": v, "peak": v} for k, v in (gauges or {}).items()},
        "histograms": {}}})
    records.append({"type": "meta", "ts": 10.0, "phase": "finish"})
    return records


EVIDENCE = {
    "none": {},
    "low_savings": dict(solver_fields={"executed_lane_iterations": 100,
                                       "lockstep_lane_iterations": 105, "rounds": 2,
                                       "chunk_retraces": 0}, phases={"re/train": 5.0}),
    "high_savings": dict(solver_fields={"executed_lane_iterations": 10,
                                        "lockstep_lane_iterations": 90, "rounds": 9,
                                        "chunk_retraces": 4}, phases={"re/train": 8.0}),
    "serving": dict(gauges={"serving.batch_fill": 0.4, "serving.cache_hit_rate": 0.5,
                            "serving.latency_p99_ms": 80.0}),
    "healthy_serving": dict(gauges={"serving.batch_fill": 0.8,
                                    "serving.cache_hit_rate": 0.9}),
    "mixed": dict(gauges={"serving.batch_fill": 0.5}, counters={"jit.traces.fe_solve": 3},
                  solver_fields={"executed_lane_iterations": 10,
                                 "lockstep_lane_iterations": 25},
                  phases={"re/train": 4.0, "fe/solve": 3.0, "cd/objective": 1.0}),
}


def test_knob_registry_is_the_jax_packages():
    mine = [dataclasses.asdict(k) for k in ttune.all_knobs()]
    ref = [dataclasses.asdict(k) for k in jtune.all_knobs()]
    assert mine == ref
    assert {k["applies_to"] for k in mine} >= {"train", "serve"}
    for spec in ttune.all_knobs():
        ref_spec = jtune.get_knob(spec.name)
        for raw in ("3", "1,2", "true", 4, (1, 2)):
            try:
                mine_v = spec.parse(raw)
            except (TypeError, ValueError) as e:
                mine_v = type(e).__name__
            try:
                ref_v = ref_spec.parse(raw)
            except (TypeError, ValueError) as e:
                ref_v = type(e).__name__
            assert mine_v == ref_v, (spec.name, raw)
    with pytest.raises(KeyError):
        ttune.get_knob("no.such.knob")


@pytest.mark.parametrize("name", sorted(EVIDENCE))
def test_propose_and_candidates_match(name):
    records = _records(**EVIDENCE[name])
    mine_report = tt.analyze_records(records)
    ref_report = jt.analyze_records(records)
    mine, ref = ttune.propose(mine_report), jtune.propose(ref_report)
    assert mine.to_dict() == ref.to_dict()
    assert set(mine.knobs) == {k.name for k in ttune.all_knobs()}
    for scope in ("train", "serve", "both"):
        for n in (1, 2):
            assert (ttune.ab_candidates(mine, scope, max_candidates=n)
                    == jtune.ab_candidates(ref, scope, max_candidates=n))
    for dep in ("phase:re_solve", "metric:serving.batch_fill",
                "solver:lane_iteration_savings", "jit:fe_solve", "solver:nope"):
        assert ttune.resolve_dep(mine_report, dep) == jtune.resolve_dep(ref_report, dep)


def _ab(pkg, tune, candidates, judge, fail_index=None):
    def trial(config, registry):
        assert registry is not pkg.get_registry()
        if fail_index is not None and config.get("i") == fail_index:
            raise RuntimeError("trial failed")
        registry.count("work", 100 - 7 * config["i"] + (config["i"] % 2) * 20)

    result = tune.run_ab_trials(candidates, trial, judge_metric=judge, minimize=True)
    doc = result.to_dict()
    for t in doc["trials"]:
        t.pop("wall_s")
        if t["score"] is not None and judge != "work":
            t["score"] = "wall"
        if t["error"] is not None:
            t["error"] = t["error"].strip().splitlines()[-1]
    return doc


@pytest.mark.parametrize("judge,fail_index", [("work", None), ("work", 2), ("absent", None)])
def test_ab_trials_with_a_counter_judge(judge, fail_index):
    candidates = [{"i": i} for i in range(4)]
    mine = _ab(tt, ttune, candidates, judge, fail_index)
    ref = _ab(jt, jtune, candidates, judge, fail_index)
    if judge == "absent":
        # judged by wall clock: the winner may differ; the bracket does not
        for doc in (mine, ref):
            doc.pop("winner_index")
            doc.pop("winner_config")
    assert mine == ref
    assert tt.get_registry().snapshot()["counters"] == {}  # trials are isolated
    if judge == "work" and fail_index is None:
        assert mine["winner_index"] == 2


@pytest.fixture(scope="module")
def tiny_glmix(tmp_path_factory):
    paths = write_tiny_glmix(tmp_path_factory.mktemp("torch_autotune_glmix"))
    with open(paths["config"]) as f:
        cfg = json.load(f)
    # the incumbent knobs are the first coordinate's; every coordinate takes them
    for coord in cfg["coordinates"].values():
        coord["optimizer"]["adaptive"] = {"chunk_iters": 2, "min_lanes": 2}
    with open(paths["config"], "w") as f:
        json.dump(cfg, f)
    return paths


def _tuned(out):
    with open(os.path.join(out, "auto-tune.json")) as f:
        doc = json.load(f)
    for t in doc["trials"]:
        t.pop("wall_s")
    with open(os.path.join(out, "best", "model-metadata.json")) as f:
        meta = json.load(f)
    return doc, meta["configurations"].get("tuned_config")


@pytest.mark.parametrize("trials", ["1", "3"])
def test_auto_tune_picks_the_jax_clis_winner(tiny_glmix, tmp_path, trials):
    flags = ("--auto-tune", "--auto-tune-trials", trials, "--auto-tune-judge", JUDGE)
    assert train_game.main(tiny_glmix_argv(tiny_glmix, tmp_path / "t", "--device", "cpu",
                                           *flags)) == 0
    assert jax_train_game.main(tiny_glmix_argv(tiny_glmix, tmp_path / "j", *flags)) == 0
    mine, mine_tuned = _tuned(tmp_path / "t")
    ref, ref_tuned = _tuned(tmp_path / "j")
    assert set(mine) == set(ref) == {"judge_metric", "minimize", "winner_index",
                                     "winner_config", "trials"}
    assert mine == ref
    assert len(mine["trials"]) == 1 + int(trials)
    assert all(t["error"] is None and t["score"] > 0 for t in mine["trials"])
    assert mine_tuned == ref_tuned
    # a larger chunk takes fewer rounds: the incumbent (2 iterations a
    # chunk) loses, and the winner trains the saved model
    assert mine["winner_index"] != 0
    assert mine_tuned == mine["winner_config"]


def test_auto_tune_report_draws_candidates_from_a_run_report(tiny_glmix, tmp_path):
    report = tmp_path / "report.json"
    report.write_text(json.dumps(tt.analyze_records(
        _records(**EVIDENCE["low_savings"])).to_dict()))
    flags = ("--auto-tune", "--auto-tune-report", str(report), "--auto-tune-judge", JUDGE)
    assert train_game.main(tiny_glmix_argv(tiny_glmix, tmp_path / "t", "--device", "cpu",
                                           *flags)) == 0
    assert jax_train_game.main(tiny_glmix_argv(tiny_glmix, tmp_path / "j", *flags)) == 0
    mine, ref = _tuned(tmp_path / "t")[0], _tuned(tmp_path / "j")[0]
    assert mine == ref
    assert [t["config"] for t in mine["trials"]] == [
        {"adaptive.chunk_iters": 2, "adaptive.min_lanes": 2},
        {"adaptive.chunk_iters": 4, "adaptive.min_lanes": 4}]

"""The port's convergence plane (``telemetry/progress.py``, the divergence
watchdog, ``train_game --progress-out``) against the JAX package's.

- the same ``ConvergenceTracker`` calls give the same records, anomaly
  kinds, health and ledger in both packages (a steady run, an objective
  increase, a non-finite objective, a line-search stall, a tracker that
  does not abort, resilience records through the failure sink);
- the tiny GLMix of the JAX package's tests/test_progress.py through both
  ``train_game --progress-out`` CLIs: the same record kinds in the same
  order, objectives within rtol 1e-4, equal solver iterations and
  convergence reasons;
- divergence injection in the port's CLI: exit code 2, no ``best/``, one
  ``AnomalyEvent`` of kind ``non_finite_objective``, the ledger's last
  record unhealthy;
- the models with and without ``--progress-out`` (and with the full
  telemetry flags) are bitwise equal;
- ``--progress-out`` is refused for a regularization-weight sweep.
"""

import json
import math
import os

import numpy as np
import pytest

import photon_ml_tpu.event as jax_event
import photon_ml_tpu.resilience as jr
import photon_ml_tpu.telemetry as jt
import photon_ml_tpu_torch.event as torch_event
import photon_ml_tpu_torch.resilience as tr
import photon_ml_tpu_torch.telemetry as tt
from _torch_parity import tiny_glmix_argv, write_tiny_glmix
from photon_ml_tpu.cli import train_game as jax_train_game
from photon_ml_tpu_torch.cli import train_game
from photon_ml_tpu_torch.io.model_io import load_game_model


@pytest.fixture(autouse=True)
def _clean():
    for pkg in (tt, jt):
        pkg.disable_tracing()
        pkg.get_registry().reset()
    for pkg in (tr, jr):
        pkg.clear_failures()
    yield
    for pkg in (tt, jt):
        pkg.disable_tracing()
        pkg.get_registry().reset()
    for pkg in (tr, jr):
        pkg.clear_failures()


@pytest.fixture(scope="module")
def tiny_glmix(tmp_path_factory):
    return write_tiny_glmix(tmp_path_factory.mktemp("torch_progress_glmix"))


class _Collect:
    def __init__(self):
        self.events = []

    def on_event(self, event):
        self.events.append(event)


SCENARIOS = {
    "steady": [
        ("coordinate", 0, "fixed", 10.0, dict(loss=9.0, regularization=1.0, grad_norm=0.5,
                                             coef_delta_norm=2.0, solver_iterations=7,
                                             line_search_trials=9,
                                             convergence_reason="GRADIENT_CONVERGED")),
        ("validation", 0, "fixed", 0.71),
        ("coordinate", 0, "per_user", 9.0, dict(solver_iterations=3)),
        ("coordinate", 1, "fixed", 8.995, dict(grad_norm=0.01)),
        ("validation", 1, "fixed", 0.73),
    ],
    "increase": [("coordinate", 0, "a", 5.0, {}), ("coordinate", 0, "b", 4.0, {}),
                 ("coordinate", 1, "a", 4.5, {})],
    "non_finite": [("coordinate", 0, "a", 5.0, {}), ("coordinate", 0, "b", float("nan"), {})],
    "stall": [("coordinate", i, "a", 5.0 - 0.01 * i,
               dict(grad_norm=3.0, convergence_reason="OBJECTIVE_NOT_IMPROVING"))
              for i in range(4)],
}


def _run_tracker(pkg, event_mod, scenario, path, abort=True):
    emitter = event_mod.EventEmitter()
    collect = _Collect()
    emitter.register_listener(collect)
    tracker = pkg.ConvergenceTracker(ledger_path=str(path), emitter=emitter,
                                     abort_on_divergence=abort)
    raised = None
    try:
        for call in SCENARIOS[scenario]:
            if call[0] == "validation":
                tracker.record_validation(*call[1:])
            else:
                tracker.record_coordinate(*call[1:4], **call[4])
    except pkg.DivergenceError as e:
        raised = (str(e), e.anomaly)
    health = tracker.health()
    tracker.finish()
    with open(path) as f:
        ledger = [{k: v for k, v in json.loads(line).items() if k != "ts"} for line in f]
    return {
        "records": json.loads(json.dumps(tracker.records)),
        "raised": json.loads(json.dumps(raised)),
        "health": json.loads(json.dumps(health)),
        "events": [(e.kind, e.coordinate_id, e.outer_iteration) for e in collect.events],
        "ledger": ledger,
        "counters": pkg.get_registry().snapshot()["counters"],
    }


def _same(a, b):
    """Equal, with NaN equal to NaN (json round trips keep NaN)."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("abort", [True, False])
def test_tracker_records_and_anomalies_match(tmp_path, scenario, abort):
    mine = _run_tracker(tt, torch_event, scenario, tmp_path / "t.jsonl", abort)
    for pkg in (tt, jt):
        pkg.get_registry().reset()
    ref = _run_tracker(jt, jax_event, scenario, tmp_path / "j.jsonl", abort)
    assert _same(mine, ref)
    if scenario != "steady":
        kinds = {"increase": "objective_increase", "non_finite": "non_finite_objective",
                 "stall": "line_search_stall"}
        assert mine["events"][0][0] == kinds[scenario]
        assert mine["health"]["healthy"] is False
        assert (mine["raised"] is not None) == abort


def test_failure_sink_mirrors_resilience_records(tmp_path):
    out = []
    for pkg, res in ((tt, tr), (jt, jr)):
        tracker = pkg.ConvergenceTracker(ledger_path=str(tmp_path / f"{pkg.__name__}.jsonl"))
        tracker.attach_failure_sink()
        res.record_failure("retry_exhausted", "stream.read_part_file", "3 attempts", block=4)
        tracker.detach_failure_sink()
        res.record_failure("ignored", "x")
        out.append((tracker.records, tracker.health()))
        tracker.finish()
    assert out[0] == out[1]
    assert out[0][1]["healthy"] is True and out[0][1]["resilience_events"] == 1


def test_convergence_report_of_the_same_records_matches(tmp_path):
    recs = _run_tracker(tt, torch_event, "steady", tmp_path / "t.jsonl")["ledger"]
    mine = tt.convergence_report(tt.extract_progress_records(recs))
    ref = jt.convergence_report(jt.extract_progress_records(recs))
    assert mine == ref
    assert tt.format_progress_report(mine) == jt.format_progress_report(ref)


def _progress(path):
    return [r for r in tt.validate_ledger(str(path)) if r["type"] == "progress"]


def test_progress_out_matches_the_jax_cli(tiny_glmix, tmp_path):
    rc = train_game.main(tiny_glmix_argv(
        tiny_glmix, tmp_path / "t", "--device", "cpu",
        "--progress-out", str(tmp_path / "t.jsonl")))
    assert rc == 0
    rc = jax_train_game.main(tiny_glmix_argv(
        tiny_glmix, tmp_path / "j", "--progress-out", str(tmp_path / "j.jsonl")))
    assert rc == 0
    mine, ref = _progress(tmp_path / "t.jsonl"), _progress(tmp_path / "j.jsonl")
    assert [(r["kind"], r["outer"], r["coordinate"]) for r in mine] == [
        (r["kind"], r["outer"], r["coordinate"]) for r in ref]
    assert len(mine) == 8  # 2 outer iterations x 2 coordinates x (update, validation)
    for a, b in zip(mine, ref):
        assert set(a) == set(b)
        for key in ("objective", "loss", "regularization", "metric"):
            if key in a:
                np.testing.assert_allclose(a[key], b[key], rtol=1e-4)
        for key in ("solver_iterations", "convergence_reason"):
            assert a.get(key) == b.get(key)
    fixed = [r for r in mine if r["kind"] == "coordinate" and r["coordinate"] == "fixed"]
    assert all("grad_norm" in r and "coef_delta_norm" in r for r in fixed)
    for a, b in zip(fixed, [r for r in ref if r["kind"] == "coordinate"
                            and r["coordinate"] == "fixed"]):
        np.testing.assert_allclose(a["coef_delta_norm"], b["coef_delta_norm"], rtol=1e-3)
    ledger = tt.validate_ledger(str(tmp_path / "t.jsonl"))
    assert ledger[-1]["phase"] == "finish" and ledger[-1]["healthy"] is True


class DivergenceListener:
    """Collects the events of the port CLI's emitter (``--event-listeners``
    instantiates it by dotted name)."""

    received = []

    def on_event(self, event):
        DivergenceListener.received.append(event)

    def close(self):
        pass


def test_divergence_injection_exits_2_without_a_model(tiny_glmix, tmp_path, monkeypatch):
    from photon_ml_tpu_torch.algorithm.coordinate_descent import CoordinateDescent

    real = CoordinateDescent._record_progress
    calls = {"n": 0}

    def poisoned(self, outer, cid, coord, prev_model, model, objective, loss, reg):
        calls["n"] += 1
        if calls["n"] >= 2:
            objective = float("inf")
        real(self, outer, cid, coord, prev_model, model, objective, loss, reg)

    monkeypatch.setattr(CoordinateDescent, "_record_progress", poisoned)
    DivergenceListener.received = []
    out = tmp_path / "out"
    rc = train_game.main(tiny_glmix_argv(
        tiny_glmix, out, "--device", "cpu", "--progress-out", str(tmp_path / "p.jsonl"),
        "--telemetry-out", str(tmp_path / "t.jsonl"),
        "--event-listeners", f"{__name__}.DivergenceListener"))
    assert rc == 2
    assert calls["n"] == 2
    assert not (out / "best").exists()
    anomalies = [e for e in DivergenceListener.received
                 if isinstance(e, torch_event.AnomalyEvent)]
    assert [a.kind for a in anomalies] == ["non_finite_objective"]
    records = tt.validate_ledger(str(tmp_path / "p.jsonl"))
    assert records[-1]["phase"] == "finish" and records[-1]["healthy"] is False
    assert "anomaly" in [r.get("kind") for r in tt.extract_progress_records(records)]
    # the run ledger closed too, with the anomaly bridged in and the failed spans
    run = tt.validate_ledger(str(tmp_path / "t.jsonl"))
    assert run[-1]["phase"] == "finish"
    assert any(r["type"] == "event" and r["event"] == "AnomalyEvent" for r in run)
    assert any(r["type"] == "span" and r["name"] == "cd/run" and r["failed"] for r in run)


def _saved(out):
    model, _ = load_game_model(str(out / "best"), device="cpu")
    fixed = model.models["fixed"].coefficients.means.numpy()
    re = [c.numpy() for c in model.models["per_user"].coefficients]
    return fixed, re


def test_models_bitwise_with_and_without_tracking(tiny_glmix, tmp_path):
    plain = train_game.run(train_game.parse_args(tiny_glmix_argv(
        tiny_glmix, tmp_path / "plain", "--device", "cpu")))
    tracked = train_game.run(train_game.parse_args(tiny_glmix_argv(
        tiny_glmix, tmp_path / "tracked", "--device", "cpu",
        "--progress-out", str(tmp_path / "p.jsonl"),
        "--telemetry-out", str(tmp_path / "t.jsonl"), "--trace-out", str(tmp_path / "t.json"),
        "--introspect-port", "0")))
    assert plain.objective_history == tracked.objective_history
    assert plain.validation_history == tracked.validation_history
    a, b = _saved(tmp_path / "plain"), _saved(tmp_path / "tracked")
    assert np.array_equal(a[0], b[0])
    assert all(np.array_equal(x, y) for x, y in zip(a[1], b[1]))
    assert not tt.get_tracer().enabled  # the CLI turned tracing off again


def test_progress_out_refuses_a_sweep(tiny_glmix, tmp_path):
    cfg = json.load(open(tiny_glmix["config"]))
    opt = cfg["coordinates"]["fixed"]["optimizer"]
    del opt["regularization_weight"]
    opt["regularization_weights"] = [0.1, 10.0]
    path = tmp_path / "sweep.json"
    path.write_text(json.dumps(cfg))
    argv = tiny_glmix_argv(tiny_glmix, tmp_path / "out", "--device", "cpu",
                           "--progress-out", str(tmp_path / "p.jsonl"))
    argv[argv.index(tiny_glmix["config"])] = str(path)
    with pytest.raises(ValueError, match="ONE fit"):
        train_game.run(train_game.parse_args(argv))
    assert not os.path.exists(tmp_path / "out" / "best")

"""The port's telemetry (``photon_ml_tpu_torch/telemetry``) against the JAX
package's.

- spans: nesting, paths, depths, failed spans, and a thread that enters
  the dispatching thread's context chaining under its span; the disabled
  tracer hands out the shared no-op;
- the same ``SpanRecord``s through both packages' sinks give the same
  ledger records (but for the write clock ``ts``), Chrome trace events,
  span-tree summaries and summary tables;
- the event bridge and the metrics registry fold the same events and
  observations into the same snapshot; ``prometheus``-free readers
  (``jit_trace_counts``) agree;
- ``validate_ledger`` and ``validate_chrome_trace`` accept and reject the
  same files;
- device-sync spans: no barrier runs with tracing off, two per device-sync
  span with it on (counted through the module's barrier hook), and a
  traced fit is bitwise the untraced one;
- the nvcc build of a kernel library counts as a compile
  (``jit.traces.nvcc/<name>``).
"""

import contextvars
import dataclasses
import importlib
import json
import threading

import numpy as np
import pytest

import photon_ml_tpu.event as jax_event
import photon_ml_tpu.telemetry as jt
import photon_ml_tpu_torch.event as torch_event
import photon_ml_tpu_torch.telemetry as tt
from photon_ml_tpu.telemetry.span import SpanRecord as JaxSpanRecord
from photon_ml_tpu_torch.telemetry.span import SpanRecord

# the span module (the package re-exports a function of the same name)
span_mod = importlib.import_module("photon_ml_tpu_torch.telemetry.span")


@pytest.fixture(autouse=True)
def _clean_telemetry():
    """Both packages' tracer and registry are process globals: start and
    leave each test with tracing off and empty collectors."""
    for pkg in (tt, jt):
        pkg.disable_tracing()
        pkg.get_tracer().clear()
        pkg.get_registry().reset()
    yield
    for pkg in (tt, jt):
        pkg.disable_tracing()
        pkg.get_tracer().clear()
        pkg.get_registry().reset()


def _records():
    """A small span tree with a failed span, attrs of several types and a
    second thread, as (port records, JAX records)."""
    rows = [
        dict(span_id=1, parent_id=None, name="game/fit", path="game/fit", depth=1,
             start_s=0.0, duration_s=2.5, thread_id=11, thread_name="MainThread",
             attrs={"coordinates": 3, "num_rows": 600, "score_plane": "device"}),
        dict(span_id=2, parent_id=1, name="cd/run", path="game/fit/cd/run", depth=2,
             start_s=0.01, duration_s=2.4, thread_id=11, thread_name="MainThread",
             attrs={"iterations": 2, "schedule": "async"}),
        dict(span_id=3, parent_id=2, name="cd/overlap", path="game/fit/cd/run/cd/overlap",
             depth=3, start_s=0.02, duration_s=1.25, thread_id=12, thread_name="cd-async_0",
             attrs={"coordinate": "per_user", "outer": 0}),
        dict(span_id=4, parent_id=3, name="re/solve_bucket",
             path="game/fit/cd/run/cd/overlap/re/solve_bucket", depth=4, start_s=0.03,
             duration_s=0.5, thread_id=13, thread_name="re-buckets_0", failed=True,
             error="RuntimeError",
             attrs={"bucket": 0, "mode": "adaptive", "entities": 24, "overlap": True}),
        dict(span_id=5, parent_id=2, name="cd/objective", path="game/fit/cd/run/cd/objective",
             depth=3, start_s=1.3, duration_s=0.001, thread_id=11, thread_name="MainThread",
             attrs={"coordinate": "fixed", "outer": 1, "value": np.float32(0.5)}),
    ]
    return [SpanRecord(**r) for r in rows], [JaxSpanRecord(**r) for r in rows]


def _ledger_lines(path):
    out = []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            rec.pop("ts")
            out.append(rec)
    return out


def test_span_nesting_paths_and_threads():
    tracer = tt.enable_tracing(device_sync=False)
    with tt.span("outer", a=1) as outer:
        with tt.span("inner", b=2):
            pass
        ctx = contextvars.copy_context()

        def worker():
            with tt.span("worker", c=3):
                with tt.span("leaf"):
                    pass

        t = threading.Thread(target=lambda: ctx.run(worker), name="w0")
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        outer.set_attrs(d=4)
    with pytest.raises(KeyError):
        with tt.span("fails"):
            raise KeyError("x")
    spans = {s.name: s for s in tracer.spans()}
    assert spans["outer"].parent_id is None and spans["outer"].depth == 1
    assert spans["outer"].attrs == {"a": 1, "d": 4}
    assert spans["inner"].parent_id == spans["outer"].span_id
    assert spans["inner"].path == "outer/inner" and spans["inner"].depth == 2
    assert spans["worker"].parent_id == spans["outer"].span_id
    assert spans["worker"].thread_name == "w0" and spans["worker"].path == "outer/worker"
    assert spans["leaf"].path == "outer/worker/leaf" and spans["leaf"].depth == 3
    assert spans["fails"].failed and spans["fails"].error == "KeyError"
    assert not spans["outer"].failed
    # tracing off: the shared no-op, nothing recorded
    tt.disable_tracing()
    assert tt.span("x") is tt.NOOP_SPAN
    assert len(tracer) == len(spans)


def test_timed_span_measures_with_tracing_off():
    sp = span_mod.timed_span("phase")
    with sp:
        pass
    assert sp.duration_s >= 0.0 and not sp.failed
    assert len(tt.get_tracer()) == 0


def test_tracer_appends_from_many_threads():
    """The tracer's list takes appends from several threads under its lock:
    none is lost."""
    import sys

    tracer = tt.enable_tracing(device_sync=False)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(200):
                with tt.span("s"):
                    tt.get_registry().count("c")

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert len(tracer) == 16 * 200
    assert tt.get_registry().counter_value("c") == 16 * 200
    assert len({s.span_id for s in tracer.spans()}) == 16 * 200


def test_sinks_match_the_jax_package(tmp_path):
    ours, theirs = _records()
    origin = 1_700_000_000.0
    for pkg, recs, name in ((tt, ours, "t"), (jt, theirs, "j")):
        ledger = pkg.RunLedger(str(tmp_path / f"{name}.jsonl"))
        for r in recs:
            ledger.write_span(r, origin)
        ledger.write("meta", phase="finish", label="x", values=np.arange(3))
        ledger.close()
        pkg.write_chrome_trace(str(tmp_path / f"{name}.json"), recs, metadata={"label": "x"},
                               pid_key="host")
    assert _ledger_lines(tmp_path / "t.jsonl") == _ledger_lines(tmp_path / "j.jsonl")
    assert (json.loads((tmp_path / "t.json").read_text())
            == json.loads((tmp_path / "j.json").read_text()))
    assert tt.chrome_trace_events(ours) == jt.chrome_trace_events(theirs)
    assert tt.span_tree_summary(ours, max_depth=3) == jt.span_tree_summary(theirs, max_depth=3)
    snap = {"counters": {"jit.traces.a": 2.0, "solver.buckets": 3.0},
            "gauges": {"mem.host_peak_rss_bytes": {"last": 1.0, "peak": 2.0}},
            "histograms": {}}
    assert (tt.format_summary_table(ours, snap, "run")
            == jt.format_summary_table(theirs, snap, "run"))


def _events(mod):
    stats = dict(coordinate_id="per_user", bucket=1, optimizer="lbfgs", num_entities=24,
                 rounds=3, dispatch_widths=(24, 16, 8), iterations_p50=4.0,
                 iterations_p99=9.0, executed_lane_iterations=120,
                 lockstep_lane_iterations=216, wasted_lane_fraction=0.44)
    return [
        mod.TrainingStartEvent(task="LOGISTIC_REGRESSION"),
        mod.SolverStatsEvent(**stats),
        mod.ScoringStartEvent(model_id="m", num_requests=10),
        mod.ScoringFinishEvent(model_id="m", num_requests=10, wall_seconds=0.5,
                               metrics={"latency_p99_s": 0.002, "batch_fill_ratio": 0.75}),
        mod.ModelSwapEvent(model_id="m", generation=2, fingerprint="f", coordinates=("a",),
                           rows_updated=5, blackout_s=0.01),
        mod.TransferStatsEvent(score_plane="device", outer_iteration=0, num_rows=10,
                               row_transfers_h2d=0, row_transfers_d2h=0, row_bytes_h2d=0,
                               row_bytes_d2h=0, host_score_sums=0, device_plane_updates=3),
        mod.AnomalyEvent(kind="non_finite_objective", coordinate_id="fixed",
                         outer_iteration=1, objective_value=float("inf"), detail={"x": 1}),
    ]


def test_event_bridge_and_registry_match_the_jax_package(tmp_path):
    for name in ("ScoringStartEvent", "ScoringFinishEvent", "ModelSwapEvent",
                 "TransferStatsEvent", "AnomalyEvent"):
        assert ([f.name for f in dataclasses.fields(getattr(torch_event, name))]
                == [f.name for f in dataclasses.fields(getattr(jax_event, name))])
    snaps, lines = [], []
    for pkg, mod, name in ((tt, torch_event, "t"), (jt, jax_event, "j")):
        registry = pkg.MetricsRegistry()
        ledger = pkg.RunLedger(str(tmp_path / f"{name}.jsonl"))
        listener = pkg.TelemetryEventListener(ledger=ledger, registry=registry)
        for ev in _events(mod):
            listener.on_event(ev)
        listener.close()
        ledger.close()
        for v in np.random.default_rng(0).standard_normal(5000):
            registry.observe("lat", float(v))
        registry.gauge("g", 3.0)
        registry.gauge("g", 1.0)
        registry.scoped("tenant=a").count("req", 2)
        snaps.append(registry.snapshot())
        lines.append(_ledger_lines(tmp_path / f"{name}.jsonl"))
    assert snaps[0] == snaps[1]
    assert lines[0] == lines[1]


def test_compile_counter_api():
    for pkg in (tt, jt):
        pkg.note_jit_trace("nvcc", "spmv")
        pkg.note_jit_trace("nvcc", "spmv")
        pkg.note_jit_trace("other")
    assert tt.jit_trace_counts() == jt.jit_trace_counts() == {"nvcc/spmv": 2, "other": 1}


def test_nvcc_build_counts_as_a_compile(tmp_path, monkeypatch):
    """A build that runs (the library was missing) lands in
    ``jit.traces.nvcc/<name>``; a build that fails counts nothing."""
    from photon_ml_tpu_torch.utils import cudalib

    class Done:
        def __init__(self, rc):
            self.returncode = rc

        def communicate(self):
            return "ptxas info", None

    for name, rc in (("lib_a", 0), ("lib_b", 1)):
        tmp = tmp_path / f"{name}.tmp"
        tmp.write_bytes(b"")
        if rc:
            with pytest.raises(RuntimeError, match="nvcc failed"):
                cudalib._finish_build(name, (Done(rc), str(tmp), tmp_path / f"{name}.so"))
        else:
            cudalib._finish_build(name, (Done(rc), str(tmp), tmp_path / f"{name}.so"))
    assert tt.jit_trace_counts() == {"nvcc/lib_a": 1}
    assert (tmp_path / "lib_a.so").exists() and not (tmp_path / "lib_b.so").exists()


def test_memory_watermarks_on_the_host():
    out = tt.record_memory_watermarks()
    assert out["mem.host_peak_rss_bytes"] > 0
    assert not any(k.startswith("mem.device") for k in out)  # no card here
    assert tt.get_registry().snapshot()["gauges"]["mem.host_peak_rss_bytes"]["last"] > 0


def _bad_ledgers(tmp_path, good):
    lines = good.read_text().splitlines()
    span = next(i for i, l in enumerate(lines) if json.loads(l)["type"] == "span")
    cases = {"good": "\n".join(lines) + "\n"}
    no_type = json.loads(lines[0])
    del no_type["type"]
    cases["no_type"] = "\n".join([json.dumps(no_type)] + lines[1:]) + "\n"
    missing = json.loads(lines[span])
    del missing["duration_s"]
    cases["span_missing_field"] = "\n".join(
        lines[:span] + [json.dumps(missing)] + lines[span + 1:]) + "\n"
    cases["bad_json_middle"] = "\n".join(lines[:1] + ["{nope"] + lines[1:]) + "\n"
    cases["truncated_tail"] = "\n".join(lines) + "\n" + lines[-1][: len(lines[-1]) // 2]
    cases["unknown_progress"] = "\n".join(
        lines + [json.dumps({"type": "progress", "ts": 1.0, "kind": "mystery"})]) + "\n"
    cases["progress_missing"] = "\n".join(
        lines + [json.dumps({"type": "progress", "ts": 1.0, "kind": "coordinate",
                             "outer": 0})]) + "\n"
    cases["empty"] = ""
    paths = {}
    for name, text in cases.items():
        p = tmp_path / f"ledger_{name}.jsonl"
        p.write_text(text)
        paths[name] = str(p)
    return paths


def _outcome(fn, *a, **kw):
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            out = fn(*a, **kw)
        except (ValueError, json.JSONDecodeError) as e:
            return ("raises", type(e).__name__)
    if isinstance(out, list):
        for r in out:
            r.pop("ts", None)
        return ("ok", out, [type(w.message).__name__ for w in caught])
    return ("ok", out)


def test_validators_accept_and_reject_the_same_files(tmp_path):
    ours, _ = _records()
    run = tt.start_run("validate", ledger_path=str(tmp_path / "run.jsonl"),
                       trace_path=str(tmp_path / "trace.json"))
    for r in ours:
        run.tracer._record(r)
    run.finish()
    tt.disable_tracing()
    for name, path in _bad_ledgers(tmp_path, tmp_path / "run.jsonl").items():
        for tail in (True, False):
            mine = _outcome(tt.validate_ledger, path, allow_truncated_tail=tail)
            ref = _outcome(jt.validate_ledger, path, allow_truncated_tail=tail)
            if mine[0] == "ok":
                # the warning classes are the packages' own, with the same name
                assert mine == ref, name
            else:
                assert mine[0] == ref[0] == "raises", name
    assert _outcome(tt.validate_ledger, str(tmp_path / "ledger_good.jsonl"))[0] == "ok"
    good = json.loads((tmp_path / "trace.json").read_text())
    traces = {"good": good, "not_object": [1], "no_events": {"x": 1},
              "bad_phase": {"traceEvents": [{**good["traceEvents"][0], "ph": "B"}]},
              "negative": {"traceEvents": [{**good["traceEvents"][0], "dur": -1}]},
              "missing": {"traceEvents": [{"name": "a"}]}}
    for name, doc in traces.items():
        p = tmp_path / f"trace_{name}.json"
        p.write_text(json.dumps(doc))
        mine, ref = _outcome(tt.validate_chrome_trace, str(p)), _outcome(
            jt.validate_chrome_trace, str(p))
        assert mine == ref, name
    assert _outcome(tt.validate_chrome_trace, str(tmp_path / "trace_good.json"))[0] == "ok"


def _tiny_fit(**kw):
    from test_torch_cd_async import _fit, _problem, _torch_data

    data = _torch_data(_problem(n_users=8, rows_per_user=12))
    return _fit(data, n_outer=2, **kw)[1]


def test_no_barrier_with_tracing_off_and_two_per_sync_span_with_it_on(monkeypatch):
    calls = []
    monkeypatch.setattr(span_mod, "_device_barrier", lambda: calls.append(1))
    plain = _tiny_fit()
    assert calls == []
    tracer = tt.enable_tracing()
    traced = _tiny_fit()
    spans = tracer.spans()
    tt.disable_tracing()
    synced = [s for s in spans if s.name in ("cd/coordinate", "fe/solve", "re/solve_bucket")]
    assert synced and len(calls) == 2 * len(synced)
    # device_sync=False at the tracer silences every barrier
    calls.clear()
    tt.enable_tracing(device_sync=False)
    _tiny_fit()
    tt.disable_tracing()
    assert calls == []
    assert plain.objective_history == traced.objective_history
    assert plain.validation_history == traced.validation_history
    for cid, m in plain.model.models.items():
        t = traced.model.models[cid]
        if hasattr(m, "entity_ids"):
            assert all(np.array_equal(a.numpy(), b.numpy())
                       for a, b in zip(m.coefficients, t.coefficients))
        else:
            assert np.array_equal(m.coefficients.means.numpy(), t.coefficients.means.numpy())


def test_barrier_on_the_host_is_a_no_op():
    """Without CUDA in the process the barrier returns at once (and raises
    nothing): there is no device work to wait for."""
    span_mod._device_barrier()
    tt.enable_tracing()
    with tt.span("x", device_sync=True):
        pass
    assert [s.name for s in tt.get_tracer().spans()] == ["x"]

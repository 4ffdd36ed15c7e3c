"""The port's live introspection server (``serving/introspect.py``) against
the JAX package's, on 127.0.0.1 only.

- ``prometheus_text`` renders the same text for the same registry
  (counters, gauges with peaks, histograms, label-scoped names);
- the same requests to both servers get the same status codes and bodies
  (``/metrics``, ``/healthz``, ``/varz``, an extra JSON route, a path that
  does not exist, an endpoint that raises);
- ``/healthz`` answers 503 once the divergence watchdog has tripped, with
  the anomaly in its body;
- ``/quitquitquit`` ends an ``--introspect-hold`` wait, and the
  ``train_game`` CLI writes its bound port to ``--introspect-port-file``
  and serves ``/progress`` for as long as it holds.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import photon_ml_tpu.serving.introspect as jax_introspect
import photon_ml_tpu.telemetry as jt
import photon_ml_tpu_torch.telemetry as tt
from _torch_parity import tiny_glmix_argv, write_tiny_glmix
from photon_ml_tpu_torch.cli import train_game
from photon_ml_tpu_torch.serving import IntrospectionServer, prometheus_text


@pytest.fixture(autouse=True)
def _clean():
    for pkg in (tt, jt):
        pkg.disable_tracing()
        pkg.get_registry().reset()
    yield
    for pkg in (tt, jt):
        pkg.disable_tracing()
        pkg.get_registry().reset()


def _fill(registry):
    registry.count("solver.per_user.rounds", 3)
    registry.count("events.SolverStatsEvent")
    registry.gauge("mem.device0_peak_bytes", 2.5e9)
    registry.gauge("mem.device0_peak_bytes", 1.5e9)
    registry.gauge("progress.objective", float("inf"))
    for v in np.random.default_rng(3).exponential(size=700):
        registry.observe("serving.latency_s", float(v))
    scoped = registry.scoped({"tenant": 'a"b', "host": "1"})
    scoped.count("serving.requests", 5)
    scoped.gauge("cluster.host.busy_s", 0.25)
    scoped.observe("lat", 1.0)
    return registry


def test_prometheus_text_is_the_jax_packages():
    snap = _fill(tt.MetricsRegistry()).snapshot()
    assert snap == _fill(jt.MetricsRegistry()).snapshot()
    assert prometheus_text(snap) == jax_introspect.prometheus_text(snap)
    assert prometheus_text(snap, prefix="x_") == jax_introspect.prometheus_text(
        snap, prefix="x_")
    assert prometheus_text({"counters": {}, "gauges": {}, "histograms": {}}) == (
        jax_introspect.prometheus_text({"counters": {}, "gauges": {}, "histograms": {}}))


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _boom():
    raise RuntimeError("endpoint bug")


def test_servers_answer_alike():
    servers = []
    for cls, pkg in ((IntrospectionServer, tt), (jax_introspect.IntrospectionServer, jt)):
        servers.append(cls(
            registry=_fill(pkg.MetricsRegistry()), varz=lambda: {"a": 1, "b": [1, 2]},
            health=lambda: {"generation": 3}, port=0,
            extra_json={"progress": lambda: {"records": [1, 2]}, "/broken/": _boom},
        ).start())
    try:
        for path in ("/metrics", "/healthz", "/varz", "/progress", "/progress/?x=1",
                     "/broken", "/nope"):
            assert _get(servers[0].port, path) == _get(servers[1].port, path), path
        assert _get(servers[0].port, "/broken")[0] == 500
        assert _get(servers[0].port, "/nope")[0] == 404
    finally:
        for s in servers:
            s.stop()


def test_healthz_is_503_after_the_watchdog_trips():
    tracker = tt.ConvergenceTracker()
    server = IntrospectionServer(health=tracker.health, port=0,
                                 extra_json={"/progress": tracker.progress_json}).start()
    try:
        tracker.record_coordinate(0, "fixed", 10.0)
        code, body = _get(server.port, "/healthz")
        assert code == 200 and json.loads(body)["healthy"] is True
        with pytest.raises(tt.DivergenceError):
            tracker.record_coordinate(0, "per_user", float("inf"))
        code, body = _get(server.port, "/healthz")
        doc = json.loads(body)
        assert code == 503 and doc["healthy"] is False
        assert doc["anomaly"]["anomaly_kind"] == "non_finite_objective"
        assert doc["phase"] == "diverged"
        progress = json.loads(_get(server.port, "/progress")[1])
        assert [r["kind"] for r in progress["records"]] == ["coordinate", "coordinate",
                                                            "anomaly"]
    finally:
        server.stop()
        tracker.finish()


def test_quitquitquit_ends_a_hold():
    server = IntrospectionServer(port=0).start()
    try:
        done = []
        t = threading.Thread(target=lambda: done.append(server.wait_quit(60)))
        t.start()
        time.sleep(0.05)
        assert not done
        assert _get(server.port, "/quitquitquit") == (200, "bye\n")
        t.join(timeout=30)
        assert not t.is_alive() and done == [True]
    finally:
        server.stop()


def test_train_game_serves_progress_while_it_holds(tmp_path):
    paths = write_tiny_glmix(tmp_path / "data")
    port_file = tmp_path / "port"
    rc = []
    t = threading.Thread(target=lambda: rc.append(train_game.main(tiny_glmix_argv(
        paths, tmp_path / "out", "--device", "cpu", "--introspect-port", "0",
        "--introspect-port-file", str(port_file), "--introspect-hold", "60"))))
    t.start()
    try:
        deadline = time.time() + 120
        port = None
        while time.time() < deadline and t.is_alive():
            if port_file.exists() and port_file.read_text():
                port = int(port_file.read_text())
                progress = json.loads(_get(port, "/progress")[1])
                if len([r for r in progress["records"] if r["kind"] == "coordinate"]) == 4:
                    break
            time.sleep(0.05)
        assert port is not None and port > 0
        assert _get(port, "/healthz")[0] == 200
        varz = json.loads(_get(port, "/varz")[1])
        assert varz["introspect_hold"] == 60.0 and varz["device"] == "cpu"
        assert "photon_progress_coordinate_updates 4" in _get(port, "/metrics")[1]
        assert _get(port, "/quitquitquit")[0] == 200
    finally:
        t.join(timeout=120)
    assert not t.is_alive() and rc == [0]
    assert (tmp_path / "out" / "best").is_dir()

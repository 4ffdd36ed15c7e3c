"""The port's cluster plane (``photon_ml_tpu_torch/parallel/cluster``) against
the JAX package's, on the CPU at the JAX streaming tests' sizes (3 part
files of 250/270/180 rows, blocks of 128: 6 blocks, the last ragged):

- the assigner's decisions equal the JAX package's, decision for decision;
- a message pickles to the JAX package's bytes, frames round-trip, a
  closed peer reads as EOF (death), interleaved sends frame cleanly;
- a thread-hosted 2-host fit on ``cpu`` lands within FE atol 2e-3 of the
  port's single-host streamed fit and of the JAX package's 2-host fit, and
  repeats bitwise (two partials sum the same in either order);
- the kill drill: one ``host_lost``, the counters, the fit completes;
- pass profiles have the JAX package's structure;
- ``ClusterPlane.launch`` of 2 subprocess workers on ``cpu``;
- ``train_game --streaming --hosts 2`` (and the drill) against the JAX CLI.

Tests assert on outputs and counts, never on host timing.
"""

import pickle
import socket
import threading

import numpy as np
import pytest
import torch

import photon_ml_tpu.parallel.cluster as jc
import photon_ml_tpu.resilience as jr
import photon_ml_tpu.streaming as js
import photon_ml_tpu.telemetry as jt
import photon_ml_tpu_torch.parallel.cluster as tc
import photon_ml_tpu_torch.resilience as tr
import photon_ml_tpu_torch.streaming as ts
import photon_ml_tpu_torch.telemetry as tt
from photon_ml_tpu.io import data_reader as jdr
from photon_ml_tpu_torch.io import data_reader as tdr
from test_torch_streaming import BLOCK_ROWS, _cli_config, write_stream_dataset


@pytest.fixture(autouse=True)
def _clean_planes():
    for pkg in (tr, jr):
        pkg.reset_faults()
        pkg.clear_failures()
    for pkg in (tt, jt):
        pkg.get_registry().reset()
    yield
    for pkg in (tr, jr):
        pkg.reset_faults()
        pkg.clear_failures()


# ================================================================= assigner


def _assigner_script(pkg, num_blocks, hosts, gaps_seq, fail_host=None, exclude=()):
    """The same sequence of calls on either package's BlockAssigner; every
    returned value and every drained decision."""
    a = pkg.BlockAssigner(num_blocks, hosts=hosts)
    out = [a.assign()]
    for i, gaps in enumerate(gaps_seq):
        a.update(gaps)
        out.append(a.assign())
        out.append(a.predicted_shares(out[-1]))
        if i == 0 and exclude:
            a.mark_blocks_failed(exclude)
            out.append(a.assign())
    if fail_host is not None:
        inflight = out[-2][fail_host] if isinstance(out[-2], dict) else []
        a.mark_host_failed(fail_host)
        out.append(a.reassign(list(inflight) or [0, 1]))
        out.append(a.assign())
    out.append(a.drain_decisions())
    out.append(a.effective_scores().tolist())
    return out


@pytest.mark.parametrize("case", [
    dict(num_blocks=7, hosts=[0, 1, 2], gaps_seq=[]),
    dict(num_blocks=12, hosts=[2, 0, 1], gaps_seq=[{0: 5.0, 3: -2.0, 7: 0.5}, {1: 9.0}]),
    dict(num_blocks=9, hosts=[0, 1], gaps_seq=[{b: float(b * b) for b in range(9)}],
         fail_host=1),
    dict(num_blocks=10, hosts=[0, 1, 2, 3], gaps_seq=[{2: 1.0}, {}, {5: 3.0, 6: 3.0}],
         fail_host=2, exclude=[4, 9]),
])
def test_assigner_decisions_equal_jax(case):
    assert _assigner_script(tc, **case) == _assigner_script(jc, **case)


def test_assigner_refusals_equal_jax():
    for pkg in (tc, jc):
        with pytest.raises(ValueError, match="num_blocks"):
            pkg.BlockAssigner(0, hosts=[0])
        with pytest.raises(ValueError, match="at least one host"):
            pkg.BlockAssigner(3, hosts=[])
        with pytest.raises(ValueError, match="decay"):
            pkg.BlockAssigner(3, hosts=[0], decay=0.0)
        a = pkg.BlockAssigner(3, hosts=[0])
        a.mark_host_failed(0)
        with pytest.raises(RuntimeError, match="no live hosts"):
            a.assign()


# ================================================================= protocol


def _frames(pkg, msg) -> bytes:
    """The bytes ``send_msg`` puts on the wire for ``msg``."""
    a, b = socket.socketpair()
    try:
        pkg.send_msg(a, msg)
        a.shutdown(socket.SHUT_WR)
        out = b""
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                return out
            out += chunk
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("msg", [
    {"type": "hello", "host": 1, "num_blocks": 6},
    {"type": "pass", "pass_id": 3, "frag": 0,
     "w": np.arange(13, dtype=np.float32) / 7, "blocks": [0, 2, 4]},
    {"type": "partial", "pass_id": 3, "frag": 0, "host": 1, "f": 12.5,
     "g": np.linspace(-1, 1, 13), "block_stats": [
         {"block": 2, "partial_loss": 1.0, "partial_grad_norm": 2.0, "gap": 0.5}]},
    {"type": "residual", "residual": None},
])
def test_messages_are_the_jax_bytes(msg):
    assert _frames(tc, msg) == _frames(jc, msg)


def test_roundtrip_eof_and_interleaved_sends():
    a, b = socket.socketpair()
    ma, mb = tc.MessageSocket(a), tc.MessageSocket(b)
    payload = {"type": "partial", "g": np.random.default_rng(0).normal(size=1000)}
    ma.send(payload)
    got = mb.recv()
    np.testing.assert_array_equal(got["g"], payload["g"])

    def blast(tag):
        for i in range(50):
            ma.send({"type": tag, "i": i, "pad": np.zeros(2000)})

    threads = [threading.Thread(target=blast, args=(t,)) for t in ("x", "y")]
    for t in threads:
        t.start()
    seen = {"x": [], "y": []}
    for _ in range(100):
        m = mb.recv()
        seen[m["type"]].append(m["i"])
    for t in threads:
        t.join()
    assert seen == {"x": list(range(50)), "y": list(range(50))}
    ma.close()
    with pytest.raises(EOFError):
        mb.recv()
    mb.close()


# ============================================================ the streamed fit


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("cluster")
    paths, _ = write_stream_dataset(root)
    shards = {
        "t": {"global": tdr.FeatureShardConfiguration(feature_bags=("features",),
                                                      add_intercept=True)},
        "j": {"global": jdr.FeatureShardConfiguration(feature_bags=("features",),
                                                      add_intercept=True)},
    }
    return {
        "root": str(root), "paths": paths, "shards": shards,
        "tmaps": tdr.build_index_maps(paths, shards["t"]),
        "jmaps": jdr.build_index_maps(paths, shards["j"]),
    }


def _source(pkg, ds):
    key, maps = ("t", ds["tmaps"]) if pkg is ts else ("j", ds["jmaps"])
    return pkg.StreamingSource.open(ds["paths"], ds["shards"][key], index_maps=maps,
                                    block_rows=BLOCK_ROWS)


def _estimator(port: bool):
    if port:
        from photon_ml_tpu_torch.estimators.game import (
            FixedEffectCoordinateConfiguration, GameEstimator)
        from photon_ml_tpu_torch.opt.config import (
            GlmOptimizationConfiguration, RegularizationContext)
        from photon_ml_tpu_torch.types import RegularizationType, TaskType
        kw = {"device": "cpu"}
    else:
        from photon_ml_tpu.estimators.game import (
            FixedEffectCoordinateConfiguration, GameEstimator)
        from photon_ml_tpu.opt import GlmOptimizationConfiguration, RegularizationContext
        from photon_ml_tpu.types import RegularizationType, TaskType
        kw = {}
    opt = GlmOptimizationConfiguration(
        regularization=RegularizationContext(RegularizationType.L2), regularization_weight=0.5)
    return GameEstimator(task=TaskType.LOGISTIC_REGRESSION,
                         coordinates={"fixed": FixedEffectCoordinateConfiguration("global", opt)},
                         num_outer_iterations=1, **kw)


def _plane(port: bool, ds, hosts=2, chaos_kill_after=None):
    pkg, spkg = (tc, ts) if port else (jc, js)
    if port:
        from photon_ml_tpu_torch.types import TaskType
        extra = {"device": "cpu"}
    else:
        from photon_ml_tpu.types import TaskType
        extra = {}
    coord = pkg.ClusterCoordinator(hosts, _source(spkg, ds).plan.num_blocks,
                                   heartbeat_timeout_s=60.0)
    for h in range(hosts):
        pkg.serve_worker_in_thread(pkg.ClusterWorker(
            host_id=h, source=_source(spkg, ds), shard_id="global",
            task=TaskType.LOGISTIC_REGRESSION,
            chaos_kill_after=chaos_kill_after if h == hosts - 1 else None, **extra,
        ), coord.address)
    coord.wait_for_workers(timeout_s=60.0)
    return coord


def _w(fit):
    w = fit.model.models["fixed"].coefficients.means
    return w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)


def _cluster_fit(port: bool, ds, telemetry=False, progress=None, **plane_kw):
    plane = _plane(port, ds, **plane_kw)
    if telemetry:
        plane.enable_telemetry()
    try:
        src = _source(ts if port else js, ds)
        return _estimator(port).fit_streaming(src, cluster=plane, progress=progress), plane
    finally:
        plane.shutdown()


def test_two_host_fit_matches_single_host_and_jax(dataset):
    solo = _estimator(True).fit_streaming(_source(ts, dataset))
    tracker = tt.ConvergenceTracker(abort_on_divergence=False)
    fit, _ = _cluster_fit(True, dataset, progress=tracker)
    tracker.finish()
    again, _ = _cluster_fit(True, dataset)
    jfit, _ = _cluster_fit(False, dataset)
    np.testing.assert_allclose(_w(fit), _w(solo), atol=2e-3)
    np.testing.assert_allclose(_w(fit), _w(jfit), atol=2e-3)
    assert fit.objective_history[-1][1] == pytest.approx(solo.objective_history[-1][1],
                                                         rel=1e-4)
    # two partials sum the same in either arrival order: bitwise repeats
    np.testing.assert_array_equal(_w(fit), _w(again))
    cluster = [r for r in tracker.records if r.get("kind") == "cluster"]
    assert any(r["event"] == "rebalance" for r in cluster)
    blocks = [r for r in tracker.records if r.get("kind") == "block"]
    assert {r["block"] for r in blocks} == set(range(6))
    assert all("gap_estimate" in r for r in blocks)


def test_kill_drill_reassigns_and_completes(dataset):
    tracker = tt.ConvergenceTracker(abort_on_divergence=False)
    fit, plane = _cluster_fit(True, dataset, progress=tracker, chaos_kill_after=2)
    tracker.finish()
    solo = _estimator(True).fit_streaming(_source(ts, dataset))
    np.testing.assert_allclose(_w(fit), _w(solo), atol=2e-3)
    events = [r for r in tracker.records if r.get("kind") == "cluster"]
    lost = [e for e in events if e["event"] == "host_lost"]
    assert len(lost) == 1 and lost[0]["host"] == 1
    assert any(e["event"] == "blocks_reassigned" and e["blocks"] for e in events)
    reg = tt.get_registry()
    assert reg.counter_value("cluster.host_failures") == 1
    assert reg.counter_value("cluster.blocks_reassigned") >= 1
    assert [f["kind"] for f in tr.recent_failures()].count("cluster_host_lost") == 1
    assert plane.assigner.failed_hosts == [1]


def _structure(x):
    """Keys and value kinds of a profile, a per-host map read by one entry."""
    if isinstance(x, dict):
        keys = list(x)
        if keys and all(str(k).isdigit() for k in keys):
            return {"<host>": _structure(x[keys[0]])}
        return {k: _structure(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_structure(x[0])] if x else []
    return type(x).__name__ if not isinstance(x, (int, float)) else "number"


def test_pass_profiles_have_the_jax_structure(dataset):
    trackers = {pkg: pkg.ConvergenceTracker(abort_on_divergence=False) for pkg in (tt, jt)}
    _cluster_fit(True, dataset, telemetry=True, progress=trackers[tt])
    _cluster_fit(False, dataset, telemetry=True, progress=trackers[jt])
    for t in trackers.values():
        t.finish()
    tp, jp = trackers[tt].cluster_passes, trackers[jt].cluster_passes
    assert tp and jp and len(tp) == len(jp)
    assert _structure(tp[0]) == _structure(jp[0])
    assert sorted(tp[0]["hosts"]) == sorted(jp[0]["hosts"])
    for p in tp:
        assert p["wall_s"] == pytest.approx(
            p["busy_s"] + p["allreduce_wait_s"] + p["bubble_s"], rel=1e-9, abs=1e-9)


def test_disabled_telemetry_sends_no_extra_key(dataset):
    sent = []
    coord = tc.ClusterCoordinator(1, 6)
    try:
        class _Capture:
            host = 0

            class msock:  # noqa: N801
                @staticmethod
                def send(msg):
                    sent.append(pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL))

        coord._send_fragment(_Capture, 1, 0, np.zeros(3, np.float32), [0, 1])
        coord.enable_telemetry()
        coord._send_fragment(_Capture, 1, 1, np.zeros(3, np.float32), [0, 1])
    finally:
        coord.shutdown()
    plain = pickle.loads(sent[0])
    assert set(plain) == {"type", "pass_id", "frag", "w", "blocks"}
    assert pickle.loads(sent[1])["telemetry"] is True


def test_cluster_refusals(dataset):
    src = _source(ts, dataset)
    with pytest.raises(ValueError, match="cluster training requires mode='full'"):
        _estimator(True).fit_streaming(src, mode="stochastic", cluster=object())

    class Skewed:
        num_blocks = 99

    with pytest.raises(ValueError, match="cluster planned 99 blocks"):
        _estimator(True).fit_streaming(src, cluster=Skewed())
    class Matching:
        num_blocks = src.plan.num_blocks

    with pytest.raises(ValueError, match="device residency requires local streaming"):
        _estimator(True).fit_streaming(src, cluster=Matching(), resident_blocks=2)


def test_launch_two_subprocess_workers_on_cpu(dataset, tmp_path):
    cfg = _cli_config(tmp_path)
    src = _source(ts, dataset)
    plane = tc.ClusterPlane.launch(
        num_hosts=2, num_blocks=src.plan.num_blocks, train_dirs=[dataset["root"]],
        coordinate_config=cfg, task="LOGISTIC_REGRESSION", feature_shard="global",
        block_rows=BLOCK_ROWS, device="cpu", log_dir=str(tmp_path / "logs"),
        startup_timeout_s=120.0,
    )
    try:
        dim = src.plan.shard_dims["global"]
        w = np.linspace(-0.5, 0.5, dim).astype(np.float32)
        plane.set_residual(None)
        f, g, gaps, stats = plane.distributed_pass(w)
    finally:
        plane.close()
    assert [p.returncode for p in plane.procs] == [0, 0]
    assert sorted(s["block"] for s in stats) == list(range(src.plan.num_blocks))
    assert {s["host"] for s in stats} == {0, 1}
    # the same (f, g) as one host streaming every block
    from photon_ml_tpu_torch.streaming.coordinate import _objective_for_task
    from photon_ml_tpu_torch.types import TaskType

    obj = _objective_for_task(TaskType.LOGISTIC_REGRESSION)
    f1 = torch.zeros(())
    g1 = torch.zeros(dim)
    wt = torch.from_numpy(w)
    for blk in ts.BlockPrefetcher(_source(ts, dataset), shards=("global",), device="cpu"):
        bf, bg = obj.value_and_grad(wt, blk.data["global"], 0.0)
        f1, g1 = f1 + bf, g1 + bg
    assert f == pytest.approx(float(f1), rel=1e-5)
    np.testing.assert_allclose(g, g1.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("extra", [("--hosts", "2"),
                                   ("--hosts", "2", "--cluster-kill-host", "1:2")])
def test_train_game_hosts_cli_matches_jax(dataset, tmp_path, extra):
    from photon_ml_tpu.cli import train_game as jcli
    from photon_ml_tpu_torch.cli import train_game as tcli

    cfg = _cli_config(tmp_path)
    base = ["--train-data-dirs", dataset["root"], "--validation-data-dirs", dataset["root"],
            "--coordinate-config", cfg, "--task", "LOGISTIC_REGRESSION", "--evaluator", "AUC",
            "--streaming", "--block-rows", str(BLOCK_ROWS), "--num-outer-iterations", "2",
            "--no-block-cache", *extra]
    progress = str(tmp_path / "progress.jsonl")
    telemetry = ["--telemetry-out", str(tmp_path / "run" / "ledger.jsonl"),
                 "--trace-out", str(tmp_path / "trace.json")]
    tfit = tcli.run(tcli.parse_args(base + ["--output-dir", str(tmp_path / "t"),
                                            "--device", "cpu", "--progress-out", progress,
                                            *telemetry]))
    jfit = jcli.run(jcli.parse_args(base + ["--output-dir", str(tmp_path / "j")]))
    assert tfit.validation_metric == pytest.approx(jfit.validation_metric, abs=1e-4)
    np.testing.assert_allclose(_w(tfit), _w(jfit), atol=2e-3)
    import json

    recs = [json.loads(line) for line in open(progress)]
    kinds = {r.get("kind") for r in recs}
    assert {"cluster", "cluster_pass", "host_pass"} <= kinds
    lost = [r for r in recs if r.get("kind") == "cluster" and r.get("event") == "host_lost"]
    assert len(lost) == (1 if "--cluster-kill-host" in extra else 0)
    # worker ledgers beside the coordinator's; a Chrome trace lane a host
    workers = tmp_path / "run" / "cluster-workers"
    assert (workers / "worker-0-ledger.jsonl").stat().st_size > 0
    trace = json.load(open(tmp_path / "trace.json"))
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    lanes = {e["pid"] for e in events if e.get("cat") == "cluster"}
    assert 1 in lanes

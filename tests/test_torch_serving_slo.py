"""The port's SLO tracker, overload controller and request plane against the
JAX package's: the same decisions on the same event sequences.

- ``SLOTracker`` status, health and burn over a scripted sequence of
  completions, errors and clock steps, with its gauges; per-tenant budgets
  from ``build_tenant_slos`` under tenant label scopes.
- ``OverloadController``: the hysteresis states, deadline actuation,
  FE-only sheds (scores within tolerance of the JAX package's) and status
  over one burn-rate script.
- ``RequestPlane``: the seeded sampler, stage records, interference,
  tenant attribution and live report over one batch script.
"""

import numpy as np
import pytest

from _torch_serving_parity import ManualClock
from test_torch_serving_sharded import _requests, _sharded
import photon_ml_tpu.serving as J
import photon_ml_tpu_torch.serving as T
from photon_ml_tpu.serving.tenancy import build_tenant_slos as j_tenant_slos
from photon_ml_tpu.serving.tenancy import tag_requests as j_tag_requests
from photon_ml_tpu.telemetry.metrics import MetricsRegistry as JRegistry
from photon_ml_tpu_torch.serving.requestplane import sample_hash, tenant_of_request_id
from photon_ml_tpu_torch.telemetry.metrics import MetricsRegistry as TRegistry


def _slo_script(pkg, registry):
    clock = ManualClock(100.0)
    slo = pkg.SLOTracker(latency_threshold_s=0.01, latency_objective=0.9,
                         availability_objective=0.99, window_s=60.0,
                         num_buckets=6, clock=clock, registry=registry)
    rng = np.random.default_rng(0)
    trace = []
    for step in range(40):
        lat = rng.exponential(0.006 if step < 20 else 0.02, size=int(rng.integers(1, 9)))
        slo.observe_many(lat, errors=int(step % 7 == 0))
        if step % 5 == 0:
            slo.observe(0.002)
        clock.advance(3.0 if step != 25 else 70.0)
        trace.append((slo.status(), slo.health()))
    return trace


def test_slo_tracker_decisions_equal_jax():
    jreg, treg = JRegistry(), TRegistry()
    assert _slo_script(T, treg) == _slo_script(J, jreg)
    jg = {k: v for k, v in jreg.snapshot()["gauges"].items() if k.startswith("serving.slo")}
    tg = {k: v for k, v in treg.snapshot()["gauges"].items() if k.startswith("serving.slo")}
    assert tg == jg and tg


def test_tenant_budgets_are_independent_and_labelled_like_jax():
    out = {}
    for pkg, reg, build in ((J, JRegistry(), j_tenant_slos),
                            (T, TRegistry(), T.build_tenant_slos)):
        clock = ManualClock()
        slos = build(["a", "b"], registry=reg, latency_threshold_s=0.01,
                     latency_objective=0.9, clock=clock)
        plane = pkg.RequestPlane(sample_rate=0, tenant_slos=slos, clock=clock)
        assert plane.wants_request_ids
        plane.observe_complete(np.array([0.001, 0.5, 0.5, 0.002]),
                               request_ids=["a!1", "b!2", "b!3", "x"])
        plane.observe_errors(2, request_ids=["b!4", "a!5"])
        clock.advance(1.0)
        out[pkg] = ({t: s.status() for t, s in slos.items()},
                    {t: s.health() for t, s in slos.items()},
                    plane.tenant_requests, plane.tenant_errors,
                    sorted(k for k in reg.snapshot()["gauges"] if "tenant=" in k))
    assert out[T] == out[J]
    assert out[T][1]["a"]["healthy"] != out[T][1]["b"]["healthy"] or out[T][0]["b"] != out[T][0]["a"]


def test_tag_requests_equal_jax():
    treq = T.tag_requests(_requests(T, 3), "alpha")
    jreq = j_tag_requests(_requests(J, 3), "alpha")
    assert [r.request_id for r in treq] == [r.request_id for r in jreq] == [
        "alpha!r0", "alpha!r1", "alpha!r2"]
    assert tenant_of_request_id(treq[0].request_id) == "alpha"
    with pytest.raises(ValueError, match="must not contain"):
        T.tag_requests(treq, "a!b")


class _SLO:
    def __init__(self):
        self.burn = 0.0

    def status(self):
        return {"burn_rate": self.burn}


class _Batcher:
    def __init__(self, max_wait_s):
        self.max_wait_s = max_wait_s


def test_overload_hysteresis_and_sheds_equal_jax():
    out = {}
    for pkg in (J, T):
        slo = _SLO()
        reg = JRegistry() if pkg is J else TRegistry()
        clock = ManualClock()
        ctl = pkg.OverloadController(slo, shrink_factor=0.25, burn_high=2.0, burn_low=0.5,
                                     poll_interval_s=0.1, registry=reg, clock=clock)
        scorer = _sharded(pkg, num_shards=2, device_budget_rows=12)
        ctl.attach_scorer(scorer)
        batchers = [_Batcher(0.004), _Batcher(0.01)]
        ctl.attach(batchers[0])
        reqs = _requests(pkg, 12, seed=6, ghost_every=3, missing_every=5)
        trace = []
        for burn in (0.1, 2.5, 1.0, 0.6, 3.0, 0.4, 0.5, 2.0):
            slo.burn = burn
            ctl.maybe_poll()
            clock.advance(0.05)
            ctl.maybe_poll()  # rate-limited: inside the interval
            clock.advance(0.06)
            if burn == 3.0:
                ctl.attach(batchers[1])  # attached mid-overload: shrinks now
            shed = [ctl.try_shed(r) for r in reqs]
            trace.append((ctl.active, [b.max_wait_s for b in batchers],
                          [None if s is None else (s.request_id, s.cold_coordinates)
                           for s in shed],
                          [None if s is None else s.score for s in shed]))
        ctl.detach(batchers[0])
        ctl.stop()
        out[pkg] = (trace, ctl.status(), batchers[0].max_wait_s, batchers[1].max_wait_s,
                    {k: v for k, v in reg.snapshot()["gauges"].items()
                     if k.startswith("serving.overload")})
    (tt, ts, *trest), (jt, js, *jrest) = out[T], out[J]
    assert ts == js and trest == jrest
    assert [t[:3] for t in tt] == [j[:3] for j in jt]
    for t, j in zip(tt, jt):
        got = [np.nan if s is None else s for s in t[3]]
        want = [np.nan if s is None else s for s in j[3]]
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)
    assert ts["shed_total"] > 0 and ts["activations"] >= 2


def test_shed_score_equals_the_device_path_fe_only_score():
    scorer = _sharded(T, num_shards=2, device_budget_rows=12)
    slo = _SLO()
    ctl = T.OverloadController(slo)
    ctl.attach_scorer(scorer)
    slo.burn = 5.0
    ctl.poll()
    ghosts = [r for r in _requests(T, 12, seed=6, ghost_every=2) if "ghost" in
              r.entity_ids.get("userId", "")]
    shed = [ctl.try_shed(r) for r in ghosts]
    full = scorer.score_batch(ghosts, bucket_size=8)
    np.testing.assert_allclose([s.score for s in shed], [f.score for f in full],
                               rtol=2e-4, atol=1e-6)
    assert [s.cold_coordinates for s in shed] == [f.cold_coordinates for f in full]


def _plane_script(pkg):
    clock = ManualClock(10.0)
    slo = pkg.SLOTracker(latency_threshold_s=0.005, clock=clock)
    plane = pkg.RequestPlane(sample_rate=3, seed=7, slo=slo, clock=clock)
    ids = [f"t{i % 2}!req-{i}" for i in range(30)]
    picked = plane.sample_indices(ids)
    plane.note_interference("admission", 10.001, 10.003)
    for b in range(3):
        batch = ids[b * 10:(b + 1) * 10]
        sampled = plane.sample_indices(batch)
        stages = {"featurize_done": 10.002, "route_done": 10.0025,
                  "dispatch_done": 10.003, "device_done": 10.0045}
        plane.record_batch("continuous", 16, len(batch),
                           [(batch[i], 10.0 + 0.0001 * i) for i in sampled],
                           10.001, stages if b != 1 else None, 10.005)
        plane.observe_complete(np.full(len(batch), 0.004 + 0.002 * b))
        clock.advance(1.0)
    plane.observe_errors(1)
    report = plane.live_report()
    return picked, [sample_hash(i, 7) for i in ids[:5]], plane.records(), report


def test_request_plane_records_equal_jax():
    tp, th, trec, trep = _plane_script(T)
    jp, jh, jrec, jrep = _plane_script(J)
    assert tp == jp and th == jh and len(tp) > 0
    assert trec == jrec
    assert trep == jrep

"""Multi-tenant serving: the port's variant plane (``serving/tenancy``),
the sharded scorer's ``view`` hook and ``serving/scenarios`` against the
JAX package's, on one seeded GLMix model packed by both packages.

- Router ``route`` / ``route_many`` / ramp / pin decisions and quota
  verdicts under a hand-driven clock are equal, decision for decision.
- ``view=None`` is bitwise the plain sharded path; a diverged variant's
  scores match the JAX variant's (rtol 2e-4, atol 1e-5); an undiverged
  variant and the base stay bitwise the plain path; rolling one variant
  back leaves the other bitwise as it was.
- ``TenancyPlane.status`` has the JAX package's keys; a lone tenant on the
  base variant through the plane is bitwise the plain path.
- ``build_scenario`` makes the same stream for all eight scenarios; the
  three tenancy scenarios run end to end with the JAX package's verdicts.
"""

import tempfile

import numpy as np
import pytest

from _torch_serving_parity import ManualClock, serving_pair
import photon_ml_tpu.incremental as JI
import photon_ml_tpu.serving as J
import photon_ml_tpu_torch.incremental as TI
import photon_ml_tpu_torch.serving as T
from photon_ml_tpu.telemetry.metrics import MetricsRegistry as JReg
from photon_ml_tpu_torch.serving.scenarios import make_row_swap_fn
from photon_ml_tpu_torch.serving.tenancy import BASE_VARIANT
from photon_ml_tpu_torch.telemetry.metrics import MetricsRegistry as TReg

BUCKETS = (1, 2, 4, 8, 16, 32, 64)
RE = "per_userId"


@pytest.fixture(scope="module")
def pair():
    return serving_pair(seed=3, n=96)


def _sharded(pkg, art, **kw):
    if pkg is T:
        kw["device"] = "cpu"
    return pkg.ShardedGameScorer(art, max_nnz=8, num_shards=2, **kw)


def _scores(scorer, requests, view=None):
    kw = {} if view is None else {"view": view}
    return {r.request_id: r.score
            for r in scorer.score_batch(requests, bucket_size=len(requests), **kw)}


def _re_updates(entities, dim, seed=0, scale=0.5):
    rng = np.random.default_rng(seed)
    return {RE: {e: {int(j): float(x) for j, x in zip(rng.integers(0, dim, 2),
                                                     rng.normal(0.0, scale, 2))}
                 for e in entities}}


# ------------------------------------------------------------------ router

@pytest.mark.parametrize("seed", [0, 5])
def test_router_decisions_equal_jax(seed):
    routers = []
    for pkg in (J, T):
        r = pkg.VariantRouter(seed=seed)
        r.set_ramp("a", 15.0)
        r.set_ramp("b", 40.0)
        r.set_ramp("c", 30.0, tenant="gamma")
        r.pin("pinned", "a")
        routers.append(r)
    jr, tr = routers
    ids = [f"x{i}" for i in range(400)]
    for tenant in ("alpha", "gamma", "pinned", None):
        want = [jr.route(tenant, i) for i in ids]
        assert [tr.route(tenant, i) for i in ids] == want
        assert tr.route_many(tenant, ids) == jr.route_many(tenant, ids) == want
    for r in routers:  # a hot ramp move keeps every request the variant had
        r.set_ramp("a", 35.0)
        r.pin("pinned", None)
    for tenant in ("alpha", "pinned"):
        assert tr.route_many(tenant, ids) == jr.route_many(tenant, ids)
    assert tr.decisions == jr.decisions
    assert tr.shares() == jr.shares() and tr.status() == jr.status()
    for r in routers:
        with pytest.raises(ValueError, match="in \\[0, 100\\]"):
            r.set_ramp("a", 120.0)
        with pytest.raises(ValueError, match="sum to"):
            r.set_ramp("d", 60.0)


# ------------------------------------------------------------------- quota

def test_quota_verdicts_equal_jax():
    out = []
    for pkg in (J, T):
        clock = ManualClock(0.0)
        quota = pkg.TenantQuota(
            {"gold": pkg.TenantBudget(rate=4.0, burst=6, priority=1),
             "bronze": pkg.TenantBudget(rate=2.0, burst=8, priority=0)},
            global_rate=5.0, global_burst=10, reserve_fraction=0.3, clock=clock)
        rng = np.random.default_rng(1)
        verdicts = []
        for _ in range(300):
            clock.advance(float(rng.exponential(0.08)))
            tenant = ("gold", "bronze", "stranger")[int(rng.integers(3))]
            verdicts.append(quota.try_admit(tenant, n=int(rng.integers(1, 3))))
        out.append((verdicts, quota.stats()))
    assert out[1] == out[0]
    assert 0 < sum(out[1][0]) < len(out[1][0])


# --------------------------------------------------------------- view hook

def test_view_none_is_the_plain_path_bitwise(pair):
    ja, ta, jr, tr = pair
    scorer = _sharded(T, ta)
    plain = _scores(scorer, tr)
    compiles = scorer.compile_count
    # view=None (the plain path, the artifact and FE tensors read under
    # the lock) against the JAX sharded scorer on the same requests
    want = _scores(_sharded(J, ja), jr)
    assert sorted(plain) == sorted(want)
    ids = sorted(want)
    np.testing.assert_allclose([plain[i] for i in ids], [want[i] for i in ids],
                               rtol=2e-4, atol=1e-5)
    # the scorer's own artifact and FE tensors as a view: the same program
    assert _scores(scorer, tr, view=(scorer.artifact, scorer._fe_params)) == plain
    assert scorer.compile_count == compiles
    full = T.GameScorer(ta, max_nnz=8, device="cpu")
    assert _scores(full, tr) == plain


@pytest.fixture
def registries(pair):
    """Both packages' registries over their own sharded scorer, variants
    v1 and v2, v1 diverged by one delta (RE rows of 5 users, 2 of them
    unknown to the model, and a new FE vector)."""
    ja, ta, jr, tr = pair
    out = {}
    dim = ta.tables[RE].dim
    users = ["u1", "u3", "u7", "brand_new", "other_new"]
    fe = np.random.default_rng(4).normal(size=ta.tables["fixed"].dim).astype(np.float32)
    for pkg, I, art, req in ((J, JI, ja, jr), (T, TI, ta, tr)):
        scorer = _sharded(pkg, art)
        reg = pkg.VariantRegistry(scorer)
        reg.add_variant("v1")
        reg.add_variant("v2")
        before = _scores(scorer, req)
        delta = I.build_delta(_re_updates(users, dim), art, fe_updates={"fixed": fe},
                              generation=1)
        report = reg.apply_delta("v1", delta)
        out[pkg] = (scorer, reg, req, before, report)
    return out


def test_diverged_variant_matches_jax(registries):
    js, jreg, jreq, jbefore, jrep = registries[J]
    ts, treg, treq, tbefore, trep = registries[T]
    for f in ("variant_id", "generation", "fingerprint", "rows_updated", "new_overlay_rows",
              "rolled_back"):
        assert getattr(trep, f) == getattr(jrep, f), f
    assert trep.new_overlay_rows == 5
    v1 = _scores(ts, treq, view=treg.view("v1"))
    want = _scores(js, jreq, view=jreg.view("v1"))
    np.testing.assert_allclose([v1[k] for k in sorted(v1)], [want[k] for k in sorted(want)],
                               rtol=2e-4, atol=1e-5)
    assert v1 != tbefore
    # base and the undiverged v2 are bitwise the plain path
    assert treg.view("v2") is None and treg.view(BASE_VARIANT) is None
    assert _scores(ts, treq) == tbefore
    assert _scores(treg.scorer("v2"), treq) == tbefore
    assert treg.stats() == jreg.stats()
    assert treg.state("v1").overlay_rows == jreg.state("v1").overlay_rows


def test_variant_rollback_leaves_the_other_bitwise(registries):
    ts, treg, treq, tbefore, _ = registries[T]
    js, jreg, jreq, _, _ = registries[J]
    dim = ts.artifact.tables[RE].dim
    for pkg, I, scorer, reg in ((J, JI, js, jreg), (T, TI, ts, treg)):
        d = I.build_delta(_re_updates(["u2", "u3"], dim, seed=9), scorer.artifact, generation=1)
        reg.apply_delta("v2", d)
        # v1's second generation rewrites its overlay rows in place
        d2 = I.build_delta(_re_updates(["u1", "u3"], dim, seed=11), scorer.artifact,
                           base_fingerprint=reg.state("v1").fingerprint, generation=2)
        reg.apply_delta("v1", d2)
    v2 = _scores(ts, treq, view=treg.view("v2"))
    for reg in (jreg, treg):
        st = reg.rollback("v1")
        assert (st.generation, st.rollbacks) == (1, 1)
    assert _scores(ts, treq, view=treg.view("v2")) == v2
    assert _scores(ts, treq) == tbefore
    v1_gen1 = _scores(ts, treq, view=treg.view("v1"))
    want = _scores(js, jreq, view=jreg.view("v1"))
    np.testing.assert_allclose([v1_gen1[k] for k in sorted(v1_gen1)],
                               [want[k] for k in sorted(want)], rtol=2e-4, atol=1e-5)
    assert treg.stats() == jreg.stats()
    with pytest.raises(ValueError, match="no generation to roll back"):
        treg.rollback("v1")
    with pytest.raises(KeyError):
        treg.state("nope")


def test_variant_chain_check_refuses_a_wrong_head(pair):
    _, ta, _, _ = pair
    for fp, want in (("a" * 16, True), (None, False)):
        reg = T.VariantRegistry(_sharded(T, ta), base_fingerprint=fp)
        reg.add_variant("v1")
        stale = TI.build_delta(_re_updates(["u4"], ta.tables[RE].dim), ta,
                               base_fingerprint="0" * 16, generation=1)
        if want:
            with pytest.raises(ValueError, match="chains to base"):
                reg.apply_delta("v1", stale)
            assert reg.state("v1").generation == 0
        else:  # no chain root: the first delta starts the chain
            assert reg.apply_delta("v1", stale).generation == 1


def test_gated_variant_rejects_a_bad_delta_like_jax(pair):
    ja, ta, jr, tr = pair
    out = {}
    for pkg, I, art, req in ((J, JI, ja, jr), (T, TI, ta, tr)):
        scorer = _sharded(pkg, art)
        base = scorer.score_batch(req, bucket_size=len(req))
        s = np.asarray([r.score for r in base], dtype=np.float32)
        labels = (s > np.median(s)).astype(np.float32)
        reg = pkg.VariantRegistry(scorer, gate=pkg.ValidationGate(
            req, labels, max_auc_regression=0.02, bucket_size=len(req)))
        reg.add_variant("cand")
        before = _scores(scorer, req)
        bad = I.build_delta(_re_updates([f"u{i}" for i in range(5)], art.tables[RE].dim,
                                        seed=5, scale=50.0), art, generation=1)
        rep = reg.apply_delta("cand", bad)
        assert _scores(scorer, req) == before
        good = I.build_delta(_re_updates(["u1"], art.tables[RE].dim, seed=2, scale=0.01), art,
                             generation=1)
        rep2 = reg.apply_delta("cand", good)
        out[pkg] = (rep, rep2, reg.stats())
    (jrep, jrep2, jstats), (trep, trep2, tstats) = out[J], out[T]
    assert (trep.rolled_back, trep2.rolled_back) == (jrep.rolled_back, jrep2.rolled_back) == (
        True, False)
    assert trep.validation_metric == pytest.approx(jrep.validation_metric, abs=1e-6)
    assert trep.baseline_metric == pytest.approx(jrep.baseline_metric, abs=1e-6) == 1.0
    assert tstats == jstats


# ------------------------------------------------------------------- plane

def _plane(pkg, Reg, art, quota=None):
    scorer = _sharded(pkg, art)
    reg = pkg.VariantRegistry(scorer)
    reg.add_variant("cand")
    mreg = Reg()
    slos = pkg.build_tenant_slos(("alpha", "beta"), registry=mreg, latency_threshold_s=5.0)
    plane = pkg.RequestPlane(sample_rate=4, tenant_slos=slos)
    router = pkg.VariantRouter(seed=2)
    router.set_ramp("cand", 25.0)
    return pkg.TenancyPlane(reg, router=router, plane=plane, quota=quota,
                            metrics=pkg.ServingMetrics(), metrics_registry=mreg,
                            bucket_sizes=BUCKETS), scorer


def _keys(doc):
    if isinstance(doc, dict):
        return {k: _keys(v) for k, v in doc.items()}
    return None


@pytest.mark.parametrize("mode", ["submit", "drain"])
def test_tenancy_plane_status_and_sheds_equal_jax(pair, mode):
    ja, ta, jr, tr = pair
    out = {}
    for pkg, Reg, art, req in ((J, JReg, ja, jr), (T, TReg, ta, tr)):
        quota = pkg.TenantQuota({"alpha": pkg.TenantBudget(rate=1e-9, burst=5),
                                 "beta": pkg.TenantBudget(rate=1e-9, burst=100)},
                                clock=ManualClock(0.0))
        tenancy, scorer = _plane(pkg, Reg, art, quota)
        tenancy.quota_mode = mode
        stream = pkg.tag_requests(req[:30], "alpha") + pkg.tag_requests(req[30:], "beta")
        res = tenancy.replay(stream, poll_every=0)
        out[pkg] = (sorted(r.request_id for r in res), tenancy.status(), tenancy.plane)
    (jids, jdoc, jplane), (tids, tdoc, tplane) = out[J], out[T]
    assert tids == jids and len(tids) == 5 + len(tr) - 30
    assert _keys(tdoc) == _keys(jdoc)
    assert tdoc["router"] == jdoc["router"] and tdoc["quota"] == jdoc["quota"]
    assert tdoc["variants"] == jdoc["variants"]
    assert tplane.tenant_errors == jplane.tenant_errors
    assert tdoc["tenants"]["alpha"]["slo"]["verdict"].startswith("budget_exhausted")
    assert tdoc["tenants"]["beta"]["slo"]["verdict"] == "ok"


def test_lone_tenant_on_the_base_variant_is_bitwise_plain(pair):
    _, ta, _, tr = pair
    plain = _scores(_sharded(T, ta), tr)
    tenancy = T.TenancyPlane(T.VariantRegistry(_sharded(T, ta)), metrics=T.ServingMetrics(),
                             bucket_sizes=BUCKETS + (128,))
    out = tenancy.replay(T.tag_requests(tr, "solo"), poll_every=0)
    assert len(out) == len(tr)
    for r in out:
        assert r.score == plain[r.request_id.split("!", 1)[1]]
    with pytest.raises(ValueError, match="must not contain"):
        T.tag_requests(tr[:1], "bad!tenant")


# --------------------------------------------------------------- scenarios

def _phase_doc(phase):
    return ([(r.request_id, sorted(r.entity_ids.items()), r.offset,
              sorted((s, sorted(f.items())) for s, f in r.features.items()))
             for r in phase.requests],
            phase.pause_before_s, phase.swap, phase.ramp_percent, phase.nearline)


@pytest.mark.parametrize("name", T.SCENARIO_NAMES)
def test_build_scenario_streams_equal_jax(pair, name):
    _, _, jr, tr = pair
    assert T.SCENARIO_NAMES == J.SCENARIO_NAMES and T.TENANCY_SCENARIOS == J.TENANCY_SCENARIOS
    js = J.build_scenario(name, jr, seed=4, num_phases=6, pause_s=0.001)
    ts = T.build_scenario(name, tr, seed=4, num_phases=6, pause_s=0.001)
    assert (ts.name, ts.seed, ts.description, ts.tenants, ts.ramp_variant) == (
        js.name, js.seed, js.description, js.tenants, js.ramp_variant)
    assert ts.num_requests == js.num_requests
    assert [_phase_doc(p) for p in ts.phases] == [_phase_doc(p) for p in js.phases]


def _scenario_doc(pkg, Reg, I, art, req, name, watch):
    scorer = _sharded(pkg, art)
    reg = pkg.VariantRegistry(scorer)
    reg.add_variant("candidate")
    if name == "ramped_rollout":
        reg.apply_delta("candidate", I.build_delta(
            _re_updates(["u1", "u7"], art.tables[RE].dim), art, generation=1))
    mreg = Reg()
    slos = pkg.build_tenant_slos(pkg.DEFAULT_TENANTS, registry=mreg, latency_threshold_s=5.0)
    plane = pkg.RequestPlane(sample_rate=4, tenant_slos=slos)
    quota = None
    if name == "tenant_isolation":
        quota = pkg.TenantQuota({t: pkg.TenantBudget(rate=1e-9, burst=55)
                                 for t in pkg.DEFAULT_TENANTS}, clock=ManualClock(0.0))
    tenancy = pkg.TenancyPlane(reg, router=pkg.VariantRouter(seed=1), plane=plane, quota=quota,
                               metrics=pkg.ServingMetrics(), metrics_registry=mreg,
                               bucket_sizes=BUCKETS)
    nearline = None
    if name == "nearline_loop":
        tenancy.router.set_ramp("candidate", 50.0)
        nearline = pkg.make_nearline_fn(reg, ["candidate"], {RE: [f"u{i}" for i in range(16)]},
                                        rows_per_delta=4, seed=3, watch_dir=watch)
    scenario = pkg.build_scenario(name, req, seed=0, num_phases=6, pause_s=0.0)
    doc = pkg.run_scenario(scenario, [scorer], BUCKETS, pkg.ServingMetrics(), plane=plane,
                           tenancy=tenancy, nearline_fn=nearline)
    return doc, reg


@pytest.mark.parametrize("name", ["tenant_isolation", "ramped_rollout", "nearline_loop"])
def test_tenancy_scenarios_run_like_jax(pair, name):
    ja, ta, jr, tr = pair
    docs = {}
    for pkg, Reg, I, art, req in ((J, JReg, JI, ja, jr), (T, TReg, TI, ta, tr)):
        with tempfile.TemporaryDirectory() as watch:
            docs[pkg] = _scenario_doc(pkg, Reg, I, art, req, name, watch)
    (jdoc, jreg), (tdoc, treg) = docs[J], docs[T]
    assert sorted(tdoc) == sorted(jdoc)
    for key in ("name", "num_phases", "num_requests", "tenant_shed", "isolation_ok",
                "flooding_tenant", "flood_shed_ok"):
        assert tdoc.get(key) == jdoc.get(key), key
    assert {t: d["requests"] for t, d in tdoc["tenants"].items()} == {
        t: d["requests"] for t, d in jdoc["tenants"].items()}
    assert {t: d["slo_verdict"] for t, d in tdoc["tenants"].items()} == {
        t: d["slo_verdict"] for t, d in jdoc["tenants"].items()}
    if name == "tenant_isolation":
        assert tdoc["isolation_ok"] is True and tdoc["tenant_shed"]["alpha"] > 0
    if name == "ramped_rollout":
        assert tdoc["variant_shares"] == jdoc["variant_shares"]
        assert tdoc["variant_shares"]["candidate"] > 0.1
    if name == "nearline_loop":
        assert tdoc["nearline"]["deltas_applied"] > 0 and tdoc["nearline"]["rollbacks"] == 0
        st = treg.state("candidate")
        assert st.generation == tdoc["nearline"]["generations"]["candidate"]
        assert st.fingerprint is not None
    with pytest.raises(ValueError, match="tenancy"):
        T.run_scenario(T.build_scenario(name, tr[:24]), [_sharded(T, ta)], BUCKETS,
                       T.ServingMetrics())


def test_hot_swap_under_load_scenario_runs(pair):
    """A non-tenancy scenario with the row swapper running beside the
    continuous batcher: every request served, swaps recorded."""
    _, ta, _, tr = pair
    scorer = _sharded(T, ta)
    metrics = T.ServingMetrics()
    scenario = T.build_scenario("hot_swap_under_load", tr, seed=0, num_phases=4, pause_s=0.0)
    swap = make_row_swap_fn([scorer], metrics, rows_per_swap=4, seed=1)
    doc = T.run_scenario(scenario, [scorer], BUCKETS, metrics, swap_fn=swap,
                         swap_interval_s=0.001)
    assert doc["num_requests"] == len(tr) and doc["name"] == "hot_swap_under_load"
    assert metrics.current_generation >= 1

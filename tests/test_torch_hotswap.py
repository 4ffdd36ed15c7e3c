"""The nearline loop's serving half: the port's ``HotSwapManager``,
``CoordinatedHotSwap`` and ``DeltaWatcher`` against the JAX package's, on
one model fitted by the JAX package and both packages' artifacts of it.

- After the same delta, the port's single-table and sharded scorers serve
  the JAX scorer's post-swap scores (rtol 2e-4, atol 1e-5) with the same
  ``SwapReport`` fields; no score signature is added.
- A bad delta fails the AUC gate in both packages, with the same verdict;
  the rollback restores the port's scores and device tables bitwise.
- A cached scorer invalidates the same rows; a coordinated swap over two
  sharded replicas applies to both or rolls both back.
- ``poll_directory`` and the ``DeltaWatcher`` pick deltas up, retry a load
  at the armed ``serve.delta.load`` fault point and skip an unreadable
  delta while keeping the live generation, as the JAX package does.
"""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from _torch_nearline_parity import (
    DU,
    NEW,
    TOUCHED,
    UNTOUCHED,
    assert_scores_close,
    estimators,
    make_nearline,
    scores,
)
import photon_ml_tpu.incremental as JI
import photon_ml_tpu.resilience as jr
import photon_ml_tpu.serving as J
import photon_ml_tpu_torch.incremental as TI
import photon_ml_tpu_torch.resilience as tr
import photon_ml_tpu_torch.serving as T

REPORT_FIELDS = ("generation", "fingerprint", "coordinates", "rows_updated", "rolled_back",
                 "regrew", "compiles_added")


@pytest.fixture(autouse=True)
def _disarmed():
    for pkg in (tr, jr):
        pkg.configure_faults({})
        pkg.reset_faults()
        pkg.clear_failures()
    yield
    for pkg in (tr, jr):
        pkg.configure_faults({})
        pkg.reset_faults()
        pkg.clear_failures()


@pytest.fixture(scope="module")
def nl(tmp_path_factory):
    """The nearline set-up, one delta per package of the same numbers (the
    JAX update's re-solved rows), and each package's request stream."""
    root = tmp_path_factory.mktemp("hotswap")
    out = make_nearline(str(root))
    je, _ = estimators()
    ju = JI.incremental_update(je, out["jmodel"], out["jevents"], merge=False)
    fp = JI.fingerprint_dir(out["jdir"])
    for I, key, art in ((JI, "j", out["ja"]), (TI, "t", out["ta"])):
        d = str(root / f"{key}deltas" / I.delta_dir_name(1))
        out[f"{key}delta"] = I.save_delta(I.build_delta(
            ju.re_updates, art, base_fingerprint=fp, generation=1, created_at_unix=100.0), d)
        out[f"{key}delta_dir"] = d
        out[f"{key}deltas"] = str(root / f"{key}deltas")
    out["fp"] = fp
    out["jreq"] = J.requests_from_game_data(out["jevents"], out["ja"])
    out["treq"] = T.requests_from_game_data(out["tevents"], out["ta"])
    out["nnz"] = T.max_nnz_of(out["treq"])
    labels = out["event_rows"][0]
    out["labels"] = np.asarray(labels > np.median(labels), dtype=np.float32)
    return out


def _scorers(nl, kind: str, **kw):
    """(JAX scorer, port scorer) of the base artifacts."""
    if kind == "sharded":
        return (J.ShardedGameScorer(nl["ja"], max_nnz=nl["nnz"], num_shards=4, **kw),
                T.ShardedGameScorer(nl["ta"], max_nnz=nl["nnz"], num_shards=4, device="cpu",
                                    **kw))
    return (J.GameScorer(nl["ja"], max_nnz=nl["nnz"], growth_headroom=True, **kw),
            T.GameScorer(nl["ta"], max_nnz=nl["nnz"], growth_headroom=True, device="cpu", **kw))


def _tables(scorer) -> dict:
    """Every device table of a port scorer, copied to the host."""
    out = {cid: w.clone() for cid, w in scorer._fe_params.items()}
    for cid, p in scorer._providers.items():
        for i, t in enumerate(getattr(p, "_tables", [p.table])):
            out[f"{cid}/{i}"] = t.clone()
    return out


def _bitwise(a: dict, b: dict) -> bool:
    return sorted(a) == sorted(b) and all(
        a[k].shape == b[k].shape and torch.equal(a[k].view(torch.int32), b[k].view(torch.int32))
        for k in a)


@pytest.mark.parametrize("kind", ["full", "sharded"])
def test_swap_serves_jax_scores(nl, kind):
    js, ts = _scorers(nl, kind)
    jbefore, tbefore = scores(js, nl["jreq"]), scores(ts, nl["treq"])
    assert_scores_close(tbefore, jbefore)
    compiles = ts.compile_count
    jm = J.HotSwapManager(js, fingerprint=nl["fp"])
    tm = T.HotSwapManager(ts, fingerprint=nl["fp"])
    jrep, trep = jm.apply_delta(nl["jdelta_dir"]), tm.apply_delta(nl["tdelta_dir"])
    for f in REPORT_FIELDS:
        assert getattr(trep, f) == getattr(jrep, f), f
    assert trep.generation == tm.generation == 1 and trep.regrew == ()
    assert trep.fingerprint == nl["tdelta"].fingerprint == nl["jdelta"].fingerprint
    assert trep.staleness_s is not None and trep.blackout_s >= 0.0
    jafter, tafter = scores(js, nl["jreq"]), scores(ts, nl["treq"])
    assert_scores_close(tafter, jafter)
    assert ts.compile_count == compiles
    by_user = {r.request_id: r.entity_ids["userId"] for r in nl["treq"]}
    moved = {by_user[k] for k in tbefore if tbefore[k] != tafter[k]}
    assert moved and moved <= set(TOUCHED + NEW) and moved & set(NEW)
    assert not moved & set(UNTOUCHED)


def _garbage(nl):
    rows = np.full((len(TOUCHED), DU), -50.0, np.float32)
    kw = dict(base_fingerprint=nl["fp"], generation=1, re_rows={"per_user": (list(TOUCHED), rows)},
              fe_updates={}, created_at_unix=0.0, fingerprint="bad0" * 4)
    return JI.DeltaArtifact(**kw), TI.DeltaArtifact(**kw)


@pytest.mark.parametrize("kind", ["full", "sharded"])
def test_gate_rejects_and_rollback_is_bitwise(nl, kind):
    js, ts = _scorers(nl, kind)
    jgate = J.ValidationGate(nl["jreq"], nl["labels"], max_auc_regression=0.05, bucket_size=16)
    tgate = T.ValidationGate(nl["treq"], nl["labels"], max_auc_regression=0.05, bucket_size=16)
    jm = J.HotSwapManager(js, fingerprint=nl["fp"], gate=jgate)
    tm = T.HotSwapManager(ts, fingerprint=nl["fp"], gate=tgate)
    before, tables = scores(ts, nl["treq"]), _tables(ts)
    compiles = ts.compile_count
    jbad, tbad = _garbage(nl)
    jrep, trep = jm.apply_delta(jbad), tm.apply_delta(tbad)
    assert trep.rolled_back and jrep.rolled_back
    for f in REPORT_FIELDS:
        assert getattr(trep, f) == getattr(jrep, f), f
    assert trep.validation_metric == pytest.approx(jrep.validation_metric, abs=1e-6)
    assert trep.baseline_metric == pytest.approx(jrep.baseline_metric, abs=1e-6)
    assert trep.validation_metric < trep.baseline_metric - 0.05
    assert (tm.generation, tm.fingerprint) == (jm.generation, jm.fingerprint) == (0, nl["fp"])
    assert scores(ts, nl["treq"]) == before
    assert _bitwise(_tables(ts), tables)
    assert ts.compile_count == compiles
    with pytest.raises(ValueError, match="no previous generation"):
        tm.rollback()
    # a good delta passes the same gate in both packages, then rolls back
    jrep, trep = jm.apply_delta(nl["jdelta_dir"]), tm.apply_delta(nl["tdelta_dir"])
    assert not trep.rolled_back and not jrep.rolled_back and tm.generation == 1
    assert trep.validation_metric == pytest.approx(jrep.validation_metric, abs=1e-6)
    tm.rollback()
    assert (tm.generation, tm.fingerprint) == (0, nl["fp"])
    assert scores(ts, nl["treq"]) == before
    assert _bitwise(_tables(ts), tables)


def test_swap_invalidates_the_same_cache_rows(nl):
    js, ts = _scorers(nl, "full", cache_capacity=16)
    scores(js, nl["jreq"]), scores(ts, nl["treq"])
    jc, tc = js.caches["per_user"], ts.caches["per_user"]
    assert sorted(tc.cached_entities()) == sorted(jc.cached_entities())
    J.HotSwapManager(js).apply_delta(nl["jdelta_dir"])
    T.HotSwapManager(ts).apply_delta(nl["tdelta_dir"])
    assert sorted(tc.cached_entities()) == sorted(jc.cached_entities())
    rows = {nl["ta"].tables["per_user"].entity_index.get_index(e) for e in TOUCHED}
    assert not set(tc.cached_entities()) & rows
    assert_scores_close(scores(ts, nl["treq"]), scores(js, nl["jreq"]))


def _replicas(pkg, nl, n=2):
    art = nl["ja"] if pkg is J else nl["ta"]
    kw = {} if pkg is J else {"device": "cpu"}
    first = pkg.ShardedGameScorer(art, max_nnz=nl["nnz"], num_shards=4, **kw)
    out = [first] + [pkg.ShardedGameScorer(art, max_nnz=nl["nnz"], num_shards=4,
                                           routing=first.routing, **kw) for _ in range(n - 1)]
    for s in out:
        s.set_replica_group(out)
    return out


def test_coordinated_swap_over_replicas(nl):
    jrs, trs = _replicas(J, nl), _replicas(T, nl)
    tgate = T.ValidationGate(nl["treq"], nl["labels"], max_auc_regression=0.05, bucket_size=16)
    jgate = J.ValidationGate(nl["jreq"], nl["labels"], max_auc_regression=0.05, bucket_size=16)
    jc = J.CoordinatedHotSwap([J.HotSwapManager(s, fingerprint=nl["fp"], gate=jgate) for s in jrs])
    tc = T.CoordinatedHotSwap([T.HotSwapManager(s, fingerprint=nl["fp"], gate=tgate) for s in trs])
    before = [scores(s, nl["treq"]) for s in trs]
    jbad, tbad = _garbage(nl)
    treps, jreps = tc.apply_delta(tbad), jc.apply_delta(jbad)
    assert [r.rolled_back for r in treps] == [r.rolled_back for r in jreps] == [True]
    assert tc.generation == 0 and [scores(s, nl["treq"]) for s in trs] == before
    treps = tc.poll_directory(nl["tdeltas"])
    jreps = jc.poll_directory(nl["jdeltas"])
    assert [(r.generation, r.rolled_back) for r in treps] == [
        (r.generation, r.rolled_back) for r in jreps] == [(1, False), (1, False)]
    assert [m.generation for m in tc.managers] == [1, 1]
    want = scores(jrs[0], nl["jreq"])
    for s in trs:
        assert_scores_close(scores(s, nl["treq"]), want)
    assert tc.poll_directory(nl["tdeltas"]) == [] and jc.poll_directory(nl["jdeltas"]) == []


def test_poll_directory_retries_an_armed_load_fault(nl):
    got = {}
    for pkg, res, key in ((J, jr, "j"), (T, tr, "t")):
        scorer = _scorers(nl, "full")[0 if pkg is J else 1]
        mgr = pkg.HotSwapManager(scorer, fingerprint=nl["fp"])
        res.configure_faults("serve.delta.load=once:1")
        reps = mgr.poll_directory(nl[f"{key}deltas"])
        stats = res.fault_stats()["serve.delta.load"]
        # a load that keeps failing is skipped and left unprocessed
        mgr2 = pkg.HotSwapManager(scorer, fingerprint=nl["fp"])
        res.configure_faults("serve.delta.load=every:1")
        skipped = mgr2.poll_directory(nl[f"{key}deltas"])
        kinds = sorted({f["kind"] for f in res.recent_failures()})
        res.configure_faults({})
        again = mgr2.poll_directory(nl[f"{key}deltas"])
        got[key] = ([r.generation for r in reps], mgr.delta_load_failures, stats, skipped,
                    mgr2.delta_load_failures, kinds, [r.generation for r in again])
    assert got["t"] == got["j"]
    assert got["t"][:2] == ([1], 0) and got["t"][2]["trips"] == 1
    assert got["t"][3:] == ([], 1, ["delta_load_failed", "retry_exhausted"], [1])


def test_unreadable_delta_keeps_the_generation_and_the_next_applies(nl, tmp_path):
    for pkg, I, key in ((J, JI, "j"), (T, TI, "t")):
        watch = str(tmp_path / key)
        bad = os.path.join(watch, I.delta_dir_name(1))
        os.makedirs(bad)
        with open(os.path.join(bad, I.DELTA_MANIFEST_FILE), "w") as f:
            f.write("{not json")
        scorer = _scorers(nl, "full")[0 if pkg is J else 1]
        mgr = pkg.HotSwapManager(scorer)
        d = nl[f"{key}delta"]
        good = I.save_delta(dataclasses.replace(d, base_fingerprint=None, generation=2),
                            os.path.join(watch, I.delta_dir_name(2)))
        reps = mgr.poll_directory(watch)
        assert [r.generation for r in reps] == [1] and mgr.fingerprint == good.fingerprint
        assert mgr.delta_load_failures >= 1
        # the good delta is processed; the bad path is retried next poll
        assert mgr.poll_directory(watch) == [] and mgr.delta_load_failures >= 2


def test_delta_watcher_polls_and_applies(nl, tmp_path):
    _, ts = _scorers(nl, "full")
    mgr = T.HotSwapManager(ts, fingerprint=nl["fp"])
    watch = str(tmp_path / "watch")
    os.makedirs(watch)
    w = T.DeltaWatcher(mgr, watch, interval_s=0.001)
    assert w.poll_now() == [] and w.stats()["polls"] == 1
    assert w.health() == {"healthy": True, "name": "serving-deltawatch", "running": False}
    w.start()
    try:
        with pytest.raises(RuntimeError, match="already running"):
            w.start()
        TI.save_delta(nl["tdelta"], os.path.join(watch, TI.delta_dir_name(1)))
        deadline = time.monotonic() + 60
        while mgr.generation == 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert w.stats()["running"] and w.health()["healthy"]
    finally:
        w.stop()
    assert mgr.generation == 1 and w.swaps == 1
    assert [r.generation for r in w.drain_reports()] == [1] and w.drain_reports() == []
    with pytest.raises(TypeError, match="poll_directory"):
        T.DeltaWatcher(object(), watch)


def test_replay_with_watch_dir_matches_jax(nl, tmp_path):
    """The serve_game --watch-deltas plumbing: replay polls the watch dir
    every 8 requests; the delta published before the second replay lands
    at its first poll, in both packages, with the same scores after."""
    out = {}
    for pkg, I, key in ((J, JI, "j"), (T, TI, "t")):
        watch = str(tmp_path / key)
        os.makedirs(watch)
        scorer = _scorers(nl, "full")[0 if pkg is J else 1]
        mgr = pkg.HotSwapManager(scorer, fingerprint=nl["fp"])
        req = nl[f"{key}req"]
        _, snap0 = pkg.replay_requests(scorer, req, bucket_sizes=(16,), swap_manager=mgr,
                                       watch_dir=watch, poll_every=8)
        assert snap0["swap_reports"] == []
        I.save_delta(nl[f"{key}delta"], os.path.join(watch, I.delta_dir_name(1)))
        res, snap1 = pkg.replay_requests(scorer, req, bucket_sizes=(16,), swap_manager=mgr,
                                         watch_dir=watch, poll_every=8)
        out[key] = ([(r["generation"], r["rolled_back"], r["rows_updated"])
                     for r in snap1["swap_reports"]], {r.request_id: r.score for r in res},
                    scorer.compile_count)
    assert out["t"][0] == out["j"][0] == [(1, False, len(TOUCHED + NEW))]
    assert out["t"][2] == out["j"][2]
    assert_scores_close(out["t"][1], out["j"][1])


def test_swap_and_rollback_on_a_split_table_are_the_one_table_scorers_bitwise(nl):
    """On a serving mesh of 4 positions each RE table of 4 shards splits
    into 4 blocks; a swap and a gated rollback serve bitwise the scores of
    the one-table scorers, and the rollback restores the blocks' bytes."""
    split = T.ShardedGameScorer(nl["ta"], max_nnz=nl["nnz"], num_shards=4, device="cpu",
                                mesh=T.serving_mesh(4, device="cpu"))
    whole = T.ShardedGameScorer(nl["ta"], max_nnz=nl["nnz"], num_shards=4, device="cpu")
    single = T.GameScorer(nl["ta"], max_nnz=nl["nnz"], growth_headroom=True, device="cpu")
    assert all(p.split for p in split._providers.values())

    def blocks(scorer):
        return {f"{cid}/{i}": torch.cat(t.blocks) for cid, p in scorer._providers.items()
                for i, t in enumerate(p._tables)}

    for s in (split, whole, single):
        T.HotSwapManager(s, fingerprint=nl["fp"]).apply_delta(nl["tdelta_dir"])
    swapped = scores(split, nl["treq"])
    assert swapped == scores(whole, nl["treq"]) == scores(single, nl["treq"])
    before = blocks(split)
    _, tbad = _garbage(nl)
    for s in (split, whole):
        gate = T.ValidationGate(nl["treq"], nl["labels"], max_auc_regression=0.05,
                                bucket_size=16)
        m = T.HotSwapManager(s, fingerprint=nl["fp"], gate=gate)
        assert m.apply_delta(tbad).rolled_back
    assert scores(split, nl["treq"]) == swapped == scores(whole, nl["treq"])
    assert _bitwise(blocks(split), before)
    assert _bitwise(blocks(split), {k: t.clone() for k, t in _tables(whole).items()
                                    if "/" in k})

"""The port's admission tier, continuous batcher and replay against the JAX
package's, and their supervised restarts.

- The same deferred rows are queued, deduplicated, dropped, requeued and
  admitted in the same order as in the JAX package; after ``drain()`` the
  routing and the statistics are equal, and a replay scores every known
  entity with its row.
- With hand-driven clocks the continuous batcher drains a partial bucket
  only once its deadline has passed on the clock, a full bucket at once,
  and forms the same batches as the JAX package's.
- A crash of the admission step or of a batcher worker, armed only after a
  first admitted step or scored batch, is restarted by its supervisor and
  the outputs stay right. Every thread a test starts is stopped and joined
  with a timeout.
"""

import threading
import time

import numpy as np
import pytest

from _torch_serving_parity import ManualClock, assert_results_close, serving_pair
from test_torch_serving_sharded import _requests, _sharded
import photon_ml_tpu.serving as J
import photon_ml_tpu_torch.serving as T
from photon_ml_tpu_torch.resilience import faultpoints
from photon_ml_tpu_torch.resilience.faultpoints import configure_faults


@pytest.fixture(autouse=True)
def _no_faults():
    configure_faults({})
    yield
    configure_faults({})


def _pair(pkg, budget=12, admit_batch=4, headroom=0.25, **kw):
    scorer = _sharded(pkg, num_shards=2, device_budget_rows=budget,
                      headroom_fraction=headroom)
    adm = pkg.AdmissionController(scorer, admit_batch=admit_batch, **kw)
    scorer.attach_admission(adm)
    return scorer, adm


def test_fault_sites_registered_under_the_reference_names():
    sites = faultpoints.registered_fault_sites()
    assert "serve.admission.step" in sites and "serve.admission.stage" in sites


def test_queueing_decisions_equal_jax():
    out = {}
    for pkg in (J, T):
        scorer, adm = _pair(pkg, max_queue=6)
        adm.note_deferred("per_user", np.array([30, 31, 30, 32]))
        adm.note_deferred("per_user", np.array([33, 34, 35, 36, 37, 31]))
        depth = adm.queue_depth
        first = adm.step()
        adm._requeue("per_user", np.array([38, 39]))
        order = list(adm._queues["per_user"])
        total = adm.drain()
        out[pkg] = (depth, first, order, total, adm.stats(),
                    scorer.routing.stats(), scorer.routing["per_user"]._slot_of.tolist())
    for a, b in zip(out[T], out[J]):
        assert a == b


def test_drained_admission_serves_every_known_entity_with_its_row():
    # 12 entities: 9 resident at start, the 3 others fill the headroom
    treq = _requests(T, 32, n_ent=12, seed=3)
    scorer, adm = _pair(T)
    full = _sharded(T, num_shards=2)
    first = scorer.score_batch(treq, bucket_size=32)
    assert any(r.cold_coordinates for r in first)
    adm.drain()
    jscorer, jadm = _pair(J)
    jscorer.score_batch(_requests(J, 32, n_ent=12, seed=3), bucket_size=32)
    jadm.drain()
    assert adm.stats() == jadm.stats()
    # what was deferred is resident now; a second pass over the same rows
    # equals full residency
    again = scorer.score_batch(treq, bucket_size=32)
    want = full.score_batch(treq, bucket_size=32)
    assert [r.score for r in again] == [r.score for r in want]
    assert not any(r.cold_coordinates for r in again)


def test_warmup_writes_only_the_cold_slot():
    scorer, adm = _pair(T)
    before = [t.clone() for t in scorer._providers["per_user"]._tables]
    adm.warmup()
    for a, b in zip(scorer._providers["per_user"]._tables, before):
        assert bool((a == b).all())


def test_stage_fault_is_retried_in_place():
    scorer, adm = _pair(T, budget=32, headroom=0.5)
    configure_faults("serve.admission.stage=once:1")
    adm.note_deferred("per_user", np.arange(30, 34))
    assert adm.step() == 4
    assert adm.stats()["admit_failures"] == 0


def test_admission_thread_restarts_after_a_step_crash():
    scorer, adm = _pair(T, budget=32, headroom=0.5)
    adm.note_deferred("per_user", np.arange(30, 34))
    assert adm.step() == 4  # a first admitted step, then the fault is armed
    configure_faults("serve.admission.step=once:1")
    adm.note_deferred("per_user", np.arange(34, 40))
    adm.start(interval_s=0.001)
    try:
        deadline = time.monotonic() + 30
        while adm.admitted_total < 10 and time.monotonic() < deadline:
            time.sleep(0.005)
        stats = adm.stats()  # while the supervised thread still reports
    finally:
        adm.stop()
    assert adm._thread is None
    assert adm.queue_depth == 0 and stats["admitted_total"] == 10
    assert stats["thread_crashes"] == 1 and stats["thread_restarts"] == 1
    assert not stats["thread_dead"] and adm.health()["healthy"]
    slots = scorer.routing["per_user"]._slot_of
    assert (slots[30:40] >= 0).all()


# ------------------------------------------------------ continuous batcher


def _wait_until(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.002)
    return cond()


def test_deadline_fires_on_the_hand_clock_only():
    out = {}
    for pkg in (J, T):
        scorer = _sharded(pkg, num_shards=2)
        clock = ManualClock()
        metrics = pkg.ServingMetrics(clock=clock)
        batcher = pkg.ContinuousBatcher(scorer, bucket_sizes=(2, 4, 8), metrics=metrics,
                                        max_wait_s=0.01, clock=clock).start()
        try:
            reqs = _requests(pkg, 11, seed=8)
            full = batcher.submit_many(reqs[:8])  # a full bucket: no deadline
            assert _wait_until(lambda: all(h.done for h in full))
            part = batcher.submit_many(reqs[8:])
            time.sleep(0.05)  # many real deadlines, none on the clock
            assert not any(h.done for h in part)
            clock.advance(0.02)
            assert _wait_until(lambda: all(h.done for h in part))
            results = [h.result(timeout=0) for h in full + part]
            snap = metrics.snapshot()
        finally:
            batcher.stop()
        assert all(not t.is_alive() for t in batcher._threads)
        out[pkg] = (results, snap["num_batches"], snap["batch_fill_ratio"],
                    snap["latency_p99_s"], snap["queue_wait_p50_s"])
    assert_results_close(out[T][0], out[J][0])
    assert out[T][1:] == out[J][1:] == (2, pytest.approx(11 / 12), 0.02, 0.0)


def test_backpressure_and_stop_resolve_every_handle():
    scorer = _sharded(T, num_shards=2)
    clock = ManualClock()
    batcher = T.ContinuousBatcher(scorer, bucket_sizes=(4,), max_wait_s=1.0,
                                  max_queue=4, clock=clock).start()
    reqs = _requests(T, 3, seed=1)
    try:
        handles = batcher.submit_many(reqs)
        assert batcher.queue_depth == 3
    finally:
        batcher.stop()
    assert all(h.done for h in handles)
    with pytest.raises(RuntimeError, match="stopped before scoring"):
        handles[0].result(timeout=0)
    with pytest.raises(RuntimeError, match="not running"):
        batcher.submit(reqs[0])
    with pytest.raises(ValueError, match="max_queue"):
        T.ContinuousBatcher(scorer, bucket_sizes=(8,), max_queue=4)


def test_worker_crash_after_a_first_batch_restarts_and_scores_right():
    scorer = _sharded(T, num_shards=2)
    clock = ManualClock()
    batcher = T.ContinuousBatcher(scorer, bucket_sizes=(2, 4), max_wait_s=0.01,
                                  clock=clock)
    state = {"armed": False}

    def bomb_clock():
        if state["armed"] and threading.current_thread().name.startswith("serving-batcher"):
            state["armed"] = False
            raise RuntimeError("loop exploded")
        return clock()

    batcher._clock = bomb_clock
    batcher.start(max_restarts=3)
    reqs = _requests(T, 12, seed=4)
    try:
        first = batcher.submit_many(reqs[:4])  # a full bucket
        assert [h.result(timeout=30).score for h in first] == [
            r.score for r in scorer.score_batch(reqs[:4], bucket_size=4)]
        state["armed"] = True
        rest = batcher.submit_many(reqs[4:])
        clock.advance(1.0)
        got = [h.result(timeout=30).score for h in rest]
        stats = batcher.thread_stats()
        healthy = batcher.health()["healthy"]
    finally:
        batcher.stop()
    assert not state["armed"] and sum(s["crashes"] for s in stats) == 1
    assert sum(s["restarts"] for s in stats) == 1 and healthy
    want = [r.score for r in scorer.score_batch(reqs[4:8], bucket_size=4)
            + scorer.score_batch(reqs[8:], bucket_size=4)]
    assert got == want


@pytest.mark.parametrize("continuous", [False, True])
def test_replay_snapshot_keys_and_counts_equal_jax(continuous):
    """Replays with the admission thread running: which rows it has placed
    by each batch depends on thread timing, so scores are held to what each
    result's cold coordinates say (the same request with those entities
    absent, scored on full tables) and only keys and counts to the JAX
    package's."""
    ja, ta, jr, tr = serving_pair(seed=5, n=40)
    out = {}
    for pkg, art, reqs in ((J, ja, jr), (T, ta, tr)):
        kw = {"device": "cpu"} if pkg is T else {}
        scorer = pkg.ShardedGameScorer(art, num_shards=2, device_budget_rows=10, **kw)
        adm = pkg.AdmissionController(scorer, admit_batch=4)
        scorer.attach_admission(adm)
        adm.warmup()
        res, snap = pkg.replay_requests(scorer, reqs, bucket_sizes=(1, 4, 8),
                                        continuous=continuous, admission=adm)
        assert adm._thread is None  # started and stopped by the replay
        out[pkg] = (res, snap)
    (tres, tsnap), (jres, jsnap) = out[T], out[J]
    assert sorted(tsnap) == sorted(jsnap)
    for key in ("num_requests", "xla_compiles"):
        assert tsnap[key] == jsnap[key]
    assert sorted(tsnap["admission"]) == sorted(jsnap["admission"])
    assert [r.request_id for r in tres] == [r.request_id for r in jres]
    re_type = {cid: t.random_effect_type for cid, t in ta.tables.items()}
    as_served = [
        T.ScoreRequest(q.request_id, q.features,
                       {k: v for k, v in q.entity_ids.items()
                        if k not in {re_type[c] for c in r.cold_coordinates}},
                       q.offset)
        for q, r in zip(tr, tres)
    ]
    want = T.GameScorer(ta, device="cpu").score_batch(as_served)
    np.testing.assert_allclose([r.score for r in tres], [w.score for w in want],
                               rtol=2e-4, atol=1e-6)

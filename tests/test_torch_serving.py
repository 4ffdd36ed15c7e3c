"""The port's single-table scorer, hot-entity cache, sealed batcher, metrics
and replay against the JAX package's, on the same artifact and requests.

- Request streams built from one dataset are equal; scores and means of
  the same requests are within atol 1e-6, rtol 2e-4 of the JAX
  ``GameScorer``'s, with the same FE-only cold coordinates.
- ``compile_count`` equals the JAX scorer's over the same bucket sequence,
  rebinds included.
- The cached path equals the full-table path bitwise; full-table headroom
  takes appends in place; ``HotEntityCache`` placement and statistics
  equal the JAX cache's over one lookup sequence.
- The sealed ``MicroBatcher`` with a hand-driven clock forms the same
  batches; replay snapshots have the same keys and counts.
"""

import numpy as np
import pytest
import torch

from _torch_serving_parity import ManualClock, assert_results_close, serving_pair
import photon_ml_tpu.serving as J
import photon_ml_tpu_torch.serving as T
from photon_ml_tpu_torch.serving.scorer import _FullTable


@pytest.fixture(scope="module")
def pair():
    return serving_pair(seed=1)


def test_requests_from_game_data_equal_jax(pair):
    _, _, jr, tr = pair
    assert len(tr) == len(jr) > 0
    for a, b in zip(tr, jr):
        assert (a.request_id, a.features, a.entity_ids, a.offset) == (
            b.request_id, b.features, b.entity_ids, b.offset)
    assert T.max_nnz_of(tr) == J.replay.max_nnz_of(jr)
    assert T.max_nnz_of(tr, round_pow2=False) == J.replay.max_nnz_of(jr, round_pow2=False)


@pytest.mark.parametrize("buckets", [(1,), (1, 2, 4, 8), (3, 8)])
def test_scores_match_jax_game_scorer(pair, buckets):
    ja, ta, jr, tr = pair
    jres, jsnap = J.replay_requests(J.GameScorer(ja), jr, bucket_sizes=buckets)
    scorer = T.GameScorer(ta, max_nnz=T.max_nnz_of(tr), device="cpu")
    tres, tsnap = T.replay_requests(scorer, tr, bucket_sizes=buckets)
    assert_results_close(tres, jres)
    assert any(r.cold_coordinates for r in tres)  # unseen entities present
    assert tsnap["num_requests"] == jsnap["num_requests"] == len(tr)
    assert tsnap["num_batches"] == jsnap["num_batches"]
    assert tsnap["xla_compiles"] == jsnap["xla_compiles"]
    assert sorted(tsnap) == sorted(jsnap)


def test_unknown_and_missing_entities_score_fe_only(pair):
    _, ta, _, _ = pair
    scorer = T.GameScorer(ta, device="cpu")
    fe = np.asarray(ta.tables["fixed"].weights)
    reqs = [
        T.ScoreRequest("ghost", {"global": {1: 2.0}, "per_user": {0: 1.0}},
                       {"userId": "ghost", "itemId": "ghost2"}),
        T.ScoreRequest("no-ids", {"global": {3: -1.0}, "per_item": {2: 5.0}}),
        T.ScoreRequest("int-id", {"global": {0: 1.0}}, {"userId": 999}, offset=0.5),
    ]
    out = scorer.score_batch(reqs, bucket_size=4)
    assert out[0].score == pytest.approx(2.0 * fe[1], abs=1e-6)
    assert out[1].score == pytest.approx(-fe[3], abs=1e-6)
    assert out[2].score == pytest.approx(fe[0] + 0.5, abs=1e-6)
    for r in out:
        assert r.cold_coordinates == ("per_itemId", "per_userId")
    assert out[0].mean == pytest.approx(1 / (1 + np.exp(-out[0].score)), abs=1e-6)


def test_compile_count_equals_jax_over_a_bucket_sequence(pair):
    ja, ta, jr, tr = pair
    js = J.GameScorer(ja, growth_headroom=True)
    ts = T.GameScorer(ta, growth_headroom=True, device="cpu")
    counts = []
    for stream, buckets in ((slice(0, 19), (4, 8)), (slice(19, 24), (4, 8)),
                            (slice(0, 30), (2, 16))):
        J.replay_requests(js, jr[stream], bucket_sizes=buckets)
        T.replay_requests(ts, tr[stream], bucket_sizes=buckets)
        counts.append((ts.compile_count, js.compile_count))
    for s in (slice(0, 2), slice(5, 7)):
        js.score_batch(jr[s], bucket_size=2)
        ts.score_batch(tr[s], bucket_size=2)
        counts.append((ts.compile_count, js.compile_count))
    # a rebind inside the padding bucket keeps the shape, one past it does not
    w = np.asarray(ta.tables["per_userId"].weights)
    for rows in (w.shape[0] + 1, 4 * w.shape[0]):
        grown = np.zeros((rows, w.shape[1]), np.float32)
        grown[: w.shape[0]] = w
        assert ts.rebind_random_effect("per_userId", grown) == js.rebind_random_effect(
            "per_userId", grown)
        js.score_batch(jr[:2], bucket_size=2)
        ts.score_batch(tr[:2], bucket_size=2)
        counts.append((ts.compile_count, js.compile_count))
    assert [t for t, _ in counts] == [j for _, j in counts]
    assert counts[-1][0] > counts[0][0] > 0


def test_cached_path_equals_full_table_bitwise(pair):
    _, ta, _, tr = pair
    full, _ = T.replay_requests(T.GameScorer(ta, device="cpu"), tr, bucket_sizes=(4,))
    cached_scorer = T.GameScorer(ta, cache_capacity=4, device="cpu")
    cached, snap = T.replay_requests(cached_scorer, tr, bucket_sizes=(4,))
    assert [r.score for r in cached] == [r.score for r in full]
    assert [r.mean for r in cached] == [r.mean for r in full]
    stats = snap["caches"]["per_userId"]
    assert stats["hits"] + stats["misses"] + stats["cold_lookups"] == len(tr)
    assert stats["evictions"] > 0
    with pytest.raises(ValueError, match="max bucket"):
        T.MicroBatcher(cached_scorer, bucket_sizes=(8,))


def test_cache_stats_equal_jax_over_one_lookup_sequence():
    rng = np.random.default_rng(0)
    backing = rng.standard_normal((12, 3)).astype(np.float32)
    jc = J.HotEntityCache(backing, capacity=4)
    tc = T.HotEntityCache(backing, capacity=4, device="cpu")
    for _ in range(30):
        rows = rng.integers(-2, 12, size=rng.integers(1, 5))
        rows = np.unique(rows)[:4] if len(set(rows[rows >= 0])) > 4 else rows
        np.testing.assert_array_equal(tc.lookup(rows), jc.lookup(rows))
        assert tc.stats() == jc.stats()
        assert tc.cached_entities() == jc.cached_entities()
    np.testing.assert_array_equal(tc.table.numpy(), np.asarray(jc.table))
    assert tc.table[tc.cold_slot].abs().sum() == 0
    assert tc.invalidate([tc.cached_entities()[0], 11, 11]) == jc.invalidate(
        [jc.cached_entities()[0], 11, 11])
    assert tc.rebind(backing[:6]) == jc.rebind(backing[:6])
    assert tc.stats() == jc.stats()
    with pytest.raises(RuntimeError, match="capacity"):
        tc.lookup(np.arange(5))
    assert T.HotEntityCache(backing, 2, device="cpu").stats()["hit_rate"] == 0.0


def test_full_table_headroom_takes_writes_in_place(pair):
    backing = np.arange(12, dtype=np.float32).reshape(6, 2)
    table = _FullTable(backing, pad_rows=8, device="cpu")
    assert table.capacity == table.cold_slot == 8 and tuple(table.table.shape) == (9, 2)
    ptr = table.table.data_ptr()
    table.update_rows(np.array([6, 2, 6]), np.array([[5.0, 7.0], [0.0, 1.0], [3.0, 4.0]]))
    dev = table.table.numpy()
    np.testing.assert_array_equal(dev[6], [3.0, 4.0])  # last write wins
    np.testing.assert_array_equal(dev[2], [0.0, 1.0])
    np.testing.assert_array_equal(dev[7:], 0.0)
    assert table.num_rows == 7 and table.table.data_ptr() == ptr
    with pytest.raises(ValueError, match="capacity"):
        table.update_rows(np.array([8]), np.array([[1.0, 1.0]]))

    # a scorer with headroom serves a row update with no new signature
    ja, ta, _, _ = pair
    for scorer, pkg in ((T.GameScorer(ta, growth_headroom=True, device="cpu"), T),
                        (J.GameScorer(ja, growth_headroom=True), J)):
        req = pkg.ScoreRequest("new", {"global": {0: 1.0}, "per_user": {0: 2.0}},
                               {"userId": "u0"})
        before = scorer.score_batch([req], bucket_size=1)[0].score
        warm = scorer.compile_count
        row = scorer.artifact.entity_row("per_userId", "u0")
        scorer.update_random_effect_rows("per_userId", np.array([row]),
                                         np.full((1, 12), 0.25, np.float32))
        after = scorer.score_batch([req], bucket_size=1)[0].score
        assert scorer.compile_count == warm
        assert after == pytest.approx(before - 2.0 * np.asarray(
            ta.tables["per_userId"].weights)[row, 0] + 0.5, abs=1e-5)


def test_fixed_effect_update_and_structure_checks(pair):
    ja, ta, _, tr = pair
    ts = T.GameScorer(ta, device="cpu")
    before = ts.score_batch(tr[:4])
    ts.update_fixed_effect("fixed", np.zeros(16, np.float32))
    after = ts.score_batch(tr[:4])
    assert all(a.score != b.score for a, b in zip(after, before))
    with pytest.raises(ValueError, match="shape"):
        ts.update_fixed_effect("fixed", np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="not a fixed-effect"):
        ts.update_fixed_effect("per_userId", np.zeros(16, np.float32))
    bad = T.ServingArtifact(ta.task, {"fixed": ta.tables["fixed"]})
    with pytest.raises(ValueError, match="coordinate structure"):
        ts.set_artifact(bad)
    ts.set_artifact(ta)
    cached = T.GameScorer(ta, cache_capacity=8, device="cpu")
    with pytest.raises(ValueError, match="cache-backed"):
        cached.update_random_effect_rows("per_userId", np.array([0]), np.zeros((1, 12)))


def test_sealed_batcher_deadline_with_a_hand_clock_equals_jax(pair):
    ja, ta, jr, tr = pair
    out = {}
    for pkg, art, reqs in ((J, ja, jr), (T, ta, tr)):
        scorer = (pkg.GameScorer(art) if pkg is J else pkg.GameScorer(art, device="cpu"))
        clock = ManualClock()
        metrics = pkg.ServingMetrics(clock=clock)
        b = pkg.MicroBatcher(scorer, bucket_sizes=(2, 4), metrics=metrics,
                             clock=clock, max_wait_s=0.005)
        trace = []
        for i, r in enumerate(reqs[:13]):
            trace.append(len(b.submit(r)))
            clock.advance(0.002 if i % 3 else 0.004)
            trace.append(len(b.poll()))
        trace.append(len(b.flush()))
        snap = metrics.snapshot()
        out[pkg] = (trace, snap["num_batches"], snap["batch_fill_ratio"],
                    snap["latency_p50_s"], snap["queue_wait_p99_s"])
    assert out[T] == out[J]
    with pytest.raises(ValueError, match="deadline"):
        T.MicroBatcher(T.GameScorer(ta, device="cpu")).poll()
    with pytest.raises(ValueError, match="max_wait_s"):
        T.MicroBatcher(T.GameScorer(ta, device="cpu"), max_wait_s=-1)


def test_replay_emits_scoring_events(pair):
    from photon_ml_tpu_torch.event import EventEmitter, EventListener

    _, ta, _, tr = pair
    seen = []

    class _Listener(EventListener):
        def on_event(self, event):
            seen.append(type(event).__name__)

    emitter = EventEmitter()
    emitter.register_listener(_Listener())
    T.replay_requests(T.GameScorer(ta, device="cpu"), tr[:5], emitter=emitter)
    assert seen == ["ScoringStartEvent", "ScoringFinishEvent"]


def test_scorer_is_on_its_device_and_refuses_cuda_without_a_card(pair):
    _, ta, _, _ = pair
    scorer = T.GameScorer(ta, device="cpu")
    assert scorer._fe_params["fixed"].device == torch.device("cpu")
    assert scorer._providers["per_userId"].table.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            T.GameScorer(ta)
        with pytest.raises(RuntimeError, match="cuda"):
            T.HotEntityCache(np.zeros((2, 2), np.float32), 1)

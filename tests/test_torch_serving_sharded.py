"""The port's entity routing and sharded device-resident scorer against the
JAX package's, on the same artifact, requests and write sequences.

- ``(shard, slot)`` placement, budgets, deferred rows, evictions under
  ``oldest`` and ``importance`` and the routing statistics equal the JAX
  package's exactly.
- Sharded scores are within atol 1e-6, rtol 2e-4 of the JAX
  ``ShardedGameScorer``'s and bitwise the port's single-table scorer's,
  for several shard counts; ``compile_count`` equals the JAX scorer's.
- ``write_slots`` writes in place (the same ``data_ptr``); the count of
  distinct write signatures equals the JAX scatter's program count;
  ``ShardedReTable.update_rows`` flips generations without pausing a
  scoring thread and leaves both halves equal.
- On a serving mesh of 4 ``cpu`` positions a table of 4 shards splits into
  4 blocks: its scores are bitwise the single-table scorer's and within
  rtol 2e-4 of the JAX scorer split over ``serving_mesh(4)``; its writes
  land in the right block (the unsplit table's bytes); with a shard count
  the positions do not divide it stays whole; a mesh naming cards the
  machine lacks is refused.
"""

import threading

import numpy as np
import pytest
import torch

from _torch_serving_parity import assert_results_close
import photon_ml_tpu.serving as J
import photon_ml_tpu_torch.serving as T
from photon_ml_tpu.indexmap import DefaultIndexMap as JMap
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch.indexmap import DefaultIndexMap as TMap
from photon_ml_tpu_torch.serving import sharded as tsharded
from photon_ml_tpu_torch.types import TaskType as TTask

N_ENT, D_RE, D_FE = 40, 4, 16
MAX_NNZ = {"global": 6, "per_user": D_RE}


def _artifact(pkg, n_ent=N_ENT, seed=5):
    rng = np.random.default_rng(seed)
    fe = (rng.standard_normal(D_FE) * 0.1).astype(np.float32)
    re = (rng.standard_normal((n_ent, D_RE)) * 0.3).astype(np.float32)
    imap = {f"u{i}": i for i in range(n_ent)}
    task, Map = (JTask, JMap) if pkg is J else (TTask, TMap)
    return pkg.ServingArtifact(
        task=task.LOGISTIC_REGRESSION,
        tables={
            "fixed": pkg.ServingTable("global", None, fe),
            "per_user": pkg.ServingTable("per_user", "userId", re, Map(imap)),
        },
        model_name="sharded-test",
    )


def _requests(pkg, n, n_ent=N_ENT, seed=9, ghost_every=0, missing_every=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if missing_every and i % missing_every == 0:
            ids = {}
        elif ghost_every and i % ghost_every == 0:
            ids = {"userId": f"ghost-{i}"}
        else:
            ids = {"userId": f"u{int(rng.integers(0, n_ent))}"}
        g = {int(c): float(v) for c, v in zip(rng.integers(0, D_FE, 6), rng.standard_normal(6))}
        u = {j: float(v) for j, v in enumerate(rng.standard_normal(D_RE))}
        out.append(pkg.ScoreRequest(f"r{i}", {"global": g, "per_user": u}, ids,
                                    float(rng.standard_normal() * 0.1)))
    return out


def _sharded(pkg, **kw):
    art = _artifact(pkg)
    if pkg is T:
        kw.setdefault("device", "cpu")
    return pkg.ShardedGameScorer(art, max_nnz=MAX_NNZ, **kw)


# ---------------------------------------------------------------- routing


@pytest.mark.parametrize("budget,shards", [(None, 1), (None, 3), (16, 4), (25, 2), (400, 4)])
def test_build_routing_placement_equals_jax(budget, shards):
    jr = J.build_routing({"a": 37, "b": 5}, num_shards=shards, device_budget_rows=budget)
    tr = T.build_routing({"a": 37, "b": 5}, num_shards=shards, device_budget_rows=budget)
    for cid in ("a", "b"):
        j, t = jr[cid], tr[cid]
        assert (t.shard_capacity, t.base_rows, t.cold_slot, t.free_slots) == (
            j.shard_capacity, j.base_rows, j.cold_slot, j.free_slots)
        np.testing.assert_array_equal(t._shard_of, j._shard_of)
        np.testing.assert_array_equal(t._slot_of, j._slot_of)
        rows = np.array([-1, 0, 3, 36, 4, 99, 36])
        for got, want in zip(t.route(rows), j.route(rows)):
            np.testing.assert_array_equal(got, want)
    assert tr.stats() == jr.stats()


@pytest.mark.parametrize("policy", ["oldest", "importance"])
def test_admission_evictions_equal_jax(policy):
    """The same deferred/allocate/publish/score-delta sequence through both
    packages' routing: identical victims, placement and statistics."""
    rng = np.random.default_rng(3)
    jr = J.build_routing({"c": 60}, num_shards=3, device_budget_rows=18,
                         eviction_policy=policy)["c"]
    tr = T.build_routing({"c": 60}, num_shards=3, device_budget_rows=18,
                         eviction_policy=policy)["c"]
    for step in range(25):
        batch = rng.integers(-1, 60, size=8)
        norms = rng.random(8)
        for r in (jr, tr):
            r.note_requests(batch, feature_norms=norms if step % 2 else None)
            r.note_score_deltas(batch, norms * 0.5)
        jd, td = jr.route(batch)[2], tr.route(batch)[2]
        np.testing.assert_array_equal(td, jd)
        if jd.size:
            k = min(jd.size, jr.free_slots + len(jr._admitted))
            if k:
                outcome = []
                for r in (jr, tr):
                    try:
                        outcome.append(r.allocate(k))
                    except RuntimeError as e:  # both must refuse alike
                        outcome.append(str(e))
                if isinstance(outcome[0], str):
                    assert outcome[1] == outcome[0]
                    continue
                (js, jsl, jv), (ts, tsl, tv) = outcome
                np.testing.assert_array_equal(ts, js)
                np.testing.assert_array_equal(tsl, jsl)
                assert tv == jv
                vals = rng.random(k).astype(np.float32)
                for r, (s, sl) in ((jr, (js, jsl)), (tr, (ts, tsl))):
                    r.note_row_norms(jd[:k], vals)
                    r.publish(jd[:k], s, sl)
        if step == 12:
            for r in (jr, tr):
                r.unpublish(np.array([int(jr._admitted[0])]))
                r.grow(64)
    assert tr.stats() == jr.stats()
    assert tr.evicted_total > 0
    np.testing.assert_array_equal(tr._slot_of, jr._slot_of)
    assert list(tr._admitted) == list(jr._admitted)
    with pytest.raises(ValueError, match="eviction_policy"):
        T.CoordinateRouting(4, 2, 2, eviction_policy="lru")


def test_allocate_without_headroom_raises_like_jax():
    for pkg in (J, T):
        r = pkg.CoordinateRouting(n_rows=8, num_shards=2, shard_capacity=4)
        with pytest.raises(RuntimeError, match="no admission headroom"):
            r.allocate(1)


# ---------------------------------------------------------------- scorer


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_scores_match_jax_and_single_table(shards):
    jreq = _requests(J, 37, ghost_every=7, missing_every=11)
    treq = _requests(T, 37, ghost_every=7, missing_every=11)
    js = _sharded(J, num_shards=shards)
    ts = _sharded(T, num_shards=shards)
    jres, jsnap = J.replay_requests(js, jreq, bucket_sizes=(4, 8))
    tres, tsnap = T.replay_requests(ts, treq, bucket_sizes=(4, 8))
    assert_results_close(tres, jres)
    single, _ = T.replay_requests(T.GameScorer(_artifact(T), max_nnz=MAX_NNZ, device="cpu"),
                                  treq, bucket_sizes=(4, 8))
    assert [r.score for r in tres] == [r.score for r in single]  # bitwise
    assert ts.compile_count == js.compile_count > 0
    assert tsnap["residency"] == jsnap["residency"]
    assert sorted(tsnap) == sorted(jsnap)


def test_budget_scorer_serves_tail_fe_only_until_admitted():
    out = {}
    for pkg in (J, T):
        scorer = _sharded(pkg, num_shards=2, device_budget_rows=12)
        adm = pkg.AdmissionController(scorer, admit_batch=4)
        scorer.attach_admission(adm)
        reqs = _requests(pkg, 24, seed=2)
        first = scorer.score_batch(reqs, bucket_size=32)
        cold_first = [r.cold_coordinates for r in first]
        admitted = adm.drain()
        second = scorer.score_batch(reqs, bucket_size=32)
        out[pkg] = (cold_first, admitted, [r.cold_coordinates for r in second],
                    [r.score for r in second], adm.stats()["steps"], adm.stats()["evicted_total"],
                    scorer.compile_count)
    t, j = out[T], out[J]
    assert t[0] == j[0] and any(t[0])
    assert t[1:3] == j[1:3] and t[4:] == j[4:]
    np.testing.assert_allclose(t[3], j[3], rtol=2e-4, atol=1e-6)


def test_write_slots_in_place_and_program_count_equals_jax():
    jt = _sharded(J, num_shards=2)._providers["per_user"]
    tt = _sharded(T, num_shards=2)._providers["per_user"]
    before = T.sharded.scatter_program_count()
    jfn = J.sharded._donated_scatter()
    j_before = jfn._cache_size()
    ptrs = [t.data_ptr() for t in tt._tables]
    rng = np.random.default_rng(0)
    for k in (1, 3, 4, 3, 8, 1):
        n = tsharded._pow2_bucket(k)
        shards = np.zeros(n, np.int32)
        slots = np.full(n, tt.cold_slot, np.int32)
        shards[:k] = rng.integers(0, 2, k)
        slots[:k] = rng.permutation(tt.cold_slot)[:k]
        vals = np.zeros((n, D_RE), np.float32)
        vals[:k] = rng.standard_normal((k, D_RE))
        # distinct real targets; pads all write zeros at (0, cold slot)
        _, first = np.unique(shards[:k] * 1000 + slots[:k], return_index=True)
        keep = np.zeros(n, bool)
        keep[first] = True
        keep[k:] = True
        for tbl in (jt, tt):
            tbl.write_slots(shards[keep], slots[keep], vals[keep])
    assert [t.data_ptr() for t in tt._tables] == ptrs
    np.testing.assert_array_equal(tt.table.numpy(), np.asarray(jt.table))
    assert tt.table[:, tt.cold_slot].abs().sum() == 0
    assert T.sharded.scatter_program_count() - before == jfn._cache_size() - j_before


def test_update_rows_flips_converges_and_equals_jax():
    js, ts = _sharded(J, num_shards=2, device_budget_rows=16), _sharded(
        T, num_shards=2, device_budget_rows=16)
    rng = np.random.default_rng(4)
    for _ in range(4):
        rows = np.unique(rng.integers(0, N_ENT + 3, size=3))  # new rows too
        vals = rng.standard_normal((rows.size, D_RE)).astype(np.float32)
        gens = ts._providers["per_user"].generation
        blocking = ts.update_random_effect_rows("per_user", rows, vals)
        js.update_random_effect_rows("per_user", rows, vals)
        p = ts._providers["per_user"]
        assert isinstance(blocking, float) and blocking >= 0.0
        assert p.generation == 1 - gens
        np.testing.assert_array_equal(p._tables[0].numpy(), p._tables[1].numpy())
        np.testing.assert_array_equal(p.table.numpy(),
                                      np.asarray(js._providers["per_user"].table))
    assert ts.routing.stats() == js.routing.stats()


def test_flip_under_concurrent_scoring_is_bitwise_the_synchronous_result():
    sharded = _sharded(T, num_shards=2)
    ref = T.GameScorer(_artifact(T), max_nnz=MAX_NNZ, device="cpu")
    reqs = _requests(T, 16, seed=21)
    stop = threading.Event()
    errors = []

    def _hammer():
        while not stop.is_set():
            try:
                sharded.score_batch(reqs, bucket_size=16)
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(e)
                return

    t = threading.Thread(target=_hammer)
    t.start()
    rng = np.random.default_rng(11)
    try:
        for _ in range(6):
            rows = np.unique(rng.integers(0, N_ENT, size=6))
            values = rng.standard_normal((rows.size, D_RE)).astype(np.float32)
            sharded.update_random_effect_rows("per_user", rows, values)
            ref.update_random_effect_rows("per_user", rows, values)
    finally:
        stop.set()
        t.join(timeout=30)
    assert not t.is_alive() and not errors
    got = sharded.score_batch(reqs, bucket_size=16)
    want = ref.score_batch(reqs, bucket_size=16)
    assert [g.score for g in got] == [w.score for w in want]


def test_replicas_share_routing_and_swap_as_one_generation():
    routing, scorers = None, []
    for _ in range(2):
        s = _sharded(T, num_shards=2, routing=routing)
        routing = s.routing
        scorers.append(s)
    adm = T.AdmissionController(scorers, admit_batch=4)
    for s in scorers:
        s.attach_admission(adm)
    assert scorers[0]._replica_group == scorers
    scorers[0].update_random_effect_rows("per_user", np.array([4]),
                                         np.full((1, D_RE), 2.5, np.float32))
    reqs = _requests(T, 8, seed=51)
    a, b = (s.score_batch(reqs, bucket_size=8) for s in scorers)
    assert [x.score for x in a] == [y.score for y in b]
    assert scorers[0]._providers["per_user"].generation == scorers[1]._providers[
        "per_user"].generation
    with pytest.raises(ValueError, match="one routing index"):
        scorers[0].set_replica_group([scorers[0], _sharded(T, num_shards=2)])


def test_rebind_and_restore_keep_layout_consistent():
    out = {}
    for pkg in (J, T):
        s = _sharded(pkg, num_shards=2)
        old_provider, old_routing = s._providers["per_user"], s.routing["per_user"]
        grown = np.zeros((3 * N_ENT, D_RE), np.float32)
        changed = s.rebind_random_effect("per_user", grown)
        s.score_batch(_requests(pkg, 4), bucket_size=4)
        s.restore_random_effect("per_user", old_provider, routing=old_routing)
        res = s.score_batch(_requests(pkg, 4), bucket_size=4)
        out[pkg] = (changed, s.compile_count, s.routing["per_user"] is old_routing,
                    [r.cold_coordinates for r in res])
    assert out[T] == out[J]


def test_importance_policy_score_deltas_equal_jax():
    out = {}
    for pkg in (J, T):
        s = _sharded(pkg, num_shards=2, device_budget_rows=12, eviction_policy="importance")
        adm = pkg.AdmissionController(s, admit_batch=4)
        s.attach_admission(adm)
        for seed in range(3):
            s.score_batch(_requests(pkg, 16, seed=seed), bucket_size=16)
            adm.drain()
        r = s.routing["per_user"]
        out[pkg] = (r._sdelta.copy(), r._freq.copy(), adm.stats()["evicted_by_policy"])
    np.testing.assert_allclose(out[T][0], out[J][0], rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(out[T][1], out[J][1], rtol=1e-6)
    assert out[T][2] == out[J][2]


def test_mesh_of_one_device_places_tables_there():
    mesh = T.serving_mesh(device="cpu")
    s = T.ShardedGameScorer(_artifact(T), mesh=mesh)
    assert s._providers["per_user"].table.device.type == "cpu"
    cap = s.routing["per_user"].shard_capacity
    assert s.table_bytes() == 4 * (D_FE + 2 * s.num_shards * (cap + 1) * D_RE)


def test_split_table_over_four_positions_scores_bitwise_and_as_jax():
    split = _sharded(T, num_shards=4, mesh=T.serving_mesh(4, device="cpu"))
    jsplit = _sharded(J, num_shards=4, mesh=J.serving_mesh(4))
    p = split._providers["per_user"]
    cap = split.routing["per_user"].shard_capacity
    assert p.split and all(isinstance(t, tsharded.SplitTable) for t in p._tables)
    assert [tuple(b.shape) for b in p.table.blocks] == [(1, cap + 1, D_RE)] * 4
    assert len(jsplit._providers["per_user"].table.sharding.device_set) == 4
    single = T.GameScorer(_artifact(T), max_nnz=MAX_NNZ, device="cpu")
    treq = _requests(T, 37, ghost_every=7, missing_every=11)
    jreq = _requests(J, 37, ghost_every=7, missing_every=11)
    tres, _ = T.replay_requests(split, treq, bucket_sizes=(4, 8))
    jres, _ = J.replay_requests(jsplit, jreq, bucket_sizes=(4, 8))
    one, _ = T.replay_requests(single, treq, bucket_sizes=(4, 8))
    assert [r.score for r in tres] == [r.score for r in one]  # bitwise
    assert_results_close(tres, jres)
    assert split.table_bytes() == _sharded(T, num_shards=4).table_bytes()

    # the same row updates as the unsplit table: its bytes, block by block
    whole = _sharded(T, num_shards=4, device_budget_rows=16)
    split = _sharded(T, num_shards=4, device_budget_rows=16,
                     mesh=T.serving_mesh(4, device="cpu"))
    rng = np.random.default_rng(4)
    for _ in range(4):
        rows = np.unique(rng.integers(0, N_ENT + 3, size=3))  # new rows too
        vals = rng.standard_normal((rows.size, D_RE)).astype(np.float32)
        for s in (whole, split):
            s.update_random_effect_rows("per_user", rows, vals)
        p, w = split._providers["per_user"], whole._providers["per_user"]
        assert p.generation == w.generation
        for half in range(2):
            np.testing.assert_array_equal(torch.cat(p._tables[half].blocks).numpy(),
                                          w._tables[half].numpy())
    reqs = _requests(T, 16, seed=3)
    assert ([r.score for r in split.score_batch(reqs, bucket_size=16)]
            == [r.score for r in whole.score_batch(reqs, bucket_size=16)])


def test_split_needs_the_shard_count_to_divide_the_positions():
    s = _sharded(T, num_shards=4, mesh=T.serving_mesh(3, device="cpu"))
    p = s._providers["per_user"]
    assert not p.split and p.table.shape[0] == 4 and p.table.device.type == "cpu"
    assert len(_sharded(J, num_shards=4, mesh=J.serving_mesh(3))._providers[
        "per_user"].table.sharding.device_set) == 1


def test_a_mesh_naming_cards_the_machine_lacks_is_refused():
    from photon_ml_tpu_torch.parallel.mesh import Mesh

    missing = f"cuda:{torch.cuda.device_count()}"
    mesh = Mesh(["cuda:0", missing], ("data",))
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match=f"names {missing}"):
            _sharded(T, num_shards=4, mesh=mesh)
    else:
        with pytest.raises(RuntimeError, match="is False"):
            _sharded(T, num_shards=4, mesh=mesh)


"""Online serving on the card: the scorers on ``cuda`` against their runs on
the host, the tables' placement, and admission writes made on another
thread seen by the next gather.

- ``GameScorer`` (full table and cached) and ``ShardedGameScorer`` score
  the same requests on cuda within atol 1e-6, rtol 2e-4 of their cpu runs;
  on the card the cached path equals the full table bitwise, and the
  sharded scorer equals the single table bitwise.
- Every table and FE vector is a cuda tensor; ``write_slots`` keeps the
  table's ``data_ptr``.
- An admission step run on a background thread publishes rows that the
  next batch on the scoring thread gathers (its score equals full
  residency bitwise); so does a hot swap's delta, and a variant view of
  it scores the same.
- On a serving mesh of 4 positions on the one card a table of 4 shards
  splits into 4 blocks on the card; its scores, before and after row
  updates, are bitwise the single table's; a mesh naming a card the
  machine lacks is refused.

Run on a machine with a card: ``python -m pytest --noconftest
tests/test_torch_serving_cuda.py``. Without one, every test here skips.
"""

import threading

import numpy as np
import pytest
import torch

import photon_ml_tpu_torch.serving as T
from photon_ml_tpu_torch.indexmap import DefaultIndexMap
from photon_ml_tpu_torch.types import TaskType

pytestmark = pytest.mark.cuda

N_ENT, D_RE, D_FE = 300, 64, 512
MAX_NNZ = {"global": 16, "per_user": 8}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _artifact(seed=5):
    rng = np.random.default_rng(seed)
    return T.ServingArtifact(
        task=TaskType.LOGISTIC_REGRESSION,
        tables={
            "fixed": T.ServingTable("global", None, rng.standard_normal(D_FE).astype(np.float32)),
            "per_user": T.ServingTable(
                "per_user", "userId", rng.standard_normal((N_ENT, D_RE)).astype(np.float32),
                DefaultIndexMap({f"u{i}": i for i in range(N_ENT)})),
        },
    )


def _requests(n, seed=9):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        e = int(rng.integers(0, N_ENT + 20))  # some unknown entities
        out.append(T.ScoreRequest(
            f"r{i}",
            {"global": dict(zip(rng.choice(D_FE, 16, replace=False).tolist(),
                                rng.standard_normal(16).tolist())),
             "per_user": dict(zip(rng.choice(D_RE, 8, replace=False).tolist(),
                                  rng.standard_normal(8).tolist()))},
            {"userId": f"u{e}"}, float(rng.standard_normal())))
    return out


def _scores(results):
    return np.array([r.score for r in results])


def test_scorers_on_cuda_equal_their_cpu_runs(card):
    art, reqs = _artifact(), _requests(96)
    for make in (lambda d: T.GameScorer(art, max_nnz=MAX_NNZ, device=d),
                 lambda d: T.GameScorer(art, max_nnz=MAX_NNZ, cache_capacity=64, device=d),
                 lambda d: T.ShardedGameScorer(art, max_nnz=MAX_NNZ, num_shards=4, device=d)):
        got, gsnap = T.replay_requests(make("cuda"), reqs, bucket_sizes=(1, 8, 32))
        want, wsnap = T.replay_requests(make("cpu"), reqs, bucket_sizes=(1, 8, 32))
        np.testing.assert_allclose(_scores(got), _scores(want), rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose([r.mean for r in got], [r.mean for r in want],
                                   rtol=2e-4, atol=1e-6)
        assert [r.cold_coordinates for r in got] == [r.cold_coordinates for r in want]
        assert gsnap["xla_compiles"] == wsnap["xla_compiles"]
    full, _ = T.replay_requests(T.GameScorer(art, max_nnz=MAX_NNZ, device="cuda"), reqs)
    cached, _ = T.replay_requests(
        T.GameScorer(art, max_nnz=MAX_NNZ, cache_capacity=64, device="cuda"), reqs)
    sharded, _ = T.replay_requests(
        T.ShardedGameScorer(art, max_nnz=MAX_NNZ, num_shards=4, device="cuda"), reqs)
    assert _scores(cached).tolist() == _scores(full).tolist()
    assert _scores(sharded).tolist() == _scores(full).tolist()


def test_tables_live_on_the_card_and_writes_stay_in_place(card):
    scorer = T.ShardedGameScorer(_artifact(), max_nnz=MAX_NNZ, num_shards=4, device="cuda")
    provider = scorer._providers["per_user"]
    assert scorer._fe_params["fixed"].is_cuda
    assert all(t.is_cuda for t in provider._tables)
    ptrs = [t.data_ptr() for t in provider._tables]
    scorer.update_random_effect_rows("per_user", np.array([3, 7]),
                                     np.ones((2, D_RE), np.float32))
    assert [t.data_ptr() for t in provider._tables] == ptrs
    assert torch.equal(provider._tables[0], provider._tables[1])
    cache = T.GameScorer(_artifact(), cache_capacity=8, device="cuda").caches["per_user"]
    assert cache.table.is_cuda


def test_admission_on_another_thread_is_seen_by_the_next_gather(card):
    art = _artifact()
    scorer = T.ShardedGameScorer(art, max_nnz=MAX_NNZ, num_shards=4,
                                 device_budget_rows=128, device="cuda")
    adm = T.AdmissionController(scorer, admit_batch=32)
    scorer.attach_admission(adm)
    full = T.ShardedGameScorer(art, max_nnz=MAX_NNZ, num_shards=4, device="cuda")
    reqs = _requests(32, seed=3)
    first = scorer.score_batch(reqs, bucket_size=32)
    assert adm.queue_depth > 0 and any(r.cold_coordinates for r in first)
    worker = threading.Thread(target=adm.drain)
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive() and adm.queue_depth == 0
    again = scorer.score_batch(reqs, bucket_size=32)
    want = full.score_batch(reqs, bucket_size=32)
    assert _scores(again).tolist() == _scores(want).tolist()
    assert [r.cold_coordinates for r in again] == [r.cold_coordinates for r in want]


def test_hot_swap_on_another_thread_is_seen_by_the_next_gather(card):
    """A delta applied by a HotSwapManager on a background thread (rows
    rewritten in place, one new entity, a new FE vector) is what the next
    batch on the scoring thread gathers: its scores equal a scorer built
    from the folded artifact, bitwise; a variant view of the same delta
    scores the same."""
    import photon_ml_tpu_torch.incremental as TI

    art, reqs = _artifact(), _requests(64, seed=4)
    rng = np.random.default_rng(1)
    rows = {f"u{e}": {int(j): float(v) for j, v in zip(rng.integers(0, D_RE, 4),
                                                        rng.standard_normal(4))}
            for e in list(range(0, 40, 3)) + [N_ENT + 1]}
    delta = TI.build_delta({"per_user": rows}, art,
                           fe_updates={"fixed": rng.standard_normal(D_FE).astype(np.float32)})
    scorer = T.ShardedGameScorer(art, max_nnz=MAX_NNZ, num_shards=4, device="cuda")
    registry = T.VariantRegistry(T.ShardedGameScorer(art, max_nnz=MAX_NNZ, num_shards=4,
                                                     device="cuda"))
    registry.add_variant("v")
    before = scorer.score_batch(reqs, bucket_size=64)
    compiles = scorer.compile_count
    manager = T.HotSwapManager(scorer)
    reports = []
    worker = threading.Thread(target=lambda: reports.append(manager.apply_delta(delta)))
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive() and reports[0].generation == 1
    after = scorer.score_batch(reqs, bucket_size=64)
    folded = T.ShardedGameScorer(TI.apply_delta(art, delta), max_nnz=MAX_NNZ, num_shards=4,
                                 device="cuda")
    want = folded.score_batch(reqs, bucket_size=64)
    assert _scores(after).tolist() == _scores(want).tolist()
    assert _scores(after).tolist() != _scores(before).tolist()
    assert scorer.compile_count == compiles
    registry.apply_delta("v", delta)
    variant = registry.scorer("v").score_batch(reqs, bucket_size=64)
    assert _scores(variant).tolist() == _scores(want).tolist()


def test_split_table_on_a_mesh_of_the_card_scores_bitwise(card):
    from photon_ml_tpu_torch.parallel.mesh import Mesh, data_parallel_mesh

    art, reqs = _artifact(), _requests(61)
    split = T.ShardedGameScorer(art, max_nnz=MAX_NNZ, num_shards=4, device="cuda",
                                mesh=data_parallel_mesh(devices=[card] * 4))
    full = T.GameScorer(art, max_nnz=MAX_NNZ, device="cuda")
    p = split._providers["per_user"]
    assert p.split and all(b.is_cuda for t in p._tables for b in t.blocks)
    assert _scores(T.replay_requests(split, reqs)[0]).tolist() == _scores(
        T.replay_requests(full, reqs)[0]).tolist()
    rows, vals = np.array([3, 7, 150]), np.full((3, D_RE), 0.5, np.float32)
    for s in (split, full):
        s.update_random_effect_rows("per_user", rows, vals)
    assert _scores(T.replay_requests(split, reqs)[0]).tolist() == _scores(
        T.replay_requests(full, reqs)[0]).tolist()
    missing = f"cuda:{torch.cuda.device_count()}"
    with pytest.raises(ValueError, match=f"names {missing}"):
        T.ShardedGameScorer(art, max_nnz=MAX_NNZ, num_shards=4,
                            mesh=Mesh(["cuda:0", missing], ("data",)))


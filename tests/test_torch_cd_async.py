"""The port's async coordinate-descent schedule against its sync loop and
against the JAX package's async schedule.

- staleness 0 equals sync bitwise (scores and objective history), and two
  staleness-1 fits are bitwise equal;
- staleness 1 against the JAX staleness-1 fit on the same data: objective
  history rtol 1e-4 per entry, coefficients atol 2e-3;
- the held-out AUC of staleness 1 within 0.02 of sync (the JAX gate,
  tests/test_cd_async.py);
- random-effect bucket overlap bitwise equal to the sequential path, and a
  factored coordinate under the async schedule (staleness 0 bitwise sync);
- schedule and staleness validation with the JAX messages; the executor's
  validation and drain; a worker that raises makes the fit raise; launch
  counts stay exact when recorded from threads.
"""

import threading

import numpy as np
import pytest
import torch

from _torch_parity import coordinates_of_jax_model
from photon_ml_tpu.algorithm.coordinate_descent import CoordinateDescent as JaxCD
from photon_ml_tpu.data.game_data import FeatureShard as JaxShard
from photon_ml_tpu.data.game_data import GameData as JaxData
from photon_ml_tpu.data.random_effect import RandomEffectDataConfiguration as JaxReData
from photon_ml_tpu.estimators import game as jax_game
from photon_ml_tpu.types import TaskType as JaxTask
from photon_ml_tpu_torch.algorithm.coordinate import RandomEffectCoordinate
from photon_ml_tpu_torch.algorithm.coordinate_descent import CoordinateDescent
from photon_ml_tpu_torch.algorithm.schedule import ScheduleExecutor
from photon_ml_tpu_torch.convert import game_model_to_numpy
from photon_ml_tpu_torch.data.game_data import FeatureShard, GameData
from photon_ml_tpu_torch.data.random_effect import (
    RandomEffectDataConfiguration,
    build_random_effect_dataset,
)
from photon_ml_tpu_torch.estimators import game
from photon_ml_tpu_torch.estimators.random_effect import train_random_effects
from photon_ml_tpu_torch.ops import launches
from photon_ml_tpu_torch.opt.config import GlmOptimizationConfiguration, RegularizationContext
from photon_ml_tpu_torch.types import RegularizationType, TaskType

N_USERS, N_ITEMS, ROWS_PER_USER = 18, 7, 24
D_FE, D_RE = 10, 5
N_OUTER = 3


def _problem(seed=0, task="LINEAR_REGRESSION", n_users=N_USERS, rows_per_user=ROWS_PER_USER):
    """The JAX test's problem: (labels, shards, id_tags) in numpy."""
    rng = np.random.default_rng(seed)
    n = n_users * rows_per_user
    Xg = rng.normal(size=(n, D_FE)).astype(np.float32)
    Xu = rng.normal(size=(n, D_RE)).astype(np.float32)
    Xi = rng.normal(size=(n, D_RE)).astype(np.float32)
    user_ids = np.repeat([f"u{i:03d}" for i in range(n_users)], rows_per_user)
    item_ids = np.array([f"i{int(v):03d}" for v in rng.integers(0, N_ITEMS, n)])
    w = rng.normal(size=D_FE).astype(np.float32)
    z = Xg @ w + 0.1 * rng.normal(size=n)
    if task == "LOGISTIC_REGRESSION":
        y = (rng.random(n) < 1.0 / (1.0 + np.exp(-z))).astype(np.float32)
    else:
        y = z.astype(np.float32)

    def coo(X):
        rows, cols = np.nonzero(X)
        return rows, cols, X[rows, cols], X.shape[1]

    shards = {"global": coo(Xg), "per_user": coo(Xu), "per_item": coo(Xi)}
    return y, shards, {"userId": user_ids, "itemId": item_ids}


def _torch_data(problem):
    y, shards, tags = problem
    return GameData(labels=y, feature_shards={k: FeatureShard(*v) for k, v in shards.items()},
                    id_tags=tags)


def _jax_data(problem):
    y, shards, tags = problem
    return JaxData(labels=y, feature_shards={k: JaxShard(*v) for k, v in shards.items()},
                   id_tags=tags)


def _fit(data, schedule="sync", staleness=1, task="LINEAR_REGRESSION", n_outer=N_OUTER):
    """FE + per-user + per-item (two buckets: the async fits overlap them)."""
    est = game.GameEstimator(
        task=TaskType[task],
        coordinates={
            "fixed": game.FixedEffectCoordinateConfiguration("global"),
            "per-user": game.RandomEffectCoordinateConfiguration(
                "per_user", RandomEffectDataConfiguration("userId")),
            "per-item": game.RandomEffectCoordinateConfiguration(
                "per_item", RandomEffectDataConfiguration("itemId", num_buckets=2)),
        },
        num_outer_iterations=n_outer, schedule=schedule, staleness=staleness, device="cpu",
    )
    return est, est.fit(data)


def _auc(scores, labels):
    order = np.argsort(scores)
    ranks = np.empty(len(scores))
    ranks[order] = np.arange(1, len(scores) + 1)
    pos = labels > 0.5
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


@pytest.fixture(scope="module")
def fits():
    data = _torch_data(_problem())
    return data, {
        "sync": _fit(data)[1],
        "async0": _fit(data, "async", 0)[1],
        "async1": _fit(data, "async", 1)[1],
        "async1_again": _fit(data, "async", 1)[1],
    }


def test_staleness_zero_equals_sync_bitwise(fits):
    data, f = fits
    assert len(f["sync"].model.models["per-item"].coefficients) == 2
    assert torch.equal(f["sync"].model.score(data), f["async0"].model.score(data))
    assert f["sync"].objective_history == f["async0"].objective_history


def test_staleness_one_repeats_bitwise(fits):
    data, f = fits
    assert f["async1"].objective_history == f["async1_again"].objective_history
    assert torch.equal(f["async1"].model.score(data), f["async1_again"].model.score(data))
    # a stale residual changes the trajectory: one entry per update all the same
    assert len(f["async1"].objective_history) == 3 * N_OUTER
    assert f["async1"].objective_history != f["sync"].objective_history


def test_staleness_one_matches_jax():
    problem = _problem()
    jest = jax_game.GameEstimator(
        task=JaxTask.LINEAR_REGRESSION,
        coordinates={
            "fixed": jax_game.FixedEffectCoordinateConfiguration("global"),
            "per-user": jax_game.RandomEffectCoordinateConfiguration(
                "per_user", JaxReData("userId")),
            "per-item": jax_game.RandomEffectCoordinateConfiguration(
                "per_item", JaxReData("itemId", num_buckets=2)),
        },
        num_outer_iterations=N_OUTER, schedule="async", staleness=1,
    )
    jfit = jest.fit(_jax_data(problem))
    _, tfit = _fit(_torch_data(problem), "async", 1)
    assert [c for c, _ in tfit.objective_history] == [c for c, _ in jfit.objective_history]
    np.testing.assert_allclose([v for _, v in tfit.objective_history],
                               [v for _, v in jfit.objective_history], rtol=1e-4)
    jm, tm = coordinates_of_jax_model(jfit.model), game_model_to_numpy(tfit.model)
    np.testing.assert_allclose(tm["fixed"]["means"], jm["fixed"]["means"], atol=2e-3)
    for cid in ("per-user", "per-item"):
        assert tm[cid]["entity_ids"] == jm[cid]["entity_ids"]
        for a, b in zip(tm[cid]["coefficients"], jm[cid]["coefficients"]):
            np.testing.assert_allclose(a, b, atol=2e-3)


def test_async_auc_within_002_of_sync_on_holdout():
    task = "LOGISTIC_REGRESSION"
    data = _torch_data(_problem(task=task))
    holdout = _torch_data(_problem(seed=5, task=task, rows_per_user=8))
    _, fit_s = _fit(data, task=task, n_outer=6)
    _, fit_a = _fit(data, "async", 1, task=task, n_outer=6)
    y = holdout.labels
    auc_s = _auc(fit_s.model.score(holdout).double().numpy(), y)
    auc_a = _auc(fit_a.model.score(holdout).double().numpy(), y)
    assert abs(auc_a - auc_s) <= 0.02


def test_factored_coordinate_under_async():
    """A factored coordinate (its alternating solves sync only their own
    stream) trains under the async schedule: staleness 0 bitwise sync."""
    from photon_ml_tpu_torch.algorithm.factored_random_effect import (
        MFOptimizationConfiguration,
    )

    data = _torch_data(_problem())

    def fit(schedule, staleness):
        est = game.GameEstimator(
            task=TaskType.LINEAR_REGRESSION,
            coordinates={
                "fixed": game.FixedEffectCoordinateConfiguration("global"),
                "mf": game.FactoredRandomEffectCoordinateConfiguration(
                    "per_item", RandomEffectDataConfiguration("userId"),
                    MFOptimizationConfiguration(num_latent_factors=2)),
            },
            num_outer_iterations=2, schedule=schedule, staleness=staleness, device="cpu",
        )
        return est.fit(data)

    sync, a0, a1 = fit("sync", 1), fit("async", 0), fit("async", 1)
    assert sync.objective_history == a0.objective_history
    assert torch.equal(sync.model.models["mf"].projection_matrix,
                       a0.model.models["mf"].projection_matrix)
    assert len(a1.objective_history) == 4
    assert all(np.isfinite(v) for _, v in a1.objective_history)


def _bucketed_dataset(n_ent=12, d=4):
    """Entities of 3 to 25 rows: three buckets by row count."""
    rng = np.random.default_rng(0)
    ids, rows, cols, vals, labels = [], [], [], [], []
    r = 0
    for e in range(n_ent):
        for _ in range(3 + 2 * e):
            x = rng.normal(size=d).astype(np.float32)
            rows += [r] * d
            cols += list(range(d))
            vals += [float(v) for v in x]
            ids.append(f"e{e:03d}")
            labels.append(float(x.sum() > 0))
            r += 1
    return build_random_effect_dataset(
        np.array(ids), np.array(rows), np.array(cols), np.array(vals, np.float32), d,
        np.array(labels, np.float32),
        RandomEffectDataConfiguration(random_effect_type="e", num_buckets=3), device="cpu",
    )


@pytest.mark.parametrize("adaptive", [False, True])
def test_bucket_overlap_equals_sequential_bitwise(adaptive):
    from photon_ml_tpu_torch.opt.config import AdaptiveSolveConfig

    ds = _bucketed_dataset()
    assert len(ds.buckets) == 3
    cfg = GlmOptimizationConfiguration(
        regularization=RegularizationContext(RegularizationType.L2),
        regularization_weight=1e-3,
        adaptive=AdaptiveSolveConfig(enabled=adaptive, chunk_iters=2, min_lanes=1),
    )
    seq_stats, ovl_stats = [], []
    seq, seq_res = train_random_effects(ds, TaskType.LOGISTIC_REGRESSION, cfg,
                                        stats_out=seq_stats)
    ovl, ovl_res = train_random_effects(ds, TaskType.LOGISTIC_REGRESSION, cfg,
                                        overlap_buckets=2, stats_out=ovl_stats)
    assert len(seq.coefficients) == len(ovl.coefficients) == len(ds.buckets)
    for cs, co in zip(seq.coefficients, ovl.coefficients):
        assert torch.equal(cs, co)
    for a, b in zip(seq_res, ovl_res):
        assert torch.equal(a.iterations, b.iterations)
    assert [s.bucket for s in ovl_stats] == [0, 1, 2]


def test_schedule_validation_messages_match_jax():
    coords = {"fixed": game.FixedEffectCoordinateConfiguration("global")}
    jcoords = {"fixed": jax_game.FixedEffectCoordinateConfiguration("global")}
    cases = [({"schedule": "eager"}, "schedule"), ({"staleness": -1}, "staleness")]
    for kw, word in cases:
        with pytest.raises(ValueError, match=word) as ours:
            game.GameEstimator(TaskType.LINEAR_REGRESSION, coords, device="cpu", **kw)
        with pytest.raises(ValueError) as theirs:
            jax_game.GameEstimator(JaxTask.LINEAR_REGRESSION, jcoords, **kw)
        assert str(ours.value) == str(theirs.value)
    for kw in ({"schedule": "lazy"}, {"staleness": -2}):
        with pytest.raises(ValueError) as ours:
            CoordinateDescent({"x": object()}, num_rows=4, device=torch.device("cpu"), **kw)
        with pytest.raises(ValueError) as theirs:
            JaxCD({"x": object()}, num_rows=4, **kw)
        assert str(ours.value) == str(theirs.value)


def test_executor_validation_and_drain():
    with pytest.raises(ValueError, match="max_in_flight"):
        ScheduleExecutor(max_in_flight=0)
    with ScheduleExecutor(max_in_flight=2) as ex:
        works = [ex.submit(i, lambda i=i: i * i) for i in range(5)]
        assert len(ex) == 5
        assert ex.oldest() is works[0]
        assert ex.drain() == [0, 1, 4, 9, 16]
        assert len(ex) == 0
    with ScheduleExecutor(max_in_flight=3, device="cpu") as ex:
        ex.submit("a", lambda: torch.ones(2), inputs=(torch.zeros(1), [{"k": torch.ones(1)}]))
        assert ex.pop_oldest().result().tolist() == [1.0, 1.0]


def test_worker_exception_fails_the_fit(monkeypatch):
    data = _torch_data(_problem())

    def boom(self, model, residual):
        raise RuntimeError("worker failed")

    monkeypatch.setattr(RandomEffectCoordinate, "update_model_device", boom)
    with pytest.raises(RuntimeError, match="worker failed"):
        _fit(data, "async", 1)
    with ScheduleExecutor(max_in_flight=2) as ex:
        ex.submit(0, lambda: 1 / 0)
        with pytest.raises(ZeroDivisionError):
            ex.drain()


def test_launch_counts_exact_from_threads():
    """More threads than cores, a short switch interval: no lost update."""
    import os
    import sys

    launches.register("threaded_test_kernel")
    launches.reset()
    per_thread, n_threads = 5_000, 2 * (os.cpu_count() or 4) + 2

    def hammer():
        for _ in range(per_thread):
            launches.record("threaded_test_kernel")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert launches.counts()["threaded_test_kernel"] == per_thread * n_threads
    launches.reset()
    assert launches.counts()["threaded_test_kernel"] == 0

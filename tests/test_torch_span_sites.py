"""The port's telemetry spans sit where the JAX package's do.

The same tiny GLMix fit (a fixed effect, per-user in one bucket, per-item
in two), traced in each package on the CPU, gives the same multiset of
(span name, parent span name, attribute keys), on the sync schedule and on
the async one at staleness 1 (the port's worker spans chain under the
dispatcher's as the JAX package's do). ``resolve_coordinate`` and
coordinate building carry their spans too.
"""

import collections

import pytest

import photon_ml_tpu.telemetry as jt
import photon_ml_tpu_torch.telemetry as tt
from photon_ml_tpu.data.random_effect import RandomEffectDataConfiguration as JaxReData
from photon_ml_tpu.estimators import game as jax_game
from photon_ml_tpu.types import TaskType as JaxTask
from test_torch_cd_async import _fit, _jax_data, _problem, _torch_data

N_OUTER = 2


@pytest.fixture(autouse=True)
def _tracing_off():
    for pkg in (tt, jt):
        pkg.disable_tracing()
        pkg.get_tracer().clear()
    yield
    for pkg in (tt, jt):
        pkg.disable_tracing()
        pkg.get_tracer().clear()


@pytest.fixture(scope="module")
def problem():
    return _problem(n_users=10, rows_per_user=16)


def _jax_estimator(schedule, staleness):
    return jax_game.GameEstimator(
        task=JaxTask.LINEAR_REGRESSION,
        coordinates={
            "fixed": jax_game.FixedEffectCoordinateConfiguration("global"),
            "per-user": jax_game.RandomEffectCoordinateConfiguration(
                "per_user", JaxReData("userId")),
            "per-item": jax_game.RandomEffectCoordinateConfiguration(
                "per_item", JaxReData("itemId", num_buckets=2)),
        },
        num_outer_iterations=N_OUTER, schedule=schedule, staleness=staleness,
    )


def _sites(spans):
    """Multiset of (name, parent name, attribute keys)."""
    by_id = {s.span_id: s for s in spans}
    return collections.Counter(
        (s.name, by_id[s.parent_id].name if s.parent_id in by_id else None,
         tuple(sorted(s.attrs)))
        for s in spans
    )


def _traced(pkg, fn):
    tracer = pkg.enable_tracing()
    try:
        fn()
    finally:
        pkg.disable_tracing()
    return tracer.spans()


@pytest.mark.parametrize("schedule,staleness", [("sync", 1), ("async", 1)])
def test_fit_spans_match_the_jax_package(problem, schedule, staleness):
    mine = _traced(tt, lambda: _fit(_torch_data(problem), schedule, staleness,
                                    n_outer=N_OUTER))
    ref = _traced(jt, lambda: _jax_estimator(schedule, staleness).fit(_jax_data(problem)))
    assert _sites(mine) == _sites(ref)
    names = {s.name for s in mine}
    expected = {"game/build_coordinate", "game/fit", "cd/run", "cd/outer_iter",
                "cd/objective", "fe/solve", "re/train", "re/solve_bucket",
                "re/adaptive_round"}
    expected |= ({"cd/reconcile", "cd/overlap"} if schedule == "async" else {"cd/coordinate"})
    assert expected <= names
    if schedule == "async":
        # worker spans: on other threads, with a parent on the span tree
        by_id = {s.span_id: s for s in mine}
        main = next(s.thread_name for s in mine if s.name == "cd/run")
        workers = [s for s in mine if s.name in ("cd/overlap", "re/solve_bucket")
                   and s.thread_name != main]
        assert workers
        for s in workers:
            node = s
            while node is not None and node.thread_name != main:
                node = by_id.get(node.parent_id)
            assert node is not None and s.path.startswith("game/fit/cd/run/")


def test_resolve_coordinate_spans_match_the_jax_package(problem):
    est, fit = _fit(_torch_data(problem), n_outer=1)
    jest = _jax_estimator("sync", 1)
    jest.num_outer_iterations = 1
    jfit = jest.fit(_jax_data(problem))
    mine = _traced(tt, lambda: est.resolve_coordinate(
        "per-user", _torch_data(problem), fit.model.models))
    ref = _traced(jt, lambda: jest.resolve_coordinate(
        "per-user", _jax_data(problem), jfit.model.models))
    assert _sites(mine) == _sites(ref)
    assert {"game/resolve_coordinate", "game/build_coordinate", "re/train"} <= {
        s.name for s in mine}

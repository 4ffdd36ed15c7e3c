"""The port's failure plane (``photon_ml_tpu_torch/resilience``) against the
JAX package's.

- ``PHOTON_FAULTS`` specs parse to the same ``FaultSpec``s and bad specs
  fail in both; ``once``, ``every`` and seeded ``prob`` triggers fire on
  the same calls;
- ``RetryPolicy`` gives the same delay sequences (its jitter is a CRC of
  the site and attempt), the same retry, recovery and exhaustion outcomes,
  and the same registry counters;
- the failure ring and its sinks, and ``SupervisedThread`` restarts and
  death, as in the JAX package;
- the checkpoint fault site ``train.checkpoint.publish`` of the port's
  ``checkpoint.py``: a fault there leaves the previous generation
  loadable and no temporary directory behind; a fit that faults at its
  checkpoint resumes bitwise equal to the uninterrupted fit.

Faults are armed with ``configure_faults`` / ``arm_fault``, never through
the environment (both packages read ``PHOTON_FAULTS`` once), and every
test leaves both packages disarmed.
"""

import dataclasses
import glob
import threading

import numpy as np
import pytest
import torch

import photon_ml_tpu.resilience as jr
import photon_ml_tpu.telemetry as jt
import photon_ml_tpu_torch.resilience as tr
import photon_ml_tpu_torch.telemetry as tt
from photon_ml_tpu_torch import checkpoint as ckpt
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.types import TaskType

SPECS = [
    "a=once:2",
    "a=every:3,b=prob:0.25:7",
    "site.x=prob:0.5,site.y=once:1!fatal",
    " a = once:4 , ,b=every:1!fatal",
]
BAD_SPECS = ["a", "a=once", "a=once:1:2", "a=prob", "a=prob:0.1:2:3", "a=never:1",
             "a=once:x"]


@pytest.fixture(autouse=True)
def _disarmed():
    for pkg in (tr, jr):
        pkg.reset_faults()
        pkg.configure_faults({})
        pkg.clear_failures()
    for pkg in (tt, jt):
        pkg.get_registry().reset()
    yield
    for pkg in (tr, jr):
        pkg.configure_faults({})
        pkg.reset_faults()
        pkg.clear_failures()
    for pkg in (tt, jt):
        pkg.get_registry().reset()


def _spec_fields(spec):
    return {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)
            if not f.name.startswith("_")}


@pytest.mark.parametrize("spec", SPECS)
def test_fault_specs_parse_the_same(spec):
    mine, ref = tr.parse_fault_env(spec), jr.parse_fault_env(spec)
    assert {k: _spec_fields(v) for k, v in mine.items()} == {
        k: _spec_fields(v) for k, v in ref.items()}


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_fault_specs_fail_in_both(spec):
    with pytest.raises(ValueError):
        jr.parse_fault_env(spec)
    with pytest.raises(ValueError):
        tr.parse_fault_env(spec)


def _fires(pkg, spec: str, site: str, calls: int):
    pkg.configure_faults(spec)
    out = []
    for _ in range(calls):
        try:
            pkg.fault_point(site)
            out.append(None)
        except pkg.FatalInjectedFault:
            out.append("fatal")
        except pkg.InjectedFault:
            out.append("fault")
    stats = pkg.fault_stats()
    pkg.configure_faults({})
    return out, stats


@pytest.mark.parametrize("spec,site", [("s=once:3", "s"), ("s=every:4", "s"),
                                       ("s=prob:0.3:11", "s"), ("s=once:2!fatal", "s"),
                                       ("s=every:1", "other")])
def test_triggers_fire_on_the_same_calls(spec, site):
    mine, ref = _fires(tr, spec, site, 40), _fires(jr, spec, site, 40)
    assert mine == ref
    assert (tt.get_registry().snapshot()["counters"]
            == jt.get_registry().snapshot()["counters"])


def test_fatal_fault_is_not_retryable_and_injected_is_an_oserror():
    assert issubclass(tr.InjectedFault, OSError)
    for name in ("InjectedFault", "FatalInjectedFault"):
        assert ([c.__name__ for c in getattr(tr, name).__mro__]
                == [c.__name__ for c in getattr(jr, name).__mro__])
    policy = tr.RetryPolicy(sleep=lambda s: None)
    assert policy.is_retryable(tr.InjectedFault("x"))
    assert not policy.is_retryable(tr.FatalInjectedFault("x"))
    assert not policy.is_retryable(FileNotFoundError("x"))
    assert not policy.is_retryable(ValueError("x"))


@pytest.mark.parametrize("kwargs", [{}, {"base_delay_s": 0.1, "backoff": 3.0, "jitter": 0.5},
                                    {"max_attempts": 8, "max_delay_s": 0.3}])
def test_retry_delays_are_the_jax_packages(kwargs):
    mine = tr.RetryPolicy(**kwargs)
    ref = jr.RetryPolicy(**kwargs)
    for site in ("stream.read_part_file", "train.checkpoint.publish", "x"):
        assert ([mine.delay_for(site, a) for a in range(1, 10)]
                == [ref.delay_for(site, a) for a in range(1, 10)])


def _retry_outcome(pkg, failures: int, max_attempts: int = 3):
    slept = []
    policy = pkg.RetryPolicy(max_attempts=max_attempts, sleep=slept.append)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) <= failures:
            raise pkg.InjectedFault(f"flake {len(calls)}")
        return "ok"

    try:
        out = policy.run("site.r", flaky)
    except pkg.RetryExhausted as e:
        out = ("exhausted", e.attempts, type(e.last).__name__)
    return out, len(calls), slept


@pytest.mark.parametrize("failures", [0, 1, 2, 3])
def test_retry_outcomes_and_counters_match(failures):
    mine = _retry_outcome(tr, failures)
    ref = _retry_outcome(jr, failures)
    assert mine == ref
    assert (tt.get_registry().snapshot()["counters"]
            == jt.get_registry().snapshot()["counters"])
    ring = [{k: v for k, v in r.items()} for r in tr.recent_failures()]
    assert ring == jr.recent_failures()


def test_failure_ring_and_sinks():
    seen = []
    tr.add_failure_sink(seen.append)
    tr.add_failure_sink(seen.append)  # idempotent

    def boom(rec):
        raise RuntimeError("a sink that fails must not fail the caller")

    tr.add_failure_sink(boom)
    try:
        for i in range(300):
            tr.record_failure("block_skipped", "stream.build_block", f"d{i}", block=i)
    finally:
        tr.remove_failure_sink(seen.append)
        tr.remove_failure_sink(boom)
    ring = tr.recent_failures()
    assert len(ring) == 256 and ring[0]["seq"] == 45 and ring[-1]["block"] == 299
    assert tr.recent_failures(2) == ring[-2:]
    assert len(seen) == 300
    counters = tt.get_registry().snapshot()["counters"]
    assert counters["resilience.failures"] == 300
    assert counters["resilience.failures.block_skipped"] == 300
    tr.record_failure("x", "y")
    assert len(seen) == 300  # detached


def test_supervised_thread_restarts_then_dies():
    for pkg in (tr, jr):
        ticks = []
        stop = threading.Event()

        def body():
            ticks.append(1)
            if len(ticks) <= 2:
                raise RuntimeError(f"crash {len(ticks)}")
            stop.set()

        sup = pkg.SupervisedThread("t1", body, stop_event=stop, restart_backoff_s=0.001)
        sup.start()
        sup.join(timeout=30)
        assert not sup.is_alive()
        assert sup.stats() == {"name": "t1", "alive": False, "dead": False, "crashes": 2,
                               "restarts": 2, "last_error": "RuntimeError: crash 2"}
        dead = []
        doomed = pkg.SupervisedThread("t2", lambda: 1 / 0, max_restarts=2,
                                      restart_backoff_s=0.001, on_dead=dead.append)
        doomed.start()
        doomed.join(timeout=30)
        assert not doomed.is_alive()
        assert doomed.dead and doomed.crashes == 3 and doomed.restarts == 2
        assert dead == [doomed]
        health = doomed.health()
        assert health["healthy"] is False and "dead after 3 crashes" in health["degraded"]
    kinds = [r["kind"] for r in tr.recent_failures()]
    assert kinds == [r["kind"] for r in jr.recent_failures()]
    assert kinds.count("thread_crash") == 5 and kinds[-1] == "thread_dead"
    assert (tt.get_registry().snapshot()["counters"]
            == jt.get_registry().snapshot()["counters"])


def _glm(value, dim=4):
    return GeneralizedLinearModel(
        coefficients=Coefficients(means=torch.full((dim,), float(value))),
        task=TaskType.LINEAR_REGRESSION,
    )


def test_checkpoint_publish_fault_keeps_the_previous_generation(tmp_path):
    assert "train.checkpoint.publish" in tr.registered_fault_sites()
    path = str(tmp_path / "ckpt")
    ckpt.save_training_checkpoint(path, {"fixed": _glm(1.0)}, {"outer": 1})
    tr.configure_faults("train.checkpoint.publish=once:1")
    with pytest.raises(tr.InjectedFault):
        ckpt.save_training_checkpoint(path, {"fixed": _glm(2.0)}, {"outer": 2})
    assert not glob.glob(str(tmp_path / ".ckpt-*"))
    models, state, _ = ckpt.load_training_checkpoint(path, device="cpu")
    assert state["outer"] == 1
    assert float(models["fixed"].coefficients.means[0]) == 1.0
    ckpt.save_training_checkpoint(path, {"fixed": _glm(2.0)}, {"outer": 2})
    _, state, _ = ckpt.load_training_checkpoint(path, device="cpu")
    assert state["outer"] == 2
    assert tr.fault_stats()["train.checkpoint.publish"] == {"calls": 2, "trips": 1}


def test_fit_faulted_at_its_checkpoint_resumes_bitwise(tmp_path):
    from test_torch_cd_async import _problem, _torch_data
    from photon_ml_tpu_torch.data.random_effect import RandomEffectDataConfiguration
    from photon_ml_tpu_torch.estimators import game

    data = _torch_data(_problem(n_users=8, rows_per_user=12))

    def estimator(outer):
        return game.GameEstimator(
            task=TaskType.LINEAR_REGRESSION,
            coordinates={
                "fixed": game.FixedEffectCoordinateConfiguration("global"),
                "per-user": game.RandomEffectCoordinateConfiguration(
                    "per_user", RandomEffectDataConfiguration("userId")),
            },
            num_outer_iterations=outer, device="cpu",
        )

    path = str(tmp_path / "ckpt")
    uninterrupted = estimator(3).fit(data)
    tr.configure_faults("train.checkpoint.publish=once:2")
    with pytest.raises(tr.InjectedFault):
        estimator(3).fit(data, checkpoint_dir=path)
    _, state, _ = ckpt.load_training_checkpoint(path, device="cpu")
    assert state["completed_iterations"] == 1
    assert not glob.glob(str(tmp_path / ".ckpt-*"))
    resumed = estimator(3).fit(data, checkpoint_dir=path)
    assert resumed.objective_history == uninterrupted.objective_history
    for cid, m in uninterrupted.model.models.items():
        r = resumed.model.models[cid]
        if hasattr(m, "entity_ids"):
            assert all(np.array_equal(a.numpy(), b.numpy())
                       for a, b in zip(m.coefficients, r.coefficients))
        else:
            assert np.array_equal(m.coefficients.means.numpy(), r.coefficients.means.numpy())

"""The port's pointwise losses and evaluators against the JAX package's, on
the same seeded inputs. Tolerances: losses rtol 2e-4 (f32 elementwise);
metrics 1e-6 (the port evaluates in float64, the reference in float32 over
a few hundred rows)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_ml_tpu.evaluation import evaluators as jax_ev
from photon_ml_tpu.losses import pointwise as jax_pw
from photon_ml_tpu.types import TaskType as JaxTask
from photon_ml_tpu_torch.evaluation import evaluators as port_ev
from photon_ml_tpu_torch.losses import pointwise as port_pw
from photon_ml_tpu_torch.types import TaskType

LOSSES = ["LogisticLoss", "SquaredLoss", "PoissonLoss", "SmoothedHingeLoss"]


def _inputs(seed, n=400, ties=False):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal(n).astype(np.float32) * 3
    if ties:
        z = np.round(z, 1)
    y = (rng.random(n) < 0.4).astype(np.float32)
    w = rng.random(n).astype(np.float32) + 0.1
    w[::17] = 0.0
    return z, y, w


@pytest.mark.parametrize("name", LOSSES)
@pytest.mark.parametrize("fn", ["value", "d1", "d2"])
def test_losses_match_jax(name, fn):
    z, y, _ = _inputs(1)
    expected = np.asarray(getattr(getattr(jax_pw, name), fn)(jnp.asarray(z), jnp.asarray(y)))
    got = getattr(getattr(port_pw, name), fn)(torch.from_numpy(z), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, expected, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("task", list(TaskType))
def test_mean_function_and_task_loss_match_jax(task):
    z, _, _ = _inputs(2)
    jt = JaxTask[task.name]
    np.testing.assert_allclose(
        port_pw.mean_function(task, torch.from_numpy(z)).numpy(),
        np.asarray(jax_pw.mean_function(jt, jnp.asarray(z))), rtol=2e-4,
    )
    assert port_pw.loss_for_task(task).__name__ == jax_pw.loss_for_task(jt).__name__


@pytest.mark.parametrize("etype", [e for e in port_ev.EvaluatorType
                                   if e is not port_ev.EvaluatorType.PRECISION_AT_K])
@pytest.mark.parametrize("ties", [False, True])
def test_evaluators_match_jax(etype, ties):
    z, y, w = _inputs(3, ties=ties)
    if etype is port_ev.EvaluatorType.POISSON_LOSS:
        z = z / 3
    expected = jax_ev.evaluator_for(jax_ev.EvaluatorType[etype.name]).evaluate(z, y, w)
    got = port_ev.evaluator_for(etype).evaluate(torch.from_numpy(z), y, w)
    assert abs(got - expected) <= 1e-6 * max(1.0, abs(expected))


def test_auc_single_class_is_nan():
    z, _, w = _inputs(4)
    assert np.isnan(port_ev.AUC.evaluate(torch.from_numpy(z), np.ones_like(z), w))


@pytest.mark.parametrize("spec", ["AUC:g", "PRECISION@3:g", "RMSE"])
def test_spec_strings_match_jax(spec):
    from photon_ml_tpu.cli.train_game import _make_evaluator

    z, y, w = _inputs(5, n=200)
    groups = np.array([f"g{i % 9}" for i in range(200)])

    class Data:
        id_tags = {"g": groups}

    expected = _make_evaluator(spec, JaxTask.LOGISTIC_REGRESSION, Data).evaluate(z, y, w)
    ev = port_ev.make_evaluator(spec, Data)
    assert ev.name == _make_evaluator(spec, JaxTask.LOGISTIC_REGRESSION, Data).name
    assert abs(ev.evaluate(torch.from_numpy(z), y, w) - expected) <= 1e-6


def test_bad_specs_raise():
    with pytest.raises(ValueError, match="precision@k"):
        port_ev.make_evaluator("PRECISION@0", None)
    with pytest.raises(KeyError):
        port_ev.make_evaluator("NOPE", None)

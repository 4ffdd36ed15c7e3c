"""Down-sampling in the port against the JAX package:

- both samplers give the same weights bitwise from the same seed, and the
  task picks the same sampler;
- a fixed-effect solve at ``down_sampling_rate`` 0.5: coefficients atol
  2e-3, objectives rtol 1e-4;
- a random-effect coordinate ignores its rate, as the JAX package's does:
  the fit equals the JAX fit (objectives rtol 1e-4, coefficients atol 2e-3)
  and the port's own fit without the rate, bitwise.
"""

import dataclasses

import numpy as np
import pytest

from _torch_parity import glmix_numpy, jax_game_data, solver_configs, torch_game_data
from photon_ml_tpu import sampler as jax_sampler
from photon_ml_tpu.data.random_effect import RandomEffectDataConfiguration as JaxReData
from photon_ml_tpu.estimators import game as jax_game
from photon_ml_tpu.types import TaskType as JaxTask
from photon_ml_tpu_torch import sampler
from photon_ml_tpu_torch.data.random_effect import RandomEffectDataConfiguration
from photon_ml_tpu_torch.estimators import game
from photon_ml_tpu_torch.types import TaskType


@pytest.mark.parametrize("name", ["DefaultDownSampler", "BinaryClassificationDownSampler"])
@pytest.mark.parametrize("rate", [0.1, 0.5, 0.9])
def test_sampler_weights_equal_jax_bitwise(name, rate):
    rng = np.random.default_rng(7)
    labels = (rng.random(1000) < 0.3).astype(np.float32)
    weights = (rng.random(1000) + 0.5).astype(np.float32)
    got = getattr(sampler, name)(rate).sample_weights(labels, weights, seed=11)
    want = getattr(jax_sampler, name)(rate).sample_weights(labels, weights, seed=11)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("task", list(TaskType), ids=lambda t: t.name)
def test_task_picks_the_same_sampler(task):
    assert (type(sampler.down_sampler_for(task, 0.5)).__name__
            == type(jax_sampler.down_sampler_for(JaxTask[task.name], 0.5)).__name__)
    with pytest.raises(ValueError, match="down_sampling_rate"):
        sampler.down_sampler_for(task, 1.5)


def _configs(rate):
    return tuple(dataclasses.replace(c, down_sampling_rate=rate)
                 for c in solver_configs(max_iterations=30))


def _fit(coordinates, data, outer=1):
    """One fit in each package: ``coordinates`` maps a coordinate id to
    (feature shard, random-effect type or None, JAX config, port config)."""
    jc, tc = {}, {}
    for cid, (shard, re_type, jo, to) in coordinates.items():
        if re_type is None:
            jc[cid] = jax_game.FixedEffectCoordinateConfiguration(shard, jo, sparse_engine="ell")
            tc[cid] = game.FixedEffectCoordinateConfiguration(shard, to)
        else:
            jc[cid] = jax_game.RandomEffectCoordinateConfiguration(shard, JaxReData(re_type), jo)
            tc[cid] = game.RandomEffectCoordinateConfiguration(
                shard, RandomEffectDataConfiguration(re_type), to)
    jfit = jax_game.GameEstimator(JaxTask.LOGISTIC_REGRESSION, jc,
                                  num_outer_iterations=outer).fit(jax_game_data(*data))
    tfit = game.GameEstimator(TaskType.LOGISTIC_REGRESSION, tc, num_outer_iterations=outer,
                              device="cpu").fit(torch_game_data(*data))
    return jfit, tfit


def test_down_sampled_fixed_effect_matches_jax():
    data = glmix_numpy(21, n=400)[:3]
    jo, to = _configs(0.5)
    jfit, tfit = _fit({"fixed": ("global", None, jo, to)}, data)
    np.testing.assert_allclose(
        tfit.model.models["fixed"].coefficients.means.numpy(),
        np.asarray(jfit.model.models["fixed"].coefficients.means), rtol=0, atol=2e-3)
    np.testing.assert_allclose([v for _, v in tfit.objective_history],
                               [v for _, v in jfit.objective_history], rtol=1e-4)
    # the sampled weights differ from the full data's: a different solve
    _, full = _fit({"fixed": ("global", None, *_configs(1.0))}, data)
    assert not np.allclose(full.model.models["fixed"].coefficients.means.numpy(),
                           tfit.model.models["fixed"].coefficients.means.numpy())


def test_random_effect_ignores_its_rate_as_jax_does():
    data = glmix_numpy(22, n=400)[:3]
    jo, to = _configs(1.0)
    jo_half, to_half = _configs(0.5)
    coordinates = {"fixed": ("global", None, jo, to),
                   "per_user": ("per_user", "userId", jo_half, to_half)}
    jfit, tfit = _fit(coordinates, data)
    np.testing.assert_allclose([v for _, v in tfit.objective_history],
                               [v for _, v in jfit.objective_history], rtol=1e-4)
    for jw, tw in zip(jfit.model.models["per_user"].coefficients,
                      tfit.model.models["per_user"].coefficients):
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=2e-3)
    coordinates["per_user"] = ("per_user", "userId", jo, to)
    _, unsampled = _fit(coordinates, data)
    assert tfit.objective_history == unsampled.objective_history

"""Random-effect training in the port against the JAX package.

- ``build_random_effect_dataset``: the buckets equal the reference's, array
  for array, under every planning option (bucketing, active cap + passive
  rows, Pearson feature filter, the three projectors);
- ``train_random_effects``: coefficients and variances against the JAX
  solves (atol 2e-3: 30 L-BFGS iterations in f32 with sums in another
  order; TRON, and OWL-QN for L1 and elastic net, likewise), and the
  adaptive driver equal to the one-shot dispatch inside the port, bitwise,
  as the reference promises;
- device scoring through ``row_gather`` and the offset regroup equal the
  reference's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_ml_tpu.data import random_effect as jax_re_data
from photon_ml_tpu.estimators import random_effect as jax_re
from photon_ml_tpu.opt import config as jax_config
from photon_ml_tpu.projector import ProjectorType as JaxProjector
from photon_ml_tpu.types import RegularizationType as JaxReg
from photon_ml_tpu.types import TaskType as JaxTask
from _torch_parity import solver_configs
from photon_ml_tpu_torch.data import random_effect as re_data
from photon_ml_tpu_torch.estimators import random_effect
from photon_ml_tpu_torch.opt import config
from photon_ml_tpu_torch.projector import ProjectorType
from photon_ml_tpu_torch.types import RegularizationType, TaskType


def _rows(seed, n=500, n_ent=41, d=30, k=4):
    """Zipf-skewed entities, k features a row out of d, labels, weights."""
    rng = np.random.default_rng(seed)
    ids = np.array([f"e{i}" for i in rng.zipf(1.6, n) % n_ent])
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(0, d, n * k)
    vals = rng.standard_normal(n * k).astype(np.float32)
    labels = (rng.random(n) < 0.5).astype(np.float32)
    offsets = (rng.standard_normal(n) * 0.2).astype(np.float32)
    weights = (rng.random(n) + 0.5).astype(np.float32)
    return ids, rows, cols, vals, d, labels, offsets, weights


PLANS = {
    "one_bucket": {},
    "buckets": {"num_buckets": 3},
    "cap_passive_filter": {"num_buckets": 2, "active_data_upper_bound": 9,
                           "passive_data_lower_bound": 3,
                           "features_to_samples_ratio": 0.8, "max_local_features": 7,
                           "seed": 5},
    "identity": {"projector": "IDENTITY", "num_buckets": 2},
    "random": {"projector": "RANDOM", "projected_dim": 6, "active_data_upper_bound": 12},
}


def _build_both(plan, seed=0):
    ids, rows, cols, vals, d, labels, offsets, weights = _rows(seed)
    kw = dict(PLANS[plan])
    proj = kw.pop("projector", "INDEX_MAP")
    jds = jax_re_data.build_random_effect_dataset(
        ids, rows, cols, vals, d, labels,
        jax_re_data.RandomEffectDataConfiguration("u", projector=JaxProjector[proj], **kw),
        offsets=offsets, weights=weights,
    )
    tds = re_data.build_random_effect_dataset(
        ids, rows, cols, vals, d, labels,
        re_data.RandomEffectDataConfiguration("u", projector=ProjectorType[proj], **kw),
        offsets=offsets, weights=weights, device="cpu",
    )
    return jds, tds, offsets


@pytest.mark.parametrize("plan", list(PLANS))
def test_buckets_equal_the_reference(plan):
    jds, tds, _ = _build_both(plan)
    assert tds.entity_ids == jds.entity_ids
    assert tds.entity_to_loc == jds.entity_to_loc
    assert len(tds.buckets) == len(jds.buckets)
    for jb, tb in zip(jds.buckets, tds.buckets):
        for f in ("X", "labels", "offsets", "weights", "sample_pos", "proj_indices",
                  "proj_valid"):
            np.testing.assert_array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)))
    for jp, tp in zip(jds.passive, tds.passive):
        assert (jp is None) == (tp is None)
        if jp is not None:
            for f in ("X", "entity_index", "sample_pos"):
                np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)))
    np.testing.assert_array_equal(tds.row_gather.numpy(), np.asarray(jds.row_gather))
    assert tds.to_summary_string() == jds.to_summary_string()


def test_offset_regroup_equals_the_reference():
    jds, tds, offsets = _build_both("cap_passive_filter")
    new = (offsets + np.arange(offsets.size, dtype=np.float32) * 0.01).astype(np.float32)
    jnew = jds.update_offsets_device(jnp.asarray(new))
    tnew = tds.update_offsets_device(torch.from_numpy(new))
    for jb, tb in zip(jnew.buckets, tnew.buckets):
        np.testing.assert_array_equal(tb.offsets.numpy(), np.asarray(jb.offsets))


def _configs(adaptive: bool, max_iterations=30):
    adapt = dict(enabled=adaptive, chunk_iters=3, min_lanes=2)
    return (
        jax_config.GlmOptimizationConfiguration(
            optimizer_config=jax_config.OptimizerConfig(max_iterations=max_iterations),
            regularization=jax_config.RegularizationContext(JaxReg.L2),
            regularization_weight=1.0,
            adaptive=jax_config.AdaptiveSolveConfig(**adapt),
        ),
        config.GlmOptimizationConfiguration(
            optimizer_config=config.OptimizerConfig(max_iterations=max_iterations),
            regularization=config.RegularizationContext(RegularizationType.L2),
            regularization_weight=1.0,
            adaptive=config.AdaptiveSolveConfig(**adapt),
        ),
    )


@pytest.mark.parametrize("plan,task", [
    (plan, task)
    for plan in ("buckets", "cap_passive_filter")
    for task in ("LOGISTIC_REGRESSION", "LINEAR_REGRESSION", "POISSON_REGRESSION")
] + [("identity", "LOGISTIC_REGRESSION"), ("random", "LINEAR_REGRESSION")])
def test_train_random_effects_matches_jax(plan, task):
    jds, tds, _ = _build_both(plan, seed=1)
    jcfg, tcfg = _configs(adaptive=True)
    jm, _ = jax_re.train_random_effects(jds, JaxTask[task], jcfg, compute_variances=True)
    tm, results = random_effect.train_random_effects(
        tds, TaskType[task], tcfg, compute_variances=True
    )
    assert len(results) == len(tds.buckets)
    for a, b in zip(jm.coefficients, tm.coefficients):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-3)
    for a, b in zip(jm.variances, tm.variances):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-2, atol=2e-3)
    np.testing.assert_allclose(
        random_effect.score_random_effects_device(tm, tds).numpy(),
        np.asarray(jax_re.score_random_effects_device(jm, jds)), atol=5e-3,
    )
    # scoring the same coefficients: one gather, equal to the reference's
    jm_same = dataclasses.replace(jm, coefficients=[jnp.asarray(w.numpy()) for w in tm.coefficients])
    np.testing.assert_allclose(
        random_effect.score_random_effects_device(tm, tds).numpy(),
        np.asarray(jax_re.score_random_effects_device(jm_same, jds)), rtol=1e-5, atol=1e-6,
    )


def test_adaptive_driver_equals_one_shot_bitwise():
    _, tds, _ = _build_both("buckets", seed=2)
    out = {}
    for adaptive in (True, False):
        _, tcfg = _configs(adaptive=adaptive, max_iterations=20)
        out[adaptive] = random_effect.train_random_effects(
            tds, TaskType.LOGISTIC_REGRESSION, tcfg, compute_variances=True
        )
    (ma, ra), (mo, ro) = out[True], out[False]
    assert any(b.num_entities > 2 for b in tds.buckets)  # the adaptive path ran
    for a, b in zip(ma.coefficients, mo.coefficients):
        assert torch.equal(a, b)
    for a, b in zip(ma.variances, mo.variances):
        assert torch.equal(a, b)
    for a, b in zip(ra, ro):
        assert torch.equal(a.iterations, b.iterations) and torch.equal(a.reason, b.reason)
        assert torch.equal(a.value, b.value)


def test_warm_start_and_unported_options():
    _, tds, _ = _build_both("one_bucket", seed=3)
    _, tcfg = _configs(adaptive=False, max_iterations=5)
    m1, _ = random_effect.train_random_effects(tds, TaskType.LOGISTIC_REGRESSION, tcfg)
    m2, r2 = random_effect.train_random_effects(
        tds, TaskType.LOGISTIC_REGRESSION, tcfg, initial_model=m1
    )
    # warm-started from the first solve, the second starts lower
    assert float(r2[0].value_history[:, 0].sum()) < float(
        random_effect.train_random_effects(tds, TaskType.LOGISTIC_REGRESSION, tcfg)[1][0]
        .value_history[:, 0].sum()
    )
    # L1 selects OWL-QN, as in the JAX package; TRON with L1 is refused
    jds, _, _ = _build_both("one_bucket", seed=3)
    jl1, l1 = _solver_configs("LBFGS", "L1")
    jm, _ = jax_re.train_random_effects(jds, JaxTask.LOGISTIC_REGRESSION, jl1)
    tm, _ = random_effect.train_random_effects(tds, TaskType.LOGISTIC_REGRESSION, l1)
    np.testing.assert_allclose(tm.coefficients[0].numpy(), np.asarray(jm.coefficients[0]),
                               atol=2e-3)
    _, tron_l1 = _solver_configs("TRON", "L1")
    with pytest.raises(ValueError, match="TRON does not support L1"):
        random_effect.train_random_effects(tds, TaskType.LOGISTIC_REGRESSION, tron_l1)


def _solver_configs(optimizer, reg, adaptive=True):
    adapt = dict(enabled=adaptive, chunk_iters=3, min_lanes=2)
    alpha = 0.5 if reg == "ELASTIC_NET" else None
    jcfg, tcfg = solver_configs(optimizer, reg, 1.0, alpha)
    return (
        dataclasses.replace(jcfg, adaptive=jax_config.AdaptiveSolveConfig(**adapt)),
        dataclasses.replace(tcfg, adaptive=config.AdaptiveSolveConfig(**adapt)),
    )


@pytest.mark.parametrize("optimizer,reg,task", [
    ("TRON", "L2", "LOGISTIC_REGRESSION"),
    ("TRON", "L2", "POISSON_REGRESSION"),
    ("LBFGS", "L1", "LINEAR_REGRESSION"),
    ("LBFGS", "ELASTIC_NET", "LOGISTIC_REGRESSION"),
])
def test_tron_and_owlqn_random_effects_match_jax(optimizer, reg, task):
    """Batched TRON and OWL-QN entity solves through the adaptive driver
    against the JAX package's: coefficients atol 2e-3 where the optimum
    is sharp (TRON), objectives rtol 1e-4 (an L1 optimum leaves w less
    determined than F). Against the one-shot dispatch: objectives rtol
    1e-5, coefficients atol 2e-4. Not bitwise, as L-BFGS is: the CPU's
    plain value+gradient rounds a lane's last bit differently in a batch of
    another width, and TRON's acceptance test near an optimum compares f at
    that rounding (the reference promises 1e-5 here, not bits). The solver
    stats count the buckets."""
    jds, tds, _ = _build_both("buckets", seed=4)
    jcfg, tcfg = _solver_configs(optimizer, reg)
    jm, jres = jax_re.train_random_effects(jds, JaxTask[task], jcfg, compute_variances=True)
    stats = []
    tm, tres = random_effect.train_random_effects(tds, TaskType[task], tcfg,
                                                  compute_variances=True, stats_out=stats)
    for a, b in zip(jres, tres):
        np.testing.assert_allclose(b.value.numpy(), np.asarray(a.value), rtol=1e-4, atol=1e-6)
    if optimizer == "TRON":
        for a, b in zip(jm.coefficients, tm.coefficients):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-3)
        for a, b in zip(jm.variances, tm.variances):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-2, atol=2e-3)
    kind = "tron" if optimizer == "TRON" else "owlqn"
    assert [s.optimizer for s in stats] == [kind] * len(tds.buckets)
    assert [s.num_entities for s in stats] == [b.num_entities for b in tds.buckets]
    _, oneshot = _solver_configs(optimizer, reg, adaptive=False)
    om, ores = random_effect.train_random_effects(tds, TaskType[task], oneshot)
    for a, b in zip(ores, tres):
        np.testing.assert_allclose(b.value.numpy(), a.value.numpy(), rtol=1e-5, atol=1e-7)
    for a, b in zip(om.coefficients, tm.coefficients):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=2e-4)

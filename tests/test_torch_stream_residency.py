"""The port's HBM residency plane and gap scheduler
(``photon_ml_tpu_torch/streaming/residency.py``, ``gapsched.py``) against
the JAX package's: for the same seeded gap trajectories and seeds, the same
epoch orders, exploration picks, pin and evict decisions, budgets,
snapshots and registry gauges; the same validation errors; and a streamed
coordinate with residency on serves the same blocks from the resident set
as the JAX one, with the same h2d bytes, bitwise the non-resident solve.
"""

import numpy as np
import pytest
import torch

import photon_ml_tpu.streaming as js
import photon_ml_tpu.telemetry as jt
import photon_ml_tpu_torch.streaming as ts
import photon_ml_tpu_torch.telemetry as tt
from photon_ml_tpu.io import data_reader as jdr
from photon_ml_tpu_torch.io import data_reader as tdr
from test_torch_streaming import BLOCK_ROWS, _shards, write_stream_dataset

NUM_BLOCKS = 12


def _gap_trajectory(seed, epochs, num_blocks=NUM_BLOCKS):
    """Per epoch a dict block -> gap over a seeded random subset (signed:
    the first-order surrogate can go slightly negative)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(epochs):
        visited = rng.choice(num_blocks, size=rng.integers(1, num_blocks + 1), replace=False)
        out.append({int(b): float(g) for b, g in zip(visited, rng.normal(size=visited.size))})
    return out


@pytest.fixture(autouse=True)
def _registries():
    for pkg in (tt, jt):
        pkg.get_registry().reset()
    yield
    for pkg in (tt, jt):
        pkg.get_registry().reset()


def _gauges(pkg, prefix):
    snap = pkg.get_registry().snapshot()
    return {k: v for k, v in snap.get("gauges", {}).items() if k.startswith(prefix)}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kw", [{}, {"decay": 0.3, "explore": 0.25, "visit_fraction": 0.3},
                                {"explore": 0.0, "visit_fraction": 1.0}])
def test_gap_scheduler_decisions_equal_jax(seed, kw):
    t = ts.GapScheduler(NUM_BLOCKS, seed=seed, **kw)
    j = js.GapScheduler(NUM_BLOCKS, seed=seed, **kw)
    for epoch, gaps in enumerate(_gap_trajectory(seed + 10, 8)):
        assert t.epoch_order().tolist() == j.epoch_order().tolist()
        if epoch == 4:
            t.mark_failed([3, 7])
            j.mark_failed([3, 7])
        t.update(gaps)
        j.update(gaps)
        assert np.array_equal(t.effective_scores(), j.effective_scores())
    assert t.drain_decisions() == j.drain_decisions()
    assert _gauges(tt, "stream.gap_sched") == _gauges(jt, "stream.gap_sched") != {}


def test_gap_scheduler_orders_group_by_part_file_as_jax(tmp_path):
    paths, _ = write_stream_dataset(tmp_path)
    tsrc = ts.StreamingSource.open(paths, _shards(tdr), index_maps=tdr.build_index_maps(
        paths, _shards(tdr)), block_rows=BLOCK_ROWS // 2)
    jsrc = js.StreamingSource.open(paths, _shards(jdr), index_maps=jdr.build_index_maps(
        paths, _shards(jdr)), block_rows=BLOCK_ROWS // 2)
    nb = tsrc.plan.num_blocks
    t = ts.GapScheduler(nb, plan=tsrc.plan, seed=4)
    j = js.GapScheduler(nb, plan=jsrc.plan, seed=4)
    for gaps in _gap_trajectory(5, 6, nb):
        assert t.epoch_order().tolist() == j.epoch_order().tolist()
        t.update(gaps)
        j.update(gaps)


@pytest.mark.parametrize("bad", [{"num_blocks": 0}, {"decay": 0.0}, {"explore": 1.5},
                                 {"visit_fraction": 0.0}])
def test_gap_scheduler_validation_equal_jax(bad):
    args = {"num_blocks": 4, **bad}
    for pkg in (ts, js):
        with pytest.raises(ValueError):
            pkg.GapScheduler(**args)
    every = ts.GapScheduler(2)
    every.mark_failed([0, 1])
    with pytest.raises(RuntimeError, match="every block is excluded"):
        every.epoch_order()


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("budget", [{"max_blocks": 3}, {"max_bytes": 5000},
                                    {"max_blocks": 5, "max_bytes": 3500}])
def test_residency_decisions_equal_jax(seed, budget):
    t = ts.ResidencyManager(NUM_BLOCKS, 1000, **budget)
    j = js.ResidencyManager(NUM_BLOCKS, 1000, **budget)
    assert t.capacity == j.capacity
    rng = np.random.default_rng(seed)
    for epoch, gaps in enumerate(_gap_trajectory(seed, 7)):
        for b in rng.permutation(NUM_BLOCKS):
            entry = object()
            assert t.offer(int(b), entry) == j.offer(int(b), entry)
            assert (t.get(int(b)) is None) == (j.get(int(b)) is None)
        if epoch == 3:
            failed = [int(rng.integers(NUM_BLOCKS))]
            t.mark_failed(failed)
            j.mark_failed(failed)
        t.update_gaps(gaps)
        j.update_gaps(gaps)
        assert t.repin() == j.repin()
        assert t.resident_indices() == j.resident_indices()
    assert t.drain_decisions() == j.drain_decisions()
    assert t.snapshot() == j.snapshot()
    assert _gauges(tt, "stream.residency") == _gauges(jt, "stream.residency") != {}


def test_residency_attached_to_the_scheduler_equal_jax():
    out = []
    for pkg in (ts, js):
        mgr = pkg.ResidencyManager(NUM_BLOCKS, 10, max_blocks=4)
        sched = pkg.GapScheduler(NUM_BLOCKS, seed=1)
        sched.attach_residency(mgr)
        for b in range(NUM_BLOCKS):
            mgr.offer(b, object())
        for gaps in _gap_trajectory(8, 4):
            sched.epoch_order()
            sched.update(gaps)
        sched.mark_failed([int(mgr.resident_indices()[0])])
        out.append((mgr.resident_indices(), mgr.drain_decisions(), sched.drain_decisions()))
    assert out[0] == out[1]


@pytest.mark.parametrize("bad", [{"num_blocks": 0}, {"block_bytes": 0}, {"decay": 2.0},
                                 {"max_blocks": -1}, {"max_bytes": 10}])
def test_residency_validation_equal_jax(bad):
    args = {"num_blocks": 4, "block_bytes": 100, **bad}
    for pkg in (ts, js):
        with pytest.raises(ValueError):
            pkg.ResidencyManager(**args)


def test_resident_coordinate_serves_the_same_blocks_as_jax(tmp_path):
    """A full-batch streamed solve with residency on: the same resident set,
    hits and h2d bytes as the JAX coordinate, and bitwise the port's
    solve with residency off."""
    from photon_ml_tpu.opt.config import GlmOptimizationConfiguration as JCfg
    from photon_ml_tpu.opt.config import RegularizationContext as JReg
    from photon_ml_tpu.types import RegularizationType as JRT
    from photon_ml_tpu.types import TaskType as JTask
    from photon_ml_tpu_torch.opt.config import GlmOptimizationConfiguration as TCfg
    from photon_ml_tpu_torch.opt.config import RegularizationContext as TReg
    from photon_ml_tpu_torch.types import RegularizationType as TRT
    from photon_ml_tpu_torch.types import TaskType as TTask

    paths, _ = write_stream_dataset(tmp_path)
    tsrc = ts.StreamingSource.open(paths, _shards(tdr), index_maps=tdr.build_index_maps(
        paths, _shards(tdr)), block_rows=BLOCK_ROWS)
    jsrc = js.StreamingSource.open(paths, _shards(jdr), index_maps=jdr.build_index_maps(
        paths, _shards(jdr)), block_rows=BLOCK_ROWS)
    tcfg = TCfg(regularization=TReg(TRT.L2), regularization_weight=0.5)
    jcfg = JCfg(regularization=JReg(JRT.L2), regularization_weight=0.5)

    def port(**kw):
        return ts.StreamingFixedEffectCoordinate(
            source=tsrc, shard_id="global", task=TTask.LOGISTIC_REGRESSION,
            configuration=tcfg, device="cpu", **kw)

    tcoord = port(resident_blocks=2)
    jcoord = js.StreamingFixedEffectCoordinate(
        source=jsrc, shard_id="global", task=JTask.LOGISTIC_REGRESSION, configuration=jcfg,
        resident_blocks=2)
    tmodel = tcoord.update_model_device(None, torch.zeros(tsrc.plan.total_rows))
    import jax.numpy as jnp

    jcoord.update_model_device(None, jnp.zeros(jsrc.plan.total_rows, jnp.float32))
    tmgr, jmgr = tcoord._residency, jcoord._residency
    assert tmgr.resident_indices() == jmgr.resident_indices()
    assert tmgr.stats.hbm_hit_blocks == jmgr.stats.hbm_hit_blocks > 0
    assert tmgr.stats.hbm_hit_bytes == jmgr.stats.hbm_hit_bytes
    # after pinning, a pass uploads only the non-resident remainder
    assert tcoord.last_prefetch_stats.h2d_bytes == (
        tsrc.plan.num_blocks - 2) * tsrc.block_upload_bytes(("global",))
    assert tcoord.last_prefetch_stats.h2d_bytes == jcoord.last_prefetch_stats.h2d_bytes
    off = port(collect_block_stats=True).update_model_device(
        None, torch.zeros(tsrc.plan.total_rows))
    assert torch.equal(off.coefficients.means, tmodel.coefficients.means)
    hier, ref = ts.residency_hierarchy(tsrc, tmgr), js.residency_hierarchy(jsrc, jmgr)
    assert hier["hbm"] == ref["hbm"] and hier["ram"]["files_decoded"] == ref["ram"][
        "files_decoded"]

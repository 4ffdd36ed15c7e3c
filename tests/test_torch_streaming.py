"""The port's streaming out-of-core training (``photon_ml_tpu_torch/streaming``)
against the JAX package's, at the JAX tests' sizes (tests/test_streaming.py:
3 uneven part files of 250/270/180 rows, blocks of 128 rows, so blocks
straddle files and the last one is ragged):

- the block plan (widths, dims, bounds, spans) is equal; every HostBlock's
  arrays and the RowPlanes are bitwise equal;
- the prefetcher visits the same blocks in the same order and counts the
  same h2d bytes at depth 0 and 2;
- ``solve_streaming`` reaches the JAX solve's coefficients (atol 2e-3) and
  objective (rtol 1e-4); the streamed objective and gradient equal the
  in-memory ones; TRON and L1 are refused;
- the stochastic mode draws the JAX package's block orders (blind
  permutations and gap-scheduler orders, exactly);
- residency on is bitwise residency off, with fewer h2d bytes;
- the count of program constructions does not grow with blocks, passes or
  fits;
- ``fit_streaming`` against the JAX ``fit_streaming`` (GLMix: scores rtol
  2e-4, AUC 1e-4), against the port's in-memory ``fit``, and its refusals;
- ``on_block_error=skip`` through the ``stream.build_block`` fault point
  skips the same blocks in both packages, and the skip lands in the
  progress ledger;
- both ``train_game --streaming`` CLIs produce models within the same
  tolerances.

Tests assert on outputs and counts, never on host timing.
"""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

import photon_ml_tpu.resilience as jr
import photon_ml_tpu.streaming as js
import photon_ml_tpu.telemetry as jt
import photon_ml_tpu_torch.resilience as tr
import photon_ml_tpu_torch.streaming as ts
import photon_ml_tpu_torch.telemetry as tt
from photon_ml_tpu.io import data_reader as jdr
from photon_ml_tpu_torch.io import data_reader as tdr

FILE_ROWS = (250, 270, 180)  # uneven on purpose: blocks straddle files
N_ROWS = sum(FILE_ROWS)
D_GLOBAL = 12
D_USER = 4
N_USERS = 10
BLOCK_ROWS = 128  # 700 rows -> 6 blocks, the last one ragged (60 real rows)


def _shards(dr):
    return {
        "global": dr.FeatureShardConfiguration(feature_bags=("features",), add_intercept=True),
        "per_user": dr.FeatureShardConfiguration(feature_bags=("userFeatures",),
                                                 add_intercept=False),
    }


@pytest.fixture(autouse=True)
def _clean_planes():
    for pkg in (tr, jr):
        pkg.configure_faults({})
        pkg.reset_faults()
        pkg.clear_failures()
    yield
    for pkg in (tr, jr):
        pkg.configure_faults({})
        pkg.reset_faults()
        pkg.clear_failures()
    for pkg in (tt, jt):
        pkg.get_registry().reset()


def write_stream_dataset(root):
    """Synthetic GLMix logistic data over 3 uneven Avro part files (the JAX
    streaming tests' fixture), written by the port's writer; returns the
    part-file paths and the labels."""
    rng = np.random.default_rng(11)
    Xg = rng.normal(size=(N_ROWS, D_GLOBAL)).astype(np.float32)
    Xu = rng.normal(size=(N_ROWS, D_USER)).astype(np.float32)
    users = rng.integers(0, N_USERS, size=N_ROWS)
    wg = rng.normal(size=D_GLOBAL).astype(np.float32)
    wu = {u: rng.normal(size=D_USER).astype(np.float32) for u in range(N_USERS)}
    z = Xg @ wg + np.array([Xu[i] @ wu[users[i]] for i in range(N_ROWS)], np.float32)
    y = (1.0 / (1.0 + np.exp(-z)) > rng.random(N_ROWS)).astype(np.float32)
    paths, row = [], 0
    for fi, n in enumerate(FILE_ROWS):
        recs = [{
            "uid": f"r{i}",
            "label": float(y[i]),
            "weight": 1.0 + (i % 2),  # non-trivial weights
            "features": [("g", str(j), float(Xg[i, j])) for j in range(D_GLOBAL)],
            "userFeatures": [("u", str(j), float(Xu[i, j])) for j in range(D_USER)],
            "metadataMap": {"userId": f"u{users[i]:02d}"},
        } for i in range(row, row + n)]
        p = os.path.join(str(root), f"part-{fi:05d}.avro")
        tdr.write_training_examples(p, recs)
        paths.append(p)
        row += n
    return paths, y


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("stream")
    paths, y = write_stream_dataset(root)
    return {
        "root": str(root), "paths": paths, "labels": y,
        "tmaps": tdr.build_index_maps(paths, _shards(tdr)),
        "jmaps": jdr.build_index_maps(paths, _shards(jdr)),
    }


def _open(pkg, dataset, **kw):
    dr, maps = (tdr, dataset["tmaps"]) if pkg is ts else (jdr, dataset["jmaps"])
    kw.setdefault("block_rows", BLOCK_ROWS)
    return pkg.StreamingSource.open(dataset["paths"], _shards(dr), index_maps=maps,
                                    id_tags=("userId",), **kw)


@pytest.fixture(scope="module")
def sources(dataset):
    return _open(ts, dataset), _open(js, dataset)


@pytest.fixture(scope="module")
def mem_data(dataset):
    tdata, _, _ = tdr.read_game_data(dataset["paths"], _shards(tdr), dataset["tmaps"],
                                     id_tags=("userId",))
    jdata, _, _ = jdr.read_game_data(dataset["paths"], _shards(jdr), dataset["jmaps"],
                                     id_tags=("userId",))
    return tdata, jdata


def _cfg(pkg_opt, lam=0.5, **kw):
    return pkg_opt.GlmOptimizationConfiguration(
        regularization=pkg_opt.RegularizationContext(_l2_type(pkg_opt)),
        regularization_weight=lam, **kw)


def _l2_type(pkg_opt):
    if pkg_opt.__name__.startswith("photon_ml_tpu_torch"):
        from photon_ml_tpu_torch.types import RegularizationType
    else:
        from photon_ml_tpu.types import RegularizationType
    return RegularizationType.L2


def _topt():
    import photon_ml_tpu_torch.opt.config as c
    return c


def _jopt():
    import photon_ml_tpu.opt.config as c
    return c


def _t_blocks(source, shard="global", depth=2):
    return lambda: (blk.data[shard] for blk in ts.BlockPrefetcher(
        source, shards=(shard,), depth=depth, device="cpu"))


def _j_blocks(source, shard="global"):
    return lambda: (blk.data[shard] for blk in js.BlockPrefetcher(source, shards=(shard,)))


def _t_objective():
    from photon_ml_tpu_torch.losses.objective import make_glm_objective
    from photon_ml_tpu_torch.losses.pointwise import LogisticLoss
    return make_glm_objective(LogisticLoss)


def _j_objective():
    from photon_ml_tpu.losses.objective import make_glm_objective
    from photon_ml_tpu.losses.pointwise import LogisticLoss
    return make_glm_objective(LogisticLoss)


# ------------------------------------------------------- host ELL packing
@pytest.mark.parametrize("seed", [0, 1])
def test_pack_ell_equals_jax(seed):
    """``ops.features.pack_ell_host`` / ``pack_ell_into`` against the JAX
    package's: duplicates summed, int32 indices, piecewise packing equal
    to whole-block packing, the same refusal of an overfull row."""
    from photon_ml_tpu.ops import features as jf
    from photon_ml_tpu_torch.ops import features as tf

    rng = np.random.default_rng(seed)
    n, d, nnz = 40, 30, 200
    rows, cols = rng.integers(0, n, nnz), rng.integers(0, d, nnz)
    vals = rng.standard_normal(nnz).astype(np.float32)
    mine, ref = tf.pack_ell_host(rows, cols, vals, (n, d)), jf.pack_ell_host(rows, cols, vals,
                                                                             (n, d))
    for a, b in zip(mine, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert mine[1].dtype == np.int32
    k = mine[0].shape[1]
    out = (np.zeros((n, k), np.float32), np.zeros((n, k), np.int32))
    for lo, hi in ((0, 17), (17, n)):  # row-disjoint pieces
        keep = (rows >= lo) & (rows < hi)
        tf.pack_ell_into(rows[keep], cols[keep], vals[keep], *out, num_cols=d)
    assert np.array_equal(out[0], mine[0]) and np.array_equal(out[1], mine[1])
    for pkg in (tf, jf):
        with pytest.raises(ValueError, match="exceeds max_nnz"):
            pkg.pack_ell_host(rows, cols, vals, (n, d), max_nnz=1)


# ------------------------------------------------------------------ the plan
def test_plan_is_equal(sources):
    tsrc, jsrc = sources
    tp, jp = tsrc.plan, jsrc.plan
    assert tp.num_blocks == jp.num_blocks == 6
    for f in ("block_rows", "total_rows", "files", "file_rows", "shard_widths",
              "shard_dims", "padded_rows"):
        assert getattr(tp, f) == getattr(jp, f), f
    for b in range(tp.num_blocks):
        assert tp.block_bounds(b) == jp.block_bounds(b)
        assert tp.spans(b) == jp.spans(b)
    order = [5, 0, 3, 1, 4, 2]
    assert ts.group_by_part_file(order, tp) == js.group_by_part_file(order, jp)
    assert tsrc.block_upload_bytes() == jsrc.block_upload_bytes()
    assert tsrc.block_upload_bytes(("global",)) == jsrc.block_upload_bytes(("global",))
    assert tsrc.block_feature_bytes("global") == jsrc.block_feature_bytes("global")


def _host_block_equal(a, b):
    assert (a.index, a.start, a.num_real) == (b.index, b.start, b.num_real)
    for f in ("labels", "offsets", "weights"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
        assert not x.flags.writeable  # the read-only contract
    assert sorted(a.shards) == sorted(b.shards)
    for sid in a.shards:
        for x, y in zip(a.shards[sid], b.shards[sid]):
            assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), sid
    assert sorted(a.id_tags) == sorted(b.id_tags)
    for t in a.id_tags:
        assert a.id_tags[t].dtype == b.id_tags[t].dtype
        assert np.array_equal(a.id_tags[t], b.id_tags[t])


@pytest.mark.parametrize("shards", [None, ("global",)])
def test_host_blocks_are_bitwise_equal(sources, shards):
    tsrc, jsrc = sources
    for b in range(tsrc.plan.num_blocks):
        _host_block_equal(tsrc.build_block(b, shards=shards),
                          jsrc.build_block(b, shards=shards))


def test_row_planes_are_bitwise_equal(sources):
    tp = sources[0].row_planes(coo_shards=("per_user",))
    jp = sources[1].row_planes(coo_shards=("per_user",))
    for f in ("labels", "offsets", "weights"):
        assert np.array_equal(getattr(tp, f), getattr(jp, f))
    assert np.array_equal(tp.id_tags["userId"], jp.id_tags["userId"])
    for x, y in zip(tp.shard_coo["per_user"], jp.shard_coo["per_user"]):
        assert np.array_equal(np.asarray(x), np.asarray(y))


# ---------------------------------------------------------------- prefetcher
@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("order", [None, [4, 1, 5, 0]])
def test_prefetcher_order_and_bytes_equal(sources, depth, order):
    tsrc, jsrc = sources
    tp = ts.BlockPrefetcher(tsrc, shards=("global",), depth=depth, order=order, device="cpu")
    jp = js.BlockPrefetcher(jsrc, shards=("global",), depth=depth, order=order)
    tblocks, jblocks = list(tp), list(jp)
    assert [b.index for b in tblocks] == [b.index for b in jblocks]
    assert [(b.start, b.num_real) for b in tblocks] == [(b.start, b.num_real) for b in jblocks]
    assert [b.weight_sum for b in tblocks] == [b.weight_sum for b in jblocks]
    assert tp.stats.blocks == jp.stats.blocks == len(tblocks)
    assert tp.stats.h2d_bytes == jp.stats.h2d_bytes
    assert tp.stats.h2d_bytes == len(tblocks) * tsrc.block_upload_bytes(("global",))
    for tb, jb in zip(tblocks, jblocks):
        td, jd = tb.data["global"], jb.data["global"]
        assert td.features.indices.dtype == torch.int64
        assert np.array_equal(td.features.values.numpy(), np.asarray(jd.features.values))
        assert np.array_equal(td.features.indices.numpy(), np.asarray(jd.features.indices))
        for f in ("labels", "offsets", "weights"):
            assert np.array_equal(getattr(td, f).numpy(), np.asarray(getattr(jd, f)))


def test_prefetcher_worker_error_falls_back_to_sync_decode(dataset):
    """A crash that escapes the prefetch worker finishes the pass with
    synchronous decodes on the consumer, as in the JAX package."""
    tr.configure_faults("stream.build_block=once:2!fatal")
    src = _open(ts, dataset)
    blocks = list(ts.BlockPrefetcher(src, shards=("global",), depth=2, device="cpu"))
    assert [b.index for b in blocks] == list(range(src.plan.num_blocks))
    kinds = [f["kind"] for f in tr.recent_failures()]
    assert "prefetch_worker_failed" in kinds


# -------------------------------------------------------------- the solvers
def _fe_problems(sources, mem_data):
    """The port's and the JAX package's in-memory FE problem of the same
    rows (ELL), and the objectives."""
    from photon_ml_tpu.ops.data import LabeledData as JLD
    from photon_ml_tpu_torch.ops.data import LabeledData as TLD

    tdata, jdata = mem_data
    tld = TLD.create(tdata.sparse_features("global", engine="ell", device="cpu"),
                     torch.from_numpy(tdata.labels), offsets=torch.from_numpy(tdata.offsets),
                     weights=torch.from_numpy(tdata.weights))
    jld = JLD.create(jdata.sparse_features("global"), jdata.labels,
                     offsets=jdata.offsets, weights=jdata.weights)
    return tld, jld, sources[0].plan.shard_dims["global"]


def test_streamed_value_and_gradient_equal_in_memory(sources, mem_data):
    tld, _, dim = _fe_problems(sources, mem_data)
    obj = _t_objective()
    w = torch.from_numpy(np.random.default_rng(0).normal(size=dim).astype(np.float32))
    f_ref, g_ref = obj.value_and_grad(w, tld, 0.3)
    programs = ts.solver.StreamPrograms.for_objective(obj)
    f, g, _ = ts.solver._full_pass(programs, w, _t_blocks(sources[0]), dim,
                                   torch.tensor(0.3), ts.StreamSolveInfo())
    assert float(f) == pytest.approx(float(f_ref), rel=1e-5)
    np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=0,
                               atol=1e-5 * float(g_ref.abs().max()))
    got = ts.streamed_objective_value(obj, w, _t_blocks(sources[0]), dim, 0.3)
    assert got == float(f)


def test_solve_streaming_matches_jax(sources, mem_data):
    import jax.numpy as jnp

    from photon_ml_tpu_torch.opt.solve import solve

    tld, _, dim = _fe_problems(sources, mem_data)
    tobj, jobj = _t_objective(), _j_objective()
    tinfo = ts.StreamSolveInfo()
    got = ts.solve_streaming(tobj, torch.zeros(dim), _t_blocks(sources[0]), _cfg(_topt()),
                             info=tinfo)
    ref = js.solve_streaming(jobj, jnp.zeros((dim,), jnp.float32), _j_blocks(sources[1]),
                             _cfg(_jopt()))
    assert got.w.shape == (1, dim)
    assert float(got.value[0]) == pytest.approx(float(ref.value), rel=1e-4)
    np.testing.assert_allclose(got.w[0].numpy(), np.asarray(ref.w), atol=2e-3)
    assert int(got.iterations[0]) > 0 and tinfo.passes == tinfo.line_search_trials + 1
    assert tinfo.blocks == tinfo.passes * sources[0].plan.num_blocks
    # the in-memory solve of the same rows reaches the same optimum
    mem = solve(tobj, torch.zeros(1, dim), tld, _cfg(_topt()))
    assert float(got.value[0]) == pytest.approx(float(mem.value[0]), rel=1e-4)
    np.testing.assert_allclose(got.w[0].numpy(), mem.w[0].numpy(), atol=2e-3)
    # bitwise repeatable, synchronous decode or threaded
    again = ts.solve_streaming(tobj, torch.zeros(dim), _t_blocks(sources[0], depth=0),
                               _cfg(_topt()))
    assert torch.equal(again.w, got.w) and torch.equal(again.value, got.value)


def test_tron_and_l1_are_refused(sources):
    c = _topt()
    dim = sources[0].plan.shard_dims["global"]
    tron = c.GlmOptimizationConfiguration(
        optimizer_config=c.OptimizerConfig(optimizer=c.OptimizerType.TRON))
    with pytest.raises(ValueError, match="TRON"):
        ts.solve_streaming(_t_objective(), torch.zeros(dim), _t_blocks(sources[0]), tron)
    from photon_ml_tpu_torch.types import RegularizationType
    l1 = c.GlmOptimizationConfiguration(
        regularization=c.RegularizationContext(RegularizationType.L1),
        regularization_weight=0.5)
    with pytest.raises(ValueError, match="L1"):
        ts.solve_streaming(_t_objective(), torch.zeros(dim), _t_blocks(sources[0]), l1)


class _Recorded:
    """make_blocks_ordered over a prefetcher that records each order."""

    def __init__(self, pkg, source):
        self.pkg, self.source, self.orders = pkg, source, []

    def __call__(self, order):
        self.orders.append([int(i) for i in order])
        kw = {"device": "cpu"} if self.pkg is ts else {}
        prefetcher = self.pkg.BlockPrefetcher(self.source, shards=("global",),
                                              order=list(order), **kw)
        return (_Shard(b) for b in prefetcher)


class _Shard:
    def __init__(self, blk):
        self.data, self.weight_sum, self.index = blk.data["global"], blk.weight_sum, blk.index


@pytest.mark.parametrize("gap_schedule", [False, True])
def test_stochastic_orders_equal_jax(sources, mem_data, gap_schedule):
    import jax.numpy as jnp

    dim = sources[0].plan.shard_dims["global"]
    nb = sources[0].plan.num_blocks
    total_weight = float(np.sum(mem_data[0].weights))
    kw = dict(num_blocks=nb, total_weight=total_weight, epochs=6, chunk_iters=4,
              blocks_per_update=2, seed=3)
    trec, jrec = _Recorded(ts, sources[0]), _Recorded(js, sources[1])
    tsched = ts.GapScheduler(nb, plan=sources[0].plan, seed=5) if gap_schedule else None
    jsched = js.GapScheduler(nb, plan=sources[1].plan, seed=5) if gap_schedule else None
    got = ts.solve_streaming_stochastic(_t_objective(), torch.zeros(dim), trec, _cfg(_topt()),
                                        scheduler=tsched, **kw)
    ref = js.solve_streaming_stochastic(_j_objective(), jnp.zeros((dim,), jnp.float32), jrec,
                                        _cfg(_jopt()), scheduler=jsched, **kw)
    assert trec.orders == jrec.orders
    np.testing.assert_allclose(got.w[0].numpy(), np.asarray(ref.w), atol=2e-3)
    if gap_schedule:
        for a, b in zip(tsched.decisions, jsched.decisions):
            assert {k: a[k] for k in ("epoch", "visited", "explored", "num_blocks",
                                      "unvisited", "excluded")} == {
                k: b[k] for k in ("epoch", "visited", "explored", "num_blocks",
                                  "unvisited", "excluded")}
            assert a["score_max"] == pytest.approx(b["score_max"], rel=1e-4)


# -------------------------------------------------------------- the estimator
def _estimator(pkg_root, with_re=True, device=None):
    import importlib

    game = importlib.import_module(f"{pkg_root}.estimators.game")
    opt = importlib.import_module(f"{pkg_root}.opt.config")
    data = importlib.import_module(f"{pkg_root}.data.random_effect")
    types = importlib.import_module(f"{pkg_root}.types")

    def l2(lam):
        return opt.GlmOptimizationConfiguration(
            regularization=opt.RegularizationContext(types.RegularizationType.L2),
            regularization_weight=lam)

    coords = {"fixed": game.FixedEffectCoordinateConfiguration("global", l2(0.1))}
    if with_re:
        coords["per-user"] = game.RandomEffectCoordinateConfiguration(
            "per_user", data=data.RandomEffectDataConfiguration("userId", num_buckets=2),
            optimizer=l2(1.0))
    kw = {} if device is None else {"device": device}
    return game.GameEstimator(task=types.TaskType.LOGISTIC_REGRESSION, coordinates=coords,
                              update_order=list(coords),
                              num_outer_iterations=2 if with_re else 1, **kw)


def _auc(scores, labels):
    order = np.argsort(scores)
    ranks = np.empty(len(scores))
    ranks[order] = np.arange(1, len(scores) + 1)
    pos = labels > 0.5
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    return (ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)


@pytest.fixture(scope="module")
def glmix_fits(dataset, sources, mem_data):
    """The port's and the JAX package's streamed GLMix fits (2 outer
    iterations) over the same part files, validated on the same rows."""
    tdata, jdata = mem_data
    tfit = _estimator("photon_ml_tpu_torch", device="cpu").fit_streaming(
        _open(ts, dataset), validation_data=tdata)
    jfit = _estimator("photon_ml_tpu").fit_streaming(_open(js, dataset), validation_data=jdata)
    return tfit, jfit


def test_fit_streaming_matches_jax(glmix_fits, mem_data):
    tfit, jfit = glmix_fits
    tdata, jdata = mem_data
    tscores = tfit.model.score(tdata).numpy()
    jscores = np.asarray(jfit.model.score(jdata))
    # relative to the score vector: two f32 L-BFGS runs to tolerance 1e-7
    # leave coefficients 1e-4 apart, which moves a small score by more
    # than 2e-4 of itself
    assert np.linalg.norm(tscores - jscores) <= 2e-4 * np.linalg.norm(jscores)
    np.testing.assert_allclose(tfit.model.models["fixed"].coefficients.means.numpy(),
                               np.asarray(jfit.model.models["fixed"].coefficients.means),
                               atol=2e-3)
    assert _auc(tscores, tdata.labels) == pytest.approx(_auc(jscores, jdata.labels), abs=1e-4)
    assert tfit.validation_metric == pytest.approx(jfit.validation_metric, abs=1e-4)
    assert [c for c, _ in tfit.objective_history] == [c for c, _ in jfit.objective_history]
    np.testing.assert_allclose([v for _, v in tfit.objective_history],
                               [v for _, v in jfit.objective_history], rtol=1e-4)


def test_fit_streaming_matches_in_memory_fit(glmix_fits, mem_data):
    tdata = mem_data[0]
    fit_mem = _estimator("photon_ml_tpu_torch", device="cpu").fit(tdata, tdata)
    sc_mem = fit_mem.model.score(tdata).numpy()
    sc_st = glmix_fits[0].model.score(tdata).numpy()
    assert abs(_auc(sc_mem, tdata.labels) - _auc(sc_st, tdata.labels)) < 1e-3


def test_fit_streaming_is_repeatable_and_counts_no_new_programs(dataset, glmix_fits):
    """A fit over the block cache (warm) is bitwise the cold fit, and no
    later fit, nor more blocks, constructs another program: each is built
    once."""
    ts.solver.StreamPrograms._CACHE.clear()
    ts.coordinate._OBJECTIVE_CACHE.clear()
    ts.reset_stream_trace_counts()
    cache = os.path.join(dataset["root"], "cache_repeat")
    fits = [_estimator("photon_ml_tpu_torch", device="cpu").fit_streaming(
        _open(ts, dataset, cache_dir=cache))]
    first = dict(ts.stream_trace_counts())
    assert first and all(v == 1 for v in first.values()), first
    fits.append(_estimator("photon_ml_tpu_torch", device="cpu").fit_streaming(
        _open(ts, dataset, cache_dir=cache)))
    _estimator("photon_ml_tpu_torch", device="cpu").fit_streaming(
        _open(ts, dataset, block_rows=BLOCK_ROWS // 2))
    assert dict(ts.stream_trace_counts()) == first
    a, b = (f.model.models for f in fits)
    assert torch.equal(a["fixed"].coefficients.means, b["fixed"].coefficients.means)
    for x, y in zip(a["per-user"].coefficients, b["per-user"].coefficients):
        assert torch.equal(x, y)
    # the cold fit (no cache) is the same fit too
    cold = glmix_fits[0].model.models["fixed"].coefficients.means
    assert torch.equal(a["fixed"].coefficients.means, cold)


@contextlib.contextmanager
def _built_coordinate(pkg):
    """The StreamingFixedEffectCoordinate that ``fit_streaming`` builds
    inside the block, captured for inspection."""
    seen = {}
    orig = pkg.StreamingFixedEffectCoordinate.__post_init__

    def keep(self):
        orig(self)
        seen["coordinate"] = self

    pkg.StreamingFixedEffectCoordinate.__post_init__ = keep
    try:
        yield seen
    finally:
        pkg.StreamingFixedEffectCoordinate.__post_init__ = orig


def test_residency_is_bitwise_and_uploads_less(dataset):
    off = _estimator("photon_ml_tpu_torch", with_re=False, device="cpu").fit_streaming(
        _open(ts, dataset))
    src = _open(ts, dataset)
    tracker = tt.ConvergenceTracker(label="residency")
    try:
        with _built_coordinate(ts) as seen:
            on = _estimator("photon_ml_tpu_torch", with_re=False, device="cpu").fit_streaming(
                src, resident_blocks=3, progress=tracker)
    finally:
        tracker.finish()
    assert torch.equal(off.model.models["fixed"].coefficients.means,
                       on.model.models["fixed"].coefficients.means)
    coord = seen["coordinate"]
    mgr, unit = coord._residency, src.block_upload_bytes(("global",))
    assert mgr.resident_blocks == 3 and mgr.stats.hbm_hit_blocks > 0
    assert mgr.stats.hbm_hit_bytes == mgr.stats.hbm_hit_blocks * unit
    # the last pass (the score pass) uploaded only the non-resident blocks
    assert coord.last_prefetch_stats.h2d_bytes == (src.plan.num_blocks - 3) * unit
    assert coord.last_prefetch_stats.resident_hit_blocks == 3
    kinds = {r["kind"] for r in tracker.records}
    assert {"block", "residency", "coordinate"} <= kinds


def test_residency_decisions_in_the_fit_equal_jax(dataset):
    """The resident set picked in a fit from measured gaps: the same pins
    and evictions in both packages."""
    out = {}
    for pkg, root, dev in ((ts, "photon_ml_tpu_torch", "cpu"), (js, "photon_ml_tpu", None)):
        with _built_coordinate(pkg) as seen:
            _estimator(root, with_re=False, device=dev).fit_streaming(
                _open(pkg, dataset), resident_blocks=2)
        coord = seen["coordinate"]
        out[root] = (coord._residency.resident_indices(),
                     [(d["action"], d["block"]) for d in coord.last_residency_decisions])
    assert out["photon_ml_tpu_torch"] == out["photon_ml_tpu"]


@pytest.mark.parametrize("gap_schedule", [False, True])
def test_stochastic_fit_is_repeatable_and_matches_jax(dataset, mem_data, gap_schedule):
    """The stochastic mode: bitwise repeatable, the JAX fit's AUC (1e-4);
    the blind shuffle within the JAX tests' 1e-2 of the in-memory fit."""
    tdata, jdata = mem_data
    kw = dict(mode="stochastic", stochastic_epochs=20, stochastic_chunk_iters=8,
              blocks_per_update=3, gap_schedule=gap_schedule)
    fits = [_estimator("photon_ml_tpu_torch", with_re=False, device="cpu").fit_streaming(
        _open(ts, dataset), **kw) for _ in range(2)]
    assert torch.equal(fits[0].model.models["fixed"].coefficients.means,
                       fits[1].model.models["fixed"].coefficients.means)
    jfit = _estimator("photon_ml_tpu", with_re=False).fit_streaming(_open(js, dataset), **kw)
    auc = _auc(fits[0].model.score(tdata).numpy(), tdata.labels)
    assert auc == pytest.approx(_auc(np.asarray(jfit.model.score(jdata)), jdata.labels),
                                abs=1e-4)
    if not gap_schedule:
        fit_mem = _estimator("photon_ml_tpu_torch", with_re=False, device="cpu").fit(tdata, tdata)
        assert abs(auc - _auc(fit_mem.model.score(tdata).numpy(), tdata.labels)) < 1e-2


def test_fit_streaming_refusals(dataset):
    est = _estimator("photon_ml_tpu_torch", with_re=False, device="cpu")
    est.compute_variance = True
    with pytest.raises(ValueError, match="variance"):
        est.fit_streaming(_open(ts, dataset))
    with pytest.raises(ValueError, match="mode"):
        _estimator("photon_ml_tpu_torch", with_re=False, device="cpu").fit_streaming(
            _open(ts, dataset), mode="minibatch")
    with pytest.raises(ValueError, match="item 8, The cluster plane"):
        _estimator("photon_ml_tpu_torch", with_re=False, device="cpu").fit_streaming(
            _open(ts, dataset), cluster=object())
    with pytest.raises(ValueError, match="gap_schedule"):
        _estimator("photon_ml_tpu_torch", with_re=False, device="cpu").fit_streaming(
            _open(ts, dataset), gap_schedule=True)


def test_streaming_defaults_to_cuda(dataset):
    """Without a card the default device raises; nothing falls back to the
    host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    src = _open(ts, dataset)
    with pytest.raises(RuntimeError, match="is_available"):
        ts.BlockPrefetcher(src)
    with pytest.raises(RuntimeError, match="is_available"):
        _estimator("photon_ml_tpu_torch", with_re=False).fit_streaming(src)


def test_checkpoint_dim_is_checked_for_streaming_coordinates(dataset, tmp_path):
    from photon_ml_tpu_torch.models.coefficients import Coefficients
    from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel

    wrong = {"fixed": GeneralizedLinearModel(Coefficients(torch.zeros(3)))}
    with pytest.raises(ValueError, match="checkpoint dim 3 != data dim"):
        _estimator("photon_ml_tpu_torch", with_re=False, device="cpu").fit_streaming(
            _open(ts, dataset), initial_models=wrong)


# ----------------------------------------------------------- failure plane
def test_skip_mode_skips_the_same_blocks(dataset):
    out = {}
    for pkg, res in ((ts, tr), (js, jr)):
        res.configure_faults("stream.build_block=once:2!fatal")
        src = _open(pkg, dataset, decode_workers=0)
        src.on_block_error = "skip"
        out[pkg] = ([b.index for b in src.iter_blocks(shards=("global",))],
                    sorted(src.failed_blocks),
                    [s["block"] for s in src.drain_skipped_blocks()],
                    [f["kind"] for f in res.recent_failures()])
        res.configure_faults({})
    assert out[ts] == out[js]
    assert out[ts][1] == [1] and "block_skipped" in out[ts][3]


def test_skipped_block_lands_in_the_progress_ledger(dataset, tmp_path):
    from photon_ml_tpu_torch.telemetry.validate import validate_ledger

    ledger = str(tmp_path / "progress.jsonl")
    tracker = tt.ConvergenceTracker(ledger_path=ledger, label="chaos")
    tracker.attach_failure_sink()
    tr.configure_faults("stream.build_block=once:2!fatal")
    src = _open(ts, dataset, decode_workers=0)
    src.on_block_error = "skip"
    try:
        fit = _estimator("photon_ml_tpu_torch", with_re=False, device="cpu").fit_streaming(
            src, progress=tracker)
    finally:
        tracker.finish()
        tr.configure_faults({})
    assert fit is not None
    res = [r for r in validate_ledger(ledger)
           if r["type"] == "progress" and r["kind"] == "resilience"]
    assert any(r["failure_kind"] == "block_skipped" and r.get("block") == 1 for r in res)
    assert tracker.health()["healthy"]


# ------------------------------------------------------------------ the CLI
def _cli_config(tmp_path):
    opt = {"optimizer": "LBFGS", "regularization": "L2"}
    cfg = {
        "feature_shards": {
            "global": {"feature_bags": ["features"], "add_intercept": True},
            "per_user": {"feature_bags": ["userFeatures"], "add_intercept": False},
        },
        "coordinates": {
            "fixed": {"type": "fixed", "feature_shard": "global",
                      "optimizer": {**opt, "regularization_weight": 0.1}},
            "per_user": {"type": "random", "feature_shard": "per_user",
                         "random_effect_type": "userId",
                         "optimizer": {**opt, "regularization_weight": 1.0}},
        },
        "update_order": ["fixed", "per_user"],
    }
    path = tmp_path / "game.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.mark.parametrize("extra", [(), ("--resident-blocks", "2", "--prefetch-depth", "0"),
                                   ("--stream-mode", "stochastic", "--gap-schedule")])
def test_train_game_streaming_cli_matches_jax(dataset, tmp_path, extra):
    from photon_ml_tpu.cli import train_game as jcli
    from photon_ml_tpu_torch.cli import train_game as tcli

    cfg = _cli_config(tmp_path)
    base = ["--train-data-dirs", dataset["root"], "--validation-data-dirs", dataset["root"],
            "--coordinate-config", cfg, "--task", "LOGISTIC_REGRESSION", "--evaluator", "AUC",
            "--streaming", "--block-rows", str(BLOCK_ROWS), "--num-outer-iterations", "2",
            "--no-block-cache", *extra]
    tfit = tcli.run(tcli.parse_args(base + ["--output-dir", str(tmp_path / "t"),
                                            "--device", "cpu"]))
    jfit = jcli.run(jcli.parse_args(base + ["--output-dir", str(tmp_path / "j")]))
    assert tfit.validation_metric == pytest.approx(jfit.validation_metric, abs=1e-4)
    tw = tfit.model.models["fixed"].coefficients.means.numpy()
    jw = np.asarray(jfit.model.models["fixed"].coefficients.means)
    np.testing.assert_allclose(tw, jw, atol=2e-3)
    assert os.path.isdir(tmp_path / "t" / "best" / "fixed-effect" / "fixed")


def test_train_game_streaming_cli_block_cache_and_refusals(dataset, tmp_path):
    from photon_ml_tpu_torch.cli import train_game as tcli

    cfg = _cli_config(tmp_path)
    base = ["--train-data-dirs", dataset["root"], "--coordinate-config", cfg,
            "--task", "LOGISTIC_REGRESSION", "--streaming", "--block-rows", str(BLOCK_ROWS),
            "--device", "cpu"]
    cache = str(tmp_path / "bc")
    fits = [tcli.run(tcli.parse_args(base + ["--output-dir", str(tmp_path / f"o{i}"),
                                             "--block-cache-dir", cache]))
            for i in range(2)]
    assert len(os.listdir(cache)) == 1  # one fingerprint directory
    assert torch.equal(fits[0].model.models["fixed"].coefficients.means,
                       fits[1].model.models["fixed"].coefficients.means)
    assert tcli._default_block_cache_dir([dataset["root"]]) == os.path.join(
        dataset["root"], "_block_cache")
    with pytest.raises(ValueError, match="incompatible with: --compute-variance"):
        tcli.run(tcli.parse_args(base + ["--output-dir", str(tmp_path / "x"),
                                         "--compute-variance"]))
    for bad in (["--gap-schedule"], ["--resident-blocks", "-1"], ["--block-rows", "0"],
                ["--stream-mode", "stochastic", "--resident-blocks", "2"]):
        with pytest.raises(SystemExit):
            tcli.parse_args(base + ["--output-dir", str(tmp_path / "x"), *bad])


def test_train_game_streaming_cli_offheap_stores_and_a_shared_cache(dataset, tmp_path):
    """``--offheap-indexmap-dir`` feeds the streaming source in both CLIs;
    the port's run over the JAX run's block cache serves every block from
    it (the fingerprints commit to the stores' content digests), and the
    two models agree."""
    from photon_ml_tpu.cli import train_game as jcli
    from photon_ml_tpu_torch.cli import build_index
    from photon_ml_tpu_torch.cli import train_game as tcli

    idx = str(tmp_path / "idx")
    assert build_index.main(["--data-dirs", dataset["root"], "--output-dir", idx,
                             "--feature-shard", "global=features",
                             "--feature-shard", "per_user=userFeatures"]) == 0
    base = ["--train-data-dirs", dataset["root"], "--validation-data-dirs", dataset["root"],
            "--coordinate-config", _cli_config(tmp_path), "--task", "LOGISTIC_REGRESSION",
            "--evaluator", "AUC", "--streaming", "--block-rows", str(BLOCK_ROWS),
            "--offheap-indexmap-dir", idx, "--block-cache-dir", str(tmp_path / "cache")]
    jfit = jcli.run(jcli.parse_args(base + ["--output-dir", str(tmp_path / "j")]))
    tt.get_registry().reset()
    tfit = tcli.run(tcli.parse_args(base + ["--output-dir", str(tmp_path / "t"),
                                            "--device", "cpu"]))
    counters = tt.get_registry().snapshot()["counters"]
    assert counters["stream.cache_hit_blocks"] == counters["stream.blocks"] > 0
    assert tfit.validation_metric == pytest.approx(jfit.validation_metric, abs=1e-4)
    np.testing.assert_allclose(tfit.model.models["fixed"].coefficients.means.numpy(),
                               np.asarray(jfit.model.models["fixed"].coefficients.means),
                               atol=2e-3)

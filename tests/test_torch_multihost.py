"""The multi-process runtime of the port (``parallel/multihost.py`` on
``torch.distributed``) with 2 gloo ranks in CPU subprocesses (each under
a timeout of its own): ``barrier``; ``host_shard_files`` equal to the JAX
package's rule; ``fetch_global`` gathering a sharded array; a 2 x 1 grid
with a tile a rank, bitwise the one-process 2 x 1 grid (maps and an
L-BFGS solve), and so a 1 x 2 grid, a feat column a rank; a GLMix fit over that grid on the host score plane (the
effective plane under several ranks), its schedule sync, each rank
solving only the random-effect slices of its own grid position, the
model bitwise the one-process model.

Run as a script, this file is one rank:
``python tests/test_torch_multihost.py RANK WORLD PORT OUT.npz``.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

TIMEOUT_S = 180
FILES = ["e.avro", "a.avro", "c.avro", "b.avro", "d.avro"]


def _problem(seed=5, n=90, d=23, k=4):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), k + 1)
    cols = np.concatenate([rng.integers(1, d, (n, k)), np.zeros((n, 1), np.int64)],
                          axis=1).reshape(-1)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    y = (rng.random(n) < 0.5).astype(np.float32)
    return rows, cols, vals, (n, d), y


def _grid_outputs(mesh_kw, grid=(2, 1)):
    """Maps and an L-BFGS solve over a 2 x 1 (or ``grid``) ELL grid of
    ``_problem``."""
    import torch

    from photon_ml_tpu_torch.estimators.model_training import train_glm
    from photon_ml_tpu_torch.ops.data import LabeledData
    from photon_ml_tpu_torch.opt.config import GlmOptimizationConfiguration, OptimizerConfig
    from photon_ml_tpu_torch.parallel.grid_features import grid_from_coo, grid_mesh
    from photon_ml_tpu_torch.types import TaskType

    rows, cols, vals, shape, y = _problem()
    gf = grid_from_coo(rows, cols, vals, shape, grid_mesh(*grid, **mesh_kw), engine="ell")
    w = torch.linspace(-1, 1, gf.dim)
    c = torch.linspace(1, -1, gf.num_rows)
    pad = gf.num_rows - shape[0]
    data = LabeledData.create(gf, torch.nn.functional.pad(torch.from_numpy(y), (0, pad)),
                              weights=torch.nn.functional.pad(torch.ones(shape[0]), (0, pad)))
    cfg = GlmOptimizationConfiguration(
        optimizer_config=OptimizerConfig.lbfgs(max_iterations=15), regularization_weight=1.0)
    fit = train_glm(data, TaskType.LOGISTIC_REGRESSION, cfg)[0]
    return {"z": gf.matvec(w).numpy(), "g": gf.rmatvec(c).numpy(),
            "gsq": gf.rmatvec_sq(c).numpy(), "rn": gf.row_norms_sq().numpy(),
            "w": fit.model.coefficients.means.numpy()}


def _glmix_fit(parallel_devices=None, schedule="async"):
    """A small GLMix fit (FE over a 2 x 1 ELL grid, per-user RE), its FE
    coefficients, scores and the estimator's effective plane and
    schedule."""
    from photon_ml_tpu_torch.data.game_data import FeatureShard, GameData
    from photon_ml_tpu_torch.data.random_effect import RandomEffectDataConfiguration
    from photon_ml_tpu_torch.estimators.game import (
        FixedEffectCoordinateConfiguration, GameEstimator, ParallelConfiguration,
        RandomEffectCoordinateConfiguration)
    from photon_ml_tpu_torch.types import TaskType

    rows, cols, vals, (n, d), y = _problem()
    users = np.array([f"u{i % 7}" for i in range(n)])
    data = GameData(labels=y, feature_shards={
        "g": FeatureShard(rows, cols, vals, d),
        "u": FeatureShard(np.repeat(np.arange(n), 2), np.tile(np.arange(2), n),
                          np.ones(2 * n, np.float32), 2)}, id_tags={"userId": users})
    est = GameEstimator(
        task=TaskType.LOGISTIC_REGRESSION,
        coordinates={"fixed": FixedEffectCoordinateConfiguration("g"),
                     "per_user": RandomEffectCoordinateConfiguration(
                         "u", RandomEffectDataConfiguration("userId"))},
        num_outer_iterations=2, device="cpu", schedule=schedule,
        parallel=ParallelConfiguration(2, 1, engine="ell", devices=parallel_devices))
    coords = est.build_coordinates(data)
    fit = est.fit(data, coordinates=coords)
    re_model = fit.model.models["per_user"]
    return {"fit_w": fit.model.models["fixed"].coefficients.means.numpy(),
            "fit_scores": fit.model.score(data).numpy(),
            "plane": np.array(est._effective_score_plane()),
            "schedule": np.array(est._effective_schedule()),
            "fit_re_w": np.concatenate([c.numpy().ravel() for c in re_model.coefficients]),
            "fit_objective": np.array([v for _, v in fit.objective_history]),
            "re_lanes": np.array([st.num_entities
                                  for st in coords["per_user"].last_solver_stats]),
            "re_slices": np.array([len(b.local()) for b in coords["per_user"].dataset.buckets])}


def rank_main(rank: int, world: int, port: int, out: str) -> int:
    from photon_ml_tpu_torch.parallel.mesh import P, Mesh, fetch_global, place
    from photon_ml_tpu_torch.parallel.multihost import (
        barrier, global_batch_from_host_rows, host_shard_files, initialize_distributed)

    assert initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu") is True
    barrier("start")
    result = {"files": np.array(host_shard_files(FILES))}
    mesh = Mesh(["cpu"] * world, ("data",), ranks=list(range(world)))
    x = np.arange(4 * world, dtype=np.float32) * 1.5
    placed = place(x, mesh, P("data"))
    result["local_shards"] = np.array(len(placed.shards))
    result["gathered"] = fetch_global(placed)
    # each rank's own rows make one global batch; a block of the wrong size
    # is refused with the remedy
    own = np.arange(3 * rank, 3 * rank + 3, dtype=np.float32)
    result["batch"] = fetch_global(global_batch_from_host_rows(own, mesh, P("data")))
    try:
        global_batch_from_host_rows(np.zeros(5, np.float32), mesh, P("data"), global_rows=6)
        result["refusal"] = np.array("")
    except ValueError as e:
        result["refusal"] = np.array(str(e))
    result.update(_grid_outputs({"device": "cpu"}))
    # a feat column a rank: the solve's dot products and norms gather the
    # other rank's block partials
    result.update({f"feat_{k}": v for k, v in _grid_outputs({"device": "cpu"}, (1, 2)).items()})
    result.update(_glmix_fit())
    barrier("end")
    np.savez(out, **result)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results (each rank a subprocess under TIMEOUT_S)."""
    tmp = tmp_path_factory.mktemp("multihost")
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.dirname(os.path.dirname(__file__)),
                                         env.get("PYTHONPATH", "")])
    outs = [str(tmp / f"rank{r}.npz") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, __file__, str(r), "2", str(port), outs[r]],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], logs
    return [dict(np.load(o)) for o in outs]


def test_ranks_join_and_pass_barriers(ranks):
    assert len(ranks) == 2  # each rank joined, met both barriers and saved


def test_host_shard_files_is_the_jax_rule(ranks, monkeypatch):
    import jax

    from photon_ml_tpu.parallel import multihost as jax_multihost

    for r, res in enumerate(ranks):
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        assert list(res["files"]) == jax_multihost.host_shard_files(FILES)
    assert sorted(list(ranks[0]["files"]) + list(ranks[1]["files"])) == sorted(FILES)


def test_fetch_global_gathers_every_rank(ranks):
    for res in ranks:
        assert int(res["local_shards"]) == 1  # each rank holds its own block
        np.testing.assert_array_equal(res["gathered"], np.arange(8, dtype=np.float32) * 1.5)


def test_global_batch_from_host_rows(ranks):
    for res in ranks:
        np.testing.assert_array_equal(res["batch"], np.arange(6, dtype=np.float32))
        assert "Each host must supply exactly the rows its own devices" in str(res["refusal"])


def test_a_tile_a_rank_is_the_one_process_grid_bitwise(ranks):
    one = _grid_outputs({"devices": ["cpu", "cpu"]})
    for res in ranks:
        for key in ("z", "g", "gsq", "rn", "w"):
            np.testing.assert_array_equal(res[key], one[key], err_msg=key)


def test_a_feat_column_a_rank_is_the_one_process_grid_bitwise(ranks):
    one = _grid_outputs({"devices": ["cpu", "cpu"]}, (1, 2))
    for res in ranks:
        for key in ("z", "g", "gsq", "rn", "w"):
            np.testing.assert_array_equal(res[f"feat_{key}"], one[key], err_msg=key)


def test_several_ranks_train_on_the_host_plane_sync(ranks):
    # the fit is the one-process grid fit's within the coefficient tolerance
    # (each rank solves its random effects' lanes in one batch, the one
    # process in a batch a device slice)
    solo = _glmix_fit(["cpu", "cpu"], schedule="sync")
    assert str(solo["plane"]) == "device" and str(solo["schedule"]) == "sync"
    for res in ranks:
        assert str(res["plane"]) == "host" and str(res["schedule"]) == "sync"
        np.testing.assert_allclose(res["fit_w"], solo["fit_w"], atol=2e-3)
        np.testing.assert_allclose(res["fit_scores"], solo["fit_scores"], atol=2e-3)
    np.testing.assert_array_equal(ranks[0]["fit_w"], ranks[1]["fit_w"])


def test_each_rank_solves_its_own_slices_and_the_model_is_bitwise_one_process(ranks):
    # 7 users padded to 8 entity lanes over the grid's 2 positions: each
    # rank holds and solves one slice of 4 lanes a bucket, the one process
    # both; the other rank's coefficients and scores arrive by all_gather
    solo = _glmix_fit(["cpu", "cpu"], schedule="sync")
    buckets = solo["re_slices"].size
    np.testing.assert_array_equal(solo["re_slices"], np.full(buckets, 2))
    np.testing.assert_array_equal(solo["re_lanes"], np.full(2 * buckets, 4))
    for res in ranks:
        np.testing.assert_array_equal(res["re_slices"], np.ones(buckets))
        np.testing.assert_array_equal(res["re_lanes"], np.full(buckets, 4))
        for key in ("fit_w", "fit_scores", "fit_re_w", "fit_objective"):
            np.testing.assert_array_equal(res[key], solo[key], err_msg=key)


if __name__ == "__main__":
    sys.exit(rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))

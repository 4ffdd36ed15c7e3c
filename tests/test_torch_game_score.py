"""GameModel.score: the JAX package's model and the port's model (its
weights carried across by convert.game_model_from_numpy) score the same
GameData rows. Fixed effect + two random effects, with unseen entities (left
join: RE contribution 0) and features outside an entity's projected space
(dropped). Tolerance rtol 2e-4, atol 1e-5 (f32 sums in another order).
"""

import numpy as np
import pytest
import torch

from _torch_parity import (
    coordinates_of_jax_model,
    glmix_numpy,
    jax_game_data,
    jax_game_model,
    torch_game_data,
)
from photon_ml_tpu_torch.convert import game_model_from_numpy
from photon_ml_tpu_torch.ops import fused_perm

RTOL, ATOL = 2e-4, 1e-5


@pytest.mark.parametrize("engine", ["auto", "ell", "fused", "benes"])
def test_score_matches_jax(engine):
    labels, shards, id_tags, coords = glmix_numpy(seed=1)
    jmodel = jax_game_model(coords)
    expected = np.asarray(jmodel.score(jax_game_data(labels, shards, id_tags)))

    ported = coordinates_of_jax_model(jmodel)
    ported["fixed"]["sparse_engine"] = engine
    model = game_model_from_numpy(ported, jmodel.task, device="cpu")
    data = torch_game_data(labels, shards, id_tags)
    got = model.score(data)
    assert got.shape == (len(labels),) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), expected, rtol=RTOL, atol=ATOL)
    if engine == "fused":
        assert isinstance(
            data.sparse_features("global", "fused", "cpu"), fused_perm.FusedSparseFeatures
        )


@pytest.mark.parametrize("cid", ["fixed", "per_userId", "per_itemId"])
def test_each_coordinate_matches_jax(cid):
    labels, shards, id_tags, coords = glmix_numpy(seed=2)
    jmodel = jax_game_model(coords)
    expected = np.asarray(
        jmodel.score_coordinate(cid, jax_game_data(labels, shards, id_tags))
    )
    model = game_model_from_numpy(coordinates_of_jax_model(jmodel), jmodel.task, device="cpu")
    got = model.score_coordinate(cid, torch_game_data(labels, shards, id_tags)).numpy()
    np.testing.assert_allclose(got, expected, rtol=RTOL, atol=ATOL)


def test_random_projection_re_matches_jax():
    labels, shards, id_tags, coords = glmix_numpy(seed=3, projector="random")
    jmodel = jax_game_model(coords)
    expected = np.asarray(jmodel.score(jax_game_data(labels, shards, id_tags)))
    model = game_model_from_numpy(coordinates_of_jax_model(jmodel), jmodel.task, device="cpu")
    got = model.score(torch_game_data(labels, shards, id_tags)).numpy()
    np.testing.assert_allclose(got, expected, rtol=RTOL, atol=ATOL)


def test_unseen_entities_and_dropped_features_score_zero():
    labels, shards, id_tags, coords = glmix_numpy(seed=4)
    model = game_model_from_numpy(coords, "LOGISTIC_REGRESSION", device="cpu")
    data = torch_game_data(labels, shards, id_tags)
    z = model.score_coordinate("per_userId", data).numpy()
    unseen = np.char.startswith(id_tags["userId"].astype(str), "new")
    assert unseen.any() and np.all(z[unseen] == 0.0)
    # an entity's row whose features all lie outside its space scores 0
    c = coords["per_userId"]
    e = 0
    outside = np.setdiff1d(np.arange(c["global_dim"]), c["proj_indices"][0][e])[:3]
    one = torch_game_data(
        np.zeros(1, np.float32),
        {"per_user": (np.zeros(3, np.int64), outside, np.ones(3, np.float32), c["global_dim"])},
        {"userId": np.array(["u0"])},
    )
    assert float(model.score_coordinate("per_userId", one)[0]) == 0.0


def test_benes_engine_names_its_roadmap_entry():
    """The "benes" engine, once refused with a pointer to the roadmap, is
    built and cached: its matvec equals the ELL engine's. An unknown engine
    name still raises."""
    from photon_ml_tpu_torch.ops.sparse_perm import BenesSparseFeatures, ColumnSplitFeatures

    labels, shards, id_tags, _ = glmix_numpy(seed=5)
    data = torch_game_data(labels, shards, id_tags)
    benes = data.sparse_features("global", engine="benes", device="cpu")
    assert isinstance(benes, (BenesSparseFeatures, ColumnSplitFeatures))
    assert data.sparse_features("global", engine="benes", device="cpu") is benes
    w = torch.from_numpy(np.random.default_rng(5).standard_normal(benes.dim).astype(np.float32))
    ell = data.sparse_features("global", engine="ell", device="cpu")
    np.testing.assert_allclose(benes.matvec(w).numpy(), ell.matvec(w).numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="unknown sparse engine"):
        data.sparse_features("global", engine="dense", device="cpu")

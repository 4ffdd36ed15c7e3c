"""Avro data and GAME models cross between the JAX package and the port.

Data written by either package's ``write_training_examples`` reads into
identical arrays through the other's ``read_game_data``, both packages on
their pure-Python decode path and both on their native columnar path. A model saved by
either package's ``save_game_model`` loads in the other and scores the same
rows to rtol 2e-4, atol 1e-5.
"""

import numpy as np
import pytest

from _torch_parity import (
    coordinates_of_jax_model,
    glmix_numpy,
    jax_game_data,
    jax_game_model,
    torch_game_data,
)
from photon_ml_tpu.io import data_reader as jax_reader
from photon_ml_tpu.io import model_io as jax_model_io
from photon_ml_tpu.io import native_reader
from photon_ml_tpu_torch.convert import game_model_from_numpy
from photon_ml_tpu_torch.io import data_reader as port_reader
from photon_ml_tpu_torch.io import model_io as port_model_io

RTOL, ATOL = 2e-4, 1e-5


def _records(seed, n=60):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        rec = {
            "uid": f"r{i}",
            "label": float(rng.random() < 0.5),
            "features": [("g", str(j), float(rng.standard_normal()))
                         for j in rng.choice(9, 3, replace=False)],
            "userFeatures": [("u", str(j), float(rng.standard_normal()))
                             for j in rng.choice(5, 2, replace=False)],
            "metadataMap": {"userId": f"user{i % 7}"},
        }
        if i % 4 == 0:
            rec["weight"] = 0.5
            rec["offset"] = 0.25
        out.append(rec)
    return out


SHARDS = {
    "global": (["features"], True),
    "per_user": (["userFeatures"], False),
}


def _read(reader, path):
    configs = {
        sid: reader.FeatureShardConfiguration(feature_bags=bags, add_intercept=icpt)
        for sid, (bags, icpt) in SHARDS.items()
    }
    return reader.read_game_data([path], configs, id_tags=["userId"])


def _assert_same_data(a, b, uids_a, uids_b, maps_a, maps_b):
    np.testing.assert_array_equal(a.labels, b.labels)
    np.testing.assert_array_equal(a.offsets, b.offsets)
    np.testing.assert_array_equal(a.weights, b.weights)
    assert uids_a == uids_b
    np.testing.assert_array_equal(a.id_tags["userId"], b.id_tags["userId"])
    for sid in SHARDS:
        sa, sb = a.feature_shards[sid], b.feature_shards[sid]
        assert sa.dim == sb.dim
        for f in ("rows", "cols", "vals"):
            np.testing.assert_array_equal(getattr(sa, f), getattr(sb, f))
        assert dict(maps_a[sid].items()) == dict(maps_b[sid].items())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_avro_data_reads_the_same_in_both_packages(tmp_path, monkeypatch, writer):
    # both packages on their record-at-a-time Python codec
    monkeypatch.setattr(native_reader, "native_available", lambda: False)
    monkeypatch.setattr(port_reader, "_read_game_data_native", lambda *a: None)
    monkeypatch.setattr(port_reader, "_build_index_maps_native", lambda *a: None)
    path = str(tmp_path / "part-00000.avro")
    write = (jax_reader if writer == "jax" else port_reader).write_training_examples
    assert write(path, _records(3)) == 60
    a, maps_a, uids_a = _read(jax_reader, path)
    b, maps_b, uids_b = _read(port_reader, path)
    _assert_same_data(a, b, uids_a, uids_b, maps_a, maps_b)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_avro_data_reads_the_same_natively_in_both_packages(tmp_path, writer):
    """Both packages on their default native columnar path: the same
    arrays, uids and index maps (keys numbered per bag stream)."""
    path = str(tmp_path / "part-00000.avro")
    write = (jax_reader if writer == "jax" else port_reader).write_training_examples
    assert write(path, _records(4)) == 60
    a, maps_a, uids_a = _read(jax_reader, path)
    b, maps_b, uids_b = _read(port_reader, path)
    _assert_same_data(a, b, uids_a, uids_b, maps_a, maps_b)


def _score_both(jmodel, pmodel, labels, shards, id_tags):
    z_jax = np.asarray(jmodel.score(jax_game_data(labels, shards, id_tags)))
    z_port = pmodel.score(torch_game_data(labels, shards, id_tags)).numpy()
    return z_jax, z_port


def test_model_saved_by_jax_scores_the_same_in_the_port(tmp_path):
    labels, shards, id_tags, coords = glmix_numpy(seed=7)
    jmodel = jax_game_model(coords)
    jax_model_io.save_game_model(jmodel, str(tmp_path / "m"))
    pmodel, maps = port_model_io.load_game_model(str(tmp_path / "m"), device="cpu")
    assert set(pmodel.models) == set(jmodel.models)
    assert set(maps) == {"global", "per_user", "per_item"}
    z_jax, z_port = _score_both(jmodel, pmodel, labels, shards, id_tags)
    np.testing.assert_allclose(z_port, z_jax, rtol=RTOL, atol=ATOL)


def test_model_saved_by_the_port_scores_the_same_in_jax(tmp_path):
    labels, shards, id_tags, coords = glmix_numpy(seed=8)
    pmodel = game_model_from_numpy(coords, "LOGISTIC_REGRESSION", device="cpu")
    port_model_io.save_game_model(pmodel, str(tmp_path / "m"))
    jmodel, _ = jax_model_io.load_game_model(str(tmp_path / "m"))
    assert jmodel.task.name == "LOGISTIC_REGRESSION"
    z_jax, z_port = _score_both(jmodel, pmodel, labels, shards, id_tags)
    np.testing.assert_allclose(z_port, z_jax, rtol=RTOL, atol=ATOL)


def test_port_model_round_trip_keeps_coefficients(tmp_path):
    labels, shards, id_tags, coords = glmix_numpy(seed=9)
    jmodel = jax_game_model(coords)
    pmodel = game_model_from_numpy(coordinates_of_jax_model(jmodel), jmodel.task, device="cpu")
    port_model_io.save_game_model(pmodel, str(tmp_path / "m"), num_output_files_per_random_effect=3)
    again, _ = port_model_io.load_game_model(str(tmp_path / "m"), device="cpu")
    np.testing.assert_array_equal(
        again.models["fixed"].coefficients.means.numpy(), coords["fixed"]["means"]
    )
    for cid in ("per_userId", "per_itemId"):
        assert dict(again.models[cid].items()) == dict(pmodel.models[cid].items())

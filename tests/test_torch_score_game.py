"""The port's score_game CLI (--device cpu) against the JAX package's
score_game on one Avro fixture: the same scores (rtol 2e-4, atol 1e-5: f32
sums in another order) and the same AUC (to 1e-6)."""

import os

import numpy as np
import pytest

from _torch_parity import jax_game_model
from photon_ml_tpu.cli import score_game as jax_cli
from photon_ml_tpu.indexmap import INTERCEPT_KEY, DefaultIndexMap, feature_key
from photon_ml_tpu.io.data_reader import write_training_examples
from photon_ml_tpu.io.model_io import save_game_model
from photon_ml_tpu_torch.cli import score_game as port_cli
from photon_ml_tpu_torch.io.scores_io import load_scores

N_ROWS = 160
CONFIG = {"feature_shards": {
    "global": {"feature_bags": ["features"], "add_intercept": True},
    "per_user": {"feature_bags": ["userFeatures"], "add_intercept": False},
    "per_item": {"feature_bags": ["itemFeatures"], "add_intercept": False},
}}


@pytest.fixture(scope="module")
def fixture_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("score_game_parity")
    rng = np.random.default_rng(21)
    records = []
    for i in range(N_ROWS):
        records.append({
            "uid": f"r{i}",
            "label": float(rng.random() < 0.5),
            "features": [("g", str(j), float(rng.standard_normal()))
                         for j in rng.choice(8, 4, replace=False)],
            "userFeatures": [("u", str(j), float(rng.standard_normal()))
                             for j in rng.choice(5, 2, replace=False)],
            "itemFeatures": [("i", str(j), 1.0) for j in rng.choice(4, 2, replace=False)],
            "metadataMap": {
                "userId": f"{'new' if i % 11 == 0 else 'u'}{i % 6}",
                "itemId": f"i{i % 3}",
            },
        })
    os.makedirs(root / "data")
    write_training_examples(str(root / "data" / "part-00000.avro"), records)

    maps = {
        "global": DefaultIndexMap(
            {**{feature_key("g", str(j)): j for j in range(8)}, INTERCEPT_KEY: 8}
        ),
        "per_user": DefaultIndexMap({feature_key("u", str(j)): j for j in range(5)}),
        "per_item": DefaultIndexMap({feature_key("i", str(j)): j for j in range(4)}),
    }
    coords = {"fixed": {"feature_shard": "global",
                        "means": rng.standard_normal(9).astype(np.float32)}}
    for re_type, shard, prefix, count, dim, local in (
        ("userId", "per_user", "u", 6, 5, 3), ("itemId", "per_item", "i", 3, 4, 2)
    ):
        pidx = np.sort(
            np.stack([rng.choice(dim, local, replace=False) for _ in range(count)]), axis=1
        )
        ids = [f"{prefix}{e}" for e in range(count)]
        coords[f"per_{re_type}"] = {
            "feature_shard": shard, "random_effect_type": re_type,
            "coefficients": [rng.standard_normal((count, local)).astype(np.float32)],
            "proj_indices": [pidx], "proj_valid": [np.ones((count, local), bool)],
            "entity_ids": [ids], "entity_to_loc": {e: (0, k) for k, e in enumerate(ids)},
            "global_dim": dim, "projector_type": "index_map", "projection_seed": 0,
        }
    save_game_model(
        jax_game_model(coords), str(root / "model"), index_maps=maps, configurations=CONFIG
    )
    return root


def _argv(root, out, *extra):
    return ["--data-dirs", str(root / "data"), "--model-dir", str(root / "model"),
            "--output-dir", str(out), "--evaluator", "AUC", *extra]


def _scores(out):
    items = sorted(load_scores(str(out)), key=lambda s: int(s.uid[1:]))
    return items, np.array([s.prediction_score for s in items])


def test_port_cli_matches_jax_cli(fixture_dirs, tmp_path):
    auc_jax = jax_cli.run(jax_cli.parse_args(_argv(fixture_dirs, tmp_path / "jax")))
    auc_port = port_cli.run(
        port_cli.parse_args(_argv(fixture_dirs, tmp_path / "port", "--device", "cpu"))
    )
    jax_items, z_jax = _scores(tmp_path / "jax")
    port_items, z_port = _scores(tmp_path / "port")
    assert len(port_items) == N_ROWS
    np.testing.assert_allclose(z_port, z_jax, rtol=2e-4, atol=1e-5)
    assert np.isfinite(auc_port) and abs(auc_port - auc_jax) <= 1e-6
    for a, b in zip(jax_items, port_items):
        assert (a.uid, a.label, a.weight, a.id_tags) == (b.uid, b.label, b.weight, b.id_tags)


def test_port_cli_output_files_and_main(fixture_dirs, tmp_path):
    out = tmp_path / "parts"
    assert port_cli.main(_argv(fixture_dirs, out, "--device", "cpu", "--num-output-files", "3")) == 0
    assert sorted(os.listdir(out)) == [f"part-{p:05d}.avro" for p in range(3)]
    assert len(_scores(out)[0]) == N_ROWS
    # an existing output dir is replaced only when asked
    port_cli.main(_argv(fixture_dirs, out, "--device", "cpu", "--delete-output-dir-if-exists"))
    assert os.listdir(out) == ["part-00000.avro"]


def test_port_cli_missing_entity_policy(fixture_dirs, tmp_path):
    with pytest.raises(ValueError, match="absent from the model"):
        port_cli.run(port_cli.parse_args(_argv(
            fixture_dirs, tmp_path / "o", "--device", "cpu", "--missing-entity-policy", "error"
        )))


def test_port_cli_grouped_evaluator_matches_jax(fixture_dirs, tmp_path):
    extra = ["--evaluator", "AUC:itemId"]
    m_jax = jax_cli.run(jax_cli.parse_args(_argv(fixture_dirs, tmp_path / "j") + extra))
    m_port = port_cli.run(port_cli.parse_args(
        _argv(fixture_dirs, tmp_path / "p", "--device", "cpu") + extra
    ))
    assert abs(m_port - m_jax) <= 1e-6

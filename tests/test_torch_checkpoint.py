"""Training checkpoints and resume in the port, against the JAX package's
file format:

- a checkpoint written by the JAX package loads in the port with equal
  arrays, and the port's loads in the JAX package (fixed-effect,
  random-effect and factored kinds);
- resuming after 1 of 2 outer iterations equals the uninterrupted run
  bitwise (objectives, validation metric, every model array), and a
  complete checkpoint skips training;
- a checkpoint written for other data is rejected;
- atomic overwrite, the orphan sweep and keep-last-n pruning;
- ``train_game --checkpoint-dir``.
"""

import json
import os

import numpy as np
import pytest
import torch

from photon_ml_tpu import checkpoint as jax_ckpt
from photon_ml_tpu_torch import checkpoint as ckpt
from photon_ml_tpu_torch.algorithm.factored_random_effect import MFOptimizationConfiguration
from photon_ml_tpu_torch.cli import train_game
from photon_ml_tpu_torch.data.game_data import FeatureShard, GameData
from photon_ml_tpu_torch.data.random_effect import RandomEffectDataConfiguration
from photon_ml_tpu_torch.estimators.game import (
    FactoredRandomEffectCoordinateConfiguration,
    FixedEffectCoordinateConfiguration,
    GameEstimator,
    RandomEffectCoordinateConfiguration,
)
from photon_ml_tpu_torch.opt.config import GlmOptimizationConfiguration, RegularizationContext
from photon_ml_tpu_torch.types import RegularizationType, TaskType

RATINGS = os.path.join(os.path.dirname(__file__), "fixtures", "ratings")


def _l2(lam):
    return GlmOptimizationConfiguration(
        regularization=RegularizationContext(RegularizationType.L2), regularization_weight=lam
    )


def _problem(seed=0, n_users=6, rows=25, dg=8, du=4):
    """A linear GLMix problem: training and validation GameData."""
    rng = np.random.default_rng(seed)
    n = n_users * rows
    Xg = rng.normal(size=(n, dg)).astype(np.float32)
    Xu = rng.normal(size=(n, du)).astype(np.float32)
    users = np.repeat([f"u{i}" for i in range(n_users)], rows)
    wg = rng.normal(size=dg).astype(np.float32)
    wu = {f"u{i}": rng.normal(size=du).astype(np.float32) for i in range(n_users)}
    y = Xg @ wg + np.array([Xu[i] @ wu[users[i]] for i in range(n)], np.float32)
    y += 0.05 * rng.normal(size=n).astype(np.float32)

    def coo(X):
        r, c = np.nonzero(X)
        return FeatureShard(rows=r, cols=c, vals=X[r, c], dim=X.shape[1])

    def part(sl):
        return GameData(labels=y[sl], feature_shards={"g": coo(Xg[sl]), "u": coo(Xu[sl])},
                        id_tags={"userId": users[sl]})

    cut = int(0.8 * n)
    return part(slice(0, cut)), part(slice(cut, n))


def _estimator(num_outer=2):
    return GameEstimator(
        task=TaskType.LINEAR_REGRESSION,
        coordinates={
            "fixed": FixedEffectCoordinateConfiguration("g", _l2(0.1)),
            "per_user": RandomEffectCoordinateConfiguration(
                "u", RandomEffectDataConfiguration("userId"), _l2(1.0)),
            "mf": FactoredRandomEffectCoordinateConfiguration(
                "g", RandomEffectDataConfiguration("userId"), MFOptimizationConfiguration(2, 2),
                _l2(1.0)),
        },
        num_outer_iterations=num_outer,
        device="cpu",
    )


def _arrays(models):
    """Every array of a models dict (either package's), as numpy, by a path
    name."""
    out = {}
    for cid, m in models.items():
        if hasattr(getattr(m, "coefficients", None), "means"):
            out[f"{cid}/means"] = m.coefficients.means
            continue
        if hasattr(m, "projection_matrix"):
            out[f"{cid}/B"] = m.projection_matrix
            m = m.latent
        for b in range(len(m.coefficients)):
            out[f"{cid}/coef_{b}"] = m.coefficients[b]
            out[f"{cid}/idx_{b}"] = m.proj_indices[b]
            out[f"{cid}/valid_{b}"] = m.proj_valid[b]
    return {k: np.asarray(v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


@pytest.fixture(scope="module")
def fitted():
    data, vdata = _problem()
    return data, vdata, _estimator(1).fit(data, vdata)


def test_checkpoints_cross_between_the_packages(fitted, tmp_path):
    _, _, fit = fitted
    models = fit.model.models
    ckpt.save_training_checkpoint(str(tmp_path / "port"), models,
                                  state={"completed_iterations": 1}, best_models=models)
    jmodels, state, jbest = jax_ckpt.load_training_checkpoint(str(tmp_path / "port"))
    assert state["completed_iterations"] == 1
    want = _arrays(models)
    for got in (_arrays(jmodels), _arrays(jbest)):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert jmodels["mf"].latent.entity_ids == models["mf"].latent.entity_ids
    # the JAX package writes them back; the port reads its file
    jax_ckpt.save_training_checkpoint(str(tmp_path / "jax"), jmodels,
                                      state={"completed_iterations": 1})
    back, _, best = ckpt.load_training_checkpoint(str(tmp_path / "jax"), device="cpu")
    assert best is None
    got = _arrays(back)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert back["per_user"].proj_indices[0].dtype == torch.int64
    assert back["mf"].latent.entity_to_loc == models["mf"].latent.entity_to_loc
    assert ckpt.model_fingerprint(back) == jax_ckpt.model_fingerprint(jmodels)


def test_resume_equals_the_uninterrupted_run_bitwise(tmp_path):
    data, vdata = _problem(1)
    straight = _estimator(2).fit(data, vdata)
    ck = str(tmp_path / "ck")
    partial = _estimator(1).fit(data, vdata, checkpoint_dir=ck)
    assert ckpt.has_checkpoint(ck)
    assert len(partial.objective_history) == 3
    resumed = _estimator(2).fit(data, vdata, checkpoint_dir=ck)
    assert resumed.objective_history == straight.objective_history
    assert resumed.validation_history == straight.validation_history
    assert resumed.validation_metric == straight.validation_metric
    want, got = _arrays(straight.model.models), _arrays(resumed.model.models)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # a complete checkpoint: nothing left to train, the same histories
    again = _estimator(2).fit(data, vdata, checkpoint_dir=ck)
    assert again.objective_history == resumed.objective_history
    assert torch.equal(again.model.score(vdata), resumed.model.score(vdata))


def test_incompatible_checkpoint_is_rejected(fitted, tmp_path):
    _, _, fit = fitted
    ck = str(tmp_path / "ck")
    ckpt.save_training_checkpoint(ck, fit.model.models, state={"completed_iterations": 1})
    other, _ = _problem(99, n_users=9, rows=11)
    with pytest.raises(ValueError, match="incompatible"):
        _estimator(2).fit(other, checkpoint_dir=ck)


def test_atomic_overwrite_and_orphan_sweep(fitted, tmp_path):
    _, _, fit = fitted
    for name in (".ckpt-tmp-dead", ".ckpt-old-dead"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "junk.json").write_text("{}")
    d = str(tmp_path / "c")
    ckpt.save_training_checkpoint(d, fit.model.models, state={"completed_iterations": 1})
    ckpt.save_training_checkpoint(d, fit.model.models, state={"completed_iterations": 2})
    _, state, _ = ckpt.load_training_checkpoint(d, device="cpu")
    assert state["completed_iterations"] == 2
    assert [p for p in os.listdir(tmp_path) if p.startswith((".ckpt-tmp-", ".ckpt-old-"))] == []


def test_keep_last_n_prunes_numbered_siblings(fitted, tmp_path):
    _, _, fit = fitted
    (tmp_path / "notes").mkdir()  # not a checkpoint: survives
    for i in range(1, 5):
        ckpt.save_training_checkpoint(str(tmp_path / f"ckpt-{i:06d}"), fit.model.models,
                                      state={"completed_iterations": i}, keep_last_n=2)
    assert sorted(p for p in os.listdir(tmp_path) if p.startswith("ckpt-")) == [
        "ckpt-000003", "ckpt-000004"]
    assert (tmp_path / "notes").is_dir()
    with pytest.raises(ValueError, match="iteration-numbered"):
        ckpt.save_training_checkpoint(str(tmp_path / "latest"), fit.model.models,
                                      state={"completed_iterations": 1}, keep_last_n=3)


def test_train_game_checkpoint_dir(tmp_path):
    cfg = {
        "feature_shards": {"global": {"feature_bags": ["features"], "add_intercept": True}},
        "coordinates": {"fixed": {"type": "fixed", "feature_shard": "global",
                                  "optimizer": {"regularization": "L2",
                                                "regularization_weight": 10.0}}},
    }
    (tmp_path / "game.json").write_text(json.dumps(cfg))
    ck = tmp_path / "ckpt"
    fit = train_game.run(train_game.parse_args([
        "--train-data-dirs", os.path.join(RATINGS, "train"),
        "--coordinate-config", str(tmp_path / "game.json"),
        "--task", "LINEAR_REGRESSION", "--output-dir", str(tmp_path / "out"),
        "--num-outer-iterations", "2", "--checkpoint-dir", str(ck), "--device", "cpu",
    ]))
    payload = json.loads((ck / ckpt.STATE_FILE).read_text())
    assert payload["state"]["completed_iterations"] == 2
    assert [tuple(x) for x in payload["state"]["objective_history"]] == fit.objective_history

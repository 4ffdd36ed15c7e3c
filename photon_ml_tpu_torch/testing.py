"""Synthetic-data generators and GAME factories for tests and examples.

Port of ``photon_ml_tpu/testing.py``: the numpy draws are the same calls in
the same order, so a seed gives the JAX module's arrays; the factories
build the port's ``GameData`` and models, the models on an explicit
``device`` (default ``cuda``).

Reference parity: photon-test-utils SparkTestUtils.scala:85-307 (seeded
per-task generators in three numerical regimes — benign, outlier/ill-
conditioned, invalid NaN/Inf — plus invalid-label draws) and
photon-api util/GameTestUtils.scala:41 (factories for labeled points,
fixed/random-effect datasets, coordinates and models). The reference ships
these in a main source set precisely so downstream tests can reuse them;
same here.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from photon_ml_tpu_torch.data.game_data import FeatureShard, GameData
from photon_ml_tpu_torch.device import DEFAULT_DEVICE, DeviceLike, resolve_device
from photon_ml_tpu_torch.types import TaskType


def _features(rng, n, d, regime: str) -> np.ndarray:
    """Dense features in one of the reference's three regimes."""
    X = rng.normal(size=(n, d))
    if regime == "benign":
        return X.astype(np.float32)
    if regime == "outlier":
        # heavy-tailed, badly scaled columns (ill-conditioned):
        # SparkTestUtils.generateSparseVectorWithOutliers
        scales = 10.0 ** rng.integers(-4, 5, size=d)
        X = X * scales
        mask = rng.random((n, d)) < 0.02
        X = np.where(mask, X * 1e4, X)
        return X.astype(np.float32)
    if regime == "invalid":
        # sprinkle NaN/Inf (generateSparseVectorWithInvalidValues)
        bad = rng.random((n, d)) < 0.05
        choice = rng.random((n, d))
        X = np.where(bad & (choice < 0.5), np.nan, X)
        X = np.where(bad & (choice >= 0.5), np.inf, X)
        return X.astype(np.float32)
    raise ValueError(f"unknown regime: {regime}")


def _labels(rng, z: np.ndarray, task: TaskType) -> np.ndarray:
    if task is TaskType.LOGISTIC_REGRESSION:
        return (1.0 / (1.0 + np.exp(-z)) > rng.random(len(z))).astype(np.float32)
    if task is TaskType.POISSON_REGRESSION:
        return rng.poisson(np.exp(np.clip(z, -10, 3))).astype(np.float32)
    if task is TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM:
        return (z > 0).astype(np.float32)
    return (z + 0.1 * rng.normal(size=len(z))).astype(np.float32)


def draw_sample(
    task: TaskType,
    n: int = 200,
    d: int = 10,
    regime: str = "benign",
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(X, y, w_true) for one task/regime — the per-task draw* generators.

    ``regime='balanced'`` is implied for classification: labels come from
    the model probability so classes are roughly balanced at w ~ N(0,1).
    """
    rng = np.random.default_rng(seed)
    X = _features(rng, n, d, regime)
    w_true = rng.normal(size=d).astype(np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        z = np.nan_to_num(X, nan=0.0, posinf=0.0, neginf=0.0) @ w_true
        y = _labels(rng, z, task)
    return X, y, w_true


def draw_invalid_labels(
    task: TaskType, n: int = 50, seed: int = 0
) -> np.ndarray:
    """Labels that must fail validation (drawSampleFromInvalidLabels):
    NaN everywhere, negatives for Poisson, non-binary for classifiers."""
    rng = np.random.default_rng(seed)
    y = rng.normal(size=n).astype(np.float32)
    bad = rng.random(n) < 0.3
    if task is TaskType.POISSON_REGRESSION:
        return np.where(bad, -np.abs(y) - 1.0, np.abs(y)).astype(np.float32)
    if task.is_classification:
        return np.where(bad, 0.5, (y > 0).astype(np.float32)).astype(np.float32)
    return np.where(bad, np.nan, y).astype(np.float32)


def dense_to_shard(X: np.ndarray) -> FeatureShard:
    """Dense matrix → COO FeatureShard (test plumbing helper)."""
    rows, cols = np.nonzero(X)
    return FeatureShard(
        rows=rows, cols=cols, vals=X[rows, cols].astype(np.float32),
        dim=X.shape[1],
    )


def generate_fixed_effect_data(
    task: TaskType = TaskType.LOGISTIC_REGRESSION,
    n: int = 200,
    d: int = 10,
    shard_name: str = "global",
    seed: int = 0,
) -> Tuple[GameData, np.ndarray]:
    """GameData with one fixed-effect shard (GameTestUtils
    generateFixedEffectDataSet). Returns (data, w_true)."""
    X, y, w_true = draw_sample(task, n, d, seed=seed)
    return (
        GameData(labels=y, feature_shards={shard_name: dense_to_shard(X)},
                 id_tags={}),
        w_true,
    )


def generate_glmix_data(
    task: TaskType = TaskType.LINEAR_REGRESSION,
    n_entities: int = 10,
    rows_per_entity: int = 30,
    d_global: int = 10,
    d_entity: int = 4,
    re_type: str = "userId",
    global_shard: str = "global",
    re_shard: str = "per_entity",
    noise: float = 0.1,
    seed: int = 0,
) -> Tuple[GameData, Dict[str, np.ndarray]]:
    """Fixed + per-entity random-effect data (GameTestUtils
    generateRandomEffectDataSet + linear models). Returns
    (data, {'w_fixed': ..., 'w_<entity>': ...})."""
    rng = np.random.default_rng(seed)
    n = n_entities * rows_per_entity
    Xg = rng.normal(size=(n, d_global)).astype(np.float32)
    Xe = rng.normal(size=(n, d_entity)).astype(np.float32)
    entities = np.repeat(
        [f"e{i:04d}" for i in range(n_entities)], rows_per_entity
    )
    w_fixed = rng.normal(size=d_global).astype(np.float32)
    w_entity = {
        f"e{i:04d}": rng.normal(size=d_entity).astype(np.float32)
        for i in range(n_entities)
    }
    z = Xg @ w_fixed + np.array(
        [Xe[r] @ w_entity[entities[r]] for r in range(n)], dtype=np.float32
    )
    if task is TaskType.LINEAR_REGRESSION:
        y = (z + noise * rng.normal(size=n)).astype(np.float32)
    else:
        y = _labels(rng, z, task)
    data = GameData(
        labels=y,
        feature_shards={
            global_shard: dense_to_shard(Xg),
            re_shard: dense_to_shard(Xe),
        },
        id_tags={re_type: entities},
    )
    truth = {"w_fixed": w_fixed}
    truth.update({f"w_{k}": v for k, v in w_entity.items()})
    return data, truth


def generate_game_model(
    data: GameData,
    task: TaskType,
    coordinates: Dict[str, dict],
    seed: int = 0,
    device: DeviceLike = DEFAULT_DEVICE,
):
    """Random (untrained) GameModel matching a dataset's shapes, on
    ``device`` (GameTestUtils generate*Model): coordinates maps cid →
    {'feature_shard': ..., optional 'random_effect_type': ...}."""
    import torch

    from photon_ml_tpu_torch.models.coefficients import Coefficients
    from photon_ml_tpu_torch.models.game import CoordinateMeta, GameModel
    from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
    from photon_ml_tpu_torch.models.random_effect import RandomEffectModel

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    models: Dict[str, object] = {}
    meta: Dict[str, CoordinateMeta] = {}
    for cid, spec in coordinates.items():
        shard = data.feature_shards[spec["feature_shard"]]
        re_type = spec.get("random_effect_type")
        meta[cid] = CoordinateMeta(
            feature_shard=spec["feature_shard"], random_effect_type=re_type
        )
        if re_type is None:
            models[cid] = GeneralizedLinearModel(
                coefficients=Coefficients(
                    means=torch.from_numpy(
                        rng.normal(size=shard.dim).astype(np.float32)
                    ).to(dev)
                ),
                task=task,
            )
        else:
            entity_ids = sorted(set(map(str, data.id_tags[re_type])))
            models[cid] = RandomEffectModel.from_entity_coefficients(
                random_effect_type=re_type,
                task=task,
                entity_coefficients={
                    eid: {
                        j: float(rng.normal())
                        for j in range(shard.dim)
                    }
                    for eid in entity_ids
                },
                global_dim=shard.dim,
                device=dev,
            )
    return GameModel(models=models, meta=meta, task=task)

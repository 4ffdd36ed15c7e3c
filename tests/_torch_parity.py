"""Shared fixtures of the PyTorch port's parity tests: one seeded GLMix
problem in numpy, handed to the JAX package and to the port."""

from __future__ import annotations

import numpy as np


def glmix_numpy(seed: int, n: int = 300, fe_dim: int = 50, fe_k: int = 6,
                counts=(("userId", "per_user", "u", 20), ("itemId", "per_item", "i", 8)),
                re_dim: int = 30, re_local: int = 6, re_k: int = 4,
                projector: str = "index_map"):
    """Rows with FE features, two random-effect shards, ~10% unseen entities
    and ~25% of RE nonzeros outside the entity's projected space.

    Returns (labels, shards {name: (rows, cols, vals, dim)}, id_tags,
    coordinates) where coordinates is ``convert.game_model_from_numpy``
    input."""
    rng = np.random.default_rng(seed)
    shards = {
        "global": (
            np.repeat(np.arange(n), fe_k),
            rng.integers(0, fe_dim, n * fe_k),
            rng.standard_normal(n * fe_k).astype(np.float32),
            fe_dim,
        )
    }
    coords = {
        "fixed": {
            "feature_shard": "global",
            "means": rng.standard_normal(fe_dim).astype(np.float32),
        }
    }
    id_tags = {}
    for re_type, shard, prefix, count in counts:
        pidx = np.sort(
            np.stack([rng.choice(re_dim, re_local, replace=False) for _ in range(count)]),
            axis=1,
        )
        valid = np.ones((count, re_local), dtype=bool)
        short = rng.random(count) < 0.3
        valid[short, re_local - 2:] = False
        pidx[~valid] = re_dim  # the reference's padding index
        ent = rng.integers(0, count, n)
        unseen = rng.random(n) < 0.1
        ids = np.array(
            [f"{'new' if u else prefix}{e}" for e, u in zip(ent, unseen)]
        )
        picks = pidx[ent[:, None], rng.integers(0, re_local - 2, (n, re_k))]
        outside = rng.random((n, re_k)) < 0.25
        cols = np.where(outside, rng.integers(0, re_dim, (n, re_k)), picks)
        shards[shard] = (
            np.repeat(np.arange(n), re_k), cols.reshape(-1),
            rng.standard_normal(n * re_k).astype(np.float32), re_dim,
        )
        id_tags[re_type] = ids
        entity_ids = [f"{prefix}{e}" for e in range(count)]
        local_dim = 4 if projector == "random" else re_local
        coords[f"per_{re_type}"] = {
            "feature_shard": shard,
            "random_effect_type": re_type,
            "coefficients": [rng.standard_normal((count, local_dim)).astype(np.float32)],
            "proj_indices": [pidx[:, :local_dim]],
            "proj_valid": [valid[:, :local_dim]],
            "entity_ids": [entity_ids],
            "entity_to_loc": {eid: (0, e) for e, eid in enumerate(entity_ids)},
            "global_dim": re_dim,
            "projector_type": projector,
            "projection_seed": 3,
        }
    labels = (rng.random(n) < 0.5).astype(np.float32)
    return labels, shards, id_tags, coords


def jax_game_data(labels, shards, id_tags):
    from photon_ml_tpu.data.game_data import FeatureShard, GameData

    return GameData(
        labels=labels,
        feature_shards={k: FeatureShard(*v) for k, v in shards.items()},
        id_tags=id_tags,
    )


def torch_game_data(labels, shards, id_tags):
    from photon_ml_tpu_torch.data.game_data import FeatureShard, GameData

    return GameData(
        labels=labels,
        feature_shards={k: FeatureShard(*v) for k, v in shards.items()},
        id_tags=id_tags,
    )


def jax_game_model(coords, task_name: str = "LOGISTIC_REGRESSION"):
    """The JAX package's GameModel with the given coordinates."""
    import jax.numpy as jnp

    from photon_ml_tpu.models.coefficients import Coefficients
    from photon_ml_tpu.models.game import CoordinateMeta, GameModel
    from photon_ml_tpu.models.glm import GeneralizedLinearModel
    from photon_ml_tpu.models.random_effect import RandomEffectModel
    from photon_ml_tpu.projector import ProjectorType
    from photon_ml_tpu.types import TaskType

    task = TaskType[task_name]
    models, meta = {}, {}
    for cid, c in coords.items():
        meta[cid] = CoordinateMeta(
            feature_shard=c["feature_shard"],
            random_effect_type=c.get("random_effect_type"),
        )
        if "means" in c:
            models[cid] = GeneralizedLinearModel(
                coefficients=Coefficients(means=jnp.asarray(c["means"])), task=task
            )
            continue
        models[cid] = RandomEffectModel(
            random_effect_type=c["random_effect_type"],
            task=task,
            coefficients=[jnp.asarray(w) for w in c["coefficients"]],
            variances=[None for _ in c["coefficients"]],
            proj_indices=[jnp.asarray(p, dtype=jnp.int32) for p in c["proj_indices"]],
            proj_valid=[jnp.asarray(p) for p in c["proj_valid"]],
            entity_ids=c["entity_ids"],
            entity_to_loc=c["entity_to_loc"],
            global_dim=c["global_dim"],
            projector_type=ProjectorType(c["projector_type"]),
            projection_seed=c["projection_seed"],
        )
    return GameModel(models=models, meta=meta, task=task)


def coordinates_of_jax_model(model):
    """The JAX GameModel's arrays as numpy, in ``game_model_from_numpy``
    form."""
    out = {}
    for cid, sub in model.models.items():
        m = model.meta[cid]
        c = {"feature_shard": m.feature_shard, "random_effect_type": m.random_effect_type}
        if hasattr(sub, "coefficients") and hasattr(sub.coefficients, "means"):
            c["means"] = np.asarray(sub.coefficients.means)
            if sub.coefficients.variances is not None:
                c["variances"] = np.asarray(sub.coefficients.variances)
        else:
            c.update(
                coefficients=[np.asarray(w) for w in sub.coefficients],
                variances=[None if v is None else np.asarray(v) for v in sub.variances],
                proj_indices=[np.asarray(p) for p in sub.proj_indices],
                proj_valid=[np.asarray(p) for p in sub.proj_valid],
                entity_ids=sub.entity_ids,
                entity_to_loc=sub.entity_to_loc,
                global_dim=sub.global_dim,
                projector_type=sub.projector_type,
                projection_seed=sub.projection_seed,
            )
        out[cid] = c
    return out

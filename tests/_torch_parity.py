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


def solver_configs(optimizer: str = "LBFGS", regularization: str = "L2",
                   weight: float = 1.0, alpha=None, **opt):
    """The same GlmOptimizationConfiguration in both packages: ``optimizer``
    LBFGS or TRON (each with its own defaults), ``opt`` the OptimizerConfig
    fields."""
    from photon_ml_tpu.opt import config as jax_config
    from photon_ml_tpu.types import RegularizationType as JaxReg
    from photon_ml_tpu_torch.opt import config
    from photon_ml_tpu_torch.types import RegularizationType

    def make(cfg, reg_enum):
        factory = cfg.OptimizerConfig.tron if optimizer == "TRON" else cfg.OptimizerConfig.lbfgs
        return cfg.GlmOptimizationConfiguration(
            optimizer_config=factory(**opt),
            regularization=cfg.RegularizationContext(reg_enum[regularization], alpha=alpha),
            regularization_weight=weight,
        )

    return make(jax_config, JaxReg), make(config, RegularizationType)


def dense_bucket(seed: int, E: int = 6, s: int = 24, d: int = 5, labels: str = "binary"):
    """A batch of E dense problems in both packages, with padding rows and
    an all-padding last entity: (jax data, torch data, zero w0 [E, d]).
    ``labels`` "binary" (logistic), or "counts" (Poisson, also fit by the
    squared loss)."""
    import jax.numpy as jnp
    import torch

    from photon_ml_tpu.ops.data import LabeledData as JaxData
    from photon_ml_tpu.ops.features import DenseFeatures as JaxDense
    from photon_ml_tpu_torch.ops.data import LabeledData
    from photon_ml_tpu_torch.ops.features import DenseFeatures

    rng = np.random.default_rng(seed)
    X = rng.standard_normal((E, s, d)).astype(np.float32)
    if labels == "counts":
        y = rng.poisson(1.5, (E, s)).astype(np.float32)
    else:
        y = (rng.random((E, s)) < 0.5).astype(np.float32)
    off = (rng.standard_normal((E, s)) * 0.2).astype(np.float32)
    wt = (rng.random((E, s)) + 0.5).astype(np.float32)
    wt[:, -4:] = 0.0  # padding rows
    wt[-1] = 0.0      # an all-padding entity
    jd = JaxData.create(JaxDense(jnp.asarray(X)), jnp.asarray(y), jnp.asarray(off),
                        jnp.asarray(wt))
    td = LabeledData.create(DenseFeatures(torch.from_numpy(X)), torch.from_numpy(y),
                            torch.from_numpy(off), torch.from_numpy(wt))
    return jd, td, np.zeros((E, d), np.float32)


def jax_vmapped_solve(loss: str, jd, w0, cfg, box=None):
    """The JAX package's ``solve`` under vmap over the entity axis."""
    import jax
    import jax.numpy as jnp

    from photon_ml_tpu.losses import pointwise as jax_pointwise
    from photon_ml_tpu.losses.objective import make_glm_objective as jax_objective
    from photon_ml_tpu.opt.solve import solve as jax_solve

    obj = jax_objective(getattr(jax_pointwise, loss), use_pallas=False)
    return jax.vmap(lambda w, dd: jax_solve(obj, w, dd, cfg, box=box))(jnp.asarray(w0), jd)


def write_tiny_glmix(root) -> dict:
    """The JAX package's tests/test_progress.py tiny logistic GLMix CLI
    fixture (fixed + per_user, 60 training and 24 held-out rows) written
    under ``root`` with the port's Avro writer: {"train", "test",
    "config"} paths."""
    import json
    import os

    from photon_ml_tpu_torch.io.data_reader import write_training_examples

    rng = np.random.default_rng(7)
    n_users, rows, dg, du = 6, 10, 4, 2
    wg = rng.normal(size=dg)
    wu = {f"user{i}": rng.normal(size=du) for i in range(n_users)}

    def make(n_rows, seed):
        r = np.random.default_rng(seed)
        records = []
        for i in range(n_rows):
            user = f"user{i % n_users}"
            xg = r.normal(size=dg)
            xu = r.normal(size=du)
            z = xg @ wg + xu @ wu[user]
            y = 1.0 if 1 / (1 + np.exp(-z)) > r.random() else 0.0
            records.append({
                "uid": f"r{i}", "label": y,
                "features": [("g", str(j), xg[j]) for j in range(dg)],
                "userFeatures": [("u", str(j), xu[j]) for j in range(du)],
                "metadataMap": {"userId": user},
            })
        return records

    paths = {"train": os.path.join(str(root), "train"), "test": os.path.join(str(root), "test"),
             "config": os.path.join(str(root), "game.json")}
    for name, n_rows, seed in (("train", n_users * rows, 1), ("test", n_users * 4, 2)):
        os.makedirs(paths[name])
        write_training_examples(os.path.join(paths[name], "part-00000.avro"), make(n_rows, seed))
    opt = {"optimizer": "LBFGS", "regularization": "L2"}
    config = {
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
    with open(paths["config"], "w") as f:
        json.dump(config, f)
    return paths


def tiny_glmix_argv(paths: dict, out, *extra) -> list:
    """train_game arguments over ``write_tiny_glmix``'s files (AUC, 2 outer
    iterations), as the JAX test passes them."""
    return [
        "--train-data-dirs", paths["train"], "--validation-data-dirs", paths["test"],
        "--coordinate-config", paths["config"], "--task", "LOGISTIC_REGRESSION",
        "--output-dir", str(out), "--evaluator", "AUC", "--num-outer-iterations", "2", *extra,
    ]

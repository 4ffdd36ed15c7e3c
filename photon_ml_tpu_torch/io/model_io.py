"""GAME model persistence: the reference's on-disk layout, Avro coefficients.

Port of ``photon_ml_tpu/io/model_io.py`` (reference
data/avro/ModelProcessingUtils.scala:58) for fixed- and random-effect
models, with the same layout

    <dir>/model-metadata.json
    <dir>/fixed-effect/<coordinate>/id-info            (featureShardId)
    <dir>/fixed-effect/<coordinate>/coefficients/part-00000.avro
    <dir>/random-effect/<coordinate>/id-info           (reType, featureShardId)
    <dir>/random-effect/<coordinate>/coefficients/part-*.avro
    <dir>/matrix-factorization/<coordinate>/{<reType>,projection}/part-*.avro

A factored random-effect model is saved as its effective random-effect
model (w = B·latent per entity, so it scores as a plain random effect), and
its latent factors and projection matrix B as ``LatentFactorAvro`` records
under ``matrix-factorization/``. Each GLM is one BayesianLinearModelAvro
record (nonzero means/variances as name-term-value triples). The files are
the same bytes either package writes, so a model saved by one loads in the
other. The metadata's ``featureShards`` entry carries each shard's dense
``dim`` and whether its feature names are ``positional`` (original integer
indices, for saves without an index map). Loading without index maps
builds a compact index per shard from the scanned features, as the
reference does.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.device import DEFAULT_DEVICE, DeviceLike, resolve_device
from photon_ml_tpu_torch.indexmap import NAME_TERM_DELIMITER, DefaultIndexMap, IndexMap
from photon_ml_tpu_torch.io import schemas
from photon_ml_tpu_torch.io.avro import read_avro_dir, write_avro_file
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.game import CoordinateMeta, GameModel
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.models.matrix_factorization import MatrixFactorizationModel
from photon_ml_tpu_torch.models.random_effect import RandomEffectModel
from photon_ml_tpu_torch.types import TaskType

FIXED_EFFECT = "fixed-effect"
RANDOM_EFFECT = "random-effect"
ID_INFO = "id-info"
COEFFICIENTS = "coefficients"
MATRIX_FACTORIZATION = "matrix-factorization"
METADATA_FILE = "model-metadata.json"

# Reference class names (BayesianLinearModelAvro.modelClass).
_MODEL_CLASS = {
    TaskType.LOGISTIC_REGRESSION:
        "com.linkedin.photon.ml.supervised.classification.LogisticRegressionModel",
    TaskType.LINEAR_REGRESSION:
        "com.linkedin.photon.ml.supervised.regression.LinearRegressionModel",
    TaskType.POISSON_REGRESSION:
        "com.linkedin.photon.ml.supervised.regression.PoissonRegressionModel",
    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM:
        "com.linkedin.photon.ml.supervised.classification.SmoothedHingeLossLinearSVMModel",
}


def _name_term_values(
    values: Dict[int, float], index_map: Optional[IndexMap]
) -> List[dict]:
    out = []
    for idx, val in values.items():
        if val == 0.0:
            continue
        if index_map is not None:
            key = index_map.get_feature_name(int(idx))
            if key is None:
                continue
            name, _, term = key.partition(NAME_TERM_DELIMITER)
        else:
            name, term = str(idx), ""
        out.append({"name": name, "term": term, "value": float(val)})
    return out


def _glm_record(model_id, task, means, variances, index_map) -> dict:
    return {
        "modelId": model_id,
        "modelClass": _MODEL_CLASS[task],
        "means": _name_term_values(means, index_map),
        "variances": _name_term_values(variances, index_map) if variances else None,
        "lossFunction": None,
    }


def _dense_to_sparse(t: torch.Tensor) -> Dict[int, float]:
    a = t.detach().cpu().numpy()
    (nz,) = np.nonzero(a)
    return {int(i): float(a[i]) for i in nz}


def save_game_model(
    model: GameModel,
    output_dir: str,
    index_maps: Optional[Dict[str, IndexMap]] = None,
    model_name: str = "photon-ml-tpu",
    configurations: Optional[dict] = None,
    num_output_files_per_random_effect: int = 1,
) -> None:
    """Write a GAME model directory (see module docstring for layout)."""
    from photon_ml_tpu_torch.algorithm.factored_random_effect import (
        FactoredRandomEffectModel,
    )

    feature_shards: Dict[str, dict] = {}
    for cid, sub in model.models.items():
        shard = model.meta[cid].feature_shard
        if isinstance(sub, GeneralizedLinearModel):
            dim = int(sub.coefficients.means.shape[0])
        elif isinstance(sub, RandomEffectModel):
            dim = int(sub.global_dim)
        elif isinstance(sub, FactoredRandomEffectModel):
            dim = int(sub.projection_matrix.shape[0])
        else:
            raise ValueError(f"cannot save sub-model type {type(sub)} for {cid}")
        ent = feature_shards.setdefault(
            shard, {"dim": 0, "positional": (index_maps or {}).get(shard) is None}
        )
        ent["dim"] = max(ent["dim"], dim)

    os.makedirs(output_dir, exist_ok=True)
    save_game_model_metadata(
        output_dir, model.task, model_name=model_name,
        configurations=configurations, feature_shards=feature_shards,
    )
    for cid, sub in model.models.items():
        meta = model.meta[cid]
        imap = (index_maps or {}).get(meta.feature_shard)
        if isinstance(sub, GeneralizedLinearModel):
            cdir = os.path.join(output_dir, FIXED_EFFECT, cid)
            means = _dense_to_sparse(sub.coefficients.means)
            variances = (
                _dense_to_sparse(sub.coefficients.variances)
                if sub.coefficients.variances is not None
                else None
            )
            os.makedirs(os.path.join(cdir, COEFFICIENTS), exist_ok=True)
            with open(os.path.join(cdir, ID_INFO), "w") as f:
                f.write(meta.feature_shard + "\n")
            write_avro_file(
                os.path.join(cdir, COEFFICIENTS, "part-00000.avro"),
                schemas.bayesian_linear_model_schema(),
                [_glm_record(cid, model.task, means, variances, imap)],
            )
        elif isinstance(sub, RandomEffectModel):
            _save_random_effect(
                sub, os.path.join(output_dir, RANDOM_EFFECT, cid), model.task,
                imap, num_output_files_per_random_effect, meta,
            )
        else:
            # the effective per-entity coefficients, so that the saved model
            # scores as a plain random effect; the factors themselves under
            # matrix-factorization/ (LatentFactorAvro, reference :450-516)
            _save_random_effect(
                _factored_to_effective_re(sub), os.path.join(output_dir, RANDOM_EFFECT, cid),
                model.task, imap, num_output_files_per_random_effect, meta,
            )
            _save_factored_latents(sub, os.path.join(output_dir, MATRIX_FACTORIZATION, cid))


def _factored_to_effective_re(sub) -> RandomEffectModel:
    """w_e = B·latent_e for every entity, as a single-bucket INDEX_MAP model
    of its nonzero coefficients (on the host)."""
    B = sub.projection_matrix.cpu().numpy()  # [d, k]
    latent = sub.latent
    entity_coefs: Dict[str, Dict[int, float]] = {}
    for b, ids in enumerate(latent.entity_ids):
        eff = latent.coefficients[b].cpu().numpy() @ B.T  # [Eb, d]
        for e, eid in enumerate(ids):
            (nz,) = np.nonzero(eff[e])
            entity_coefs[eid] = {int(i): float(eff[e, i]) for i in nz}
    return RandomEffectModel.from_entity_coefficients(
        random_effect_type=latent.random_effect_type, task=latent.task,
        entity_coefficients=entity_coefs, global_dim=B.shape[0], device="cpu",
    )


def _save_factored_latents(sub, out_dir: str) -> None:
    """``<out_dir>/<reType>/``: one latent vector an entity;
    ``<out_dir>/projection/``: one row of B a feature column."""
    latent = sub.latent
    records = []
    for b, ids in enumerate(latent.entity_ids):
        w_b = latent.coefficients[b].cpu().numpy()
        records.extend(
            {"effectId": str(eid), "latentFactor": [float(v) for v in w_b[e]]}
            for e, eid in enumerate(ids)
        )
    B = sub.projection_matrix.cpu().numpy()
    for name, recs in (
        (latent.random_effect_type, records),
        ("projection", (
            {"effectId": str(i), "latentFactor": [float(v) for v in B[i]]}
            for i in range(B.shape[0])
        )),
    ):
        os.makedirs(os.path.join(out_dir, name), exist_ok=True)
        write_avro_file(
            os.path.join(out_dir, name, "part-00000.avro"), schemas.latent_factor_schema(), recs
        )


def _save_random_effect(
    sub: RandomEffectModel, cdir: str, task: TaskType, imap: Optional[IndexMap],
    num_files: int, meta: CoordinateMeta,
) -> None:
    items = list(sub.items())
    variances = sub.variances_by_entity()
    os.makedirs(os.path.join(cdir, COEFFICIENTS), exist_ok=True)
    with open(os.path.join(cdir, ID_INFO), "w") as f:
        f.write(f"{sub.random_effect_type}\n{meta.feature_shard}\n")
    num_files = max(1, min(num_files, max(1, len(items))))
    per_file = -(-len(items) // num_files) if items else 1
    for p in range(num_files):
        chunk = items[p * per_file : (p + 1) * per_file]
        write_avro_file(
            os.path.join(cdir, COEFFICIENTS, f"part-{p:05d}.avro"),
            schemas.bayesian_linear_model_schema(),
            (
                _glm_record(eid, task, coefs, variances.get(eid), imap)
                for eid, coefs in chunk
            ),
        )


def save_game_model_metadata(
    output_dir: str,
    task: TaskType,
    model_name: str = "photon-ml-tpu",
    configurations: Optional[dict] = None,
    feature_shards: Optional[Dict[str, dict]] = None,
) -> None:
    """model-metadata.json (reference saveGameModelMetadataToHDFS :517)."""
    os.makedirs(output_dir, exist_ok=True)
    payload = {
        "modelType": task.name,
        "modelName": model_name,
        "configurations": configurations or {},
    }
    if feature_shards:
        payload["featureShards"] = feature_shards
    with open(os.path.join(output_dir, METADATA_FILE), "w") as f:
        json.dump(payload, f, indent=2)


def load_game_model_metadata(models_dir: str) -> dict:
    with open(os.path.join(models_dir, METADATA_FILE)) as f:
        return json.load(f)


class _MapBuilder:
    """Growing name->index map with an O(1) next-index counter."""

    __slots__ = ("map", "next")

    def __init__(self) -> None:
        self.map: Dict[str, int] = {}
        self.next = 0


def _record_sparse(
    record: dict,
    field: str,
    imap: Optional[IndexMap],
    builder: Optional[_MapBuilder],
    positional: bool = False,
    dropped: Optional[List[int]] = None,
) -> Dict[int, float]:
    """NameTermValue list → {index: value}; builds a compact index on the
    fly when no map is given. Coefficients whose feature is absent from a
    provided map are counted into ``dropped`` (a one-element list)."""
    out: Dict[int, float] = {}
    entries = record.get(field) or []
    keys = [
        ntv["name"] if not ntv["term"] else f"{ntv['name']}{NAME_TERM_DELIMITER}{ntv['term']}"
        for ntv in entries
    ]
    if imap is not None:
        # one batched lookup: an off-heap map answers it natively
        for ntv, idx in zip(entries, imap.get_indices(keys).tolist()):
            if idx < 0:
                if dropped is not None:
                    dropped[0] += 1
                continue
            out[idx] = float(ntv["value"])
        return out
    for ntv, key in zip(entries, keys):
        if key not in builder.map:
            if positional:
                # positional saves name features by original index
                if ntv["term"] or not key.isdigit():
                    raise ValueError(
                        f"positional model has non-numeric feature name {key!r}"
                    )
                idx_new = int(key)
            else:
                idx_new = builder.next
            builder.map[key] = idx_new
            builder.next = max(builder.next, idx_new + 1)
        out[builder.map[key]] = float(ntv["value"])
    return out


def _note_declared_dim(shard_dims: Dict[str, int], shard: str, tokens) -> None:
    for t in tokens:
        if t.startswith("dim="):
            shard_dims[shard] = max(shard_dims.get(shard, 0), int(t[4:]))


def load_game_model(
    models_dir: str,
    index_maps: Optional[Dict[str, IndexMap]] = None,
    device: DeviceLike = DEFAULT_DEVICE,
) -> Tuple[GameModel, Dict[str, IndexMap]]:
    """Load a GAME model directory onto ``device`` → (GameModel, per-shard
    index maps)."""
    dev = resolve_device(device)
    metadata = load_game_model_metadata(models_dir)
    task = TaskType[metadata["modelType"]]
    coord_configs = (metadata.get("configurations") or {}).get("coordinates") or {}
    fe_specs: Dict[str, tuple] = {}
    re_specs: Dict[str, tuple] = {}
    meta: Dict[str, CoordinateMeta] = {}
    builders: Dict[str, _MapBuilder] = {}
    shard_dims: Dict[str, int] = {}
    positional_shards = set()
    for shard, ent in (metadata.get("featureShards") or {}).items():
        shard_dims[shard] = int(ent.get("dim", 0))
        if ent.get("positional"):
            positional_shards.add(shard)
    dropped = [0]

    def map_for(shard: str):
        if index_maps is not None and shard in index_maps:
            return index_maps[shard], None
        return None, builders.setdefault(shard, _MapBuilder())

    def read_id_info(cdir: str):
        with open(os.path.join(cdir, ID_INFO)) as f:
            return f.read().split()

    fe_dir = os.path.join(models_dir, FIXED_EFFECT)
    if os.path.isdir(fe_dir):
        for cid in sorted(os.listdir(fe_dir)):
            cdir = os.path.join(fe_dir, cid)
            tokens = read_id_info(cdir)
            shard = tokens[0]
            _note_declared_dim(shard_dims, shard, tokens)
            positional = shard in positional_shards or "names=positional" in tokens
            imap, builder = map_for(shard)
            records = list(read_avro_dir(os.path.join(cdir, COEFFICIENTS)))
            if len(records) != 1:
                raise ValueError(f"{cid}: expected one fixed-effect GLM, got {len(records)}")
            rec = records[0]
            # drops are counted on means only: variances share the keys
            means = _record_sparse(rec, "means", imap, builder, positional, dropped)
            variances = _record_sparse(rec, "variances", imap, builder, positional)
            fe_specs[cid] = (means, variances or None)
            # the engine the coordinate was trained with, from the saved
            # coordinate config, so that scoring goes through it again
            engine = (coord_configs.get(cid) or {}).get("sparse_engine", "auto")
            meta[cid] = CoordinateMeta(feature_shard=shard, sparse_engine=engine)

    re_dir = os.path.join(models_dir, RANDOM_EFFECT)
    if os.path.isdir(re_dir):
        for cid in sorted(os.listdir(re_dir)):
            cdir = os.path.join(re_dir, cid)
            tokens = read_id_info(cdir)
            re_type, shard = tokens[:2]
            _note_declared_dim(shard_dims, shard, tokens)
            positional = shard in positional_shards or "names=positional" in tokens
            imap, builder = map_for(shard)
            entity_coefs: Dict[str, Dict[int, float]] = {}
            entity_vars: Dict[str, Dict[int, float]] = {}
            for rec in read_avro_dir(os.path.join(cdir, COEFFICIENTS)):
                eid = rec["modelId"]
                entity_coefs[eid] = _record_sparse(
                    rec, "means", imap, builder, positional, dropped
                )
                v = _record_sparse(rec, "variances", imap, builder, positional)
                if v:
                    entity_vars[eid] = v
            re_specs[cid] = (re_type, shard, entity_coefs, entity_vars)
            meta[cid] = CoordinateMeta(feature_shard=shard, random_effect_type=re_type)

    if not fe_specs and not re_specs:
        raise ValueError(f"no models could be loaded from: {models_dir}")
    if dropped[0]:
        logging.getLogger("photon_ml_tpu_torch").warning(
            "%d model coefficients were DROPPED because their features are "
            "absent from the provided index maps — scores will differ from "
            "the saved model (was the index built from different data?)",
            dropped[0],
        )

    # builders are complete only after every coordinate of the shard is read
    out_maps: Dict[str, IndexMap] = dict(index_maps or {})
    for shard, builder in builders.items():
        out_maps[shard] = DefaultIndexMap(builder.map)

    def shard_dim(shard: str) -> int:
        built = builders.get(shard)
        return max(len(out_maps[shard]), built.next if built else 0, shard_dims.get(shard, 0))

    def dense(values: Dict[int, float], dim: int) -> torch.Tensor:
        a = np.zeros(dim, dtype=np.float32)
        if values:
            a[np.fromiter(values.keys(), np.int64)] = np.fromiter(values.values(), np.float32)
        return torch.from_numpy(a).to(dev)

    models: Dict[str, object] = {}
    for cid, (means, variances) in fe_specs.items():
        dim = shard_dim(meta[cid].feature_shard)
        models[cid] = GeneralizedLinearModel(
            coefficients=Coefficients(
                means=dense(means, dim),
                variances=dense(variances, dim) if variances else None,
            ),
            task=task,
        )
    for cid, (re_type, shard, entity_coefs, entity_vars) in re_specs.items():
        models[cid] = RandomEffectModel.from_entity_coefficients(
            random_effect_type=re_type,
            task=task,
            entity_coefficients=entity_coefs,
            global_dim=shard_dim(shard),
            entity_variances=entity_vars or None,
            device=dev,
        )
    return GameModel(models=models, meta=meta, task=task), out_maps


# ------------------------------------------------------- matrix factorization

def save_matrix_factorization_model(model: MatrixFactorizationModel, output_dir: str) -> None:
    """LatentFactorAvro directories, one an effect type (reference
    :450-516)."""
    for effect, factors, index in (
        (model.row_effect_type, model.row_factors, model.row_index),
        (model.col_effect_type, model.col_factors, model.col_index),
    ):
        edir = os.path.join(output_dir, effect)
        os.makedirs(edir, exist_ok=True)
        write_avro_file(
            os.path.join(edir, "part-00000.avro"),
            schemas.latent_factor_schema(),
            (
                {"effectId": str(eid), "latentFactor": [float(v) for v in factors[index[eid]]]}
                for eid in sorted(index, key=index.get)
            ),
        )


def load_matrix_factorization_model(
    input_dir: str, row_effect_type: str, col_effect_type: str
) -> MatrixFactorizationModel:
    def load(effect: str):
        recs = list(read_avro_dir(os.path.join(input_dir, effect)))
        index = {r["effectId"]: i for i, r in enumerate(recs)}
        return np.array([r["latentFactor"] for r in recs], dtype=np.float32), index

    row_factors, row_index = load(row_effect_type)
    col_factors, col_index = load(col_effect_type)
    return MatrixFactorizationModel(
        row_effect_type=row_effect_type,
        col_effect_type=col_effect_type,
        row_factors=row_factors,
        col_factors=col_factors,
        row_index=row_index,
        col_index=col_index,
    )

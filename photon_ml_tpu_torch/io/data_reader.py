"""Avro training data → GameData (feature bags merged into shards).

Copy of ``photon_ml_tpu/io/data_reader.py`` on its pure-Python decode path
(the native columnar decoder is not ported yet).

Reference parity: data/avro/AvroDataReader.scala:53 — readMerged(paths,
featureShardConfigurations) merges one or more "feature bag" array fields
of each record into a single sparse vector per feature shard, building or
reusing name→index maps per shard; GameConverters.scala:29 extracts
response/offset/weight/uid plus id tags (top-level field first, then
metadataMap — reference GameConverters.getValueFromRow).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from photon_ml_tpu_torch.data.game_data import FeatureShard, GameData
from photon_ml_tpu_torch.indexmap import (
    INTERCEPT_KEY,
    DefaultIndexMap,
    IndexMap,
    feature_key,
)
from photon_ml_tpu_torch.io.avro import read_avro_dir


def write_training_examples(
    path: str,
    records: Iterable[dict],
) -> int:
    """Write TrainingExampleAvro records (each a dict with label, features=
    [(name, term, value)...], optional uid/weight/offset/metadataMap and
    extra feature-bag fields). The inverse of this module's reader; also the
    equivalent of dev-scripts/libsvm_text_to_trainingexample_avro.py."""
    from photon_ml_tpu_torch.io.avro import write_avro_file
    from photon_ml_tpu_torch.io import schemas as _schemas

    extra_bags: List[str] = []
    materialized = []
    for rec in records:
        out = dict(rec)
        for bag in list(out):
            if bag in ("uid", "label", "metadataMap", "weight", "offset"):
                continue
            val = out[bag]
            if isinstance(val, (list, tuple)):
                out[bag] = [
                    {"name": n, "term": t, "value": float(v)} for n, t, v in val
                ]
                if bag != "features" and bag not in extra_bags:
                    extra_bags.append(bag)
        out.setdefault("features", [])
        materialized.append(out)

    schema = dict(_schemas.TRAINING_EXAMPLE)
    if extra_bags:
        schema = dict(schema)
        schema["fields"] = list(schema["fields"]) + [
            {
                "name": bag,
                "type": {"type": "array", "items": "FeatureAvro"},
                "default": [],
            }
            for bag in extra_bags
        ]
    return write_avro_file(path, schema, materialized)


@dataclasses.dataclass(frozen=True)
class FeatureShardConfiguration:
    """Which record fields (feature bags) make up one shard, and whether the
    shard gets an intercept column (reference
    FeatureShardConfiguration in GameTrainingParams)."""

    feature_bags: Sequence[str]
    add_intercept: bool = True


def _record_features(record: dict, bags: Sequence[str]):
    for bag in bags:
        arr = record.get(bag)
        if not arr:
            continue
        for f in arr:
            yield feature_key(f["name"], f["term"]), float(f["value"])


def build_index_maps(
    paths: Sequence[str] | str,
    shard_configs: Dict[str, FeatureShardConfiguration],
) -> Dict[str, IndexMap]:
    """Scan pass: distinct feature keys per shard → dense indices
    (reference 'default index map' path, GameDriver.scala:46-85)."""
    if isinstance(paths, str):
        paths = [paths]
    keys: Dict[str, dict] = {sid: {} for sid in shard_configs}
    for path in paths:
        for record in read_avro_dir(path):
            for sid, cfg in shard_configs.items():
                bucket = keys[sid]
                for key, _ in _record_features(record, cfg.feature_bags):
                    if key not in bucket:
                        bucket[key] = len(bucket)
    out: Dict[str, IndexMap] = {}
    for sid, cfg in shard_configs.items():
        bucket = keys[sid]
        if cfg.add_intercept and INTERCEPT_KEY not in bucket:
            bucket[INTERCEPT_KEY] = len(bucket)
        out[sid] = DefaultIndexMap(bucket)
    return out


def read_game_data(
    paths: Sequence[str] | str,
    shard_configs: Dict[str, FeatureShardConfiguration],
    index_maps: Optional[Dict[str, IndexMap]] = None,
    id_tags: Sequence[str] = (),
    response_field: str = "label",
    offset_field: str = "offset",
    weight_field: str = "weight",
    uid_field: str = "uid",
    is_response_required: bool = True,
) -> tuple[GameData, Dict[str, IndexMap], List[Optional[str]]]:
    """Read Avro dirs/files into a GameData. Returns (data, index_maps, uids).

    Unmapped features (absent from a provided index map) are dropped, like
    the reference's scoring path over a fixed training index.
    """
    if isinstance(paths, str):
        paths = [paths]

    if index_maps is None:
        index_maps = build_index_maps(paths, shard_configs)

    labels: List[float] = []
    offsets: List[float] = []
    weights: List[float] = []
    uids: List[Optional[str]] = []
    tag_values: Dict[str, List[str]] = {t: [] for t in id_tags}
    coo: Dict[str, tuple] = {
        sid: ([], [], []) for sid in shard_configs
    }  # rows, cols, vals

    row = 0
    for path in paths:
        for record in read_avro_dir(path):
            label = record.get(response_field)
            if label is None:
                if is_response_required:
                    raise ValueError(f"record {row} has no '{response_field}'")
                label = np.nan
            labels.append(float(label))
            off = record.get(offset_field)
            offsets.append(0.0 if off is None else float(off))
            wt = record.get(weight_field)  # explicit 0.0 weight is preserved
            weights.append(1.0 if wt is None else float(wt))
            uids.append(record.get(uid_field))
            meta = record.get("metadataMap") or {}
            for tag in id_tags:
                v = record.get(tag)
                if v is None:  # null top-level field falls back to metadataMap
                    v = meta.get(tag)
                if v is None:
                    raise ValueError(f"record {row} missing id tag '{tag}'")
                tag_values[tag].append(str(v))
            for sid, cfg in shard_configs.items():
                imap = index_maps[sid]
                rows, cols, vals = coo[sid]
                for key, value in _record_features(record, cfg.feature_bags):
                    idx = imap.get_index(key)
                    if idx >= 0:
                        rows.append(row)
                        cols.append(idx)
                        vals.append(value)
                if cfg.add_intercept:
                    idx = imap.get_index(INTERCEPT_KEY)
                    if idx >= 0:
                        rows.append(row)
                        cols.append(idx)
                        vals.append(1.0)
            row += 1

    shards = {
        sid: FeatureShard(
            rows=np.asarray(rows, dtype=np.int64),
            cols=np.asarray(cols, dtype=np.int64),
            vals=np.asarray(vals, dtype=np.float32),
            dim=len(index_maps[sid]),
        )
        for sid, (rows, cols, vals) in coo.items()
    }
    data = GameData(
        labels=np.asarray(labels, dtype=np.float32),
        feature_shards=shards,
        id_tags={t: np.asarray(v) for t, v in tag_values.items()},
        offsets=np.asarray(offsets, dtype=np.float32),
        weights=np.asarray(weights, dtype=np.float32),
    )
    return data, index_maps, uids

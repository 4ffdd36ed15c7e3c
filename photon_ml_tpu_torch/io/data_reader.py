"""Avro training data → GameData (feature bags merged into shards).

Copy of ``photon_ml_tpu/io/data_reader.py``. Reads take the native
columnar path (``io/native_reader.py``, ``native/avrodecode.cpp``) by
default, as in the JAX package, and fall back to the record-at-a-time
Python codec only where the reference does: a schema shape or codec the
field program cannot express. Both paths number feature keys as the JAX
package's matching path does, so the two packages build equal index maps
and COO orders from the same files.

Reference parity: data/avro/AvroDataReader.scala:53 — readMerged(paths,
featureShardConfigurations) merges one or more "feature bag" array fields
of each record into a single sparse vector per feature shard, building or
reusing name→index maps per shard; GameConverters.scala:29 extracts
response/offset/weight/uid plus id tags (top-level field first, then
metadataMap — reference GameConverters.getValueFromRow).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from photon_ml_tpu_torch.data.game_data import FeatureShard, GameData
from photon_ml_tpu_torch.indexmap import (
    INTERCEPT_KEY,
    DefaultIndexMap,
    IndexMap,
    feature_key,
)
from photon_ml_tpu_torch.io import native_reader as nr
from photon_ml_tpu_torch.io.avro import (
    MAGIC,
    AvroSchema,
    _decode,
    _Reader,
    list_part_files,
    read_avro_dir,
)

logger = logging.getLogger("photon_ml_tpu_torch")


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
    native = _build_index_maps_native(paths, shard_configs)
    if native is not None:
        return native
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

    native = _read_game_data_native(
        paths, shard_configs, index_maps, id_tags,
        response_field, offset_field, weight_field, uid_field,
        is_response_required,
    )
    if native is not None:
        return native

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


def list_data_files(paths: Sequence[str] | str) -> List[str]:
    """Part files of one or more dataset dirs/files, in read order — the
    file-granular view `read_game_data` concatenates over."""
    if isinstance(paths, str):
        paths = [paths]
    return _part_files(paths)


def file_row_counts(paths: Sequence[str] | str) -> List[tuple]:
    """``(path, row_count)`` per part file via a container framing scan —
    no record decode, no decompression. Streaming block planners use this
    to lay out fixed-size example blocks across file boundaries without
    materializing the dataset."""
    return [
        (path, int(sum(nr.container_block_counts(path))))
        for path in list_data_files(paths)
    ]


def iter_game_data(
    paths: Sequence[str] | str,
    shard_configs: Dict[str, FeatureShardConfiguration],
    index_maps: Dict[str, IndexMap],
    id_tags: Sequence[str] = (),
    response_field: str = "label",
    offset_field: str = "offset",
    weight_field: str = "weight",
    uid_field: str = "uid",
    is_response_required: bool = True,
):
    """File-granular variant of :func:`read_game_data`: yields
    ``(path, GameData, uids)`` one part file at a time instead of
    concatenating the whole dataset.

    ``index_maps`` must be prebuilt (e.g. :func:`build_index_maps` or a
    loaded off-heap map): every yielded piece then shares one stable column
    space, so downstream block shapes are identical across files and
    nothing retraces. Peak memory is one decoded file, not the dataset.
    """
    if index_maps is None:
        raise ValueError(
            "iter_game_data requires prebuilt index_maps; build them once "
            "with build_index_maps() so file pieces share a stable index"
        )
    for path in list_data_files(paths):
        data, _, uids = read_game_data(
            [path],
            shard_configs,
            index_maps=index_maps,
            id_tags=id_tags,
            response_field=response_field,
            offset_field=offset_field,
            weight_field=weight_field,
            uid_field=uid_field,
            is_response_required=is_response_required,
        )
        yield path, data, uids


def _part_files(paths: Sequence[str]) -> List[str]:
    files: List[str] = []
    for path in paths:
        files.extend(list_part_files(path))
    return files


def _decode_columnar_files(
    files: Sequence[str],
    numeric_fields: Sequence[str],
    string_fields: Sequence[str],
    bags: Sequence[str],
    tags: Sequence[str],
):
    """Decode every part file through the native path with one file read
    each; None -> caller falls back to the Python codec. Files decode on a
    thread each (up to the CPU count): the native decode releases the
    interpreter lock for the whole file."""

    def decode(path):
        with open(path, "rb") as f:
            raw = f.read()
        r = _Reader(raw)
        if r.read(4) != MAGIC:
            return None
        meta = _decode(r, {"type": "map", "values": "bytes"})
        root = AvroSchema(meta["avro.schema"].decode("utf-8")).root
        plan = nr.compile_program(
            root,
            numeric_fields=numeric_fields,
            string_fields=string_fields,
            bags=bags,
            tags=tags,
        )
        if plan is None:
            logger.info("%s: schema outside the native decoder's field program; "
                        "python codec", path)
            return None
        cf = nr.read_columnar_file(path, plan, data=raw)
        return None if cf is None else (plan, cf)

    if len(files) > 1:
        with ThreadPoolExecutor(min(len(files), os.cpu_count() or 1)) as pool:
            columnar = list(pool.map(decode, files))
    else:
        columnar = [decode(path) for path in files]
    return None if any(c is None for c in columnar) else columnar


def _all_bags_of(shard_configs: Dict[str, FeatureShardConfiguration]) -> List[str]:
    bags: List[str] = []
    for cfg in shard_configs.values():
        for bag in cfg.feature_bags:
            if bag not in bags:
                bags.append(bag)
    return bags


def _concat_bag_streams(columnar, feature_bags: Sequence[str]):
    """Concatenate one shard's bag streams over all files: global row ids,
    values, and key (offset, len) into the joined arena."""
    recs, vals, koffs, klens, arenas = [], [], [], [], []
    arena_base = 0
    row_base = 0
    for _, cf in columnar:
        for bag in feature_bags:
            rec, val, koff, klen = cf.bags[bag]
            recs.append(rec + row_base)
            vals.append(val)
            koffs.append(koff + arena_base)
            klens.append(klen)
        arenas.append(cf.key_arena)
        arena_base += len(cf.key_arena)
        row_base += cf.n_rows
    rows = np.concatenate(recs) if recs else np.zeros(0, np.int64)
    values = np.concatenate(vals) if vals else np.zeros(0, np.float32)
    key_off = np.concatenate(koffs) if koffs else np.zeros(0, np.int64)
    key_len = np.concatenate(klens) if klens else np.zeros(0, np.int32)
    return rows, values, key_off, key_len, b"".join(arenas)


def _read_game_data_native(
    paths: Sequence[str],
    shard_configs: Dict[str, FeatureShardConfiguration],
    index_maps: Optional[Dict[str, IndexMap]],
    id_tags: Sequence[str],
    response_field: str,
    offset_field: str,
    weight_field: str,
    uid_field: str,
    is_response_required: bool,
):
    """Columnar fast path through native/avrodecode.cpp; None -> caller
    falls back to the record-at-a-time Python codec (unsupported schema
    shape or codec). One decode pass builds both
    the index maps and the COO shards (the Python path scans twice).

    Feature-index assignment order differs from the Python path (keys are
    numbered per bag stream, not per record) — ids are run-internal either
    way; persisted artifacts are name-keyed.
    """
    files = _part_files(paths)
    if not files:
        return None
    columnar = _decode_columnar_files(
        files,
        numeric_fields=[response_field, offset_field, weight_field],
        string_fields=[uid_field, *id_tags],
        bags=_all_bags_of(shard_configs),
        tags=id_tags,
    )
    if columnar is None:
        return None

    n = sum(cf.n_rows for _, cf in columnar)

    def num_col(field, default):
        out = np.full(n, default, dtype=np.float32)
        present = np.zeros(n, dtype=bool)
        at = 0
        for plan, cf in columnar:
            m = cf.n_rows
            if field in plan.num_fields:
                out[at : at + m] = np.where(
                    cf.num_present[field], cf.num[field], default
                )
                present[at : at + m] = cf.num_present[field]
            at += m
        return out, present

    labels, labels_present = num_col(response_field, np.nan)
    if is_response_required and not labels_present.all():
        row = int(np.flatnonzero(~labels_present)[0])
        raise ValueError(f"record {row} has no '{response_field}'")
    offsets, _ = num_col(offset_field, 0.0)
    weights, _ = num_col(weight_field, 1.0)

    def str_col(field, which="strs"):
        out: List[Optional[str]] = []
        for _, cf in columnar:
            cols = cf.strs if which == "strs" else cf.tag_strs
            if field in cols:
                out.extend(nr.decode_strings(cols[field]))
            else:
                out.extend([None] * cf.n_rows)
        return out

    uids = str_col(uid_field)
    tag_values: Dict[str, np.ndarray] = {}
    for tag in id_tags:
        # top-level field wins over the metadataMap entry (reference
        # GameConverters.getValueFromRow)
        top = str_col(tag)
        from_map = str_col(tag, which="tags")
        vals = [t if t is not None else m for t, m in zip(top, from_map)]
        missing = [i for i, v in enumerate(vals) if v is None]
        if missing:
            raise ValueError(f"record {missing[0]} missing id tag '{tag}'")
        tag_values[tag] = np.asarray(vals)

    shards: Dict[str, FeatureShard] = {}
    out_maps: Dict[str, IndexMap] = {}
    for sid, cfg in shard_configs.items():
        rows, values, key_off, key_len, arena = _concat_bag_streams(
            columnar, cfg.feature_bags
        )
        if index_maps is not None:
            imap = index_maps[sid]
            if hasattr(imap, "get_indices_packed"):
                # an off-heap map looks every entry's key up natively in
                # the arena: no dedup, no Python string per key
                cols = imap.get_indices_packed(arena, key_off, key_len)
            else:
                ids, uniques = nr.dedup_keys(arena, key_off, key_len)
                lut = np.asarray(imap.get_indices(uniques), dtype=np.int64)
                cols = lut[ids] if len(ids) else np.zeros(0, np.int64)
            keep = cols >= 0  # unmapped features drop (scoring semantics)
            rows, cols, values = rows[keep], cols[keep], values[keep]
        else:
            ids, uniques = nr.dedup_keys(arena, key_off, key_len)
            key_to_id = {k: i for i, k in enumerate(uniques)}
            if cfg.add_intercept and INTERCEPT_KEY not in key_to_id:
                key_to_id[INTERCEPT_KEY] = len(key_to_id)
            imap = DefaultIndexMap(key_to_id)
            cols = ids
        if cfg.add_intercept:
            icpt = imap.get_index(INTERCEPT_KEY)
            if icpt >= 0:
                rows = np.concatenate([rows, np.arange(n, dtype=np.int64)])
                cols = np.concatenate(
                    [cols, np.full(n, icpt, dtype=np.int64)]
                )
                values = np.concatenate(
                    [values, np.ones(n, dtype=np.float32)]
                )
        out_maps[sid] = imap
        shards[sid] = FeatureShard(
            rows=rows.astype(np.int64),
            cols=cols.astype(np.int64),
            vals=values.astype(np.float32),
            dim=len(imap),
        )

    data = GameData(
        labels=labels,
        feature_shards=shards,
        id_tags=tag_values,
        offsets=offsets,
        weights=weights,
    )
    return data, out_maps, uids


def feature_keys(
    paths: Sequence[str] | str,
    shard_configs: Dict[str, FeatureShardConfiguration],
) -> Dict[str, tuple]:
    """The feature keys of each shard's bags, repeats included, as packed
    UTF-8 ``(blob, offsets, lengths)`` (intercepts not added): the key scan
    of ``build_index``, through the native columnar decode where the files
    allow it, else record by record."""
    if isinstance(paths, str):
        paths = [paths]
    files = _part_files(paths)
    columnar = _decode_columnar_files(
        files, [], [], _all_bags_of(shard_configs), []
    ) if files else None
    if columnar is not None:
        out = {}
        for sid, cfg in shard_configs.items():
            _, _, key_off, key_len, arena = _concat_bag_streams(columnar, cfg.feature_bags)
            out[sid] = (arena, key_off, key_len)
        return out
    keys: Dict[str, set] = {sid: set() for sid in shard_configs}
    for path in paths:
        for record in read_avro_dir(path):
            for sid, cfg in shard_configs.items():
                keys[sid].update(k for k, _ in _record_features(record, cfg.feature_bags))
    out = {}
    for sid, ks in keys.items():
        encoded = [k.encode("utf-8") for k in ks]
        lens = np.fromiter(map(len, encoded), dtype=np.int64, count=len(encoded))
        out[sid] = (b"".join(encoded), np.cumsum(lens) - lens, lens)
    return out


def _build_index_maps_native(
    paths: Sequence[str],
    shard_configs: Dict[str, FeatureShardConfiguration],
) -> Optional[Dict[str, IndexMap]]:
    """Columnar scan for the standalone index-build (one native decode of
    the bag streams + native key dedup); None -> Python fallback.

    Key-id assignment order differs from the Python scan (per bag stream,
    not per record), as in the JAX package.
    """
    files = _part_files(paths)
    if not files:
        return None
    columnar = _decode_columnar_files(
        files, [], [], _all_bags_of(shard_configs), []
    )
    if columnar is None:
        return None
    out: Dict[str, IndexMap] = {}
    for sid, cfg in shard_configs.items():
        _, _, key_off, key_len, arena = _concat_bag_streams(columnar, cfg.feature_bags)
        _, uniques = nr.dedup_keys(arena, key_off, key_len)
        key_to_id = {k: i for i, k in enumerate(uniques)}
        if cfg.add_intercept and INTERCEPT_KEY not in key_to_id:
            key_to_id[INTERCEPT_KEY] = len(key_to_id)
        out[sid] = DefaultIndexMap(key_to_id)
    return out

"""Serving artifact: a trained GAME model packed for the online score path.

Port of ``photon_ml_tpu/serving/artifact.py``; the files it writes are
byte-equal to the JAX package's for the same model, and each package loads
the other's artifacts.

The training-side ``GameModel`` stores random effects as padded per-bucket
blocks in per-entity *local* feature space — the right layout for coordinate
descent, the wrong one for a per-request gather. Packing materializes, per
coordinate:

- fixed effect: one dense float32 coefficient vector ``[dim]``;
- random effect: one contiguous float32 table ``[n_entities, dim]`` of
  global-space coefficient rows (sorted by entity id), plus an
  entity-id → row-index map persisted as a PHIX off-heap store
  (``indexmap/offheap``) so million-entity maps never live on the heap.

The artifact directory reuses the ``io/model_io`` metadata file
(``model-metadata.json``; task, model name, configurations) with a
``serving`` section describing each packed coordinate:

    <dir>/model-metadata.json
    <dir>/fixed-effect/<cid>.npy
    <dir>/random-effect/<cid>/table.npy
    <dir>/random-effect/<cid>/entity-index/{metadata.json,partition-0.bin}
    <dir>/feature-index/<shard>/{metadata.json,partition-0.bin}

``feature-index`` stores are forward-lookup (name → index) maps used to
featurize raw records at serve time; they preserve the model's original
indices, so reverse lookup is only meaningful when those are dense.

Packing runs on the host: the model's tensors are copied off the device
once, and the packed tables are numpy arrays (the host backing store of the
device tables the scorers build).
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from photon_ml_tpu_torch.indexmap import DefaultIndexMap, IndexMap
from photon_ml_tpu_torch.indexmap.offheap import (
    METADATA_FILE as _PHIX_METADATA_FILE,
    OffHeapIndexMap,
    PARTITION_FILE as _PHIX_PARTITION_FILE,
    build_partition,
)
from photon_ml_tpu_torch.io.model_io import (
    load_game_model_metadata,
    save_game_model_metadata,
)
from photon_ml_tpu_torch.models.game import GameModel
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.models.random_effect import RandomEffectModel
from photon_ml_tpu_torch.projector import ProjectorType
from photon_ml_tpu_torch.types import TaskType

FIXED_EFFECT_DIR = "fixed-effect"
RANDOM_EFFECT_DIR = "random-effect"
ENTITY_INDEX_DIR = "entity-index"
FEATURE_INDEX_DIR = "feature-index"
TABLE_FILE = "table.npy"
SERVING_FORMAT_VERSION = 1
# Serve-side tuning sidecar. Kept OUTSIDE model-metadata.json so a running
# --auto-tune can persist a winner without rewriting the model manifest.
TUNED_CONFIG_FILE = "tuned-config.json"


@dataclasses.dataclass
class ServingTable:
    """One packed coordinate: FE vector or RE (entities × dim) matrix."""

    feature_shard: str
    random_effect_type: Optional[str]
    weights: np.ndarray  # FE: [dim] float32; RE: [n_entities, dim] float32
    entity_index: Optional[IndexMap] = None  # RE only: entity id -> table row

    @property
    def is_random_effect(self) -> bool:
        return self.random_effect_type is not None

    @property
    def dim(self) -> int:
        return int(self.weights.shape[-1])

    @property
    def n_entities(self) -> int:
        return int(self.weights.shape[0]) if self.is_random_effect else 0


@dataclasses.dataclass
class ServingArtifact:
    task: TaskType
    tables: Dict[str, ServingTable]  # coordinate id -> packed table
    model_name: str = "photon-ml-tpu"
    # the training model's configurations blob (feature shard -> bags etc.)
    # rides along so the serve CLI can read raw records the same way the
    # score CLI does
    configurations: Dict[str, object] = dataclasses.field(default_factory=dict)
    feature_index: Dict[str, IndexMap] = dataclasses.field(default_factory=dict)
    # winning knob values from --auto-tune (knob name -> value); None when
    # the artifact has never been tuned. Persisted in the metadata's
    # "tuned_config" section at pack time and overridable post-hoc by the
    # tuned-config.json sidecar (see save_tuned_config).
    tuned_config: Optional[Dict[str, object]] = None

    def entity_row(self, cid: str, entity_id: str) -> int:
        """Table row of an entity in one RE coordinate; -1 when cold/unknown
        (the caller scores FE-only for that coordinate — RE prior mean 0)."""
        table = self.tables[cid]
        if table.entity_index is None:
            raise ValueError(f"coordinate {cid!r} is not a random effect")
        return table.entity_index.get_index(str(entity_id))

    def shard_dims(self) -> Dict[str, int]:
        dims: Dict[str, int] = {}
        for t in self.tables.values():
            dims[t.feature_shard] = max(dims.get(t.feature_shard, 0), t.dim)
        return dims

    def random_effect_types(self) -> Tuple[str, ...]:
        return tuple(
            sorted(
                {
                    t.random_effect_type
                    for t in self.tables.values()
                    if t.random_effect_type
                }
            )
        )


def pack_game_model(
    model: GameModel,
    index_maps: Optional[Dict[str, IndexMap]] = None,
    model_name: str = "photon-ml-tpu",
    configurations: Optional[dict] = None,
) -> ServingArtifact:
    """Pack a trained GameModel into the serving layout.

    Random-effect rows are materialized in *global* shard space (one dense
    row per entity, sorted by entity id); a factored RE model is expanded
    through its projection matrix (``w = latent · Bᵀ``) so the packed table
    scores identically to the training model. Sharded tensors are gathered
    with ``fetch_global`` (a collective across processes); packing itself
    is host-side.
    """
    from photon_ml_tpu_torch.algorithm.factored_random_effect import (
        FactoredRandomEffectModel,
    )
    from photon_ml_tpu_torch.parallel.mesh import fetch_global

    tables: Dict[str, ServingTable] = {}
    for cid, sub in model.models.items():
        meta = model.meta[cid]
        if isinstance(sub, GeneralizedLinearModel):
            w = np.asarray(fetch_global(sub.coefficients.means), dtype=np.float32)
            tables[cid] = ServingTable(
                feature_shard=meta.feature_shard,
                random_effect_type=None,
                weights=w,
            )
        elif isinstance(sub, RandomEffectModel):
            if sub.projector_type is ProjectorType.RANDOM:
                tables[cid] = _pack_random_effect(
                    meta.feature_shard, sub.random_effect_type,
                    sub.items(), sub.global_dim,
                )
            else:
                tables[cid] = _pack_index_mapped(
                    meta.feature_shard, sub, fetch_global
                )
        elif isinstance(sub, FactoredRandomEffectModel):
            B = np.asarray(fetch_global(sub.projection_matrix))  # [d, k]
            latent = sub.latent
            blocks = []
            for b, ids in enumerate(latent.entity_ids):
                w_b = np.asarray(fetch_global(latent.coefficients[b]))
                blocks.append((ids, (w_b @ B.T)[: len(ids)]))  # [Eb, d]
            tables[cid] = _pack_dense_rows(
                meta.feature_shard, latent.random_effect_type, blocks,
                B.shape[0],
            )
        else:
            raise ValueError(
                f"cannot pack sub-model type {type(sub).__name__} for {cid}"
            )
    configurations = dict(configurations or {})
    # a train-side --auto-tune winner rides along in the model metadata;
    # lift it into the artifact field so direct --model-dir serving boots
    # tuned exactly like artifact-dir serving
    tuned = configurations.pop("tuned_config", None)
    return ServingArtifact(
        task=model.task,
        tables=tables,
        model_name=model_name,
        configurations=configurations,
        feature_index=dict(index_maps or {}),
        tuned_config=tuned,
    )


def _entity_table(
    feature_shard: str, re_type: str, ids, table: np.ndarray
) -> ServingTable:
    return ServingTable(
        feature_shard=feature_shard,
        random_effect_type=re_type,
        weights=table,
        entity_index=DefaultIndexMap({eid: row for row, eid in enumerate(ids)}),
    )


def _pack_random_effect(
    feature_shard: str,
    re_type: str,
    items: Iterable[Tuple[str, Dict[int, float]]],
    global_dim: int,
) -> ServingTable:
    """Rows from per-entity sparse coefficients (a random projection's
    back-projected rows)."""
    sparse = {str(eid): coefs for eid, coefs in items}
    ids = sorted(sparse)
    table = np.zeros((len(ids), global_dim), dtype=np.float32)
    for row, eid in enumerate(ids):
        for i, v in sparse[eid].items():
            table[row, i] = v
    return _entity_table(feature_shard, re_type, ids, table)


def _sorted_rows(feature_shard: str, blocks_ids) -> Tuple[list, list]:
    """Sorted entity ids and, per block, each id's table row."""
    all_ids = [str(eid) for ids in blocks_ids for eid in ids]
    ids = sorted(set(all_ids))
    if len(ids) != len(all_ids):
        raise ValueError(f"random effect on {feature_shard!r} names an entity twice")
    row_of = {eid: row for row, eid in enumerate(ids)}
    return ids, [
        np.fromiter((row_of[str(e)] for e in blk), dtype=np.int64, count=len(blk))
        for blk in blocks_ids
    ]


def _pack_index_mapped(feature_shard: str, sub: RandomEffectModel, fetch) -> ServingTable:
    """An INDEX_MAP / IDENTITY random effect scattered straight into its
    table: the bytes of the per-entity dict path (``_pack_random_effect``
    over ``sub.items()``), without holding every entity's coefficients as
    Python floats."""
    ids, rows_of = _sorted_rows(feature_shard, sub.entity_ids)
    table = np.zeros((len(ids), sub.global_dim), dtype=np.float32)
    for b, blk in enumerate(sub.entity_ids):
        n = len(blk)
        w = np.asarray(fetch(sub.coefficients[b]))[:n]
        idx = np.asarray(fetch(sub.proj_indices[b]))[:n]
        ok = np.asarray(fetch(sub.proj_valid[b]))[:n].astype(bool)
        e, j = np.nonzero(ok)
        table[rows_of[b][e], idx[e, j]] = w[e, j]
    return _entity_table(feature_shard, sub.random_effect_type, ids, table)


def _pack_dense_rows(feature_shard: str, re_type: str, blocks, global_dim: int) -> ServingTable:
    """Dense per-entity rows (a factored coordinate's ``latent · Bᵀ``) into
    the table; only nonzero entries are written, so a negative zero packs
    as zero, as the reference's per-entity dict of nonzeros does."""
    ids, rows_of = _sorted_rows(feature_shard, [ids for ids, _ in blocks])
    table = np.zeros((len(ids), global_dim), dtype=np.float32)
    for (_, eff), rows in zip(blocks, rows_of):
        eff = np.asarray(eff, dtype=np.float32)
        table[rows] = np.where(eff != 0, eff, np.float32(0))
    return _entity_table(feature_shard, re_type, ids, table)


def _index_map_items(imap: IndexMap) -> Iterable[Tuple[str, int]]:
    if isinstance(imap, DefaultIndexMap):
        return list(imap.items())
    # generic path: contiguous reverse scan (OffHeapIndexMap etc.)
    out = []
    for i in range(len(imap)):
        name = imap.get_feature_name(i)
        if name is not None:
            out.append((name, i))
    return out


def _write_phix_map(items: Iterable[Tuple[str, int]], out_dir: str) -> None:
    """Persist a name→index map as a single-partition PHIX store, PRESERVING
    the given indices (unlike ``build_offheap_index_map``, which reassigns
    them — the artifact's indices must keep matching the packed weights)."""
    items = sorted(items)
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    keys = [name.encode("utf-8") for name, _ in items]
    indices = np.asarray([i for _, i in items], dtype=np.uint32)
    build_partition(str(out / _PHIX_PARTITION_FILE.format(i=0)), keys, indices)
    (out / _PHIX_METADATA_FILE).write_text(
        json.dumps(
            {
                "format": "PHIX",
                "version": 1,
                "num_partitions": 1,
                "num_entries": len(keys),
                "partition_offsets": [0],
            }
        )
    )


def save_artifact(artifact: ServingArtifact, output_dir: str) -> None:
    """Atomically write the artifact directory (layout in the module
    docstring): build in a tmp sibling dir, fsync the metadata file, rename
    over the target. A crash at any point leaves either the previous
    artifact or the new one, never a half-written directory that
    ``load_artifact`` would open."""
    import shutil
    import tempfile

    from photon_ml_tpu_torch.io.model_io import METADATA_FILE

    parent = os.path.dirname(os.path.abspath(output_dir)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".artifact-tmp-", dir=parent)
    try:
        _write_artifact_contents(artifact, tmp)
        # the metadata file is written LAST and names every other file;
        # fsync it so the rename below never exposes an artifact whose
        # manifest is still in the page cache only
        fd = os.open(os.path.join(tmp, METADATA_FILE), os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        old = None
        if os.path.isdir(output_dir):
            old = tempfile.mkdtemp(prefix=".artifact-old-", dir=parent)
            os.rmdir(old)
            os.replace(output_dir, old)
        os.replace(tmp, output_dir)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _write_artifact_contents(artifact: ServingArtifact, output_dir: str) -> None:
    os.makedirs(output_dir, exist_ok=True)
    serving: Dict[str, object] = {
        "format_version": SERVING_FORMAT_VERSION,
        "coordinates": {},
    }
    for cid, table in artifact.tables.items():
        desc = {
            "kind": "random" if table.is_random_effect else "fixed",
            "feature_shard": table.feature_shard,
            "dim": table.dim,
        }
        if table.is_random_effect:
            desc["random_effect_type"] = table.random_effect_type
            desc["n_entities"] = table.n_entities
            cdir = os.path.join(output_dir, RANDOM_EFFECT_DIR, cid)
            os.makedirs(cdir, exist_ok=True)
            np.save(
                os.path.join(cdir, TABLE_FILE),
                np.asarray(table.weights, dtype=np.float32),
            )
            _write_phix_map(
                _index_map_items(table.entity_index),
                os.path.join(cdir, ENTITY_INDEX_DIR),
            )
        else:
            fdir = os.path.join(output_dir, FIXED_EFFECT_DIR)
            os.makedirs(fdir, exist_ok=True)
            np.save(
                os.path.join(fdir, f"{cid}.npy"),
                np.asarray(table.weights, dtype=np.float32),
            )
        serving["coordinates"][cid] = desc
    for shard, imap in artifact.feature_index.items():
        _write_phix_map(
            _index_map_items(imap),
            os.path.join(output_dir, FEATURE_INDEX_DIR, shard),
        )
    configurations = dict(artifact.configurations)
    configurations["serving"] = serving
    if artifact.tuned_config:
        configurations["tuned_config"] = dict(artifact.tuned_config)
    save_game_model_metadata(
        output_dir, artifact.task,
        model_name=artifact.model_name,
        configurations=configurations,
    )


def load_artifact(artifact_dir: str, mmap: bool = True) -> ServingArtifact:
    """Open an artifact directory.

    ``mmap=True`` memory-maps the RE coefficient tables (they are the
    host-side backing store behind the device tables, so the full tables
    need never be resident in host memory) and the PHIX entity stores
    (always mmap'd).
    """
    metadata = load_game_model_metadata(artifact_dir)
    task = TaskType[metadata["modelType"]]
    configurations = dict(metadata.get("configurations") or {})
    serving = configurations.pop("serving", None)
    if not serving:
        raise ValueError(
            f"{artifact_dir} has no 'serving' section in its metadata — "
            "not a serving artifact (export one with "
            "photon_ml_tpu_torch.serving.save_artifact)"
        )
    mmap_mode = "r" if mmap else None
    tables: Dict[str, ServingTable] = {}
    for cid, desc in serving["coordinates"].items():
        if desc["kind"] == "random":
            cdir = os.path.join(artifact_dir, RANDOM_EFFECT_DIR, cid)
            weights = np.load(os.path.join(cdir, TABLE_FILE), mmap_mode=mmap_mode)
            entity_index: IndexMap = OffHeapIndexMap(
                os.path.join(cdir, ENTITY_INDEX_DIR)
            )
            tables[cid] = ServingTable(
                feature_shard=desc["feature_shard"],
                random_effect_type=desc["random_effect_type"],
                weights=weights,
                entity_index=entity_index,
            )
        else:
            weights = np.load(
                os.path.join(artifact_dir, FIXED_EFFECT_DIR, f"{cid}.npy"),
                mmap_mode=mmap_mode,
            )
            tables[cid] = ServingTable(
                feature_shard=desc["feature_shard"],
                random_effect_type=None,
                weights=weights,
            )
    feature_index: Dict[str, IndexMap] = {}
    fdir = os.path.join(artifact_dir, FEATURE_INDEX_DIR)
    if os.path.isdir(fdir):
        for shard in sorted(os.listdir(fdir)):
            feature_index[shard] = OffHeapIndexMap(os.path.join(fdir, shard))
    # tuned config: sidecar (serve-side --auto-tune) overrides the metadata
    # section (train-side --auto-tune carried through the pack flow)
    tuned = configurations.pop("tuned_config", None)
    sidecar = load_tuned_config(artifact_dir)
    if sidecar is not None:
        tuned = sidecar
    return ServingArtifact(
        task=task,
        tables=tables,
        model_name=metadata.get("modelName", "game-model"),
        configurations=configurations,
        feature_index=feature_index,
        tuned_config=tuned,
    )


def save_tuned_config(
    artifact_dir: str,
    tuned_config: Dict[str, object],
    provenance: Optional[Dict[str, object]] = None,
) -> str:
    """Atomically persist an --auto-tune winner next to an artifact.

    Written as the ``tuned-config.json`` sidecar (tmp file + fsync +
    rename) so a live artifact directory is never rewritten and a reader
    never observes a half-written file."""
    import tempfile

    doc: Dict[str, object] = {"tuned_config": dict(tuned_config)}
    if provenance:
        doc["provenance"] = dict(provenance)
    target = os.path.join(artifact_dir, TUNED_CONFIG_FILE)
    fd, tmp = tempfile.mkstemp(
        prefix=".tuned-config-", suffix=".json", dir=artifact_dir
    )
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, target)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return target


def load_tuned_config(artifact_dir: str) -> Optional[Dict[str, object]]:
    """Read the tuned-config sidecar; None when the artifact is untuned."""
    path = os.path.join(artifact_dir, TUNED_CONFIG_FILE)
    if not os.path.exists(path):
        return None
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    tuned = doc.get("tuned_config")
    if not isinstance(tuned, dict):
        raise ValueError(f"{path}: missing 'tuned_config' object")
    return tuned

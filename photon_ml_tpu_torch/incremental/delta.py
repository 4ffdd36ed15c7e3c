"""Delta artifact: a versioned overlay holding only the RE rows (and FE
vectors) an incremental update changed, chained to its base artifact by
content fingerprint.

A nearline update touches a few thousand entity rows out of a
multi-million-row serving artifact; republishing the full artifact per
update would make publish latency (and artifact storage) scale with the
model instead of the event batch. A delta directory stores just the
overlay:

    <dir>/delta-manifest.json                  # chain + coordinate descriptors
    <dir>/random-effect/<cid>/rows.npy         # [n_touched, dim] float32
    <dir>/fixed-effect/<cid>.npy               # full replacement vector

``base_fingerprint`` is the content fingerprint (sha256 over every file) of
the artifact or delta this overlay applies on top of — deltas form a hash
chain, so applying one to the wrong base (or to a base with a missing
intermediate delta) fails loudly instead of serving a silently-wrong
model. ``compact`` folds a verified chain back into a full artifact, which
restarts the chain.

Port of ``photon_ml_tpu/incremental/delta.py``: host-side numpy, and the
directories it writes are byte-equal to the JAX package's for the same
numbers (same field order, float32 rows, entity ids sorted as strings, the
same manifest JSON), so a delta built by either package chains onto an
artifact packed by the other.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch.indexmap import IndexMap

DELTA_MANIFEST_FILE = "delta-manifest.json"
DELTA_FORMAT_VERSION = 1
DELTA_DIR_PREFIX = "delta-"
_ROWS_FILE = "rows.npy"


# Top-level files that never count toward an artifact's content identity.
# tuned-config.json is a serve-side sidecar (--auto-tune winner): writing it
# next to a live artifact must not orphan the delta chain anchored on the
# artifact's fingerprint.
FINGERPRINT_EXCLUDE = ("tuned-config.json",)


def fingerprint_dir(path: str, exclude: Tuple[str, ...] = FINGERPRINT_EXCLUDE) -> str:
    """Content fingerprint of a directory tree: sha256 over every file's
    relative path and bytes, in sorted path order. Any byte change — or a
    file added/removed — changes the fingerprint (except top-level names in
    ``exclude``, which are advisory sidecars, not model content)."""
    h = hashlib.sha256()
    files = []
    for root, _, names in os.walk(path):
        for name in names:
            full = os.path.join(root, name)
            rel = os.path.relpath(full, path)
            if rel in exclude:
                continue
            files.append((rel, full))
    for rel, full in sorted(files):
        h.update(rel.encode("utf-8"))
        h.update(b"\0")
        with open(full, "rb") as f:
            while True:
                chunk = f.read(1 << 20)
                if not chunk:
                    break
                h.update(chunk)
            h.update(b"\1")
    return h.hexdigest()[:16]


@dataclasses.dataclass
class DeltaArtifact:
    """In-memory overlay: per-coordinate touched RE rows + FE replacements.

    ``re_rows[cid] = (entity_ids, rows)`` with ``rows[i]`` the new
    global-space coefficient row of ``entity_ids[i]``; ids may be present in
    the base (in-place update) or new (appended). ``fingerprint`` is the
    content fingerprint of the delta's own directory — set by
    ``save_delta``/``load_delta``, None for an unsaved delta."""

    base_fingerprint: Optional[str]
    generation: int
    re_rows: Dict[str, Tuple[List[str], np.ndarray]]
    fe_updates: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    created_at_unix: float = 0.0
    fingerprint: Optional[str] = None

    @property
    def num_rows_updated(self) -> int:
        return sum(len(ids) for ids, _ in self.re_rows.values())

    def coordinates(self) -> Tuple[str, ...]:
        return tuple(sorted(set(self.re_rows) | set(self.fe_updates)))


def build_delta(
    re_updates: Dict[str, Dict[str, Dict[int, float]]],
    artifact,
    fe_updates: Optional[Dict[str, np.ndarray]] = None,
    base_fingerprint: Optional[str] = None,
    generation: int = 1,
    created_at_unix: float = 0.0,
) -> DeltaArtifact:
    """Densify an incremental trainer's sparse row updates against the base
    ``ServingArtifact``'s coordinate dims. ``re_updates[cid][entity_id]`` is
    a sparse global-space coefficient map (``RandomEffectModel.items()``
    format)."""
    re_rows: Dict[str, Tuple[List[str], np.ndarray]] = {}
    for cid, per_entity in re_updates.items():
        table = artifact.tables.get(cid)
        if table is None or not table.is_random_effect:
            raise ValueError(
                f"delta names coordinate {cid!r} which is not a random "
                "effect of the base artifact"
            )
        ids = sorted(str(e) for e in per_entity)
        rows = np.zeros((len(ids), table.dim), dtype=np.float32)
        for r, eid in enumerate(ids):
            for i, v in per_entity[eid].items():
                rows[r, int(i)] = v
        re_rows[cid] = (ids, rows)
    fe = {}
    for cid, w in (fe_updates or {}).items():
        table = artifact.tables.get(cid)
        if table is None or table.is_random_effect:
            raise ValueError(
                f"delta names coordinate {cid!r} which is not a fixed "
                "effect of the base artifact"
            )
        w = np.asarray(w, dtype=np.float32)
        if w.shape != (table.dim,):
            raise ValueError(
                f"fixed-effect update for {cid!r} has shape {w.shape}, "
                f"base artifact expects ({table.dim},)"
            )
        fe[cid] = w
    return DeltaArtifact(
        base_fingerprint=base_fingerprint,
        generation=int(generation),
        re_rows=re_rows,
        fe_updates=fe,
        created_at_unix=float(created_at_unix),
    )


def save_delta(delta: DeltaArtifact, output_dir: str) -> DeltaArtifact:
    """Atomically write a delta directory (tmp sibling + rename, same
    pattern as ``save_artifact``). Returns the delta with its content
    ``fingerprint`` filled in — that is what the NEXT delta chains to."""
    from photon_ml_tpu_torch.serving.artifact import (
        FIXED_EFFECT_DIR,
        RANDOM_EFFECT_DIR,
    )

    parent = os.path.dirname(os.path.abspath(output_dir)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".delta-tmp-", dir=parent)
    try:
        manifest: Dict[str, object] = {
            "format_version": DELTA_FORMAT_VERSION,
            "base_fingerprint": delta.base_fingerprint,
            "generation": delta.generation,
            "created_at_unix": delta.created_at_unix,
            "coordinates": {},
        }
        for cid, (ids, rows) in delta.re_rows.items():
            cdir = os.path.join(tmp, RANDOM_EFFECT_DIR, cid)
            os.makedirs(cdir)
            np.save(
                os.path.join(cdir, _ROWS_FILE),
                np.asarray(rows, dtype=np.float32),
            )
            manifest["coordinates"][cid] = {
                "kind": "random",
                "dim": int(rows.shape[1]),
                "entity_ids": list(ids),
            }
        for cid, w in delta.fe_updates.items():
            fdir = os.path.join(tmp, FIXED_EFFECT_DIR)
            os.makedirs(fdir, exist_ok=True)
            np.save(os.path.join(fdir, f"{cid}.npy"), w)
            manifest["coordinates"][cid] = {"kind": "fixed", "dim": int(w.shape[0])}
        mpath = os.path.join(tmp, DELTA_MANIFEST_FILE)
        with open(mpath, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        fingerprint = fingerprint_dir(tmp)
        old = None
        if os.path.isdir(output_dir):
            old = tempfile.mkdtemp(prefix=".delta-old-", dir=parent)
            os.rmdir(old)
            os.replace(output_dir, old)
        os.replace(tmp, output_dir)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return dataclasses.replace(delta, fingerprint=fingerprint)


def load_delta(delta_dir: str) -> DeltaArtifact:
    from photon_ml_tpu_torch.serving.artifact import (
        FIXED_EFFECT_DIR,
        RANDOM_EFFECT_DIR,
    )

    with open(os.path.join(delta_dir, DELTA_MANIFEST_FILE)) as f:
        manifest = json.load(f)
    if manifest.get("format_version") != DELTA_FORMAT_VERSION:
        raise ValueError(
            f"unsupported delta format version: {manifest.get('format_version')}"
        )
    re_rows: Dict[str, Tuple[List[str], np.ndarray]] = {}
    fe_updates: Dict[str, np.ndarray] = {}
    for cid, desc in manifest["coordinates"].items():
        if desc["kind"] == "random":
            rows = np.load(
                os.path.join(delta_dir, RANDOM_EFFECT_DIR, cid, _ROWS_FILE)
            )
            ids = [str(e) for e in desc["entity_ids"]]
            if rows.shape != (len(ids), desc["dim"]):
                raise ValueError(
                    f"delta {delta_dir}: coordinate {cid!r} rows shape "
                    f"{rows.shape} does not match its manifest "
                    f"({len(ids)}, {desc['dim']})"
                )
            re_rows[cid] = (ids, rows)
        else:
            fe_updates[cid] = np.load(
                os.path.join(delta_dir, FIXED_EFFECT_DIR, f"{cid}.npy")
            )
    return DeltaArtifact(
        base_fingerprint=manifest.get("base_fingerprint"),
        generation=int(manifest["generation"]),
        re_rows=re_rows,
        fe_updates=fe_updates,
        created_at_unix=float(manifest.get("created_at_unix", 0.0)),
        fingerprint=fingerprint_dir(delta_dir),
    )


class OverlayIndexMap(IndexMap):
    """Entity index extended with appended rows, without rebuilding the
    (possibly off-heap, million-entry) base map: new entity ids resolve
    through a small host-side dict layered over the base store."""

    def __init__(self, base: IndexMap, added: Dict[str, int]):
        self._base = base
        self._added = dict(added)
        self._reverse = {int(i): name for name, i in self._added.items()}

    def get_index(self, name: str) -> int:
        idx = self._added.get(name)
        if idx is not None:
            return idx
        return self._base.get_index(name)

    def get_feature_name(self, index: int) -> Optional[str]:
        name = self._reverse.get(int(index))
        if name is not None:
            return name
        return self._base.get_feature_name(index)

    def __len__(self) -> int:
        return len(self._base) + len(self._added)

    def get_indices(self, names) -> np.ndarray:
        """Vectorized lookup: probe the (small) overlay dict first, then
        hand the misses to the base map's own vectorized path in one call —
        the serving route step resolves whole buckets through this, so the
        per-name generator fallback of the base class would put a Python
        loop on the hot path."""
        added = self._added
        if not added:
            return np.asarray(self._base.get_indices(names), dtype=np.int64)
        out = np.fromiter(
            (added.get(n, -1) for n in names),
            dtype=np.int64,
            count=len(names),
        )
        miss = out < 0
        if miss.any():
            missing = [n for n, m in zip(names, miss) if m]
            out[miss] = np.asarray(
                self._base.get_indices(missing), dtype=np.int64
            )
        return out


def rebase_delta(
    delta: DeltaArtifact, base_fingerprint: Optional[str]
) -> DeltaArtifact:
    """Retarget a delta onto a different chain head (a copy; the input is
    untouched). The multi-variant case: one nearline trainer emits a delta
    against the shared base artifact, and each variant rebases it onto its
    OWN chain head before applying, so every variant's hash chain stays
    unbroken without retraining per variant. The content ``fingerprint``
    is cleared — a rebased delta is new content and must be re-saved (or
    applied in memory) to earn one."""
    return dataclasses.replace(
        delta, base_fingerprint=base_fingerprint, fingerprint=None
    )


def apply_delta(artifact, delta: DeltaArtifact):
    """Fold a delta into a ``ServingArtifact`` → a NEW artifact (host-side;
    the input artifact and its possibly-mmap'd tables are not mutated).
    Existing entity rows are replaced in place; unknown ids are appended
    (sorted among themselves) behind an :class:`OverlayIndexMap`."""
    import dataclasses as dc

    from photon_ml_tpu_torch.serving.artifact import ServingTable

    tables = dict(artifact.tables)
    for cid, (ids, rows) in delta.re_rows.items():
        table = tables.get(cid)
        if table is None or not table.is_random_effect:
            raise ValueError(
                f"delta touches {cid!r} which is not a random effect of the "
                "base artifact"
            )
        if rows.shape[1] != table.dim:
            raise ValueError(
                f"delta rows for {cid!r} have dim {rows.shape[1]}, base "
                f"table has dim {table.dim}"
            )
        targets = np.asarray(table.entity_index.get_indices(ids), dtype=np.int64)
        n_old = table.n_entities
        n_new = int((targets < 0).sum())
        weights = np.array(table.weights, dtype=np.float32, copy=True)
        entity_index = table.entity_index
        if n_new:
            weights = np.concatenate(
                [weights, np.zeros((n_new, table.dim), dtype=np.float32)]
            )
            added: Dict[str, int] = {}
            nxt = n_old
            for i, eid in enumerate(ids):
                if targets[i] < 0:
                    added[eid] = nxt
                    targets[i] = nxt
                    nxt += 1
            entity_index = OverlayIndexMap(table.entity_index, added)
        weights[targets] = np.asarray(rows, dtype=np.float32)
        tables[cid] = ServingTable(
            feature_shard=table.feature_shard,
            random_effect_type=table.random_effect_type,
            weights=weights,
            entity_index=entity_index,
        )
    for cid, w in delta.fe_updates.items():
        table = tables.get(cid)
        if table is None or table.is_random_effect:
            raise ValueError(
                f"delta replaces {cid!r} which is not a fixed effect of the "
                "base artifact"
            )
        if w.shape != (table.dim,):
            raise ValueError(
                f"delta fixed-effect vector for {cid!r} has shape {w.shape}, "
                f"base table has dim {table.dim}"
            )
        tables[cid] = dc.replace(table, weights=np.asarray(w, dtype=np.float32))
    return dc.replace(artifact, tables=tables)


def verify_chain(
    base_fingerprint: str, deltas: Sequence[DeltaArtifact]
) -> None:
    """Check that ``deltas`` form an unbroken hash chain rooted at
    ``base_fingerprint`` (each delta's ``base_fingerprint`` must equal its
    predecessor's content fingerprint)."""
    fp = base_fingerprint
    for i, delta in enumerate(deltas):
        if delta.base_fingerprint is not None and delta.base_fingerprint != fp:
            raise ValueError(
                f"delta chain broken at position {i} (generation "
                f"{delta.generation}): it chains to base "
                f"{delta.base_fingerprint}, expected {fp} — a delta is "
                "missing, reordered, or built against a different artifact"
            )
        fp = delta.fingerprint


def compact(
    base_artifact_dir: str,
    delta_dirs: Sequence[str],
    output_dir: str,
) -> str:
    """Fold a verified delta chain back into a full artifact at
    ``output_dir`` (atomic write). Returns the new artifact's content
    fingerprint — the root of the next chain."""
    from photon_ml_tpu_torch.serving.artifact import load_artifact, save_artifact

    artifact = load_artifact(base_artifact_dir, mmap=False)
    deltas = [load_delta(d) for d in delta_dirs]
    verify_chain(fingerprint_dir(base_artifact_dir), deltas)
    for delta in deltas:
        artifact = apply_delta(artifact, delta)
    save_artifact(artifact, output_dir)
    return fingerprint_dir(output_dir)


def discover_deltas(watch_dir: str) -> List[str]:
    """Delta directories under ``watch_dir`` (``delta-*`` dirs containing a
    manifest), sorted by name — publish with zero-padded generation numbers
    (``delta-000042``) so name order is chain order."""
    if not os.path.isdir(watch_dir):
        return []
    out = []
    for name in sorted(os.listdir(watch_dir)):
        full = os.path.join(watch_dir, name)
        if name.startswith(DELTA_DIR_PREFIX) and os.path.isfile(
            os.path.join(full, DELTA_MANIFEST_FILE)
        ):
            out.append(full)
    return out


def delta_dir_name(generation: int) -> str:
    return f"{DELTA_DIR_PREFIX}{int(generation):06d}"

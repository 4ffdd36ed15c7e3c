"""GAME data: per-row responses + feature shards + id tags.

Port of ``photon_ml_tpu/data/game_data.py``. The container stays host numpy
(one column per field, features as COO per shard); ``sparse_features``
builds a shard's layout on a device and caches it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.device import DEFAULT_DEVICE, DeviceLike, resolve_device
from photon_ml_tpu_torch.ops import fused_perm, sparse_perm
from photon_ml_tpu_torch.ops.features import from_scipy_like

# "auto" picks the fused engine for shards at least this large on the card
# (the reference's rule, photon_ml_tpu/data/game_data.py:154-165)
FUSED_MIN_NNZ = 1 << 20

ENGINES = ("auto", "ell", "benes", "fused")


@dataclasses.dataclass
class FeatureShard:
    """One feature bag/shard in COO form over its own feature space."""

    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    dim: int

    def slice_rows(self, row_mask: np.ndarray) -> "FeatureShard":
        """Subset to rows where mask is True, renumbering rows densely."""
        keep = row_mask[self.rows]
        new_index = np.cumsum(row_mask) - 1
        return FeatureShard(
            rows=new_index[self.rows[keep]],
            cols=self.cols[keep],
            vals=self.vals[keep],
            dim=self.dim,
        )

    def take_rows(self, indices: np.ndarray) -> "FeatureShard":
        """Gather rows by index, allowing repeats (bootstrap resampling);
        output row r holds the nonzeros of input row indices[r], in their
        stored order (an index naming no stored row gives none). The
        shard's stable row order and row offsets are computed once and kept:
        the learning curves and the bootstrap gather from one shard many
        times, and an offset lookup a row replaces two binary searches. The
        gather goes by blocks of :data:`GATHER_ROWS` output rows, so that
        its positions stay in cache."""
        indices = np.asarray(indices, dtype=np.int64)
        order, row_ptr = self._row_index()
        inside = (indices >= 0) & (indices < row_ptr.size - 1)
        safe = np.where(inside, indices, 0)
        starts = row_ptr[safe]
        counts = np.where(inside, row_ptr[safe + 1] - starts, 0)
        ends = np.cumsum(counts)
        total = int(ends[-1]) if ends.size else 0
        # output entry t of a run that starts at output offset o and at
        # stored position p sits at stored position t - o + p
        itype = np.int32 if self.rows.size < (1 << 31) else np.int64
        shift = (starts - (ends - counts)).astype(itype)
        rows = np.repeat(np.arange(len(indices), dtype=np.int64), counts)
        cols = np.empty(total, dtype=self.cols.dtype)
        vals = np.empty(total, dtype=self.vals.dtype)
        for a in range(0, len(indices), self.GATHER_ROWS):
            b = min(a + self.GATHER_ROWS, len(indices))
            lo, hi = (int(ends[a - 1]) if a else 0), int(ends[b - 1])
            pos = np.repeat(shift[a:b], counts[a:b])
            pos += np.arange(lo, hi, dtype=itype)
            nz = pos if order is None else order[pos]
            np.take(self.cols, nz, out=cols[lo:hi], mode="clip")
            np.take(self.vals, nz, out=vals[lo:hi], mode="clip")
        return FeatureShard(rows=rows, cols=cols, vals=vals, dim=self.dim)

    # output rows a block of take_rows' gather
    GATHER_ROWS = 1 << 12

    def _row_index(self):
        """(the stable argsort of ``rows``, or None when they are already in
        order; the offsets of each row's run in that order, [max row + 2]),
        cached while ``rows`` is the same array."""
        cached = self.__dict__.get("_row_index_cache")
        if cached is None or cached[0] is not self.rows:
            rows = np.asarray(self.rows, dtype=np.int64)
            in_order = rows.size < 2 or bool(np.all(rows[1:] >= rows[:-1]))
            order = None if in_order else np.argsort(rows, kind="stable")
            row_ptr = np.zeros(int(rows.max()) + 2 if rows.size else 1, dtype=np.int64)
            if rows.size:
                np.cumsum(np.bincount(rows), out=row_ptr[1:])
            cached = (self.rows, order, row_ptr)
            self.__dict__["_row_index_cache"] = cached
        return cached[1], cached[2]


@dataclasses.dataclass
class GameData:
    """All rows of a GAME dataset (host container; device layouts are built
    per shard by :meth:`sparse_features`)."""

    labels: np.ndarray                      # [n]
    feature_shards: Dict[str, FeatureShard]
    id_tags: Dict[str, np.ndarray]          # re_type -> per-row entity id (str)
    offsets: Optional[np.ndarray] = None    # [n]
    weights: Optional[np.ndarray] = None    # [n]

    def __post_init__(self) -> None:
        n = len(self.labels)
        self.labels = np.asarray(self.labels, dtype=np.float32)
        self.offsets = (
            np.zeros(n, dtype=np.float32)
            if self.offsets is None
            else np.asarray(self.offsets, dtype=np.float32)
        )
        self.weights = (
            np.ones(n, dtype=np.float32)
            if self.weights is None
            else np.asarray(self.weights, dtype=np.float32)
        )
        for t, ids in self.id_tags.items():
            if len(ids) != n:
                raise ValueError(f"id tag {t} has {len(ids)} rows, expected {n}")
        self._feat_cache: Dict[tuple, object] = {}

    @property
    def num_rows(self) -> int:
        return len(self.labels)

    def slice_rows(self, row_mask: np.ndarray) -> "GameData":
        """Row-subset copy (device layouts are not carried over)."""
        row_mask = np.asarray(row_mask, dtype=bool)
        return GameData(
            labels=self.labels[row_mask],
            feature_shards={
                sid: s.slice_rows(row_mask) for sid, s in self.feature_shards.items()
            },
            id_tags={t: np.asarray(v)[row_mask] for t, v in self.id_tags.items()},
            offsets=self.offsets[row_mask],
            weights=self.weights[row_mask],
        )

    def take_rows(self, indices: np.ndarray) -> "GameData":
        """Gather rows by index with repeats allowed (bootstrap resamples)."""
        indices = np.asarray(indices, dtype=np.int64)
        return GameData(
            labels=self.labels[indices],
            feature_shards={sid: s.take_rows(indices) for sid, s in self.feature_shards.items()},
            id_tags={t: np.asarray(v)[indices] for t, v in self.id_tags.items()},
            offsets=self.offsets[indices],
            weights=self.weights[indices],
        )

    def sparse_features(
        self, shard_name: str, engine: str = "auto",
        device: DeviceLike = DEFAULT_DEVICE,
    ):
        """Sparse layout of one shard on ``device``, built once and cached.

        engine:
        - "ell"   — padded row-sparse layout (gather + sum).
        - "fused" — CSR with the hand-written ``csr_matvec_f32`` kernel
          (counterpart of the reference's fused Benes engine).
        - "benes" — the stage-by-stage Benes permutation engine
          (``ops/sparse_perm.py``: each plan's compiled groups,
          ``lane_relayout_f32`` and ``inner_shuffle_f32``, on the card);
          its routing plans
          are cached in ``sparse_perm.default_plan_cache()``.
        - "auto"  — "fused" on ``cuda`` for a shard with at least 2^20
          nonzeros, else "ell" (the reference's rule).
        """
        if engine not in ENGINES:
            raise ValueError(
                f"unknown sparse engine {engine!r}; expected auto/ell/benes/fused"
            )
        dev = resolve_device(device)
        shard = self.feature_shards[shard_name]
        if engine == "auto":
            big = shard.rows.size >= FUSED_MIN_NNZ
            engine = "fused" if dev.type == "cuda" and big else "ell"
        if dev.type == "cuda" and dev.index is None:
            # "cuda" and "cuda:0" name one card: one cache entry
            dev = torch.device("cuda", torch.cuda.current_device())
        key = (shard_name, engine, str(dev))
        if key not in self._feat_cache:
            shape = (self.num_rows, shard.dim)
            if engine == "fused":
                feats = fused_perm.from_coo(
                    shard.rows, shard.cols, shard.vals, shape, device=dev
                )
            elif engine == "benes":
                feats = sparse_perm.from_coo(
                    shard.rows, shard.cols, shard.vals, shape, device=dev
                )
            else:
                feats = from_scipy_like(
                    shard.rows, shard.cols, shard.vals, shape, device=dev
                )
            self._feat_cache[key] = feats
        return self._feat_cache[key]

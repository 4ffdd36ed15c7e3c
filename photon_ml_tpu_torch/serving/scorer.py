"""Fixed-shape request scoring against a packed serving artifact, on the
scorer's device.

Port of ``photon_ml_tpu/serving/scorer.py``. One request carries sparse
features per shard and one entity id per random-effect type; a batch of B
requests is scored as

    z   = offset + Σ_fe x·β_fe + Σ_re x·β_re[entity]
    out = mean(z)                      (task link-inverse, e.g. sigmoid)

with every array shaped ``[B, K_shard]`` (K fixed per shard, nonzeros
padded with zero values at index 0). RE coefficients are gathered from a
device table through slot indices produced by the hot-entity cache (or the
full device-resident table): ``table[slot, idx]`` picks the ``[B, K]``
coefficients a batch multiplies, not whole ``[B, dim]`` rows. Entities
absent from the model gather the permanently-zero cold slot, so they
degrade to the FE-only score — the Photon-ML left-join semantics — without
a branch.

The score path is plain torch: a few gathers, products and sums a batch
(no kernel of its own). Shapes are fixed per (bucket size, table shapes)
signature; ``compile_count`` counts the distinct signatures scored, which
is the number of programs the JAX scorer traces for the same bucket
sequence (each first sighting also calls ``note_jit_trace``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import operator
import time
from itertools import chain
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from photon_ml_tpu_torch.device import DEFAULT_DEVICE, DeviceLike, resolve_device
from photon_ml_tpu_torch.losses.pointwise import mean_function
from photon_ml_tpu_torch.serving.artifact import ServingArtifact
from photon_ml_tpu_torch.serving.cache import HotEntityCache
from photon_ml_tpu_torch.telemetry import note_jit_trace, span


@dataclasses.dataclass
class ScoreRequest:
    """One item to score: sparse features per shard + entity ids."""

    request_id: str
    features: Dict[str, Dict[int, float]]  # shard -> {feature index: value}
    entity_ids: Dict[str, str] = dataclasses.field(default_factory=dict)
    offset: float = 0.0


@dataclasses.dataclass(slots=True)
class ScoreResult:
    request_id: str
    score: float  # margin z including the request offset (GameModel.score + offset)
    mean: float   # task link-inverse of the margin
    cold_coordinates: Tuple[str, ...] = ()  # RE coordinates served FE-only


_EMPTY_FEATS: Dict[int, float] = {}
_FEAT_VALUES = operator.methodcaller("values")
_REQ_OFFSET = operator.attrgetter("offset")
_REQ_ENTITY_IDS = operator.attrgetter("entity_ids")


def featurize_requests(
    requests: Sequence[ScoreRequest],
    n: int,
    bucket: int,
    shard_nnz: Dict[str, int],
    shard_dim: Dict[str, int],
) -> Tuple[Dict[str, Tuple[np.ndarray, np.ndarray]], np.ndarray]:
    """Pack ``n`` requests into padded ``[bucket, K]`` value/index arrays
    per shard plus a ``[bucket]`` offsets vector.

    One flat ``np.fromiter`` pass over all nonzeros per shard, fed by
    C-level ``chain.from_iterable`` iteration (the per-row dict loop this
    replaces was the second-largest serving cost after the cache fill, and
    a nested generator expression here costs two frame resumes per
    nonzero); output is bit-identical to the row-at-a-time packing — same
    dict iteration order, same zero padding. Shared by the single-table
    and the sharded scorer so their featurization cannot drift apart."""
    shards: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for shard, k in shard_nnz.items():
        dim = shard_dim[shard]
        vals = np.zeros((bucket, k), dtype=np.float32)
        idx = np.zeros((bucket, k), dtype=np.int32)
        feats_list = [req.features.get(shard) or _EMPTY_FEATS
                      for req in requests]
        lens = np.fromiter(map(len, feats_list), dtype=np.int64, count=n)
        total = int(lens.sum())
        if total:
            if int(lens.max()) > k:
                i = int(np.argmax(lens))
                raise ValueError(
                    f"request {requests[i].request_id!r} has {int(lens[i])} "
                    f"nonzeros in shard {shard!r} but the scorer was built "
                    f"with max_nnz={k} — raise max_nnz"
                )
            flat_idx = np.fromiter(
                chain.from_iterable(feats_list),
                dtype=np.int64, count=total,
            )
            if flat_idx.size and (
                int(flat_idx.min()) < 0 or int(flat_idx.max()) >= dim
            ):
                rows_of = np.repeat(np.arange(n), lens)
                bad = int(rows_of[(flat_idx < 0) | (flat_idx >= dim)][0])
                bad_c = next(
                    c for c in requests[bad].features[shard]
                    if not 0 <= int(c) < dim
                )
                raise ValueError(
                    f"request {requests[bad].request_id!r}: feature index "
                    f"{int(bad_c)} out of range for shard {shard!r} "
                    f"(dim {dim})"
                )
            flat_val = np.fromiter(
                chain.from_iterable(map(_FEAT_VALUES, feats_list)),
                dtype=np.float32, count=total,
            )
            rows = np.repeat(np.arange(n), lens)
            starts = np.repeat(np.cumsum(lens) - lens, lens)
            cols = np.arange(total) - starts
            idx[rows, cols] = flat_idx
            vals[rows, cols] = flat_val
        shards[shard] = (vals, idx)
    offsets = np.zeros(bucket, dtype=np.float32)
    if n:
        offsets[:n] = np.fromiter(
            map(_REQ_OFFSET, requests), dtype=np.float32, count=n
        )
    return shards, offsets


def device_stream(device: torch.device):
    """Context that issues work on ``device``'s default stream. The scoring
    threads and the admission thread of one scorer all enter it, so table
    writes and gathers are ordered on one stream whichever thread issues
    them; on the CPU it does nothing."""
    if device.type == "cuda":
        return torch.cuda.stream(torch.cuda.default_stream(device))
    return contextlib.nullcontext()


def upload(device: torch.device, arrays: Sequence[np.ndarray]) -> List[torch.Tensor]:
    """Copy a batch's host arrays to ``device`` in ONE transfer: their bytes
    are laid end to end (each start aligned to 8 bytes) in one host buffer,
    and each comes back as a device view with its own dtype and shape. On a
    card the buffer is pinned and the copy is queued on the current stream
    without waiting for it, so a caller that holds a lock does not hold it
    across a stream sync (the caching host allocator keeps the buffer until
    the copy has run)."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    starts, at = [], 0
    for a in arrays:
        starts.append(at)
        at += -(-a.nbytes // 8) * 8
    host = torch.empty(at, dtype=torch.uint8, pin_memory=device.type == "cuda")
    buf = host.numpy()
    for a, s in zip(arrays, starts):
        buf[s:s + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev = host.to(device, non_blocking=True)
    return [
        dev[s:s + a.nbytes].view(_TORCH_DTYPE[a.dtype.str]).view(a.shape)
        for a, s in zip(arrays, starts)
    ]


_TORCH_DTYPE = {
    np.dtype(np.float32).str: torch.float32,
    np.dtype(np.int64).str: torch.int64,
    np.dtype(np.int32).str: torch.int32,
}


class _FullTable:
    """No-cache RE row provider: whole table device-resident, plus the
    trailing zero cold row. Same lookup contract as HotEntityCache.

    ``pad_rows`` reserves headroom BETWEEN the live rows and the cold slot
    (device shape ``[pad_rows + 1, dim]``, cold slot at ``pad_rows``): a
    hot-swap can then append new entities into the zero headroom rows
    without changing the table shape — and therefore without a new score
    signature. The headroom rows are all-zero until claimed, so an
    accidental gather of one degrades to the FE-only score, same as cold.
    """

    def __init__(
        self,
        backing: np.ndarray,
        pad_rows: Optional[int] = None,
        device: DeviceLike = DEFAULT_DEVICE,
    ):
        self.device = resolve_device(device)
        n, dim = backing.shape
        pad = n if pad_rows is None else max(int(pad_rows), n)
        self._table = torch.zeros(
            (pad + 1, dim), dtype=torch.float32, device=self.device
        )
        # the backing store may be a read-only memory map: copy it in
        # chunks of host rows, each to the device
        step = max(1, (64 << 20) // max(1, 4 * dim))
        for lo in range(0, n, step):
            rows = np.array(backing[lo:lo + step], dtype=np.float32)
            self._table[lo:lo + rows.shape[0]] = torch.from_numpy(rows).to(self.device)
        self.num_rows = n  # live rows; grows as headroom is claimed
        self.cold_slot = pad

    @property
    def table(self) -> torch.Tensor:
        return self._table

    @property
    def capacity(self) -> int:
        """Rows the device table can hold without a shape change."""
        return self.cold_slot

    def lookup(self, entity_rows: np.ndarray) -> np.ndarray:
        rows = np.asarray(entity_rows, dtype=np.int64)
        return np.where(rows < 0, self.cold_slot, rows).astype(np.int32)

    def update_rows(self, rows: np.ndarray, values: np.ndarray) -> None:
        """In-place row update/append on the device — no shape change, no
        new signature. Rows must fit below the cold slot; the hot-swap
        manager rebuilds the provider at the next size bucket when they
        don't. A row named twice takes its last value, as the reference's
        scatter does."""
        rows = np.asarray(rows, dtype=np.int64)
        if rows.size == 0:
            return
        if rows.min() < 0 or rows.max() >= self.cold_slot:
            raise ValueError(
                f"row update [{rows.min()}, {rows.max()}] exceeds table "
                f"capacity {self.cold_slot} — table must grow (re-pad to "
                "the next size bucket)"
            )
        values = np.ascontiguousarray(values, dtype=np.float32).reshape(
            rows.size, -1
        )
        # the last write of a row wins: keep one value per row so the
        # device write has distinct indices
        _, last = np.unique(rows[::-1], return_index=True)
        keep = rows.size - 1 - last
        self._table.index_copy_(
            0,
            torch.from_numpy(rows[keep]).to(self.device),
            torch.from_numpy(values[keep]).to(self.device),
        )
        self.num_rows = max(self.num_rows, int(rows.max()) + 1)

    def stats(self) -> Dict[str, float]:
        return {}


def shard_nnz_of(
    dims: Dict[str, int], max_nnz: Optional[Union[int, Dict[str, int]]]
) -> Dict[str, int]:
    """Per-shard padded nonzero capacity K (an int applies to every shard;
    default: the shard's full dimension)."""
    out: Dict[str, int] = {}
    for shard, dim in dims.items():
        if isinstance(max_nnz, dict):
            k = max_nnz.get(shard, dim)
        elif max_nnz is not None:
            k = int(max_nnz)
        else:
            k = dim
        out[shard] = max(1, min(int(k), dim))
    return out


def entity_rows_of(
    requests: Sequence[ScoreRequest], n: int, bucket: int, re_type: str, table
) -> np.ndarray:
    """``[bucket]`` backing-table rows of the requests' ``re_type`` entities
    (-1 for an unknown entity, a request without one, and the pad rows).
    Ids stay C-level; the common every-request-carries-an-id case hands the
    whole list to one vectorized lookup. Artifact entity indexes are keyed
    by str, so non-str ids (ints from upstream id tags) are coerced like
    ``ServingArtifact.entity_row`` does."""
    entity_rows = np.full(bucket, -1, dtype=np.int64)
    ids = [
        e if type(e) is str or e is None else str(e)
        for e in map(
            operator.methodcaller("get", re_type),
            map(_REQ_ENTITY_IDS, requests),
        )
    ]
    if None not in ids:
        entity_rows[:n] = table.entity_index.get_indices(ids)
    else:
        where = [i for i, e in enumerate(ids) if e is not None]
        if where:
            entity_rows[np.asarray(where)] = table.entity_index.get_indices(
                [ids[i] for i in where]
            )
    return entity_rows


def structure_check(scorer, artifact: ServingArtifact) -> None:
    """Raise unless ``artifact`` keeps ``scorer``'s coordinate structure —
    same coordinate ids, shards, RE types and FE dims (a hot swap replaces
    content, never structure)."""
    fe = [
        (cid, t.feature_shard)
        for cid, t in sorted(artifact.tables.items())
        if not t.is_random_effect
    ]
    re = [
        (cid, t.feature_shard, t.random_effect_type)
        for cid, t in sorted(artifact.tables.items())
        if t.is_random_effect
    ]
    if fe != scorer._fe_specs or re != scorer._re_specs:
        raise ValueError(
            "candidate artifact changes the coordinate structure "
            f"(have fe={scorer._fe_specs} re={scorer._re_specs}, candidate "
            f"fe={fe} re={re}) — a structural change needs a new scorer, "
            "not a hot swap"
        )
    for cid, shard in scorer._fe_specs:
        if artifact.tables[cid].dim != scorer._artifact.tables[cid].dim:
            raise ValueError(
                f"candidate artifact changes fixed-effect dim of {cid!r}"
            )


def replace_fixed_effect(fe_params: Dict[str, torch.Tensor], cid: str,
                         weights: np.ndarray) -> None:
    """Swap one FE coefficient vector for new content of the same shape
    (a new tensor: a batch in flight keeps the vector it captured)."""
    old = fe_params.get(cid)
    if old is None:
        raise ValueError(f"{cid!r} is not a fixed-effect coordinate")
    w = np.ascontiguousarray(weights, dtype=np.float32)
    if tuple(w.shape) != tuple(old.shape):
        raise ValueError(
            f"fixed-effect update for {cid!r} has shape {w.shape}, "
            f"scorer holds {tuple(old.shape)}"
        )
    fe_params[cid] = torch.from_numpy(w).to(old.device)


def note_signature(signatures: set, bucket: int, tables: Sequence[torch.Tensor]) -> None:
    """Record a batch's score signature (bucket, RE table shapes); a first
    sighting is what the reference's jit traces, so it also counts in
    ``jit.traces.serving_score``."""
    key = (bucket, tuple(tuple(t.shape) for t in tables))
    if key not in signatures:
        signatures.add(key)
        note_jit_trace("serving_score")


class GameScorer:
    """Scores request batches against a :class:`ServingArtifact`.

    - ``max_nnz``: per-shard padded nonzero capacity K (int applies to all
      shards; default: the shard's full dimension, always correct).
    - ``cache_capacity``: device rows per RE coordinate. None keeps each
      full RE table device-resident; an int puts an LRU
      :class:`HotEntityCache` in front of the host backing store (must be
      >= the largest batch the caller will score).
    - ``growth_headroom``: pad full device-resident RE tables to the next
      power-of-two size bucket so a hot-swap can append new entities
      in-shape (no new signature). Cached coordinates have a fixed device
      shape and never need it. Off by default — steady-state memory is the
      padded bucket.
    - ``device``: where the tables live and the batches are scored
      (``cuda`` by default; raises without a card unless ``"cpu"``).
    """

    def __init__(
        self,
        artifact: ServingArtifact,
        max_nnz: Optional[Union[int, Dict[str, int]]] = None,
        cache_capacity: Optional[int] = None,
        growth_headroom: bool = False,
        device: DeviceLike = DEFAULT_DEVICE,
    ):
        self.device = resolve_device(device)
        self._artifact = artifact
        self._task = artifact.task
        dims = artifact.shard_dims()
        self._shard_nnz = shard_nnz_of(dims, max_nnz)
        self._shard_dim = dims

        self._fe_specs: List[Tuple[str, str]] = []  # (cid, shard)
        self._re_specs: List[Tuple[str, str, str]] = []  # (cid, shard, re_type)
        self.caches: Dict[str, HotEntityCache] = {}
        self._providers: Dict[str, object] = {}
        self._growth_headroom = bool(growth_headroom)
        fe_params: Dict[str, torch.Tensor] = {}
        with device_stream(self.device):
            for cid in sorted(artifact.tables):
                table = artifact.tables[cid]
                if table.is_random_effect:
                    self._re_specs.append(
                        (cid, table.feature_shard, table.random_effect_type)
                    )
                    if cache_capacity is not None:
                        cache = HotEntityCache(
                            table.weights, cache_capacity, device=self.device
                        )
                        self.caches[cid] = cache
                        self._providers[cid] = cache
                    else:
                        self._providers[cid] = _FullTable(
                            np.asarray(table.weights),
                            pad_rows=self._pad_rows_for(table.n_entities),
                            device=self.device,
                        )
                else:
                    self._fe_specs.append((cid, table.feature_shard))
                    fe_params[cid] = torch.from_numpy(
                        np.array(table.weights, dtype=np.float32)
                    ).to(self.device)
        self._fe_params = fe_params
        self._signatures: set = set()

    @property
    def compile_count(self) -> int:
        """Distinct score signatures so far — one per bucket size (and per
        RE table shape a rebind introduced)."""
        return len(self._signatures)

    @property
    def task(self):
        return self._task

    @property
    def artifact(self) -> ServingArtifact:
        return self._artifact

    def cache_stats(self) -> Dict[str, Dict[str, float]]:
        return {cid: c.stats() for cid, c in self.caches.items()}

    # ------------------------------------------------------ hot-swap hooks

    def _pad_rows_for(self, n: int) -> Optional[int]:
        """Full-table headroom: pad to the next power-of-two size bucket so
        moderate entity growth stays in-shape (None = tight, no headroom)."""
        if not self._growth_headroom:
            return None
        bucket = 1
        while bucket <= n:  # strictly greater: never a zero-headroom bucket
            bucket <<= 1
        return bucket

    def set_artifact(self, artifact: ServingArtifact) -> None:
        """Flip the scorer's artifact reference (entity indexes, dims) to a
        delta-applied candidate. The candidate must keep the coordinate
        structure; table CONTENT is swapped separately via
        ``update_fixed_effect`` / ``update_random_effect_rows`` /
        ``rebind_random_effect``."""
        structure_check(self, artifact)
        self._artifact = artifact

    def update_fixed_effect(self, cid: str, weights: np.ndarray) -> None:
        """Replace one FE coefficient vector (same shape: no new
        signature)."""
        with device_stream(self.device):
            replace_fixed_effect(self._fe_params, cid, weights)

    def update_random_effect_rows(
        self, cid: str, rows: np.ndarray, values: np.ndarray
    ) -> None:
        """In-place update/append of full-table RE rows on the device
        (raises if the rows exceed the table's headroom — then use
        ``rebind_random_effect``). Cached coordinates take content changes
        through ``rebind_random_effect`` + cache invalidation instead."""
        provider = self._providers.get(cid)
        if provider is None:
            raise ValueError(f"{cid!r} is not a random-effect coordinate")
        if isinstance(provider, HotEntityCache):
            raise ValueError(
                f"{cid!r} is cache-backed; rebind its backing store and "
                "invalidate the touched rows instead of updating in place"
            )
        with device_stream(self.device):
            provider.update_rows(rows, values)

    def rebind_random_effect(self, cid: str, backing: np.ndarray) -> bool:
        """Point one RE coordinate at a new backing table.

        Cache-backed: O(1) pointer swap, device shape unchanged (the caller
        invalidates the rows whose content changed). Full-table: rebuilds
        the device table — same shape when the new row count fits the
        current padding bucket, next bucket otherwise (one new signature).
        Returns True when the device table shape changed."""
        provider = self._providers.get(cid)
        if provider is None:
            raise ValueError(f"{cid!r} is not a random-effect coordinate")
        if isinstance(provider, HotEntityCache):
            provider.rebind(backing)
            return False
        n = backing.shape[0]
        pad = self._pad_rows_for(n)
        with device_stream(self.device):
            rebuilt = _FullTable(np.asarray(backing), pad_rows=pad,
                                 device=self.device)
        shape_changed = rebuilt.table.shape != provider.table.shape
        self._providers[cid] = rebuilt
        return shape_changed

    def restore_random_effect(self, cid: str, provider, routing=None) -> None:
        """Rollback hook: reinstall a snapshotted provider object.
        ``routing`` only exists for the sharded scorer's shared-layout
        snapshots and is ignored here."""
        self._providers[cid] = provider

    def _featurize(self, requests: Sequence[ScoreRequest], bucket: int):
        return featurize_requests(
            requests, len(requests), bucket, self._shard_nnz, self._shard_dim
        )

    def score_batch(
        self,
        requests: Sequence[ScoreRequest],
        bucket_size: Optional[int] = None,
        stages: Optional[dict] = None,
    ) -> List[ScoreResult]:
        """Score up to ``bucket_size`` requests, padding the batch to exactly
        that size (defaults to ``len(requests)``). Results keep request order.

        ``stages`` is the request plane's stage clock: when a dict is
        passed (only for batches carrying a sampled request), monotonic
        stage-boundary timestamps are stamped into it (featurize_done,
        route_done, dispatch_done, device_done). ``None`` — the default —
        costs nothing."""
        n = len(requests)
        bucket = int(bucket_size) if bucket_size is not None else n
        if n == 0:
            return []
        if n > bucket:
            raise ValueError(f"{n} requests do not fit bucket size {bucket}")

        with span("serve/score_batch", n=n, bucket=bucket):
            return self._score_batch_impl(requests, n, bucket, stages)

    def _score_batch_impl(
        self,
        requests: Sequence[ScoreRequest],
        n: int,
        bucket: int,
        stages: Optional[dict] = None,
    ) -> List[ScoreResult]:
        shards, offsets = self._featurize(requests, bucket)
        if stages is not None:
            stages["featurize_done"] = time.perf_counter()
        cold: List[List[str]] = [[] for _ in range(n)]
        slot_arrays: List[np.ndarray] = []
        with device_stream(self.device):
            for cid, _, re_type in self._re_specs:
                table = self._artifact.tables[cid]
                entity_rows = entity_rows_of(requests, n, bucket, re_type, table)
                for i in range(n):
                    if entity_rows[i] < 0:
                        cold[i].append(cid)
                # pad rows bypass the provider: they would otherwise count
                # as cold lookups in the cache statistics
                provider = self._providers[cid]
                cid_slots = np.full(bucket, provider.cold_slot, dtype=np.int64)
                cid_slots[:n] = provider.lookup(entity_rows[:n])
                slot_arrays.append(cid_slots)

            if stages is not None:
                stages["route_done"] = time.perf_counter()
            order = list(shards)
            dev = upload(
                self.device,
                [offsets]
                + [shards[s][0] for s in order]
                + [shards[s][1].astype(np.int64) for s in order]
                + slot_arrays,
            )
            k = len(order)
            vals = dict(zip(order, dev[1:1 + k]))
            idx = dict(zip(order, dev[1 + k:1 + 2 * k]))
            tables = [self._providers[cid].table for cid, _, _ in self._re_specs]
            note_signature(self._signatures, bucket, tables)
            z = dev[0]
            for cid, shard in self._fe_specs:
                z = z + (vals[shard] * self._fe_params[cid][idx[shard]]).sum(dim=1)
            for (cid, shard, _), table, slots in zip(
                self._re_specs, tables, dev[1 + 2 * k:]
            ):
                z = z + (vals[shard] * table[slots[:, None], idx[shard]]).sum(dim=1)
            out = torch.stack((z, mean_function(self._task, z)))
            if stages is not None:
                # the copy and the launches are asynchronous: this boundary
                # closes dispatch; the host copy below waits for the H2D copy
                # and the device, closing the "device" stage
                stages["dispatch_done"] = time.perf_counter()
            z_list, mean_list = out.cpu().tolist()
        if stages is not None:
            stages["device_done"] = time.perf_counter()
        return [
            ScoreResult(
                request_id=req.request_id,
                score=z_list[i],
                mean=mean_list[i],
                cold_coordinates=tuple(cold[i]),
            )
            for i, req in enumerate(requests)
        ]

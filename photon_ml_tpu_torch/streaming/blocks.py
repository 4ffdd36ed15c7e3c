"""Out-of-core example blocks: fixed-shape slices of a disk-resident dataset.

Port of ``photon_ml_tpu/streaming/blocks.py`` (host numpy, copied; the part
files decode through the port's native columnar reader, one thread a
file). The in-memory trainers materialize one ``GameData`` for the whole
dataset. This module instead lays the dataset out as a sequence of
``block_rows``-row blocks over the part files (``io/data_reader.py``
provides the file-granular reader), where every block has IDENTICAL
shapes:

* row planes (labels / offsets / weights) are padded ``[block_rows]`` arrays
  with weight 0 in padding rows — an algebraic no-op in every objective term
  (see ops/data.py), so padded blocks are exact;
* each feature shard is packed into a padded ELL pair ``[block_rows, k]``
  (f32 values, int32 indices, as in the JAX package) where ``k`` is the
  GLOBAL max nnz/row recorded by the planning pass, so every block has the
  same shapes and the same upload bytes.

A stable feature index (the off-heap/prebuilt index maps) is mandatory: all
blocks must live in one column space. The planning pass decodes each part
file once to record per-shard ELL widths and exact per-file row counts; the
streaming pass then re-decodes files on demand with a tiny LRU so peak host
memory is O(decoded files in cache) + O(prefetch_depth × block bytes), never
O(dataset).

Fault sites ``stream.read_part_file`` and ``stream.build_block``; spans
``read stream plan``, ``read stream file``, ``read stream block`` and
``read stream row planes``, with the JAX package's names.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch.io.data_reader import (
    FeatureShardConfiguration,
    build_index_maps,
    file_row_counts,
    read_game_data,
)
from photon_ml_tpu_torch.ops.features import pack_ell_into
from photon_ml_tpu_torch.resilience.failures import record_failure
from photon_ml_tpu_torch.resilience.faultpoints import fault_point, register_fault_site
from photon_ml_tpu_torch.resilience.retry import DEFAULT_IO_RETRY
from photon_ml_tpu_torch.streaming.blockcache import BlockCache, plan_fingerprint
from photon_ml_tpu_torch.telemetry import span

FAULT_READ = register_fault_site(
    "stream.read_part_file",
    "part-file read + columnar decode (retried; pool failures fall back"
    " to a synchronous decode on the consumer thread)",
)
FAULT_BUILD = register_fault_site(
    "stream.build_block",
    "block assembly after decode; a permanent failure here is what"
    " on_block_error=abort|skip governs",
)


def auto_decode_workers() -> int:
    """Measured auto default for the decode pool width.

    inflate + the columnar decode run with the GIL released (one native
    call per file — see io/native_reader.py), so file decodes scale
    near-linearly with threads until memory bandwidth; the cap is one
    thread per core minus one (reserved for the consumer/solver), bounded
    at 16 where the packed decoder's gains flatten. On a single-CPU host
    this is 0 — synchronous decode, since extra threads only add
    contention there. Override with ``PHOTON_STREAM_DECODE_WORKERS``.
    """
    env = os.environ.get("PHOTON_STREAM_DECODE_WORKERS")
    if env is not None:
        try:
            return max(0, int(env))
        except ValueError:
            pass
    return max(0, min((os.cpu_count() or 1) - 1, 16))


def readahead_file_budget() -> int:
    """Max decoded part files the readahead may hold AHEAD of the consumer.

    Decoded-file residency is the peak-RSS term of streaming, and it must
    be bounded independently of the pool width: with the worker cap at 16,
    scheduling ``workers + depth`` files ahead would let a many-core host
    keep ~17 decoded files resident — the out-of-core bound assumes a
    handful. The default (4) matches the residency of
    the original ``min(4, cpus-1)`` pool; override with
    ``PHOTON_STREAM_READAHEAD_FILES`` when files are small relative to
    RAM and deeper readahead measurably helps the hide ratio.
    """
    env = os.environ.get("PHOTON_STREAM_READAHEAD_FILES")
    if env is not None:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    return 4


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """Static layout of a streamed dataset: file boundaries + block shapes.

    Produced once by the planning pass; every block of the run obeys it, so
    block shapes are a function of the plan alone."""

    block_rows: int
    total_rows: int
    files: Tuple[str, ...]
    file_rows: Tuple[int, ...]
    shard_widths: Dict[str, int]   # shard -> ELL k (global max nnz/row)
    shard_dims: Dict[str, int]     # shard -> feature dimension d

    @property
    def num_blocks(self) -> int:
        return max(1, -(-self.total_rows // self.block_rows))

    @property
    def padded_rows(self) -> int:
        """Total rows including final-block padding (num_blocks*block_rows)."""
        return self.num_blocks * self.block_rows

    def block_bounds(self, index: int) -> Tuple[int, int]:
        """[start, stop) global row range of real rows in block ``index``."""
        if not 0 <= index < self.num_blocks:
            raise IndexError(f"block {index} out of range [0, {self.num_blocks})")
        start = index * self.block_rows
        return start, min(start + self.block_rows, self.total_rows)

    def spans(self, index: int) -> List[Tuple[int, int, int]]:
        """Per-file pieces of block ``index`` as (file_idx, lo, hi) with
        lo/hi local to that file — a block freely spans file boundaries."""
        start, stop = self.block_bounds(index)
        out: List[Tuple[int, int, int]] = []
        base = 0
        for fi, rows in enumerate(self.file_rows):
            file_end = base + rows
            lo = max(start, base)
            hi = min(stop, file_end)
            if lo < hi:
                out.append((fi, lo - base, hi - base))
            base = file_end
            if base >= stop:
                break
        return out


def group_by_part_file(
    indices: Sequence[int], plan: BlockPlan
) -> List[int]:
    """Reorder ``indices`` so blocks that START in the same part file are
    adjacent, without changing the set of blocks visited.

    Shuffled or importance-ordered visits are the stochastic mode's
    re-decode hazard: two blocks of the same file scheduled far apart make
    the decode LRU decode that file twice. Grouping fixes it — part files
    appear in order of their highest-priority block (the first appearance
    in ``indices``), and within a file blocks run in ascending index so
    the decode walk is monotone across each file's spans. With the default
    ``file_cache_size`` (2 — current + next for boundary-spanning blocks),
    each part file is decoded once per pass over the result, plus at most
    one extra decode per file-boundary-straddling block whose neighbor
    group lands much later — O(num_files) total instead of the O(visits)
    worst case of an ungrouped shuffle.
    """
    by_file: Dict[int, List[int]] = {}
    file_order: List[int] = []
    for i in indices:
        b = int(i)
        fi = plan.spans(b)[0][0]
        bucket = by_file.get(fi)
        if bucket is None:
            bucket = by_file[fi] = []
            file_order.append(fi)
        bucket.append(b)
    out: List[int] = []
    for fi in file_order:
        out.extend(sorted(by_file[fi]))
    return out


@dataclasses.dataclass
class HostBlock:
    """One decoded, padded, host-staged block (numpy only — built in the
    prefetcher's background thread; the consumer uploads it).

    ALL arrays are read-only by contract: cache hits are views over a
    ``mode='r'`` memmap, and the decode path freezes its arrays to match,
    so an in-place mutation fails uniformly on cold and warm epochs
    instead of only once the cache warms. Consumers copy if they must
    write (none currently do: the prefetcher copies blocks into pinned
    staging, uploads them and drops them)."""

    index: int
    start: int        # global row of the first real row
    num_real: int     # real rows (rest is weight-0 padding)
    labels: np.ndarray    # [block_rows] f32
    offsets: np.ndarray   # [block_rows] f32 (base offsets from the files)
    weights: np.ndarray   # [block_rows] f32, 0.0 in padding rows
    shards: Dict[str, Tuple[np.ndarray, np.ndarray]]  # sid -> (vals, idx) ELL
    id_tags: Dict[str, np.ndarray]  # re_type -> [num_real] entity ids


@dataclasses.dataclass
class RowPlanes:
    """Whole-dataset per-row scalar planes accumulated by one setup pass.

    These are O(n) scalars + id strings (not features); the random-effect
    coordinates and the CD driver's objective need them resident. The
    feature payload of the streamed (fixed-effect) shard is what stays
    out-of-core."""

    labels: np.ndarray
    offsets: np.ndarray
    weights: np.ndarray
    id_tags: Dict[str, np.ndarray]
    shard_coo: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray, int]]


class StreamingSource:
    """A disk-resident GAME dataset exposed as fixed-shape example blocks.

    Open once per run (the planning pass decodes every part file once to
    fix ELL widths); then ``iter_blocks`` streams HostBlocks in any block
    order, re-decoding part files on demand through a small LRU cache.
    """

    def __init__(
        self,
        files: Sequence[str],
        file_rows: Sequence[int],
        shard_configs: Dict[str, FeatureShardConfiguration],
        index_maps,
        plan: BlockPlan,
        id_tags: Sequence[str] = (),
        read_kwargs: Optional[dict] = None,
        file_cache_size: int = 2,
        decode_workers: Optional[int] = None,
    ):
        self.files = list(files)
        self.file_rows = list(file_rows)
        self.shard_configs = shard_configs
        self.index_maps = index_maps
        self.plan = plan
        self.id_tags = tuple(id_tags)
        self.read_kwargs = dict(read_kwargs or {})
        self.file_cache_size = max(1, int(file_cache_size))
        if decode_workers is None:
            decode_workers = auto_decode_workers()
        self.decode_workers = max(0, int(decode_workers))
        self.cache: Optional[BlockCache] = None  # see attach_cache
        self._file_cache: Dict[int, object] = {}  # fi -> GameData (LRU)
        self._cache_limit = self.file_cache_size
        self._lock = threading.RLock()
        self._pending: Dict[int, Future] = {}  # fi -> in-flight decode
        self._pool: Optional[ThreadPoolExecutor] = None
        self._row_planes: Optional[RowPlanes] = None
        # degraded mode for permanent block failures: "abort" (default —
        # exactness over availability) or "skip" (train on the blocks that
        # decode; each skip is recorded and excluded from gap scheduling)
        self.on_block_error = "abort"
        self.failed_blocks: set = set()
        self._skipped_log: List[dict] = []
        # decode accounting for the planning/setup passes
        self.files_decoded = 0
        # RAM level of the residency hierarchy: part files served from the
        # decoded-file LRU instead of re-decoding (residency_hierarchy)
        self.file_cache_hits = 0
        self._work_s = 0.0  # host decode+pack seconds, whatever thread
        # wall-clock with >= 1 decode in flight (for the wall-based hide
        # ratio: parallel workers must not be double counted)
        self._wall_s = 0.0
        self._wall_active = 0
        self._wall_anchor = 0.0

    # -- construction ------------------------------------------------------

    @classmethod
    def open(
        cls,
        paths: Sequence[str] | str,
        shard_configs: Dict[str, FeatureShardConfiguration],
        index_maps=None,
        block_rows: int = 4096,
        id_tags: Sequence[str] = (),
        file_cache_size: int = 2,
        decode_workers: Optional[int] = None,
        cache_dir: Optional[str] = None,
        **read_kwargs,
    ) -> "StreamingSource":
        """Plan a streamed dataset: list part files, fix the feature index,
        and record global ELL widths with one decode pass per file.
        ``cache_dir`` attaches a decoded block cache (see blockcache.py)
        so later epochs reload spilled blocks instead of re-decoding."""
        if isinstance(paths, str):
            paths = [paths]
        if block_rows < 1:
            raise ValueError(f"block_rows must be >= 1, got {block_rows}")
        with span("read stream plan", files=0):
            counts = file_row_counts(paths)
        files = [p for p, _ in counts]
        rows = [n for _, n in counts]
        if not files or sum(rows) == 0:
            raise ValueError(f"no rows found under {paths}")
        if index_maps is None:
            index_maps = build_index_maps(paths, shard_configs)

        src = cls(
            files, rows, shard_configs, index_maps,
            plan=None,  # type: ignore[arg-type]  # set below
            id_tags=id_tags, read_kwargs=read_kwargs,
            file_cache_size=file_cache_size,
            decode_workers=decode_workers,
        )
        widths = {sid: 1 for sid in shard_configs}
        dims = {sid: len(index_maps[sid]) for sid in shard_configs}

        def file_widths(fi: int) -> Dict[str, int]:
            data = src._decode_file(fi, cache=False)
            if data.num_rows != rows[fi]:
                raise ValueError(
                    f"{files[fi]}: framing scan counted {rows[fi]} rows but "
                    f"decode produced {data.num_rows}"
                )
            return {
                sid: int(np.bincount(shard.rows, minlength=data.num_rows).max())
                for sid, shard in data.feature_shards.items() if shard.rows.size
            }

        # the planning decodes run a file a thread (the native decoder
        # releases the interpreter lock), at most the readahead budget of
        # decoded files at once
        threads = max(1, min(src.decode_workers, readahead_file_budget()))
        with ThreadPoolExecutor(max_workers=threads,
                                thread_name_prefix="stream-plan") as pool:
            for per_file in pool.map(file_widths, range(len(files))):
                for sid, k in per_file.items():
                    widths[sid] = max(widths[sid], k)
        src.plan = BlockPlan(
            block_rows=int(block_rows),
            total_rows=sum(rows),
            files=tuple(files),
            file_rows=tuple(rows),
            shard_widths=widths,
            shard_dims=dims,
        )
        if cache_dir:
            src.attach_cache(cache_dir)
        return src

    def attach_cache(self, cache_dir: str, sweep: bool = True) -> BlockCache:
        """Attach a decoded block cache rooted at ``cache_dir``. The cache
        key (plan fingerprint) commits to block_rows, the part files'
        (path, size, mtime_ns), the shard layout, a content digest of each
        feature index map (externally loaded maps change column ids without
        changing the input files), id tags and reader options — any change
        misses cleanly and ``sweep`` reclaims the orphaned entries of older
        plans."""
        fp = plan_fingerprint(
            self.plan.block_rows,
            self.plan.files,
            self.plan.shard_widths,
            self.plan.shard_dims,
            id_tags=self.id_tags,
            read_kwargs=self.read_kwargs,
            index_maps=self.index_maps,
        )
        self.cache = BlockCache(cache_dir, fp)
        if sweep:
            self.cache.sweep_stale()
        return self.cache

    # -- file decode + cache ----------------------------------------------

    @property
    def work_seconds(self) -> float:
        """Cumulative host decode+pack seconds across all threads — WORK,
        not exposed latency. Zero delta across a warm (fully cached) epoch
        is the 'zero Avro work' contract of the block cache."""
        with self._lock:
            return self._work_s

    @property
    def decode_wall_seconds(self) -> float:
        """Wall-clock seconds during which >= 1 decode/pack was in flight
        (overlapping workers counted once). The prefetcher differences
        this to compute the WALL-based hide ratio; cache loads are not
        decode and do not count."""
        with self._lock:
            w = self._wall_s
            if self._wall_active > 0:
                w += time.perf_counter() - self._wall_anchor
            return w

    def _add_work(self, dt: float) -> None:
        with self._lock:
            self._work_s += dt

    def _wall_enter(self) -> None:
        now = time.perf_counter()
        with self._lock:
            if self._wall_active == 0:
                self._wall_anchor = now
            self._wall_active += 1

    def _wall_exit(self) -> None:
        now = time.perf_counter()
        with self._lock:
            self._wall_active -= 1
            if self._wall_active == 0:
                self._wall_s += now - self._wall_anchor

    def _decode_now(self, fi: int):
        """The actual (uncached) file read — safe from any thread."""
        t0 = time.perf_counter()
        self._wall_enter()
        try:
            return self._decode_now_inner(fi, t0)
        finally:
            self._wall_exit()

    def _decode_now_inner(self, fi: int, t0: float):
        with span("read stream file", file=self.files[fi]):
            # the one seam where disk flakiness enters streaming: a
            # transient read/decode error retries with backoff instead of
            # aborting an hours-long fit (the Spark task-retry analogue)
            def _read():
                fault_point(FAULT_READ)
                return read_game_data(
                    [self.files[fi]],
                    self.shard_configs,
                    index_maps=self.index_maps,
                    id_tags=self.id_tags,
                    **self.read_kwargs,
                )

            data, _, _ = DEFAULT_IO_RETRY.run("stream.read_part_file", _read)
        # sort each shard's COO by (row, col) once here: block assembly
        # then slices row ranges by binary search instead of masking the
        # whole file, and ELL packing skips its per-block lexsort
        for shard in data.feature_shards.values():
            r, c = shard.rows, shard.cols
            if r.size and not bool(np.all(
                (r[1:] > r[:-1]) | ((r[1:] == r[:-1]) & (c[1:] >= c[:-1]))
            )):
                order = np.lexsort((c, r))
                shard.rows = r[order]
                shard.cols = c[order]
                shard.vals = shard.vals[order]
        with self._lock:
            self.files_decoded += 1
            self._work_s += time.perf_counter() - t0
        return data

    def _cache_insert(self, fi: int, data) -> None:
        with self._lock:
            self._file_cache[fi] = data
            while len(self._file_cache) > self._cache_limit:
                self._file_cache.pop(next(iter(self._file_cache)))

    def _decode_file(self, fi: int, cache: bool = True):
        with self._lock:
            cached = self._file_cache.pop(fi, None)
            if cached is not None:
                self._file_cache[fi] = cached  # re-insert: most recently used
                # RAM level of the residency hierarchy: a decoded-file LRU
                # hit is an Avro decode that never happened
                self.file_cache_hits += 1
                return cached
            fut = self._pending.get(fi)
        if fut is not None:
            try:
                return fut.result()  # the pool job inserts into the cache
            except Exception as exc:  # noqa: BLE001 - degraded mode below
                # pool decode failed even after its own retries: fall back
                # to a synchronous decode on this (consumer) thread — one
                # more independent attempt before the failure is permanent
                record_failure(
                    "prefetch_decode_failed",
                    "stream.read_part_file",
                    f"{type(exc).__name__}: {exc}; retrying synchronously",
                    file=self.files[fi],
                )
        data = self._decode_now(fi)
        if cache:
            self._cache_insert(fi, data)
        return data

    def prefetch_files(self, fis: Sequence[int]) -> None:
        """Schedule background decodes of the named part files on the decode
        pool (no-op when ``decode_workers`` is 0). The readahead window also
        widens the LRU so a prefetched file is not evicted before its blocks
        are consumed — decoded-file residency is the time/memory tradeoff of
        parallel decode."""
        if self.decode_workers <= 0:
            return
        with self._lock:
            self._cache_limit = max(self.file_cache_size, len(fis) + 1)
            todo = [
                fi for fi in fis
                if fi not in self._file_cache and fi not in self._pending
            ]
            if not todo:
                return
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.decode_workers,
                    thread_name_prefix="stream-decode",
                )
            for fi in todo:
                self._pending[fi] = self._pool.submit(self._prefetch_job, fi)

    def _prefetch_job(self, fi: int):
        try:
            data = self._decode_now(fi)
            self._cache_insert(fi, data)
            return data
        finally:
            with self._lock:
                self._pending.pop(fi, None)

    def prefetch_blocks(
        self, indices: Sequence[int], shards: Optional[Sequence[str]] = None
    ) -> None:
        """Cache-aware readahead: schedule file decodes for the named
        blocks, skipping any block the block cache already holds — the
        cache is consulted BEFORE the Avro decode pool, so a fully warm
        epoch never schedules a decode. The scheduled file list is capped
        at :func:`readahead_file_budget` + 1 regardless of how many blocks
        the caller names (blocks spanning many small files must not blow
        the decoded-file residency bound); dropped files simply decode on
        demand when their block is built."""
        want = tuple(shards) if shards is not None else tuple(self.shard_configs)
        budget = readahead_file_budget() + 1  # +1: the file being consumed
        fis: List[int] = []
        for b in indices:
            if self.cache is not None and self.cache.has(int(b), want):
                continue
            for fi, _, _ in self.plan.spans(int(b)):
                if fi not in fis:
                    fis.append(fi)
            if len(fis) >= budget:
                break
        if fis:
            self.prefetch_files(fis[:budget])

    # -- block assembly ----------------------------------------------------

    def build_block(
        self, index: int, shards: Optional[Sequence[str]] = None
    ) -> Optional[HostBlock]:
        """Assemble one padded HostBlock (host numpy only). ``shards``
        restricts ELL packing to the named feature shards (the streamed
        fixed-effect coordinate only needs its own). With a block cache
        attached, a valid cached entry is returned as zero-copy memmap
        views (no Avro work at all); otherwise the block is decoded and
        spilled so the NEXT visit hits.

        A permanently failing block (decode retries exhausted) either
        propagates (``on_block_error='abort'``, the default) or — under
        ``'skip'`` — is recorded, excluded from future gap scheduling,
        and returned as ``None`` (iteration drops it)."""
        want = tuple(shards) if shards is not None else tuple(self.shard_configs)
        try:
            fault_point(FAULT_BUILD)
            if self.cache is not None:
                blk = self.cache.load(index, want)
                if blk is not None:
                    return blk
            blk = self._build_block_decode(index, want)
        except Exception as exc:  # noqa: BLE001 - policy decides below
            if self.on_block_error != "skip":
                raise
            self._note_skipped(index, exc)
            return None
        if self.cache is not None:
            self.cache.store(blk, want)
        return blk

    def _note_skipped(self, index: int, exc: BaseException) -> None:
        with self._lock:
            self.failed_blocks.add(int(index))
            self._skipped_log.append(
                {
                    "block": int(index),
                    "error": f"{type(exc).__name__}: {exc}",
                }
            )
        record_failure(
            "block_skipped",
            "stream.build_block",
            f"block {int(index)}: {type(exc).__name__}: {exc}",
            block=int(index),
        )

    def drain_skipped_blocks(self) -> List[dict]:
        """Skip records accumulated since the last drain (the streamed
        coordinate forwards them to the progress ledger)."""
        with self._lock:
            out, self._skipped_log = self._skipped_log, []
        return out

    def _build_block_decode(
        self, index: int, want: Tuple[str, ...]
    ) -> HostBlock:
        """The decode path: pull file pieces through the LRU/pool and pack
        each piece's COO slice DIRECTLY into the block's preallocated ELL
        staging buffers (pieces are row-disjoint, so piecewise packing is
        exact and the per-block COO concatenation copy is gone)."""
        plan = self.plan
        start, stop = plan.block_bounds(index)
        num_real = stop - start
        b = plan.block_rows

        labels = np.zeros(b, dtype=np.float32)
        offsets = np.zeros(b, dtype=np.float32)
        weights = np.zeros(b, dtype=np.float32)  # padding stays weight 0
        tag_parts: Dict[str, List[np.ndarray]] = {t: [] for t in self.id_tags}
        packed: Dict[str, Tuple[np.ndarray, np.ndarray]] = {
            sid: (
                np.zeros((b, plan.shard_widths[sid]), dtype=np.float32),
                np.zeros((b, plan.shard_widths[sid]), dtype=np.int32),
            )
            for sid in want
        }

        out_row = 0
        t_build = 0.0
        self._wall_enter()
        t0 = time.perf_counter()
        try:
            for fi, lo, hi in plan.spans(index):
                t_build += time.perf_counter() - t0
                piece = self._decode_file(fi)
                t0 = time.perf_counter()
                n_piece = hi - lo
                sl = slice(lo, hi)
                labels[out_row:out_row + n_piece] = piece.labels[sl]
                offsets[out_row:out_row + n_piece] = piece.offsets[sl]
                weights[out_row:out_row + n_piece] = piece.weights[sl]
                for t in self.id_tags:
                    tag_parts[t].append(np.asarray(piece.id_tags[t])[sl])
                for sid in want:
                    shard = piece.feature_shards[sid]
                    r = shard.rows
                    if r.size and bool(np.all(r[1:] >= r[:-1])):
                        # decoder COO is row-major: slice by binary search
                        # instead of masking the whole file's triplets
                        i0, i1 = np.searchsorted(r, (lo, hi))
                        rr = r[i0:i1] - lo + out_row
                        cc, vv = shard.cols[i0:i1], shard.vals[i0:i1]
                    else:
                        keep = (r >= lo) & (r < hi)
                        rr = r[keep] - lo + out_row
                        cc, vv = shard.cols[keep], shard.vals[keep]
                    pack_ell_into(
                        rr, cc, vv, packed[sid][0], packed[sid][1],
                        num_cols=plan.shard_dims[sid],
                    )
                out_row += n_piece
            t_build += time.perf_counter() - t0
        finally:
            self._wall_exit()
        self._add_work(t_build)
        id_tags = {
            t: (np.concatenate(v) if v else np.zeros(0, dtype=object))
            for t, v in tag_parts.items()
        }
        # freeze: cache hits are read-only memmap views, so the decode path
        # must fail in-place writes identically (HostBlock contract)
        for arr in (labels, offsets, weights, *id_tags.values()):
            arr.flags.writeable = False
        for vals, idx in packed.values():
            vals.flags.writeable = False
            idx.flags.writeable = False
        return HostBlock(
            index=index,
            start=start,
            num_real=num_real,
            labels=labels,
            offsets=offsets,
            weights=weights,
            shards=packed,
            id_tags=id_tags,
        )

    def iter_blocks(
        self,
        order: Optional[Sequence[int]] = None,
        shards: Optional[Sequence[str]] = None,
    ) -> Iterator[HostBlock]:
        """Yield HostBlocks in ``order`` (default: sequential). Sequential
        order decodes each part file exactly once thanks to the LRU;
        arbitrary shuffled orders may re-decode. Callers that control the
        order (the gap scheduler, custom samplers) should pass it through
        :func:`group_by_part_file` first — same visit set, same-file
        blocks adjacent — so each part file is decoded at most once per
        pass; any residual re-decode cost stays visible in the io phase
        of the telemetry report."""
        indices = range(self.plan.num_blocks) if order is None else order
        for i in indices:
            with span("read stream block", block=int(i)):
                blk = self.build_block(int(i), shards=shards)
            if blk is not None:
                yield blk

    # -- whole-dataset row planes (setup pass) ----------------------------

    def row_planes(self, coo_shards: Sequence[str] = ()) -> RowPlanes:
        """One streamed setup pass accumulating the per-row scalar planes
        (labels/offsets/weights/id tags) and, optionally, the full COO of
        the named (small, per-entity) shards for random-effect grouping.
        Cached: a later call asking for shards the cache lacks re-runs the
        setup pass for the union."""
        if self._row_planes is not None:
            missing = set(coo_shards) - set(self._row_planes.shard_coo)
            if not missing:
                return self._row_planes
            coo_shards = sorted(set(coo_shards) | set(self._row_planes.shard_coo))
            self._row_planes = None
        labels, offsets, weights = [], [], []
        tags: Dict[str, List[np.ndarray]] = {t: [] for t in self.id_tags}
        coo: Dict[str, List[Tuple[np.ndarray, np.ndarray, np.ndarray]]] = {
            sid: [] for sid in coo_shards
        }
        base = 0
        budget = readahead_file_budget()
        with span("read stream row planes", shards=len(list(coo_shards))):
            for fi in range(len(self.files)):
                # the next files decode on the pool while this one is read
                self.prefetch_files(range(fi, min(len(self.files), fi + 1 + budget)))
                piece = self._decode_file(fi)
                labels.append(piece.labels)
                offsets.append(piece.offsets)
                weights.append(piece.weights)
                for t in self.id_tags:
                    tags[t].append(np.asarray(piece.id_tags[t]))
                for sid in coo_shards:
                    shard = piece.feature_shards[sid]
                    coo[sid].append((shard.rows + base, shard.cols, shard.vals))
                base += piece.num_rows
        self._row_planes = RowPlanes(
            labels=np.concatenate(labels),
            offsets=np.concatenate(offsets),
            weights=np.concatenate(weights),
            id_tags={t: np.concatenate(v) for t, v in tags.items()},
            shard_coo={
                sid: (
                    np.concatenate([p[0] for p in v]) if v else np.zeros(0, np.int64),
                    np.concatenate([p[1] for p in v]) if v else np.zeros(0, np.int64),
                    np.concatenate([p[2] for p in v]) if v else np.zeros(0, np.float32),
                    self.plan.shard_dims[sid],
                )
                for sid, v in coo.items()
            },
        )
        return self._row_planes

    def block_feature_bytes(self, shard: str) -> int:
        """Host bytes of ONE staged block of ``shard`` (f32 values + i32
        indices) — the unit the prefetch-depth RSS bound multiplies."""
        k = self.plan.shard_widths[shard]
        return self.plan.block_rows * k * 8

    def block_upload_bytes(self, shards: Optional[Sequence[str]] = None) -> int:
        """H2D bytes of ONE uploaded block restricted to ``shards``
        (default: all): the per-row scalar planes (labels/offsets/weights,
        f32 each) plus each shard's ELL payload as it crosses the link
        (f32 values + i32 indices). Block shapes are fixed by the plan, so
        this is uniform across blocks — the residency plane's byte budget
        divides by it exactly."""
        want = tuple(shards) if shards is not None else tuple(self.shard_configs)
        b = self.plan.block_rows
        total = 3 * b * 4
        for sid in want:
            total += b * self.plan.shard_widths[sid] * 8
        return total

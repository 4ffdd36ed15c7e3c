"""Double-buffered host→device block prefetcher.

Port of ``photon_ml_tpu/streaming/prefetch.py``. A background thread
assembles and ELL-packs HostBlocks into a bounded queue of depth
``prefetch_depth`` (the staging queue). The part-file decodes are scheduled
ahead of the assembly cursor on the source's decode pool
(``decode_workers`` threads; the native columnar decoder runs without the
interpreter lock), so several files decode while the consumer pops a
staged block, uploads it and the device solves block *k*. Host memory for
staged feature payloads is bounded by ``prefetch_depth × block bytes`` by
the queue itself, plus the decoded readahead files held by the source's LRU.

The upload (``_to_device``) on the card: the block's arrays are copied into
one slot of a ring of pinned host buffers (HostBlocks are read-only: cache
hits are views over ``mode='r'`` memmaps, decoded blocks are frozen), the
slot crosses the link in ONE ``non_blocking`` copy on a copy stream of the
prefetcher's own, the int32 indices are widened to int64 there (the bytes
that cross are the JAX package's: f32 values, int32 indices), and an event
recorded after that work is what the consumer's stream waits on; the
tensors handed over carry ``record_stream`` for the consumer's stream. A
slot is written again only after the event of the copy out of it has
completed. On the host (``device="cpu"``) the same buffer layout is filled
in ordinary memory, a fresh buffer a block.

Telemetry: decode runs under ``read stream block`` spans, consumer stalls
under ``read stream wait``, uploads under ``stream h2d transfer``. The
registry gains ``stream.blocks`` / ``stream.decode_s`` /
``stream.decode_work_s`` / ``stream.stall_s`` / ``stream.transfer_s`` /
``stream.upload_hidden_s`` / ``stream.h2d_bytes`` /
``stream.cache_hit_blocks`` / ``stream.cache_load_s`` counters and the
``stream.prefetch_hide_ratio`` gauge, under the JAX package's names.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.device import DEFAULT_DEVICE, DeviceLike, resolve_device
from photon_ml_tpu_torch.ops.data import LabeledData
from photon_ml_tpu_torch.ops.features import EllFeatures
from photon_ml_tpu_torch.resilience.failures import record_failure
from photon_ml_tpu_torch.streaming.blocks import (
    HostBlock,
    StreamingSource,
    readahead_file_budget,
)
from photon_ml_tpu_torch.telemetry import get_registry, span

_DONE = object()


@dataclasses.dataclass
class DeviceBlock:
    """One device-resident block: fixed-shape LabeledData per shard plus
    the block's place in the global row space."""

    index: int
    start: int
    num_real: int
    data: Dict[str, LabeledData]   # shard -> [block_rows] LabeledData
    weight_sum: float              # Σ real weights (stochastic l2 scaling)


@dataclasses.dataclass
class PrefetchStats:
    """Wall-clock accounting of one streamed pass.

    ``decode_s`` is WALL time with at least one decode in flight;
    ``decode_work_s`` is the per-thread SUM — with N parallel workers the
    sum can be ~N× the wall, which is why the hide ratio is defined over
    wall."""

    blocks: int = 0
    decode_s: float = 0.0        # decode wall clock (>=1 decode in flight)
    decode_work_s: float = 0.0   # summed per-thread decode+pack seconds
    stall_s: float = 0.0         # consumer time blocked waiting for a block
    transfer_s: float = 0.0      # staging copy + upload dispatch (all uploads)
    upload_hidden_s: float = 0.0  # uploads dispatched while solve in flight
    h2d_bytes: int = 0           # bytes actually crossing host->device
    cache_hit_blocks: int = 0    # blocks served from the block cache
    cache_load_s: float = 0.0    # wall seconds mapping+validating entries
    # HBM residency plane (streaming/residency.py): blocks this pass served
    # straight from the device-resident set — uploads that never happened.
    # Written by the streamed coordinate, which owns the resident/streamed
    # merge; the prefetcher itself only ever sees the non-resident order.
    resident_hit_blocks: int = 0
    resident_hit_bytes: int = 0  # H2D bytes those hits avoided
    # per-block duality-gap estimates of the most recent streamed solve's
    # final pass (block index -> gap), written by the streaming coordinate
    # when the convergence plane is on
    block_gaps: Optional[Dict[int, float]] = None

    @property
    def hide_ratio(self) -> float:
        """WALL-based: fraction of decode wall clock that did NOT surface
        as a consumer stall. A fully cached pass has decode_s == 0 — all
        data movement hidden — and reads 1.0."""
        if self.decode_s <= 0:
            return 1.0
        return max(0.0, (self.decode_s - self.stall_s) / self.decode_s)

    @property
    def decode_parallelism(self) -> float:
        """Achieved decode-pool parallelism: summed per-thread decode work
        over decode wall clock. 1.0 means fully serial; ~N means N workers
        genuinely overlapped. 0.0 when no decode ran (fully cached pass)."""
        if self.decode_s <= 0:
            return 0.0
        return self.decode_work_s / self.decode_s


def _block_arrays(blk: HostBlock) -> List[Tuple[str, np.ndarray]]:
    """The arrays of a block in upload order: the row planes, then each
    shard's values and indices (sorted by shard, as the block cache lays
    them out)."""
    arrays = [("labels", blk.labels), ("offsets", blk.offsets), ("weights", blk.weights)]
    for sid in sorted(blk.shards):
        vals, idx = blk.shards[sid]
        arrays.append((f"{sid}:vals", vals))
        arrays.append((f"{sid}:idx", idx))
    return arrays


class _PinnedRing:
    """Pinned host staging slots of one prefetcher, each with the event of
    the last copy out of it; a slot is handed out again only once that
    copy has completed (a reused slot still being read would upload a
    wrong block, not fail)."""

    def __init__(self, slots: int) -> None:
        self._slots: List[Optional[Tuple[torch.Tensor, Optional[torch.cuda.Event]]]] = (
            [None] * max(2, slots)
        )
        self._next = 0

    def take(self, nbytes: int) -> Tuple[int, torch.Tensor]:
        i = self._next
        self._next = (i + 1) % len(self._slots)
        slot = self._slots[i]
        if slot is None or slot[0].numel() != nbytes:
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            self._slots[i] = (buf, None)
            return i, buf
        buf, event = slot
        if event is not None:
            event.synchronize()
        return i, buf

    def release(self, i: int, event: torch.cuda.Event) -> None:
        self._slots[i] = (self._slots[i][0], event)


class BlockPrefetcher:
    """Iterate a StreamingSource's blocks with background decode, uploaded
    to ``device`` (default ``cuda``; raises without a card unless
    ``device="cpu"``).

    ``depth=0`` disables the thread (synchronous decode — the debugging /
    determinism baseline); ``depth>=1`` double-buffers with a staging queue
    of that size.
    """

    def __init__(
        self,
        source: StreamingSource,
        shards: Optional[Sequence[str]] = None,
        depth: int = 2,
        order: Optional[Sequence[int]] = None,
        device: DeviceLike = DEFAULT_DEVICE,
    ):
        self.source = source
        self.shards = tuple(shards) if shards is not None else None
        self.depth = int(depth)
        self.order = list(order) if order is not None else None
        self.device = resolve_device(device)
        self.stats = PrefetchStats()
        if self.depth < 0:
            raise ValueError(f"prefetch depth must be >= 0, got {depth}")
        self._ring: Optional[_PinnedRing] = None
        self._copy_stream = None

    # -- host->device -----------------------------------------------------

    def _staging(self, nbytes: int) -> Tuple[Optional[int], torch.Tensor]:
        if self.device.type != "cuda":
            return None, torch.empty(nbytes, dtype=torch.uint8)
        if self._ring is None:
            self._ring = _PinnedRing(self.depth + 1)
            self._copy_stream = torch.cuda.Stream(self.device)
        return self._ring.take(nbytes)

    def _to_device(self, blk: HostBlock) -> DeviceBlock:
        t0 = time.perf_counter()
        arrays = _block_arrays(blk)
        # indices cross as int32 (the host dtype, as in the JAX package), so
        # these bytes are what the link carries and what residency budgets
        nbytes = sum(int(a.size) * 4 for _, a in arrays)
        with span("stream h2d transfer", block=blk.index, bytes=int(nbytes)):
            slot, host = self._staging(nbytes)
            staged = host.numpy()
            spans: Dict[str, Tuple[int, int]] = {}
            at = 0
            for name, arr in arrays:
                n = int(arr.size) * 4
                dtype = np.int32 if name.endswith(":idx") else np.float32
                np.copyto(staged[at:at + n].view(dtype).reshape(arr.shape), arr,
                          casting="same_kind")
                spans[name] = (at, n)
                at += n
            data = self._upload(host, slot, spans, blk)
        dt = time.perf_counter() - t0
        self.stats.transfer_s += dt
        self.stats.h2d_bytes += int(nbytes)
        if self.stats.blocks > 1:
            # the copy is queued on the copy stream while the consumer's
            # stream still works on the previous block: the H2D/compute
            # overlap measured as stream.upload_hidden_s
            self.stats.upload_hidden_s += dt
        return DeviceBlock(
            index=blk.index, start=blk.start, num_real=blk.num_real,
            data=data, weight_sum=float(blk.weights.sum()),
        )

    def _upload(self, host: torch.Tensor, slot: Optional[int],
                spans: Dict[str, Tuple[int, int]], blk: HostBlock) -> Dict[str, LabeledData]:
        if self.device.type == "cuda":
            consumer = torch.cuda.current_stream(self.device)
            # the copy stream does not wait for the consumer: its buffers
            # are fresh allocations, kept from reuse by record_stream
            with torch.cuda.stream(self._copy_stream):
                dev = host.to(self.device, non_blocking=True)
                views, widened = self._views(dev, spans)
                done = torch.cuda.Event()
                done.record(self._copy_stream)
            consumer.wait_event(done)
            for t in (dev, *widened):
                t.record_stream(consumer)
            self._ring.release(slot, done)
        else:
            views, _ = self._views(host, spans)
        b = blk.labels.shape[0]
        labels, offsets, weights = views["labels"], views["offsets"], views["weights"]
        data: Dict[str, LabeledData] = {}
        for sid in blk.shards:
            k = blk.shards[sid][0].shape[1]
            feats = EllFeatures(
                values=views[f"{sid}:vals"].view(b, k),
                indices=views[f"{sid}:idx"].view(b, k),
                num_cols=self.source.plan.shard_dims[sid],
            )
            data[sid] = LabeledData(features=feats, labels=labels,
                                    offsets=offsets, weights=weights)
        return data

    @staticmethod
    def _views(buf: torch.Tensor, spans):
        """Typed views of the staged bytes; the int32 indices widened to
        the int64 that torch.gather takes (on the copy stream on the
        card). Returns (views by name, the widened tensors)."""
        views, widened = {}, []
        for name, (at, n) in spans.items():
            raw = buf[at:at + n]
            if name.endswith(":idx"):
                wide = raw.view(torch.int32).to(torch.int64)
                widened.append(wide)
                views[name] = wide
            else:
                views[name] = raw.view(torch.float32)
        return views, widened

    # -- iteration --------------------------------------------------------

    def __iter__(self) -> Iterator[DeviceBlock]:
        work0 = self.source.work_seconds
        wall0 = self.source.decode_wall_seconds
        cache = self.source.cache
        hits0 = cache.stats.hits if cache is not None else 0
        load0 = cache.stats.load_s if cache is not None else 0.0
        try:
            if self.depth == 0:
                yield from self._iter_sync()
            else:
                yield from self._iter_threaded()
        finally:
            # differencing the source's counters attributes exactly this
            # pass's decode, whichever thread ran it
            self.stats.decode_s += self.source.decode_wall_seconds - wall0
            self.stats.decode_work_s += self.source.work_seconds - work0
            if cache is not None:
                self.stats.cache_hit_blocks += cache.stats.hits - hits0
                self.stats.cache_load_s += cache.stats.load_s - load0
        reg = get_registry()
        reg.count("stream.blocks", self.stats.blocks)
        reg.count("stream.decode_s", self.stats.decode_s)
        reg.count("stream.decode_work_s", self.stats.decode_work_s)
        reg.count("stream.stall_s", self.stats.stall_s)
        reg.count("stream.transfer_s", self.stats.transfer_s)
        reg.count("stream.upload_hidden_s", self.stats.upload_hidden_s)
        reg.count("stream.h2d_bytes", self.stats.h2d_bytes)
        reg.count("stream.cache_hit_blocks", self.stats.cache_hit_blocks)
        reg.count("stream.cache_load_s", self.stats.cache_load_s)
        reg.gauge("stream.prefetch_hide_ratio", self.stats.hide_ratio)
        if self.stats.decode_s > 0:
            reg.gauge("stream.decode_parallelism", self.stats.decode_parallelism)

    def _block_order(self):
        if self.order is not None:
            return list(self.order)
        return list(range(self.source.plan.num_blocks))

    def _readahead(self, order, pos) -> None:
        """Schedule background decode of the files the next few blocks
        need; window = min(decode workers, readahead file budget) + queue
        depth, so the pool stays fed but decoded-file residency stays
        bounded by the budget. Cache-aware: blocks the block cache already
        holds schedule nothing."""
        window = (
            min(self.source.decode_workers, readahead_file_budget())
            + max(1, self.depth)
        )
        self.source.prefetch_blocks(order[pos:pos + window], shards=self.shards)

    def _iter_sync(self) -> Iterator[DeviceBlock]:
        it = self.source.iter_blocks(order=self.order, shards=self.shards)
        while True:
            t0 = time.perf_counter()
            try:
                blk = next(it)
            except StopIteration:
                break
            dt = time.perf_counter() - t0
            # synchronous mode: decode time is fully exposed, count it as
            # a stall so hide_ratio reads 0 honestly
            self.stats.stall_s += dt
            self.stats.blocks += 1
            yield self._to_device(blk)

    def _iter_threaded(self) -> Iterator[DeviceBlock]:
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        order = self._block_order()

        def worker() -> None:
            pos = 0
            try:
                for pos, b in enumerate(order):
                    if stop.is_set():
                        break
                    self._readahead(order, pos)
                    with span("read stream block", block=int(b)):
                        blk = self.source.build_block(int(b), shards=self.shards)
                    if blk is not None:  # None = skipped (on_block_error)
                        q.put((pos, blk))
                q.put(_DONE)
            except BaseException as e:  # degraded mode: consumer takes over
                q.put((pos, e))

        t = threading.Thread(
            target=worker, name="stream-prefetch", daemon=True
        )
        t.start()
        try:
            while True:
                t0 = time.perf_counter()
                if q.empty():
                    with span("read stream wait"):
                        item = q.get()
                    self.stats.stall_s += time.perf_counter() - t0
                else:
                    item = q.get()
                if item is _DONE:
                    break
                pos, payload = item
                if isinstance(payload, BaseException):
                    # the prefetch thread died past build_block's own
                    # retries: finish the pass with synchronous decodes on
                    # this thread (one more independent attempt per block;
                    # a truly permanent failure still raises here, under
                    # whatever on_block_error policy the source carries)
                    record_failure(
                        "prefetch_worker_failed",
                        "stream.prefetch",
                        f"{type(payload).__name__}: {payload}; falling back"
                        f" to synchronous decode for {len(order) - pos}"
                        " remaining blocks",
                    )
                    for b in order[pos:]:
                        with span("read stream block", block=int(b)):
                            blk = self.source.build_block(
                                int(b), shards=self.shards
                            )
                        if blk is None:
                            continue
                        self.stats.blocks += 1
                        yield self._to_device(blk)
                    break
                self.stats.blocks += 1
                yield self._to_device(payload)
        finally:
            stop.set()
            # drain so a blocked worker can observe the stop flag and exit
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5.0)

"""Serving metrics: latency percentiles, queue depth, batch fill, cache hits.

The batcher feeds per-request latencies (enqueue → scored) and per-batch
fill/queue observations; ``snapshot`` renders everything as one plain dict
so it can be logged, JSON-dumped by the CLI/bench, or attached to a
``ScoringFinishEvent``. Latencies additionally land in a fixed log-spaced
histogram (100µs … 10s) whose bucket counts are EXACT for the lifetime of
the collector.

Memory is bounded: a long-lived scorer observes millions of requests, so
raw per-observation lists would grow without limit. Percentile estimates
come from fixed-size uniform reservoirs (Vitter's Algorithm R); counts,
sums, maxima, and the histogram are exact running aggregates.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np

# log-spaced upper bounds, seconds: 1e-4 .. 1e1 (8 per decade is plenty to
# localize a p99 shift; the exact percentiles come from the raw samples)
LATENCY_BUCKET_BOUNDS = tuple(
    float(b) for b in np.logspace(-4, 1, num=5 * 8 + 1)
)

# Reservoir capacity for percentile estimation. Below this many
# observations the samples are exact; beyond it each kept sample is a
# uniform draw, so a p99 over 4096 samples has ~40 tail points — stable to
# well under a histogram bucket width.
RESERVOIR_SIZE = 4096


class _Reservoir:
    """Uniform fixed-size sample of a stream (Vitter's Algorithm R) plus
    exact running count/sum/max. Deterministic for a given observation
    sequence (seeded generator) so snapshots are reproducible in tests."""

    __slots__ = ("capacity", "count", "total", "maximum", "_samples", "_rng")

    def __init__(self, capacity: int = RESERVOIR_SIZE, seed: int = 0):
        self.capacity = int(capacity)
        self.count = 0
        self.total = 0.0
        self.maximum = 0.0
        self._samples: np.ndarray = np.empty(self.capacity, dtype=np.float64)
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return min(self.count, self.capacity)

    def add(self, value: float) -> None:
        value = float(value)
        if self.count == 0 or value > self.maximum:
            self.maximum = value
        self.total += value
        if self.count < self.capacity:
            self._samples[self.count] = value
        else:
            j = int(self._rng.integers(0, self.count + 1))
            if j < self.capacity:
                self._samples[j] = value
        self.count += 1

    def add_many(self, values: np.ndarray) -> None:
        """Vectorized :meth:`add` — one RNG draw per overflow element, same
        keep-probability as the sequential loop (later duplicates win, as
        they would one at a time). The batcher feeds per-batch latency
        arrays through this so steady-state metrics cost is O(batch), not
        O(requests) Python calls."""
        values = np.asarray(values, dtype=np.float64).ravel()
        m = values.size
        if m == 0:
            return
        vmax = float(values.max())
        if self.count == 0 or vmax > self.maximum:
            self.maximum = vmax
        self.total += float(values.sum())
        fill = min(self.capacity - self.count, m) if self.count < self.capacity else 0
        if fill > 0:
            self._samples[self.count:self.count + fill] = values[:fill]
        if m > fill:
            tail = values[fill:]
            prior = np.arange(
                self.count + fill, self.count + m, dtype=np.int64
            )
            j = self._rng.integers(0, prior + 1)
            keep = j < self.capacity
            if keep.any():
                self._samples[j[keep]] = tail[keep]
        self.count += m

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def samples(self) -> np.ndarray:
        return self._samples[: len(self)]

    def percentile(self, q) -> np.ndarray:
        """Percentile(s) of the kept sample. An EMPTY reservoir returns
        NaN shaped like ``q`` (scalar q -> scalar NaN, array q -> NaN
        array) instead of letting numpy raise — callers guard on
        ``count`` for display, but analysis paths may probe blind."""
        samples = self.samples()
        if samples.size == 0:
            return np.full(np.shape(q), np.nan)[()]
        return np.percentile(samples, q)


class ServingMetrics:
    def __init__(
        self,
        clock: Callable[[], float] = time.perf_counter,
        request_plane=None,
    ):
        self._clock = clock
        # request plane (serving/requestplane.py): hot-swap blackouts are
        # forwarded as interference spans so swap pauses show up in the
        # sampled requests' p99 breakdown instead of vanishing from every
        # latency attribution
        self.request_plane = request_plane
        self._latencies = _Reservoir(seed=0)
        self._hist = np.zeros(len(LATENCY_BUCKET_BOUNDS) + 1, dtype=np.int64)
        self._fill_real = 0
        self._fill_padded = 0
        self._queue_depth_sum = 0
        self._queue_depth_count = 0
        self._queue_depth_max = 0
        self._queue_waits = _Reservoir(seed=1)
        # per-bucket-size latency reservoirs: which bucket a request drained
        # through is the serving-side shape signature, so tail latency is
        # attributable per compiled program, not just in aggregate
        self._bucket_latencies: Dict[int, _Reservoir] = {}
        self.deferred_lookups = 0  # known entities awaiting device admission
        self.num_requests = 0
        self.num_batches = 0
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        # hot-swap counters (fed by serving.hotswap.HotSwapManager)
        self.num_swaps = 0
        self.num_rollbacks = 0
        self.rows_updated_total = 0
        self.current_generation = 0
        self._last_swap_blackout_s: Optional[float] = None
        self._max_swap_blackout_s = 0.0
        self._last_update_staleness_s: Optional[float] = None

    def observe_batch(
        self, n_real: int, bucket_size: int, queue_depth: int
    ) -> None:
        now = self._clock()
        if self._t_first is None:
            self._t_first = now
        self._t_last = now
        self.num_batches += 1
        self.num_requests += n_real
        self._fill_real += n_real
        self._fill_padded += bucket_size
        self._queue_depth_sum += int(queue_depth)
        self._queue_depth_count += 1
        self._queue_depth_max = max(self._queue_depth_max, int(queue_depth))

    def observe_latency(
        self, seconds: float, bucket_size: Optional[int] = None
    ) -> None:
        self._latencies.add(seconds)
        self._hist[np.searchsorted(LATENCY_BUCKET_BOUNDS, seconds)] += 1
        if bucket_size is not None:
            self._bucket_reservoir(bucket_size).add(seconds)

    def observe_latencies(
        self, seconds: np.ndarray, bucket_size: Optional[int] = None
    ) -> None:
        """Batched :meth:`observe_latency`: one call per drained batch."""
        seconds = np.asarray(seconds, dtype=np.float64).ravel()
        if seconds.size == 0:
            return
        self._latencies.add_many(seconds)
        np.add.at(
            self._hist, np.searchsorted(LATENCY_BUCKET_BOUNDS, seconds), 1
        )
        if bucket_size is not None:
            self._bucket_reservoir(bucket_size).add_many(seconds)

    def _bucket_reservoir(self, bucket_size: int) -> _Reservoir:
        res = self._bucket_latencies.get(int(bucket_size))
        if res is None:
            # deterministic per-bucket seed so snapshots are reproducible
            res = _Reservoir(seed=100 + int(bucket_size))
            self._bucket_latencies[int(bucket_size)] = res
        return res

    def observe_queue_wait(self, seconds: float) -> None:
        """Time a request sat in the batcher queue before its batch was
        drained — tracked separately from total latency so queueing policy
        (deadline vs. fill) is visible independently of scoring cost."""
        self._queue_waits.add(seconds)

    def observe_queue_waits(self, seconds: np.ndarray) -> None:
        self._queue_waits.add_many(np.asarray(seconds, dtype=np.float64))

    def observe_deferred(self, count: int) -> None:
        """RE lookups that found a known entity not yet device-resident —
        served FE-only this request, queued for asynchronous admission."""
        self.deferred_lookups += int(count)

    def observe_swap(
        self,
        generation: int,
        rows_updated: int,
        blackout_s: float,
        staleness_s: Optional[float] = None,
        rolled_back: bool = False,
    ) -> None:
        """One hot-swap attempt. ``blackout_s`` is the time the scorer's
        tables were mid-flip (no requests may run); ``staleness_s`` is
        swap-visible time minus the update's event-batch timestamp — how old
        the freshest served coefficients are at the moment they go live."""
        self.num_swaps += 1
        self._last_swap_blackout_s = float(blackout_s)
        self._max_swap_blackout_s = max(
            self._max_swap_blackout_s, float(blackout_s)
        )
        if self.request_plane is not None and blackout_s > 0:
            # the swap manager calls this right after its critical section,
            # so the pause window is [now - blackout, now] on the shared
            # perf_counter timebase — in-flight and queued sampled requests
            # overlap it and attribute the pause as swap_pause interference
            end = self._clock()
            self.request_plane.note_interference(
                "swap_pause", end - float(blackout_s), end
            )
        if rolled_back:
            self.num_rollbacks += 1
            return
        self.current_generation = int(generation)
        self.rows_updated_total += int(rows_updated)
        if staleness_s is not None:
            self._last_update_staleness_s = float(staleness_s)

    def snapshot(
        self,
        cache_stats: Optional[Dict[str, Dict[str, float]]] = None,
        compile_count: Optional[int] = None,
        residency: Optional[Dict[str, Dict[str, float]]] = None,
        admission: Optional[Dict[str, float]] = None,
    ) -> dict:
        out: dict = {
            "num_requests": self.num_requests,
            "num_batches": self.num_batches,
            "batch_fill_ratio": (
                round(self._fill_real / self._fill_padded, 6)
                if self._fill_padded
                else 0.0
            ),
            "queue_depth_mean": (
                round(self._queue_depth_sum / self._queue_depth_count, 3)
                if self._queue_depth_count
                else 0.0
            ),
            "queue_depth_max": self._queue_depth_max,
        }
        if self._latencies.count:
            # percentiles from the reservoir sample (exact below capacity);
            # mean/max are exact running aggregates
            p50, p95, p99 = self._latencies.percentile([50, 95, 99])
            out.update(
                latency_p50_s=round(float(p50), 6),
                latency_p95_s=round(float(p95), 6),
                latency_p99_s=round(float(p99), 6),
                latency_mean_s=round(self._latencies.mean, 6),
                latency_max_s=round(self._latencies.maximum, 6),
            )
            nz = np.nonzero(self._hist)[0]
            out["latency_histogram"] = {
                (
                    f"le_{LATENCY_BUCKET_BOUNDS[i]:.6g}s"
                    if i < len(LATENCY_BUCKET_BOUNDS)
                    else "inf"
                ): int(self._hist[i])
                for i in nz
            }
        if self._bucket_latencies:
            # one entry per compiled program signature (bucket size): the
            # serving analogue of per-kernel attribution
            per_bucket: dict = {}
            for size in sorted(self._bucket_latencies):
                res = self._bucket_latencies[size]
                if not res.count:
                    continue
                b50, b95, b99 = res.percentile([50, 95, 99])
                per_bucket[str(size)] = {
                    "count": res.count,
                    "latency_p50_s": round(float(b50), 6),
                    "latency_p95_s": round(float(b95), 6),
                    "latency_p99_s": round(float(b99), 6),
                    "latency_max_s": round(res.maximum, 6),
                }
            if per_bucket:
                out["per_bucket_latency"] = per_bucket
        if self._queue_waits.count:
            q50, q99 = self._queue_waits.percentile([50, 99])
            out.update(
                queue_wait_p50_s=round(float(q50), 6),
                queue_wait_p99_s=round(float(q99), 6),
                queue_wait_max_s=round(self._queue_waits.maximum, 6),
            )
        if self.deferred_lookups:
            out["deferred_lookups"] = self.deferred_lookups
            if self.num_requests:
                out["deferred_rate"] = round(
                    self.deferred_lookups / self.num_requests, 6
                )
        if self.num_swaps:
            out["swaps"] = {
                "num_swaps": self.num_swaps,
                "num_rollbacks": self.num_rollbacks,
                "current_generation": self.current_generation,
                "rows_updated_total": self.rows_updated_total,
                "last_blackout_s": (
                    round(self._last_swap_blackout_s, 6)
                    if self._last_swap_blackout_s is not None
                    else None
                ),
                "max_blackout_s": round(self._max_swap_blackout_s, 6),
                "last_staleness_s": (
                    round(self._last_update_staleness_s, 6)
                    if self._last_update_staleness_s is not None
                    else None
                ),
            }
        if self._t_first is not None and self._t_last > self._t_first:
            wall = self._t_last - self._t_first
            out["wall_seconds"] = round(wall, 6)
            out["requests_per_s"] = round(self.num_requests / wall, 3)
        if compile_count is not None:
            out["xla_compiles"] = int(compile_count)
        if cache_stats:
            out["caches"] = dict(cache_stats)
            hits = sum(c.get("hits", 0) for c in cache_stats.values())
            misses = sum(c.get("misses", 0) for c in cache_stats.values())
            out["cache_hit_rate"] = (
                round(hits / (hits + misses), 6) if hits + misses else 0.0
            )
        if residency:
            # device-resident fraction per RE coordinate: what share of
            # lookups hit rows already on device (replaces cache_hit_rate in
            # sharded mode, where there is no per-request host cache)
            out["residency"] = dict(residency)
            on = sum(r.get("resident_lookups", 0) for r in residency.values())
            tot = sum(r.get("total_lookups", 0) for r in residency.values())
            out["device_resident_rate"] = round(on / tot, 6) if tot else 0.0
        if admission:
            out["admission"] = dict(admission)
        return out

"""Process-global metrics registry: counters, gauges, histograms.

One :class:`MetricsRegistry` per process (via :func:`get_registry`)
absorbs every numeric signal the codebase already produces piecemeal —
``SolverStats``/``TransferStats`` from the optimizers, serving
latency/hit-rate snapshots, hot-swap blackouts — plus two new ones:

* **compile counting** — :func:`note_jit_trace` counts compiles under
  ``jit.traces.*``. The port has no tracing compiler: its one compile step
  is the ``nvcc`` build of a kernel library at first use
  (``utils/cudalib.py``), counted as ``jit.traces.nvcc/<library>``, so the
  counters move exactly on build-cache misses.
* **memory watermarks** — :func:`record_memory_watermarks` records the host
  peak RSS and each visible card's peak allocated bytes.

Histograms use a seeded bounded reservoir (Vitter's Algorithm R, the JAX
package's ``serving/metrics.py`` ``_Reservoir``), so percentile snapshots
are deterministic and memory stays fixed no matter how many observations
land. All mutators are thread-safe and cheap (one lock + dict update), so
the registry stays on even when span tracing is off.

Port of ``photon_ml_tpu/telemetry/metrics.py``; the metric names are the
same.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = [
    "MetricsRegistry",
    "ScopedMetrics",
    "get_registry",
    "note_jit_trace",
    "jit_trace_counts",
    "record_memory_watermarks",
]


def _parse_labels(labels) -> Dict[str, str]:
    """Label spec → dict: accepts a mapping or a ``"k=v"`` /
    ``"k=v,k2=v2"`` string (the ``scoped("tenant=a")`` shorthand)."""
    if isinstance(labels, str):
        out: Dict[str, str] = {}
        for part in labels.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(
                    f"label spec {labels!r}: expected 'key=value' parts"
                )
            k, v = part.split("=", 1)
            out[k.strip()] = v.strip()
        if not out:
            raise ValueError("label spec must name at least one label")
        return out
    return {str(k): str(v) for k, v in dict(labels).items()}


def _format_labels(labels: Dict[str, str]) -> str:
    """Canonical Prometheus label suffix ``{k="v",...}``: keys sorted so
    the same label set always produces the same metric name, values
    escaped per the exposition format."""
    parts = []
    for k in sorted(labels):
        v = (
            str(labels[k])
            .replace("\\", "\\\\")
            .replace('"', '\\"')
            .replace("\n", "\\n")
        )
        parts.append(f'{k}="{v}"')
    return "{" + ",".join(parts) + "}"


class ScopedMetrics:
    """Label-scoped view onto a :class:`MetricsRegistry`: every metric
    name written through it carries a fixed Prometheus label set
    (``serving.requests{tenant="a"}``). The underlying storage is the
    parent registry — scoped names land in the same counters/gauges/
    histograms dicts, render as proper labeled samples in ``/metrics``
    (see ``serving/introspect.py``), and never collide with the unlabeled
    base names. Views are cheap and stateless; build one per tenant."""

    def __init__(self, parent: "MetricsRegistry", labels):
        self._parent = parent
        self.labels = _parse_labels(labels)
        if not self.labels:
            raise ValueError("ScopedMetrics needs at least one label")
        self._suffix = _format_labels(self.labels)

    def scoped_name(self, name: str) -> str:
        """The labeled storage name a metric renders under."""
        return name + self._suffix

    def scoped(self, labels) -> "ScopedMetrics":
        """A further-scoped view (merged labels; new keys win)."""
        merged = dict(self.labels)
        merged.update(_parse_labels(labels))
        return ScopedMetrics(self._parent, merged)

    def count(self, name: str, value: float = 1.0) -> None:
        self._parent.count(self.scoped_name(name), value)

    def gauge(self, name: str, value: float) -> None:
        self._parent.gauge(self.scoped_name(name), value)

    def observe(self, name: str, value: float) -> None:
        self._parent.observe(self.scoped_name(name), value)

    def counter_value(self, name: str) -> float:
        return self._parent.counter_value(self.scoped_name(name))


# Reservoir capacity for percentile estimation. Below this many
# observations the samples are exact; beyond it each kept sample is a
# uniform draw, so a p99 over 4096 samples has ~40 tail points.
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


def _new_reservoir(seed: int) -> _Reservoir:
    return _Reservoir(seed=seed)


class MetricsRegistry:
    """Thread-safe named counters, gauges (last value + peak watermark),
    and reservoir-backed histograms."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._gauge_peaks: Dict[str, float] = {}
        self._hists: Dict[str, Any] = {}
        self._next_seed = 0

    # ----------------------------------------------------------- mutators
    def count(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)
            peak = self._gauge_peaks.get(name)
            if peak is None or value > peak:
                self._gauge_peaks[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            hist = self._hists.get(name)
            if hist is None:
                hist = _new_reservoir(seed=self._next_seed)
                self._next_seed += 1
                self._hists[name] = hist
            hist.add(value)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._gauge_peaks.clear()
            self._hists.clear()
            self._next_seed = 0

    def scoped(self, labels) -> ScopedMetrics:
        """A label-scoped view of this registry: ``scoped("tenant=a")``
        (or a mapping) returns a :class:`ScopedMetrics` whose writes land
        under Prometheus-labeled names. Existing unlabeled names are
        untouched."""
        return ScopedMetrics(self, labels)

    # ------------------------------------------------------------ readers
    def counter_value(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def snapshot(self) -> Dict[str, Any]:
        """Everything as one plain JSON-serializable dict."""
        with self._lock:
            counters = dict(self._counters)
            gauges = {
                name: {"last": value, "peak": self._gauge_peaks[name]}
                for name, value in self._gauges.items()
            }
            hists = {}
            for name, res in self._hists.items():
                entry = {
                    "count": int(res.count),
                    "mean": float(res.mean),
                    "max": float(res.maximum),
                }
                if len(res):
                    p50, p95, p99 = (
                        float(x) for x in res.percentile([50, 95, 99])
                    )
                    entry.update(p50=p50, p95=p95, p99=p99)
                hists[name] = entry
        return {"counters": counters, "gauges": gauges, "histograms": hists}

    # --------------------------------------------------------- absorbers
    def record_solver_stats(self, stats, coordinate: Optional[str] = None) -> None:
        """Fold a ``SolverStats`` (duck-typed; see opt/tracking.py) into
        solver.* counters/histograms."""
        prefix = f"solver.{coordinate}" if coordinate else "solver"
        self.count(f"{prefix}.buckets")
        self.count(f"{prefix}.entities", getattr(stats, "num_entities", 0))
        self.count(f"{prefix}.rounds", getattr(stats, "rounds", 0))
        self.count(
            f"{prefix}.executed_lane_iterations",
            getattr(stats, "executed_lane_iterations", 0),
        )
        self.count(
            f"{prefix}.lockstep_lane_iterations",
            getattr(stats, "lockstep_lane_iterations", 0),
        )
        self.count(f"{prefix}.chunk_retraces", getattr(stats, "chunk_retraces", 0))
        self.observe(f"{prefix}.iterations_p99", getattr(stats, "iterations_p99", 0))
        if not getattr(stats, "converged", True):
            self.count(f"{prefix}.unconverged_buckets")

    def record_transfer_stats(self, transfers) -> None:
        """Fold a full ``TransferStats`` (duck-typed; opt/tracking.py) into
        transfer.* counters (one CD run's totals)."""
        for field in (
            "row_transfers_h2d",
            "row_transfers_d2h",
            "row_bytes_h2d",
            "row_bytes_d2h",
            "host_score_sums",
            "device_plane_updates",
            "coordinate_updates",
            "outer_iterations",
        ):
            self.count(f"transfer.{field}", getattr(transfers, field, 0))

    def record_cluster_pass(self, profile: Dict[str, Any]) -> None:
        """Fold one distributed-pass skew profile (the coordinator's
        telemetry, parallel/cluster) into cluster.* metrics: pass-level
        wall/wait histograms plus host-scoped busy/blocks via the same
        ``scoped`` mechanism the tenancy plane uses."""
        self.count("cluster.passes")
        self.observe("cluster.pass.wall_s", float(profile.get("wall_s", 0.0)))
        self.observe(
            "cluster.pass.allreduce_wait_s",
            float(profile.get("allreduce_wait_s", 0.0)),
        )
        self.gauge(
            "cluster.pass.bubble_s", float(profile.get("bubble_s", 0.0))
        )
        self.gauge(
            "cluster.straggler_index",
            float(profile.get("straggler_index", 1.0)),
        )
        for host, h in (profile.get("hosts") or {}).items():
            scoped = self.scoped({"host": str(host)})
            scoped.gauge("cluster.host.busy_s", float(h.get("busy_s", 0.0)))
            scoped.gauge("cluster.host.wall_s", float(h.get("wall_s", 0.0)))
            scoped.count("cluster.host.blocks", float(h.get("blocks", 0)))
            scoped.count(
                "cluster.host.h2d_bytes", float(h.get("h2d_bytes", 0))
            )

    def record_serving_snapshot(self, snap: Dict[str, Any]) -> None:
        """Fold a serving metrics snapshot dict into serving.* gauges.

        Accepts both the event-shaped keys (``latency_p99_ms``,
        ``batch_fill``, ``compile_count``) and the keys
        ``ServingMetrics.snapshot()`` actually emits (``latency_p99_s``,
        ``batch_fill_ratio``, ``xla_compiles``), normalizing everything to
        the canonical serving.* gauge names documented in
        docs/OBSERVABILITY.md — the ``--auto-tune`` judge and the /metrics
        endpoint both read the canonical names."""
        norm: Dict[str, float] = {}
        for key in (
            "num_requests",
            "num_batches",
            "latency_p50_ms",
            "latency_p99_ms",
            "batch_fill",
            "cache_hit_rate",
            "compile_count",
            "num_swaps",
            "swap_blackout_max_ms",
            "requests_per_s",
            "device_resident_rate",
            "deferred_rate",
            "deferred_lookups",
        ):
            value = snap.get(key)
            if isinstance(value, (int, float)):
                norm[key] = float(value)
        for sec_key, ms_key in (
            ("latency_p50_s", "latency_p50_ms"),
            ("latency_p99_s", "latency_p99_ms"),
        ):
            value = snap.get(sec_key)
            if isinstance(value, (int, float)) and ms_key not in norm:
                norm[ms_key] = float(value) * 1e3
        fill = snap.get("batch_fill_ratio")
        if isinstance(fill, (int, float)) and "batch_fill" not in norm:
            norm["batch_fill"] = float(fill)
        compiles = snap.get("xla_compiles")
        if isinstance(compiles, (int, float)) and "compile_count" not in norm:
            norm["compile_count"] = float(compiles)
        residency = snap.get("residency")
        if isinstance(residency, dict):
            # nested per-coordinate ({cid: {...}}) or one flat stats dict
            coords = [
                v for v in residency.values() if isinstance(v, dict)
            ] or [residency]
            for key, agg in (
                ("resident_rows", sum),
                ("device_rows", sum),
                ("num_shards", max),
            ):
                values = [
                    c[key] for c in coords
                    if isinstance(c.get(key), (int, float))
                ]
                if values:
                    norm[f"residency_{key}"] = float(agg(values))
            # eviction-policy plane (CoordinateRouting.stats): per-policy
            # victim counters and the admitted set's importance spread
            for key, agg, out in (
                ("evicted_oldest", sum, "eviction.oldest"),
                ("evicted_importance", sum, "eviction.importance"),
                ("importance_mean", max, "importance.mean"),
                ("importance_max", max, "importance.max"),
            ):
                values = [
                    c[key] for c in coords
                    if isinstance(c.get(key), (int, float))
                ]
                if values:
                    norm[out] = float(agg(values))
        admission = snap.get("admission")
        if isinstance(admission, dict):
            for key in (
                "admitted_total",
                "evicted_total",
                "dropped_total",
                "queue_depth",
                "deferred_total",
            ):
                value = admission.get(key)
                if isinstance(value, (int, float)):
                    norm[f"admission_{key}"] = float(value)
            by_policy = admission.get("evicted_by_policy")
            if isinstance(by_policy, dict):
                for policy, value in by_policy.items():
                    if isinstance(value, (int, float)):
                        norm[f"eviction.{policy}"] = max(
                            norm.get(f"eviction.{policy}", 0.0), float(value)
                        )
        swaps = snap.get("swaps")
        if isinstance(swaps, dict):
            if isinstance(swaps.get("num_swaps"), (int, float)):
                norm.setdefault("num_swaps", float(swaps["num_swaps"]))
            if isinstance(swaps.get("max_blackout_s"), (int, float)):
                norm.setdefault(
                    "swap_blackout_max_ms",
                    float(swaps["max_blackout_s"]) * 1e3,
                )
        for key, value in norm.items():
            self.gauge(f"serving.{key}", value)


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global registry."""
    return _REGISTRY


def note_jit_trace(program: str, kind: str = "") -> None:
    """Global compile hook: call where a compile actually runs (a cache
    miss), so ``jit.traces.<program>[/<kind>]`` counts compiles. The port
    calls it for each ``nvcc`` build of a kernel library."""
    key = f"{program}/{kind}" if kind else program
    _REGISTRY.count("jit.traces")
    _REGISTRY.count(f"jit.traces.{key}")


def jit_trace_counts() -> Dict[str, int]:
    """Per-program trace counts recorded via :func:`note_jit_trace`."""
    snap = _REGISTRY.snapshot()["counters"]
    prefix = "jit.traces."
    return {
        name[len(prefix):]: int(value)
        for name, value in snap.items()
        if name.startswith(prefix)
    }


def record_memory_watermarks(registry: Optional[MetricsRegistry] = None) -> Dict[str, float]:
    """Record host peak RSS and each visible card's peak allocated bytes
    (``torch.cuda.max_memory_allocated``) as mem.* gauges. Without a card
    only the host gauge is recorded; a card with nothing allocated yet is
    skipped."""
    reg = registry if registry is not None else _REGISTRY
    out: Dict[str, float] = {}
    try:
        import resource
    except ImportError:  # not a Unix host: no rusage
        resource = None
    if resource is not None:
        peak_kib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        out["mem.host_peak_rss_bytes"] = float(peak_kib) * 1024.0  # Linux: KiB
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            peak = torch.cuda.max_memory_allocated(i)
            if peak:
                out[f"mem.device{i}_peak_bytes"] = float(peak)
    for name, value in out.items():
        reg.gauge(name, value)
    return out

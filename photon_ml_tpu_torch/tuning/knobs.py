"""Declared knob space: every tunable config surface, registered once.

The registration mechanism is the contract that keeps future knobs
observable: a knob is not tunable until it declares *which report metrics
its decision depends on* (``metric_deps``) and *which phase it moves*
(``phase``). The offline tuner refuses to reason about config surfaces
that are not in this table, so adding a knob forces you to say what
evidence would justify changing it.

Knobs are identified by dotted names mirroring where they act:
``adaptive.*`` feed :class:`photon_ml_tpu_torch.opt.config.AdaptiveSolveConfig`,
``serving.*`` are ``serve_game`` CLI surfaces, ``train.*`` are
``train_game``/engine surfaces.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

__all__ = ["KnobSpec", "register_knob", "get_knob", "all_knobs", "KNOBS"]


@dataclasses.dataclass(frozen=True)
class KnobSpec:
    """One tunable knob.

    ``metric_deps`` names the :class:`RunReport` evidence the tuner reads
    when proposing a value — phase fractions (``phase:<name>``), solver
    join fields (``solver:<field>``), registry metrics (``metric:<name>``)
    or jit counters (``jit:<key>``). ``candidates`` is the discrete ladder
    the A/B layer may trial; continuous knobs enumerate a sensible grid.
    """

    name: str
    kind: str  # "int" | "float" | "str" | "bool" | "csv_ints"
    default: Any
    applies_to: str  # "train" | "serve" | "both"
    phase: str  # RunReport phase bucket this knob chiefly moves
    metric_deps: Tuple[str, ...]
    candidates: Tuple[Any, ...]
    description: str

    def parse(self, value: Any) -> Any:
        if self.kind == "int":
            return int(value)
        if self.kind == "bool":
            if isinstance(value, str):
                return value.strip().lower() in ("1", "true", "yes", "on")
            return bool(value)
        if self.kind == "float":
            return float(value)
        if self.kind == "csv_ints":
            if isinstance(value, str):
                return tuple(int(v) for v in value.split(",") if v.strip())
            return tuple(int(v) for v in value)
        return str(value)


KNOBS: Dict[str, KnobSpec] = {}


def register_knob(spec: KnobSpec) -> KnobSpec:
    if spec.name in KNOBS:
        raise ValueError(f"knob {spec.name!r} registered twice")
    KNOBS[spec.name] = spec
    return spec


def get_knob(name: str) -> KnobSpec:
    try:
        return KNOBS[name]
    except KeyError:
        raise KeyError(
            f"unknown knob {name!r}; registered: {sorted(KNOBS)}"
        ) from None


def all_knobs() -> Tuple[KnobSpec, ...]:
    return tuple(KNOBS[name] for name in sorted(KNOBS))


# ------------------------------------------------------------------ table

register_knob(KnobSpec(
    name="adaptive.chunk_iters",
    kind="int",
    default=8,
    applies_to="train",
    phase="re_solve",
    metric_deps=(
        "phase:re_solve",
        "solver:lane_iteration_savings",
        "solver:chunk_retraces",
        "jit:re_bucket_chunk",
    ),
    candidates=(4, 8, 16, 32),
    description=(
        "Iterations per adaptive-RE device chunk. Larger chunks amortize "
        "dispatch overhead but waste lane iterations past convergence; "
        "smaller chunks re-check convergence more often at more dispatches."
    ),
))

register_knob(KnobSpec(
    name="adaptive.min_lanes",
    kind="int",
    default=8,
    applies_to="train",
    phase="re_solve",
    metric_deps=(
        "phase:re_solve",
        "solver:lane_iteration_savings",
        "solver:rounds",
    ),
    candidates=(4, 8, 16, 32),
    description=(
        "Smallest compacted lane count an adaptive round may shrink to. "
        "Lower values squeeze out more wasted lanes per round but add "
        "compaction rounds (and retraces for new lane shapes)."
    ),
))

register_knob(KnobSpec(
    name="serving.bucket_sizes",
    kind="csv_ints",
    default=(1, 2, 4, 8, 16, 32),
    applies_to="serve",
    phase="serving",
    metric_deps=(
        "phase:serving",
        "metric:serving.latency_p99_ms",
        "metric:serving.batch_fill",
        "metric:serving.compile_count",
    ),
    candidates=(
        (1, 2, 4, 8, 16, 32),
        (1, 4, 16, 64),
        (1, 2, 4, 8, 16, 32, 64),
        (1, 8, 64),
    ),
    description=(
        "Microbatch padding ladder. A denser ladder improves batch fill "
        "(less padding waste) at the cost of more compiled programs; a "
        "sparser one compiles less but pads more."
    ),
))

register_knob(KnobSpec(
    name="serving.cache_capacity",
    kind="int",
    default=4096,
    applies_to="serve",
    phase="serving",
    metric_deps=(
        "phase:serving",
        "metric:serving.cache_hit_rate",
        "metric:serving.latency_p50_ms",
    ),
    candidates=(1024, 4096, 16384, 65536),
    description=(
        "Per-coordinate device row-cache capacity. Bigger caches lift the "
        "hit rate on skewed entity traffic at the cost of device memory."
    ),
))

register_knob(KnobSpec(
    name="serving.max_nnz",
    kind="int",
    default=0,  # 0 = derive from the replayed requests (max_nnz_of)
    applies_to="serve",
    phase="serving",
    metric_deps=(
        "phase:serving",
        "metric:serving.latency_p99_ms",
        "metric:serving.compile_count",
    ),
    candidates=(0,),
    description=(
        "Padded nonzeros per request row (0 = derive pow2 from traffic). "
        "Overriding trades truncation risk for smaller padded programs."
    ),
))

register_knob(KnobSpec(
    name="serving.shards",
    kind="int",
    default=4,
    applies_to="serve",
    phase="serving",
    metric_deps=(
        "phase:serving",
        "metric:serving.device_resident_rate",
        "metric:serving.latency_p99_ms",
        "metric:serving.requests_per_s",
    ),
    candidates=(1, 2, 4, 8),
    description=(
        "Device shards per random-effect table in sharded serving mode. "
        "More shards spread rows (and gather traffic) across more devices "
        "at one extra gather per shard per batch; on a single device the "
        "count only shapes the stacked table layout."
    ),
))

register_knob(KnobSpec(
    name="serving.admit_batch",
    kind="int",
    default=64,
    applies_to="serve",
    phase="serving",
    metric_deps=(
        "phase:serving",
        "metric:serving.deferred_rate",
        "metric:serving.admission_dropped_total",
        "metric:serving.admission_queue_depth",
    ),
    candidates=(16, 64, 256, 1024),
    description=(
        "Rows copied host→device per async admission step (one fixed-shape "
        "scatter). Bigger batches drain a cold-start burst faster but hold "
        "the routing lock longer per step and stage more bytes at once."
    ),
))

register_knob(KnobSpec(
    name="serving.batch_deadline_ms",
    kind="float",
    default=2.0,
    applies_to="serve",
    phase="serving",
    metric_deps=(
        "phase:serving",
        "metric:serving.latency_p99_ms",
        "metric:serving.batch_fill",
        "metric:serving.requests_per_s",
    ),
    candidates=(0.5, 1.0, 2.0, 5.0),
    description=(
        "Continuous-batching deadline: a forming bucket is scored once its "
        "oldest request has waited this long. Longer deadlines fill buckets "
        "(throughput) at the cost of added tail latency under light load."
    ),
))

register_knob(KnobSpec(
    name="train.schedule",
    kind="str",
    default="sync",
    applies_to="train",
    phase="cd_driver",
    metric_deps=(
        "phase:fe_solve",
        "phase:re_solve",
        "overlap:fe_solve",
        "overlap:re_solve",
    ),
    candidates=("sync", "async"),
    description=(
        "Coordinate-descent schedule. 'async' pipelines FE/RE solves with "
        "bounded staleness on the device score plane (plus RE bucket "
        "overlap); worth trying when FE and RE both hold material "
        "wall-clock and the ledger shows no overlap yet. 'sync' is the "
        "bitwise-reproducible default and required under multi-controller."
    ),
))

register_knob(KnobSpec(
    name="train.staleness",
    kind="int",
    default=1,
    applies_to="train",
    phase="cd_driver",
    metric_deps=(
        "overlap:fe_solve",
        "overlap:re_solve",
        "phase:cd_driver",
    ),
    candidates=(0, 1, 2),
    description=(
        "Max unreconciled coordinate updates an async dispatch may ignore. "
        "0 serializes (bitwise equal to sync), higher values overlap more "
        "solves per iteration at the cost of staler residuals (slower "
        "per-iteration convergence). Ignored under schedule='sync'."
    ),
))

register_knob(KnobSpec(
    name="stream.block_rows",
    kind="int",
    default=65536,
    applies_to="train",
    phase="io",
    metric_deps=(
        "phase:io",
        "metric:stream.stall_s",
        "metric:stream.prefetch_hide_ratio",
        "metric:stream.decode_s",
        "jit:stream_vg",
    ),
    candidates=(4096, 16384, 65536, 262144),
    description=(
        "Rows per streamed example block (train_game --block-rows). Bigger "
        "blocks amortize per-block dispatch and decode overhead and raise "
        "the prefetch hide ratio, but cost O(block_rows x max_nnz) host "
        "staging and device memory per buffered block; every value is one "
        "fixed compiled shape, so retuning retraces once."
    ),
))

register_knob(KnobSpec(
    name="stream.prefetch_depth",
    kind="int",
    default=2,
    applies_to="train",
    phase="io",
    metric_deps=(
        "metric:stream.stall_s",
        "metric:stream.prefetch_hide_ratio",
        "metric:stream.transfer_s",
        "phase:io",
    ),
    candidates=(0, 1, 2, 4),
    description=(
        "Staged blocks the background decode thread may run ahead "
        "(train_game --prefetch-depth). 0 is synchronous decode (every "
        "decode second surfaces as a stall); deeper staging hides decode "
        "behind solver compute until decode itself is the bottleneck, at "
        "prefetch_depth x block bytes of host staging memory."
    ),
))

register_knob(KnobSpec(
    name="stream.decode_workers",
    kind="int",
    default=-1,
    applies_to="train",
    phase="io",
    metric_deps=(
        "metric:stream.stall_s",
        "metric:stream.decode_s",
        "metric:stream.decode_work_s",
        "metric:stream.prefetch_hide_ratio",
        "phase:io",
    ),
    candidates=(-1, 0, 1, 2, 4, 8),
    description=(
        "Decode pool threads (train_game --decode-workers). -1 = auto "
        "(cpu_count-1 capped at 16; 0 on a single-core host). Each worker "
        "decodes one part file per GIL-released native call, so workers "
        "genuinely overlap; more workers shorten decode wall-clock "
        "(stream.decode_s) while stream.decode_work_s stays constant — "
        "their ratio is the pool's achieved parallelism."
    ),
))

register_knob(KnobSpec(
    name="stream.block_cache",
    kind="bool",
    default=True,
    applies_to="train",
    phase="io",
    metric_deps=(
        "metric:stream.stall_s",
        "metric:stream.decode_s",
        "metric:stream.cache_hit_blocks",
        "metric:stream.prefetch_hide_ratio",
        "phase:io",
    ),
    candidates=(False, True),
    description=(
        "Spill decoded blocks to the mmap-backed on-disk cache "
        "(train_game --block-cache-dir / --no-block-cache). Epoch 1 pays "
        "decode once and writes entries; every later block visit reloads "
        "zero-copy at page-cache speed with zero Avro work, so "
        "stream.decode_s collapses on warm epochs. Costs one padded-block "
        "footprint of disk per (block, shard-subset)."
    ),
))

register_knob(KnobSpec(
    name="stream.gap_schedule",
    kind="bool",
    default=False,
    applies_to="train",
    phase="io",
    metric_deps=(
        "metric:stream.gap_sched.visited_blocks",
        "metric:stream.gap_sched.visit_fraction",
        "metric:stream.block_gap_max",
        "metric:stream.blocks",
        "phase:io",
    ),
    candidates=(False, True),
    description=(
        "Gap-guided block scheduling in stochastic streaming mode "
        "(train_game --gap-schedule). Epochs visit the blocks with the "
        "largest staleness-decayed duality-gap estimates (DuHL, arxiv "
        "1702.07005) instead of a blind shuffle, cutting block visits to "
        "a target metric when per-block gaps are skewed; off is bitwise-"
        "identical to the historical shuffle. Not worth turning on when "
        "block gaps are near-uniform (IID data) — the scheduler then "
        "pays exploration for no visit savings."
    ),
))

register_knob(KnobSpec(
    name="stream.resident_blocks",
    kind="int",
    default=0,
    applies_to="train",
    phase="io",
    metric_deps=(
        "metric:stream.h2d_bytes",
        "metric:stream.transfer_s",
        "metric:stream.upload_hidden_s",
        "metric:stream.residency.h2d_saved_bytes",
        "metric:stream.residency.hbm_hit_blocks",
        "phase:transfers",
    ),
    candidates=(0, 2, 4, 8, 16),
    description=(
        "Device-resident block budget for streamed training (train_game "
        "--resident-blocks; 0 = off, bitwise-identical streaming). The "
        "top-gap blocks' uploads persist across passes (DuHL, arxiv "
        "1702.07005), so warm passes re-upload only the non-resident "
        "remainder — stream.h2d_bytes drops by resident/total per pass. "
        "Worth proposing when stream.transfer_s is material and device "
        "memory has headroom of resident_blocks x block upload bytes; "
        "pointless when the solve is decode- or compute-bound."
    ),
))

register_knob(KnobSpec(
    name="serve.eviction_policy",
    kind="str",
    default="oldest",
    applies_to="serve",
    phase="serving",
    metric_deps=(
        "metric:serving.device_resident_rate",
        "metric:serving.eviction.importance",
        "metric:serving.eviction.oldest",
        "metric:serving.importance.mean",
        "metric:serving.deferred_rate",
    ),
    candidates=("oldest", "importance"),
    description=(
        "Admission-victim selection for device-resident RE rows "
        "(serve_game --eviction-policy). 'oldest' is the historical FIFO; "
        "'importance' evicts the lowest EWMA-request-frequency x "
        "coefficient-norm row, keeping hot long-tail entities resident "
        "under churn — worth trying when traffic is skewed and "
        "serving.device_resident_rate sits below ~0.95 at the configured "
        "device budget."
    ),
))

register_knob(KnobSpec(
    name="serve.overload_burn_high",
    kind="float",
    default=1.0,
    applies_to="serve",
    phase="serving",
    metric_deps=(
        "metric:serving.overload.burn_rate",
        "metric:serving.overload.active",
        "metric:serving.slo.burn_rate",
        "metric:serving.latency_p99_ms",
    ),
    candidates=(0.8, 1.0, 1.5, 2.0),
    description=(
        "SLO burn rate at which closed-loop overload control engages "
        "(serve_game --overload-burn-high): batch deadlines shrink and "
        "FE-only-able requests are answered on the host without "
        "queueing. 1.0 means the error budget burns exactly as fast as "
        "it accrues; lower engages earlier (more shedding, tighter "
        "tail), higher tolerates short bursts before actuating."
    ),
))

register_knob(KnobSpec(
    name="serve.overload_shrink",
    kind="float",
    default=0.5,
    applies_to="serve",
    phase="serving",
    metric_deps=(
        "metric:serving.overload.deadline_scale",
        "metric:serving.batch_fill_ratio",
        "metric:serving.latency_p99_ms",
    ),
    candidates=(0.25, 0.5, 0.75),
    description=(
        "Batch-deadline multiplier applied while overloaded (serve_game "
        "--overload-shrink): smaller buckets dispatch sooner, trading "
        "batch fill for queue wait exactly when queue wait is burning "
        "the latency budget. Too small wastes device dispatches on "
        "near-empty buckets; 0.5 halves the deadline."
    ),
))

register_knob(KnobSpec(
    name="serve.score_delta_importance",
    kind="bool",
    default=True,
    applies_to="serve",
    phase="serving",
    metric_deps=(
        "metric:serving.device_resident_rate",
        "metric:serving.eviction.importance",
        "metric:serving.importance.mean",
    ),
    candidates=(False, True),
    description=(
        "Fold each entity's observed |score - FE-only score| EWMA into "
        "the importance eviction score (with serve.eviction_policy="
        "importance): rows whose random-effect correction actually "
        "moves scores stay resident even at modest request frequency. "
        "Off reverts to frequency x coefficient-norm alone. No effect "
        "under the 'oldest' policy (the delta pass never runs there)."
    ),
))

register_knob(KnobSpec(
    name="train.engine",
    kind="str",
    default="auto",
    applies_to="train",
    phase="fe_solve",
    metric_deps=(
        "phase:fe_solve",
        "phase:transfers",
        "jit:fe_solve",
    ),
    candidates=("auto", "ell", "benes", "fused"),
    description=(
        "Fixed-effect matvec engine. BENCH_LASTGOOD.json records a 19x "
        "spread across engines on the same shard shape, so this is the "
        "single highest-leverage train-side knob."
    ),
))

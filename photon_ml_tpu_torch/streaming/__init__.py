"""Out-of-core training: disk-resident datasets streamed as fixed-shape
example blocks through a pinned host→device prefetcher into block-sharded
solvers on the card.

Port of ``photon_ml_tpu/streaming`` with the same modules and ``__all__``
(the cluster plane's pieces excepted: ROADMAP.md, Queue A item 8).
"""

from photon_ml_tpu_torch.streaming.blockcache import (
    BlockCache,
    CacheStats,
    plan_fingerprint,
)
from photon_ml_tpu_torch.streaming.blocks import (
    BlockPlan,
    HostBlock,
    RowPlanes,
    StreamingSource,
    auto_decode_workers,
    group_by_part_file,
    readahead_file_budget,
)
from photon_ml_tpu_torch.streaming.coordinate import StreamingFixedEffectCoordinate
from photon_ml_tpu_torch.streaming.gapsched import GapScheduler
from photon_ml_tpu_torch.streaming.prefetch import (
    BlockPrefetcher,
    DeviceBlock,
    PrefetchStats,
)
from photon_ml_tpu_torch.streaming.residency import (
    ResidencyManager,
    ResidencyStats,
    residency_hierarchy,
)
from photon_ml_tpu_torch.streaming.solver import (
    BlockStatsProbe,
    StreamSolveInfo,
    reset_stream_trace_counts,
    solve_streaming,
    solve_streaming_stochastic,
    stream_trace_counts,
    streamed_objective_value,
)

__all__ = [
    "BlockCache",
    "CacheStats",
    "plan_fingerprint",
    "auto_decode_workers",
    "group_by_part_file",
    "readahead_file_budget",
    "GapScheduler",
    "BlockPlan",
    "HostBlock",
    "RowPlanes",
    "StreamingSource",
    "StreamingFixedEffectCoordinate",
    "BlockPrefetcher",
    "DeviceBlock",
    "PrefetchStats",
    "ResidencyManager",
    "ResidencyStats",
    "residency_hierarchy",
    "BlockStatsProbe",
    "StreamSolveInfo",
    "reset_stream_trace_counts",
    "solve_streaming",
    "solve_streaming_stochastic",
    "stream_trace_counts",
    "streamed_objective_value",
]

"""Online serving of GAME models: score individual requests against a
trained model at low latency, from tables held on the device.

Ported (ROADMAP.md Queue A items 9a, 9b and 9c: single-tenant online
serving, the nearline loop and multi-tenancy), with the JAX package's
module paths and names:

- :mod:`~photon_ml_tpu_torch.serving.artifact` — pack a trained
  ``GameModel`` into a serving artifact (dense FE vectors, per-coordinate RE
  tables behind PHIX entity indexes), save and load it (files byte-equal to
  the JAX package's), and the ``--auto-tune`` sidecar.
- :mod:`~photon_ml_tpu_torch.serving.scorer` — ``GameScorer``: fixed-shape
  batches scored on the device from full RE tables or an LRU
  :mod:`~photon_ml_tpu_torch.serving.cache` of hot rows.
- :mod:`~photon_ml_tpu_torch.serving.routing` /
  :mod:`~photon_ml_tpu_torch.serving.sharded` — entity → (shard, slot)
  routing and ``ShardedGameScorer`` over double-buffered ``[S, cap+1, dim]``
  tables; :mod:`~photon_ml_tpu_torch.serving.admission` admits the cold
  tail into device headroom on a supervised thread.
- :mod:`~photon_ml_tpu_torch.serving.batcher` (sealed) and
  :mod:`~photon_ml_tpu_torch.serving.continuous` (deadline-driven worker
  threads with backpressure) batchers; :mod:`~photon_ml_tpu_torch.serving
  .replay` drives either from a scoring dataset.
- :mod:`~photon_ml_tpu_torch.serving.metrics`,
  :mod:`~photon_ml_tpu_torch.serving.requestplane`,
  :mod:`~photon_ml_tpu_torch.serving.slo`,
  :mod:`~photon_ml_tpu_torch.serving.overload` and
  :mod:`~photon_ml_tpu_torch.serving.introspect` — latency metrics,
  sampled request lifecycles, SLO budgets, overload control, and the live
  ``/metrics``, ``/healthz``, ``/varz`` server.
- :mod:`~photon_ml_tpu_torch.serving.hotswap` — apply nearline delta
  artifacts (``photon_ml_tpu_torch.incremental``) to a live scorer: in-place
  table writes with no new score signature, per-row cache invalidation, an
  AUC validation gate with rollback to the previous generation;
  :mod:`~photon_ml_tpu_torch.serving.deltawatch` runs the ``--watch-deltas``
  poll as a supervised daemon.
- :mod:`~photon_ml_tpu_torch.serving.tenancy` — N model variants as
  fingerprint-chained delta overlays on ONE shared sharded scorer (its
  ``score_batch(view=...)`` hook), seeded variant routing with hot ramps,
  per-tenant quotas and SLO budgets;
  :mod:`~photon_ml_tpu_torch.serving.scenarios` — seeded traffic shapes
  (steady, diurnal, burst storm, cold-entity flood, hot swap under load,
  tenant isolation, ramped rollout, nearline loop) over ``replay_requests``.
"""

from photon_ml_tpu_torch.serving.artifact import (
    ServingArtifact,
    ServingTable,
    load_artifact,
    load_tuned_config,
    pack_game_model,
    save_artifact,
    save_tuned_config,
)
from photon_ml_tpu_torch.serving.introspect import IntrospectionServer, prometheus_text
from photon_ml_tpu_torch.serving.admission import AdmissionController
from photon_ml_tpu_torch.serving.batcher import MicroBatcher
from photon_ml_tpu_torch.serving.cache import HotEntityCache
from photon_ml_tpu_torch.serving.continuous import ContinuousBatcher, PendingResult
from photon_ml_tpu_torch.serving.deltawatch import DeltaWatcher
from photon_ml_tpu_torch.serving.hotswap import (
    CoordinatedHotSwap,
    HotSwapManager,
    SwapReport,
    ValidationGate,
)
from photon_ml_tpu_torch.serving.metrics import ServingMetrics
from photon_ml_tpu_torch.serving.replay import (
    max_nnz_of,
    replay_requests,
    requests_from_game_data,
)
from photon_ml_tpu_torch.serving.requestplane import REQUEST_STAGES, RequestPlane
from photon_ml_tpu_torch.serving.scenarios import (
    DEFAULT_TENANTS,
    SCENARIO_NAMES,
    TENANCY_SCENARIOS,
    build_scenario,
    run_scenario,
)
from photon_ml_tpu_torch.serving.tenancy import (
    TenancyPlane,
    TenantBudget,
    TenantQuota,
    VariantRegistry,
    VariantRouter,
    VariantScorer,
    build_tenant_slos,
    make_nearline_fn,
    tag_requests,
)
from photon_ml_tpu_torch.serving.overload import OverloadController
from photon_ml_tpu_torch.serving.slo import SLOTracker
from photon_ml_tpu_torch.serving.routing import (
    CoordinateRouting,
    RoutingIndex,
    build_routing,
)
from photon_ml_tpu_torch.serving.scorer import GameScorer, ScoreRequest, ScoreResult
from photon_ml_tpu_torch.serving.sharded import (
    ShardedGameScorer,
    ShardedReTable,
    serving_mesh,
)

__all__ = [
    "AdmissionController",
    "ContinuousBatcher",
    "DEFAULT_TENANTS",
    "REQUEST_STAGES",
    "RequestPlane",
    "SCENARIO_NAMES",
    "SLOTracker",
    "TENANCY_SCENARIOS",
    "TenancyPlane",
    "TenantBudget",
    "TenantQuota",
    "VariantRegistry",
    "VariantRouter",
    "VariantScorer",
    "build_scenario",
    "build_tenant_slos",
    "make_nearline_fn",
    "run_scenario",
    "tag_requests",
    "CoordinatedHotSwap",
    "DeltaWatcher",
    "HotSwapManager",
    "SwapReport",
    "ValidationGate",
    "CoordinateRouting",
    "GameScorer",
    "HotEntityCache",
    "MicroBatcher",
    "OverloadController",
    "PendingResult",
    "RoutingIndex",
    "ScoreRequest",
    "ScoreResult",
    "ShardedGameScorer",
    "ShardedReTable",
    "ServingArtifact",
    "ServingMetrics",
    "ServingTable",
    "IntrospectionServer",
    "build_routing",
    "load_artifact",
    "load_tuned_config",
    "max_nnz_of",
    "pack_game_model",
    "prometheus_text",
    "replay_requests",
    "requests_from_game_data",
    "save_artifact",
    "save_tuned_config",
    "serving_mesh",
]

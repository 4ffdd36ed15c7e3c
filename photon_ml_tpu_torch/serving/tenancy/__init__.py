"""Tenancy plane: multi-model variant serving on one shared scorer.

See docs/SERVING.md ("Tenancy plane") for the architecture. Public
surface:

- :class:`VariantRegistry` / :class:`VariantScorer` — N fingerprint-
  chained delta-overlay variants over one sharded scorer's tables, with
  per-variant hot swap, validation gating, and rollback isolation.
- :class:`VariantRouter` — seeded deterministic (tenant, request_id) ->
  variant routing with hot-adjustable ramp percentages and pins.
- :class:`TenantQuota` / :class:`TenantBudget` — per-tenant token-bucket
  admission with priority-aware shedding from a shared global pool.
- :class:`TenancyPlane` — the assembled path: quota -> router -> one
  sealed batcher per variant; plus :func:`tag_requests` (tenant identity
  in the request id), :func:`build_tenant_slos` (independent error
  budgets, tenant-labeled gauges), and :func:`make_nearline_fn` (the
  nearline train->emit->swap loop body for scenarios).

Port of ``photon_ml_tpu/serving/tenancy``, with the same exports.
"""

from photon_ml_tpu_torch.serving.tenancy.variants import (
    BASE_VARIANT,
    VariantRegistry,
    VariantScorer,
    VariantState,
    VariantSwapReport,
)
from photon_ml_tpu_torch.serving.tenancy.router import VariantRouter
from photon_ml_tpu_torch.serving.tenancy.quota import TenantBudget, TenantQuota
from photon_ml_tpu_torch.serving.tenancy.plane import (
    TenancyPlane,
    build_tenant_slos,
    make_nearline_fn,
    tag_request,
    tag_requests,
)

__all__ = [
    "BASE_VARIANT",
    "VariantRegistry",
    "VariantScorer",
    "VariantState",
    "VariantSwapReport",
    "VariantRouter",
    "TenantBudget",
    "TenantQuota",
    "TenancyPlane",
    "build_tenant_slos",
    "make_nearline_fn",
    "tag_request",
    "tag_requests",
]

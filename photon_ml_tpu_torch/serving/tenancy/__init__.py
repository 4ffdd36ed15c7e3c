"""Tenant identity for the serving path (``serve_game --tenants``).

Only request tagging and per-tenant SLO budgets are ported; the variant
plane of ``photon_ml_tpu/serving/tenancy`` (``TenancyPlane``, variants,
router, quota) is ROADMAP.md Queue A item 9c.
"""

from photon_ml_tpu_torch.serving.tenancy.plane import (
    build_tenant_slos,
    tag_request,
    tag_requests,
)

__all__ = ["build_tenant_slos", "tag_request", "tag_requests"]

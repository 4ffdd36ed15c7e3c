"""Tenant identity and per-tenant SLO budgets for the serving path.

Port of the parts of ``photon_ml_tpu/serving/tenancy/plane.py`` that
single-tenant serving with ``serve_game --tenants`` needs: tenant identity
travels IN the request id (``"<tenant>!<rid>"`` —
:data:`~photon_ml_tpu_torch.serving.requestplane.TENANT_SEP`), so nothing
between admission and SLO attribution needs a new per-request field, and
:func:`build_tenant_slos` gives each tenant an independent error budget.
The variant plane itself (``TenancyPlane``, variants, router, quota) is
ROADMAP.md Queue A item 9c.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Sequence

from photon_ml_tpu_torch.serving.requestplane import TENANT_SEP
from photon_ml_tpu_torch.serving.scorer import ScoreRequest
from photon_ml_tpu_torch.serving.slo import SLOTracker


def tag_request(request: ScoreRequest, tenant: str) -> ScoreRequest:
    """Return the request re-identified as ``tenant``'s (id prefixed)."""
    if TENANT_SEP in tenant:
        raise ValueError(
            f"tenant name {tenant!r} must not contain {TENANT_SEP!r}"
        )
    return dataclasses.replace(
        request, request_id=f"{tenant}{TENANT_SEP}{request.request_id}"
    )


def tag_requests(
    requests: Sequence[ScoreRequest], tenant: str
) -> List[ScoreRequest]:
    return [tag_request(r, tenant) for r in requests]


def build_tenant_slos(
    tenants: Sequence[str],
    registry=None,
    latency_threshold_s: float = 0.050,
    latency_objective: float = 0.99,
    availability_objective: float = 0.999,
    window_s: float = 300.0,
    clock=time.monotonic,
) -> Dict[str, SLOTracker]:
    """One independent SLO tracker (own error budget) per tenant. With a
    metrics ``registry``, each tracker writes its ``serving.slo.*`` gauges
    under a ``tenant="<t>"`` label scope — separate Prometheus series per
    tenant in ``/metrics``."""
    slos: Dict[str, SLOTracker] = {}
    for tenant in tenants:
        scoped = (
            registry.scoped({"tenant": tenant})
            if registry is not None
            else None
        )
        slos[tenant] = SLOTracker(
            latency_threshold_s=latency_threshold_s,
            latency_objective=latency_objective,
            availability_objective=availability_objective,
            window_s=window_s,
            clock=clock,
            registry=scoped,
        )
    return slos

"""Tenancy plane: quota -> router -> per-variant batchers over ONE scorer.

Ties the tenancy pieces into a serving path:

    request --(quota admit/shed)--> router --> variant's MicroBatcher
                                                  \\-> shared sharded scorer
                                                      (variant view per batch)

One sealed :class:`~photon_ml_tpu_torch.serving.batcher.MicroBatcher` per
variant — a batch is scored under exactly one variant view, so buckets
never mix views (a view applies per batch) and the plain base variant
still takes the bitwise ``view=None`` path. Batchers share the one
``ServingMetrics``/:class:`~photon_ml_tpu_torch.serving.requestplane.RequestPlane`,
so stage attribution, sealed-batch records, and the per-tenant SLO feed
come for free from the existing request plane.

Tenant identity travels IN the request id (``"<tenant>!<rid>"`` —
:data:`~photon_ml_tpu_torch.serving.requestplane.TENANT_SEP`), so nothing
between admission and SLO attribution needs a new per-request field.
Quota sheds are charged to the shedding tenant's own error budget and
never reach the scorer, the global SLO, or any other tenant's budget.

Port of ``photon_ml_tpu/serving/tenancy/plane.py``: host-side plumbing,
copied; the variant views it batches under are the port's device tensors.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np

from photon_ml_tpu_torch.incremental.delta import (
    build_delta,
    delta_dir_name,
    save_delta,
)
from photon_ml_tpu_torch.serving.batcher import DEFAULT_BUCKET_SIZES, MicroBatcher
from photon_ml_tpu_torch.serving.requestplane import (
    TENANT_SEP,
    tenant_of_request_id,
)
from photon_ml_tpu_torch.serving.scorer import ScoreRequest, ScoreResult
from photon_ml_tpu_torch.serving.slo import SLOTracker
from photon_ml_tpu_torch.serving.tenancy.quota import TenantQuota
from photon_ml_tpu_torch.serving.tenancy.router import VariantRouter
from photon_ml_tpu_torch.serving.tenancy.variants import VariantRegistry


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


class TenancyPlane:
    """The multi-tenant serving front: admit, route, batch per variant.

    ``plane`` is the shared ``RequestPlane`` (carry ``tenant_slos`` for
    per-tenant budgets); ``quota``/``router`` are optional — without a
    quota everything admits, without a router everything serves the base
    variant. ``metrics_registry`` adds per-tenant request/shed counters
    under tenant label scopes.

    ``quota_mode`` picks WHERE the token bucket is consulted:
    ``"submit"`` (default, the historical behavior) sheds at the plane's
    front door, before routing; ``"drain"`` admits everything into the
    per-variant batchers and lets each batcher consult the quota as
    buckets seal — an over-budget tenant's requests then drop out of the
    padded bucket at the last moment (charged to that tenant via the
    plane) instead of being rejected while device slots sit idle."""

    def __init__(
        self,
        registry: VariantRegistry,
        router: Optional[VariantRouter] = None,
        plane=None,
        quota: Optional[TenantQuota] = None,
        metrics=None,
        bucket_sizes: Sequence[int] = DEFAULT_BUCKET_SIZES,
        max_wait_s: float = 0.002,
        default_tenant: str = "default",
        metrics_registry=None,
        quota_mode: str = "submit",
    ):
        if quota_mode not in ("submit", "drain"):
            raise ValueError(
                f"quota_mode must be 'submit' or 'drain', got {quota_mode!r}"
            )
        self.registry = registry
        self.router = router if router is not None else VariantRouter()
        self.plane = plane
        self.quota = quota
        self.quota_mode = quota_mode
        self._metrics = metrics
        self._bucket_sizes = tuple(bucket_sizes)
        self._max_wait_s = max_wait_s
        self.default_tenant = default_tenant
        self._metrics_registry = metrics_registry
        self._tenant_scopes: Dict[str, object] = {}
        self._batchers: Dict[str, MicroBatcher] = {}
        self._lock = threading.RLock()
        self.tenant_submitted: Dict[str, int] = {}
        self.tenant_shed: Dict[str, int] = {}

    # ------------------------------------------------------------- plumbing

    def _batcher(self, variant_id: str) -> MicroBatcher:
        b = self._batchers.get(variant_id)
        if b is None:
            with self._lock:
                b = self._batchers.get(variant_id)
                if b is None:
                    b = MicroBatcher(
                        self.registry.scorer(variant_id),
                        bucket_sizes=self._bucket_sizes,
                        metrics=self._metrics,
                        max_wait_s=self._max_wait_s,
                        plane=self.plane,
                        quota=(
                            self.quota
                            if self.quota_mode == "drain"
                            else None
                        ),
                    )
                    self._batchers[variant_id] = b
        return b

    def _scope(self, tenant: str):
        reg = self._metrics_registry
        if reg is None:
            return None
        scope = self._tenant_scopes.get(tenant)
        if scope is None:
            scope = reg.scoped({"tenant": tenant})
            self._tenant_scopes[tenant] = scope
        return scope

    # ------------------------------------------------------------ the plane

    def submit(self, request: ScoreRequest) -> List[ScoreResult]:
        """Admit -> route -> enqueue one (already tenant-tagged) request.
        Returns any results a full bucket completed; shed requests return
        nothing and are charged to the shedding tenant's error budget."""
        tenant = tenant_of_request_id(request.request_id)
        if tenant is None:
            tenant = self.default_tenant
        self.tenant_submitted[tenant] = (
            self.tenant_submitted.get(tenant, 0) + 1
        )
        if (
            self.quota is not None
            and self.quota_mode == "submit"
            and not self.quota.try_admit(tenant)
        ):
            self.tenant_shed[tenant] = self.tenant_shed.get(tenant, 0) + 1
            if self.plane is not None:
                self.plane.observe_tenant_errors(tenant, 1)
            return []
        variant = self.router.route(tenant, request.request_id)
        return self._batcher(variant).submit(request)

    def poll(self, now: Optional[float] = None) -> List[ScoreResult]:
        out: List[ScoreResult] = []
        for b in list(self._batchers.values()):
            out.extend(b.poll(now))
        return out

    def flush(self) -> List[ScoreResult]:
        out: List[ScoreResult] = []
        for b in list(self._batchers.values()):
            out.extend(b.flush())
        return out

    def _submit_chunk(
        self, requests: Sequence[ScoreRequest]
    ) -> List[ScoreResult]:
        """Bulk :meth:`submit` for a run of requests — same admit/route/
        enqueue decisions, amortized Python: tenant parse and counters run
        as comprehensions, routing goes through ``route_many``, and each
        variant's batcher gets its whole sub-run in one ``submit_many``.
        The per-request quota walk survives only when a quota is
        installed (token buckets are order-dependent)."""
        sep, default = TENANT_SEP, self.default_tenant
        tenants = [
            rid.split(sep, 1)[0] if sep in rid else default
            for rid in (r.request_id for r in requests)
        ]
        submitted = self.tenant_submitted
        for tenant, n in Counter(tenants).items():
            submitted[tenant] = submitted.get(tenant, 0) + n
        quota = self.quota if self.quota_mode == "submit" else None
        if quota is not None:
            kept: List[ScoreRequest] = []
            kept_tenants: List[str] = []
            for request, tenant in zip(requests, tenants):
                if quota.try_admit(tenant):
                    kept.append(request)
                    kept_tenants.append(tenant)
                else:
                    self.tenant_shed[tenant] = (
                        self.tenant_shed.get(tenant, 0) + 1
                    )
                    if self.plane is not None:
                        self.plane.observe_tenant_errors(tenant, 1)
            requests, tenants = kept, kept_tenants
        by_tenant: Dict[str, List[ScoreRequest]] = {}
        for request, tenant in zip(requests, tenants):
            by_tenant.setdefault(tenant, []).append(request)
        by_variant: Dict[str, List[ScoreRequest]] = {}
        route_many = self.router.route_many
        for tenant, run in by_tenant.items():
            choices = route_many(tenant, [r.request_id for r in run])
            for request, variant_id in zip(run, choices):
                by_variant.setdefault(variant_id, []).append(request)
        out: List[ScoreResult] = []
        for variant_id, run in by_variant.items():
            out.extend(self._batcher(variant_id).submit_many(run))
        return out

    def replay(
        self,
        requests: Sequence[ScoreRequest],
        poll_every: int = 64,
    ) -> List[ScoreResult]:
        """Drive a pre-tagged request stream through the plane (the
        scenario harness's per-phase engine): deadline-poll all variants'
        batchers every ``poll_every`` submissions so a variant at 1% ramp
        is not starved waiting for a full bucket, final flush drains the
        rest (``poll_every=0`` = sealed, full buckets only). Per-tenant
        counters land in the metrics registry once per call, not per
        request."""
        results: List[ScoreResult] = []
        chunk = poll_every if poll_every else len(requests) or 1
        for start in range(0, len(requests), chunk):
            results.extend(
                self._submit_chunk(requests[start:start + chunk])
            )
            if poll_every:
                results.extend(self.poll())
        results.extend(self.flush())
        if self._metrics_registry is not None:
            for tenant, n in list(self.tenant_submitted.items()):
                scope = self._scope(tenant)
                shed = self.tenant_shed.get(tenant, 0)
                scope.count("serving.tenant.requests", n)
                if shed:
                    scope.count("serving.tenant.shed", shed)
            self.tenant_submitted = {}
            self.tenant_shed = {}
        return results

    # ------------------------------------------------------------ reporting

    def status(self) -> Dict[str, object]:
        doc: Dict[str, object] = {
            "variants": self.registry.stats(),
            "router": self.router.status(),
        }
        if self.quota is not None:
            doc["quota"] = self.quota.stats()
        if self.plane is not None and self.plane.tenant_slos:
            doc["tenants"] = {
                tenant: {
                    "requests": self.plane.tenant_requests.get(tenant, 0),
                    "errors": self.plane.tenant_errors.get(tenant, 0),
                    "slo": slo.status(),
                }
                for tenant, slo in sorted(self.plane.tenant_slos.items())
            }
        return doc


def make_nearline_fn(
    registry: VariantRegistry,
    variant_ids: Sequence[str],
    entity_pool: Dict[str, Sequence[str]],
    rows_per_delta: int = 8,
    scale: float = 0.01,
    seed: int = 0,
    watch_dir: Optional[str] = None,
):
    """A synthetic nearline trainer loop body for the ``nearline_loop``
    scenario: each call emits one generation of per-variant deltas —
    sampled sparse row updates for entities from ``entity_pool[cid]``,
    chained to each variant's CURRENT fingerprint head — and hot-swaps
    them into the serving registry while traffic flows. With
    ``watch_dir``, deltas take the full production path: saved to
    ``watch_dir/<variant>/delta-NNNNNN`` (atomic publish), then picked up
    by ``poll_directory`` (discover -> load -> chain-check -> apply);
    without it, they apply in-memory."""
    rng = np.random.default_rng(seed + 1013)
    generations: Dict[str, int] = {v: 0 for v in variant_ids}
    lead = registry.lead

    def _tick() -> List[object]:
        reports: List[object] = []
        for vid in variant_ids:
            state = registry.state(vid)
            artifact = state.artifact if state.diverged else lead.artifact
            re_updates: Dict[str, Dict[str, Dict[int, float]]] = {}
            for cid, pool in entity_pool.items():
                k = min(rows_per_delta, len(pool))
                picks = rng.choice(len(pool), size=k, replace=False)
                dim = artifact.tables[cid].dim
                per_entity: Dict[str, Dict[int, float]] = {}
                for p in picks:
                    nz = rng.integers(0, dim, size=min(4, dim))
                    per_entity[str(pool[int(p)])] = {
                        int(i): float(v)
                        for i, v in zip(
                            nz, rng.normal(0.0, scale, size=nz.size)
                        )
                    }
                re_updates[cid] = per_entity
            generations[vid] += 1
            delta = build_delta(
                re_updates,
                artifact,
                base_fingerprint=state.fingerprint,
                generation=generations[vid],
            )
            if watch_dir is not None:
                vdir = os.path.join(watch_dir, vid)
                os.makedirs(vdir, exist_ok=True)
                save_delta(
                    delta,
                    os.path.join(vdir, delta_dir_name(generations[vid])),
                )
                reports.extend(registry.poll_directory(vid, vdir))
            else:
                reports.append(registry.apply_delta(vid, delta))
        return reports

    return _tick

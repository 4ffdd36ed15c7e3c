"""Deterministic variant routing with hot-adjustable ramp percentages.

A ramped rollout needs two properties at once: the variant split must be
*hot-adjustable* (1% -> 50% -> 100% without restarting or draining the
server) and *sticky per request* (replaying a request id must land on the
same variant, so experiment buckets are reproducible and debuggable).

``VariantRouter`` gets both from one seeded hash: a request's position is
``crc32(seed || tenant/request_id) % 10_000`` (basis points), and the
tenant's ramp table is a walk over ``[0, 10_000)`` — each entry claims a
contiguous slice, the remainder falls to the tenant's default variant.
Ramp changes move only the boundary: raising a variant 1% -> 50% keeps
every request it already served on it (their positions are < the old
boundary, hence < the new one), which is exactly what a rollout wants.

Port of ``photon_ml_tpu/serving/tenancy/router.py``, copied: the same
seed, tenant and request id route to the same variant in either package.
"""

from __future__ import annotations

import threading
import zlib
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch.serving.tenancy.variants import BASE_VARIANT

_BASIS = 10_000  # ramp resolution: basis points (0.01%)


class VariantRouter:
    """Maps ``(tenant, request_id) -> variant_id``, deterministically.

    ``default_variant`` serves every unramped request. Per-tenant ramps
    are set with :meth:`set_ramp` (and ``tenant=None`` sets the global
    ramp used by tenants without their own); :meth:`pin` short-circuits a
    tenant entirely (0%/100% holdouts, internal canary tenants)."""

    def __init__(
        self, default_variant: str = BASE_VARIANT, seed: int = 0
    ):
        self.default_variant = default_variant
        self.seed = int(seed)
        self._lock = threading.Lock()
        # tenant (None = global) -> [(variant_id, basis_points), ...]
        self._ramps: Dict[Optional[str], List[Tuple[str, int]]] = {}
        self._pins: Dict[str, str] = {}
        self.decisions: Dict[str, int] = {}

    # -------------------------------------------------------------- control

    def set_ramp(
        self,
        variant_id: str,
        percent: float,
        tenant: Optional[str] = None,
    ) -> None:
        """Route ``percent`` (0..100) of the tenant's traffic to
        ``variant_id`` (``tenant=None`` -> all tenants without their own
        ramp). Hot: takes effect on the next routed request; other
        variants' ramp slices and all pins are untouched."""
        if not 0.0 <= percent <= 100.0:
            raise ValueError(f"ramp percent must be in [0, 100], got {percent}")
        bp = int(round(percent * _BASIS / 100.0))
        with self._lock:
            ramp = [
                (v, b)
                for v, b in self._ramps.get(tenant, [])
                if v != variant_id
            ]
            if bp > 0:
                ramp.append((variant_id, bp))
            total = sum(b for _, b in ramp)
            if total > _BASIS:
                raise ValueError(
                    f"ramp shares for tenant {tenant!r} sum to "
                    f"{total / _BASIS:.1%} > 100%"
                )
            if ramp:
                self._ramps[tenant] = ramp
            else:
                self._ramps.pop(tenant, None)

    def clear_ramp(self, tenant: Optional[str] = None) -> None:
        with self._lock:
            self._ramps.pop(tenant, None)

    def pin(self, tenant: str, variant_id: Optional[str]) -> None:
        """Pin every request of ``tenant`` to one variant (``None``
        unpins)."""
        with self._lock:
            if variant_id is None:
                self._pins.pop(tenant, None)
            else:
                self._pins[tenant] = variant_id

    # -------------------------------------------------------------- routing

    def position(self, tenant: Optional[str], request_id: str) -> int:
        """The request's stable position in ``[0, 10_000)`` basis points.
        Seeded so distinct deployments (or reshuffles) get independent
        bucketings of the same ids."""
        key = f"{self.seed}|{tenant or ''}/{request_id}"
        return zlib.crc32(key.encode("utf-8")) % _BASIS

    def route(self, tenant: Optional[str], request_id: str) -> str:
        # lock-free read path (this is per-request): set_ramp/pin replace
        # whole list/dict values, so a concurrent reader sees either the
        # old or the new ramp atomically; the decision counter tolerates
        # benign races (it is reporting, not control flow)
        pinned = self._pins.get(tenant) if tenant is not None else None
        if pinned is not None:
            choice = pinned
        else:
            ramp = self._ramps.get(tenant)
            if ramp is None:
                ramp = self._ramps.get(None, ())
            choice = self.default_variant
            if ramp:
                pos = self.position(tenant, request_id)
                lo = 0
                for variant_id, bp in ramp:
                    if lo <= pos < lo + bp:
                        choice = variant_id
                        break
                    lo += bp
        self.decisions[choice] = self.decisions.get(choice, 0) + 1
        return choice

    def route_many(
        self, tenant: Optional[str], request_ids: Sequence[str]
    ) -> List[str]:
        """Bulk :meth:`route` for one tenant's request run — identical
        decisions (same positions, same boundary walk), but the hash runs
        in a generator feeding one vectorized boundary lookup instead of
        one Python frame per request. This is the replay hot path: per
        request it costs ~1 crc32 + 2 array ops, not a method call."""
        pinned = self._pins.get(tenant) if tenant is not None else None
        if pinned is not None:
            choices = [pinned] * len(request_ids)
        else:
            ramp = self._ramps.get(tenant)
            if ramp is None:
                ramp = self._ramps.get(None, ())
            if not ramp:
                choices = [self.default_variant] * len(request_ids)
            else:
                # crc32(prefix + rid) == crc32(rid, crc32(prefix)): chain
                # from the precomputed prefix CRC so the per-request work
                # is one encode + one C call, no string concat — positions
                # are bitwise identical to route()'s
                crc = zlib.crc32
                prefix_crc = crc(
                    f"{self.seed}|{tenant or ''}/".encode("utf-8")
                )
                positions = (
                    np.fromiter(
                        (
                            crc(rid.encode("utf-8"), prefix_crc)
                            for rid in request_ids
                        ),
                        dtype=np.int64,
                        count=len(request_ids),
                    )
                    % _BASIS
                )
                # searchsorted over the cumulative slice bounds reproduces
                # route()'s walk: pos < bounds[0] -> ramp[0], pos past the
                # last bound -> the default variant
                bounds = np.cumsum([bp for _, bp in ramp])
                names = [v for v, _ in ramp] + [self.default_variant]
                choices = [
                    names[i]
                    for i in np.searchsorted(bounds, positions, side="right")
                ]
        for variant_id, n in Counter(choices).items():
            self.decisions[variant_id] = (
                self.decisions.get(variant_id, 0) + n
            )
        return choices

    # ------------------------------------------------------------ reporting

    def shares(self) -> Dict[str, float]:
        """Observed routed-traffic share per variant (decision counts)."""
        with self._lock:
            total = sum(self.decisions.values())
            if not total:
                return {}
            return {
                v: n / total for v, n in sorted(self.decisions.items())
            }

    def status(self) -> Dict[str, object]:
        with self._lock:
            return {
                "default_variant": self.default_variant,
                "seed": self.seed,
                "ramps": {
                    ("*" if t is None else t): {
                        v: bp / _BASIS * 100.0 for v, bp in ramp
                    }
                    for t, ramp in sorted(
                        self._ramps.items(), key=lambda kv: kv[0] or ""
                    )
                },
                "pins": dict(sorted(self._pins.items())),
                "decisions": dict(sorted(self.decisions.items())),
            }

"""Per-tenant admission quotas with priority-aware shedding.

One shared scorer means one shared device budget: a tenant replaying a
backfill at 50x its contracted rate would otherwise queue every other
tenant behind it (the classic noisy-neighbour failure the
``tenant_isolation`` scenario reproduces). ``TenantQuota`` is the
admission valve in front of the tenancy plane's batchers: a token bucket
per tenant (contracted ``rate`` req/s with ``burst`` headroom), plus an
optional *global* bucket modelling the machine's aggregate capacity,
whose last ``reserve_fraction`` is spendable only by the highest-priority
tenants — so when the box saturates, low-priority bulk traffic sheds
first and interactive tenants keep their SLO.

Sheds are charged to the *shedding tenant's* error budget by the caller
(``TenancyPlane``), never to the global SLO — a tenant exceeding its own
contract must not burn anyone else's budget, including the operator's.

Port of ``photon_ml_tpu/serving/tenancy/quota.py``, copied: under the
same clock either package admits and sheds the same requests.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, Mapping, Optional


@dataclasses.dataclass
class TenantBudget:
    """One tenant's admission contract: sustained ``rate`` requests/s,
    ``burst`` instantaneous headroom, and scheduling ``priority`` (higher
    = shed later when the global pool runs dry)."""

    rate: float
    burst: float
    priority: int = 0

    def __post_init__(self):
        if self.rate <= 0 or self.burst <= 0:
            raise ValueError(
                f"rate and burst must be positive, got rate={self.rate} "
                f"burst={self.burst}"
            )


class TenantQuota:
    def __init__(
        self,
        budgets: Mapping[str, TenantBudget],
        global_rate: Optional[float] = None,
        global_burst: Optional[float] = None,
        reserve_fraction: float = 0.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if not 0.0 <= reserve_fraction < 1.0:
            raise ValueError(
                f"reserve_fraction must be in [0, 1), got {reserve_fraction}"
            )
        self._budgets = dict(budgets)
        self._clock = clock
        self._lock = threading.Lock()
        self._tokens = {t: b.burst for t, b in self._budgets.items()}
        self._last: Optional[float] = None
        self._global_rate = global_rate
        self._global_burst = (
            global_burst if global_burst is not None else global_rate
        )
        self._global_tokens = self._global_burst
        self._reserve = (
            reserve_fraction * self._global_burst
            if self._global_burst is not None
            else 0.0
        )
        self._top_priority = max(
            (b.priority for b in self._budgets.values()), default=0
        )
        self.admitted: Dict[str, int] = {}
        self.shed: Dict[str, int] = {}

    def _refill(self, now: float) -> None:
        last = self._last
        self._last = now
        if last is None:
            return
        dt = now - last
        if dt <= 0:
            return
        for tenant, budget in self._budgets.items():
            self._tokens[tenant] = min(
                budget.burst, self._tokens[tenant] + budget.rate * dt
            )
        if self._global_rate is not None:
            self._global_tokens = min(
                self._global_burst,
                self._global_tokens + self._global_rate * dt,
            )

    def try_admit(self, tenant: str, n: int = 1) -> bool:
        """Admit ``n`` requests for ``tenant`` or shed them. Tenants with
        no configured budget are admitted (quota is opt-in per tenant) but
        still draw from the global pool at priority 0."""
        with self._lock:
            self._refill(self._clock())
            budget = self._budgets.get(tenant)
            if budget is not None and self._tokens[tenant] < n:
                self.shed[tenant] = self.shed.get(tenant, 0) + n
                return False
            if self._global_rate is not None:
                priority = budget.priority if budget is not None else 0
                # the reserve is spendable only by top-priority tenants
                floor = 0.0 if priority >= self._top_priority else self._reserve
                if self._global_tokens - n < floor - 1e-9:
                    self.shed[tenant] = self.shed.get(tenant, 0) + n
                    return False
                self._global_tokens -= n
            if budget is not None:
                self._tokens[tenant] -= n
            self.admitted[tenant] = self.admitted.get(tenant, 0) + n
            return True

    def stats(self) -> Dict[str, object]:
        with self._lock:
            tenants = sorted(
                set(self._budgets) | set(self.admitted) | set(self.shed)
            )
            return {
                "tenants": {
                    t: {
                        "admitted": self.admitted.get(t, 0),
                        "shed": self.shed.get(t, 0),
                        "rate": (
                            self._budgets[t].rate
                            if t in self._budgets
                            else None
                        ),
                        "priority": (
                            self._budgets[t].priority
                            if t in self._budgets
                            else 0
                        ),
                    }
                    for t in tenants
                },
                "global_tokens": self._global_tokens,
                "reserve": self._reserve,
            }

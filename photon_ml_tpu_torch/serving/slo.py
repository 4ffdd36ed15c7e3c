"""Serving SLOs: availability + latency objectives with error-budget burn.

An SLO here is two objectives over a rolling window:

- **availability**: at least ``availability_objective`` of requests must
  complete without a scorer error (default 99.9%);
- **latency**: at least ``latency_objective`` of requests must finish
  under ``latency_threshold_s`` (default: 99% under 50ms).

Each objective's **error budget** is its allowed bad fraction
(``1 - objective``) of the window's traffic. The **burn rate** is the
observed bad fraction divided by the allowed one — burn 1.0 means the
budget is being consumed exactly as fast as it accrues; burn 2.0 means
the window will exhaust twice over. Budget remaining is ``1 - burn``
clamped at zero, and the tracker turns unhealthy (``/healthz`` degraded
reason, ``serving.slo.*`` gauges) when either objective's budget is
exhausted — the standard SRE error-budget alarm, scoped to a window so a
single historic incident does not poison the gauge forever.

The window is a ring of time buckets (default 30 x 10s): observation is
O(1) per batch (three integer adds into the current bucket), ``status``
is O(buckets). The clock is injectable so tests and the scenario harness
drive it deterministically.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional


class SLOTracker:
    def __init__(
        self,
        latency_threshold_s: float = 0.050,
        latency_objective: float = 0.99,
        availability_objective: float = 0.999,
        window_s: float = 300.0,
        num_buckets: int = 30,
        clock: Callable[[], float] = time.monotonic,
        registry=None,
    ):
        if not 0.0 < latency_objective < 1.0:
            raise ValueError(
                f"latency_objective must be in (0, 1), got {latency_objective}"
            )
        if not 0.0 < availability_objective < 1.0:
            raise ValueError(
                "availability_objective must be in (0, 1), got "
                f"{availability_objective}"
            )
        if latency_threshold_s <= 0:
            raise ValueError(
                f"latency_threshold_s must be > 0, got {latency_threshold_s}"
            )
        self.latency_threshold_s = float(latency_threshold_s)
        self.latency_objective = float(latency_objective)
        self.availability_objective = float(availability_objective)
        self.window_s = float(window_s)
        self.num_buckets = max(1, int(num_buckets))
        self._bucket_s = self.window_s / self.num_buckets
        self._clock = clock
        self._registry = registry
        # ring of [total, slow, errors] per time bucket
        self._ring = [[0, 0, 0] for _ in range(self.num_buckets)]
        self._epoch: Optional[float] = None
        self._head = 0  # absolute bucket index currently written
        self.total_observed = 0

    # ------------------------------------------------------------ observing

    def _current(self) -> list:
        now = self._clock()
        if self._epoch is None:
            self._epoch = now
        idx = int((now - self._epoch) / self._bucket_s)
        if idx > self._head:
            # zero every bucket the clock skipped over (bounded by ring size)
            for k in range(self._head + 1, min(idx, self._head + self.num_buckets) + 1):
                self._ring[k % self.num_buckets] = [0, 0, 0]
            self._head = idx
        return self._ring[self._head % self.num_buckets]

    def observe_many(self, latencies, errors: int = 0) -> None:
        """Fold one drained batch in: ``latencies`` are the seconds of the
        requests that completed, ``errors`` counts requests that failed
        (they consume availability budget; no latency sample exists)."""
        bucket = self._current()
        n = len(latencies)
        slow = 0
        if n:
            thr = self.latency_threshold_s
            try:  # ndarray fast path (one vectorized compare per batch)
                slow = int((latencies > thr).sum())
            except TypeError:
                slow = sum(1 for s in latencies if s > thr)
        bucket[0] += n + int(errors)
        bucket[1] += slow
        bucket[2] += int(errors)
        self.total_observed += n + int(errors)

    def observe(self, latency_s: float) -> None:
        self.observe_many((latency_s,))

    # ------------------------------------------------------------- reporting

    def _window_counts(self):
        # advance the ring so stale buckets age out even without traffic
        self._current()
        total = slow = errors = 0
        for t, s, e in self._ring:
            total += t
            slow += s
            errors += e
        return total, slow, errors

    def status(self) -> dict:
        """Window verdict + burn accounting; also refreshes the
        ``serving.slo.*`` gauges when a registry is attached."""
        total, slow, errors = self._window_counts()
        ok_latency = total - errors - slow
        completed = total - errors
        availability = 1.0 if total == 0 else 1.0 - errors / total
        latency_ok_rate = 1.0 if completed <= 0 else ok_latency / completed
        avail_burn = (
            0.0
            if total == 0
            else (errors / total) / (1.0 - self.availability_objective)
        )
        lat_burn = (
            0.0
            if completed <= 0
            else (slow / completed) / (1.0 - self.latency_objective)
        )
        burn = max(avail_burn, lat_burn)
        budget_remaining = max(0.0, 1.0 - burn)
        exhausted = []
        if avail_burn >= 1.0:
            exhausted.append("availability")
        if lat_burn >= 1.0:
            exhausted.append("latency")
        doc = {
            "objectives": {
                "availability": self.availability_objective,
                "latency": self.latency_objective,
                "latency_threshold_s": self.latency_threshold_s,
            },
            "window_s": self.window_s,
            "window_requests": total,
            "window_errors": errors,
            "window_slow": slow,
            "availability": round(availability, 6),
            "latency_ok_rate": round(latency_ok_rate, 6),
            "burn_rate": round(burn, 4),
            "availability_burn_rate": round(avail_burn, 4),
            "latency_burn_rate": round(lat_burn, 4),
            "error_budget_remaining": round(budget_remaining, 4),
            "verdict": (
                "budget_exhausted:" + "+".join(exhausted) if exhausted else "ok"
            ),
            "healthy": not exhausted,
        }
        if self._registry is not None:
            self._registry.gauge("serving.slo.availability", availability)
            self._registry.gauge(
                "serving.slo.latency_ok_rate", latency_ok_rate
            )
            self._registry.gauge("serving.slo.burn_rate", burn)
            self._registry.gauge(
                "serving.slo.error_budget_remaining", budget_remaining
            )
            self._registry.gauge(
                "serving.slo.budget_exhausted", 1.0 if exhausted else 0.0
            )
        return doc

    def health(self) -> Dict[str, object]:
        """``/healthz`` contribution: unhealthy while the rolling error
        budget is exhausted (serving keeps answering — the SLO alarm is a
        paging signal, not a kill switch)."""
        status = self.status()
        doc: Dict[str, object] = {"healthy": status["healthy"]}
        if not status["healthy"]:
            doc["degraded"] = (
                f"slo {status['verdict']} (burn {status['burn_rate']:.2f}x, "
                f"availability {status['availability']:.4f}, "
                f"latency_ok {status['latency_ok_rate']:.4f})"
            )
        return doc

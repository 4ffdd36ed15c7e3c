"""Closed-loop overload control: SLO burn rate drives serving actuation.

The request plane makes overload *visible* (burn-rate gauges, tail
attribution); this module makes it an *actuator*. An
:class:`OverloadController` reads one :class:`~photon_ml_tpu_torch.serving.slo
.SLOTracker`'s burn rate and, through a hysteresis state machine, drives
two knobs on the batchers attached to it:

- **deadline shrink** — while overloaded, every attached batcher's
  ``max_wait_s`` is scaled by ``shrink_factor`` (smaller buckets dispatch
  sooner: queue wait is traded for batch fill exactly when queue wait is
  what burns the latency budget);
- **FE-only shed** — requests whose random-effect entities are ALL
  absent or non-resident would gather the zero cold slot and score
  FE-only anyway; while overloaded those requests are answered inline on
  the host (same left-join FE-only semantics, no queue, no device
  dispatch), so the queue drains for requests whose scores actually need
  the device.

Control loop: ``burn >= burn_high`` (default 1.0 — the budget is burning
faster than it accrues) enters overload; ``burn <= burn_low`` (default
0.5) recovers. The gap is the hysteresis band that keeps the controller
from flapping at the boundary. The batchers poll the controller from
their own drain paths (``maybe_poll``), so no extra thread is required —
``start()`` runs an optional background poller for servers whose traffic
can stall entirely.

Observability: ``serving.overload.*`` gauges (burn rate, active flag,
deadline scale, sheds) when a metrics registry is attached, plus
``status()`` for ``/varz`` and the scenario result docs.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from photon_ml_tpu_torch.serving.scorer import ScoreRequest, ScoreResult
from photon_ml_tpu_torch.types import TaskType


def _host_mean(task, z: float) -> float:
    """Host-side task link-inverse (mirrors ``losses.pointwise
    .mean_function`` without a device dispatch); numerically stable
    sigmoid for the logistic task."""
    if task is TaskType.LOGISTIC_REGRESSION:
        if z >= 0:
            return 1.0 / (1.0 + math.exp(-z))
        e = math.exp(z)
        return e / (1.0 + e)
    if task is TaskType.POISSON_REGRESSION:
        return math.exp(min(z, 700.0))
    return z


class OverloadController:
    """SLO-burn-driven overload control over one serving replica group.

    ``attach()`` batchers (their native deadlines are recorded and
    restored on recovery/detach); ``attach_scorer()`` the scorer whose
    fixed-effect tables back the FE-only shed path. ``poll()`` reads the
    tracker and actuates; ``try_shed()`` is the batchers' intake hook.

    All actuation is reversible and bounded: deadlines never shrink below
    ``shrink_factor`` of their configured value, and shedding only ever
    answers requests with the score the full path would have produced
    FE-only anyway (cold/non-resident entities gather the zero cold
    slot)."""

    def __init__(
        self,
        slo,
        shrink_factor: float = 0.5,
        burn_high: float = 1.0,
        burn_low: float = 0.5,
        poll_interval_s: float = 0.05,
        registry=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if not 0.0 < shrink_factor <= 1.0:
            raise ValueError(
                f"shrink_factor must be in (0, 1], got {shrink_factor}"
            )
        if burn_low > burn_high:
            raise ValueError(
                f"burn_low {burn_low} > burn_high {burn_high} — the "
                "hysteresis band must be ordered"
            )
        self._slo = slo
        self.shrink_factor = float(shrink_factor)
        self.burn_high = float(burn_high)
        self.burn_low = float(burn_low)
        self.poll_interval_s = float(poll_interval_s)
        self._registry = registry
        self._clock = clock
        self._lock = threading.RLock()
        # id(batcher) -> (batcher, native max_wait_s or None)
        self._batchers: Dict[int, tuple] = {}
        self._scorer = None
        self._fe_specs: List[tuple] = []
        self._re_specs: List[tuple] = []
        self._fe_host: Dict[str, np.ndarray] = {}
        self._fe_src: Dict[str, int] = {}
        self.active = False
        self.last_burn = 0.0
        self.activations = 0
        self.recoveries = 0
        self.shed_total = 0
        self._last_poll = -math.inf
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()

    # ----------------------------------------------------------- attachment

    def attach(self, batcher) -> None:
        """Register a batcher for deadline actuation and shed intake.
        Applies the current state immediately (attaching mid-overload
        shrinks right away)."""
        with self._lock:
            native = getattr(batcher, "max_wait_s", None)
            self._batchers[id(batcher)] = (batcher, native)
            batcher._overload = self
            if self.active and native is not None:
                batcher.max_wait_s = native * self.shrink_factor

    def detach(self, batcher) -> None:
        """Unregister and restore the batcher's native deadline."""
        with self._lock:
            entry = self._batchers.pop(id(batcher), None)
            if entry is not None:
                _, native = entry
                if native is not None:
                    batcher.max_wait_s = native
            if getattr(batcher, "_overload", None) is self:
                batcher._overload = None

    def attach_scorer(self, scorer) -> None:
        """Bind the scorer whose FE tables and routing back the shed
        path. Host copies of the FE vectors are cached and refreshed
        whenever a hot swap replaces the device arrays (identity check
        per coordinate, O(1) when nothing changed)."""
        with self._lock:
            self._scorer = scorer
            self._fe_specs = list(getattr(scorer, "_fe_specs", []))
            self._re_specs = list(getattr(scorer, "_re_specs", []))
            self._fe_host.clear()
            self._fe_src.clear()

    # ------------------------------------------------------------- control

    def poll(self) -> bool:
        """One control step: read the burn rate, move the hysteresis
        state machine, actuate deadlines, refresh gauges. Returns the
        post-step overload state."""
        status = self._slo.status()
        burn = float(status.get("burn_rate", 0.0))
        with self._lock:
            self.last_burn = burn
            if not self.active and burn >= self.burn_high:
                self.active = True
                self.activations += 1
                for batcher, native in self._batchers.values():
                    if native is not None:
                        batcher.max_wait_s = native * self.shrink_factor
            elif self.active and burn <= self.burn_low:
                self.active = False
                self.recoveries += 1
                for batcher, native in self._batchers.values():
                    if native is not None:
                        batcher.max_wait_s = native
            active = self.active
        if self._registry is not None:
            self._registry.gauge("serving.overload.burn_rate", burn)
            self._registry.gauge(
                "serving.overload.active", 1.0 if active else 0.0
            )
            self._registry.gauge(
                "serving.overload.deadline_scale",
                self.shrink_factor if active else 1.0,
            )
            self._registry.gauge(
                "serving.overload.shed_total", float(self.shed_total)
            )
        return active

    def maybe_poll(self, now: Optional[float] = None) -> None:
        """Rate-limited :meth:`poll` for the batchers' drain paths: a
        no-op within ``poll_interval_s`` of the last step, and contention
        -free (a second thread arriving mid-poll skips instead of
        queueing)."""
        now = self._clock() if now is None else now
        if now - self._last_poll < self.poll_interval_s:
            return
        if not self._lock.acquire(blocking=False):
            return
        try:
            if now - self._last_poll < self.poll_interval_s:
                return
            self._last_poll = now
        finally:
            self._lock.release()
        self.poll()

    # ------------------------------------------------------------ shedding

    def _fe_vector(self, cid: str) -> Optional[np.ndarray]:
        params = getattr(self._scorer, "_fe_params", None)
        if params is None:
            return None
        dev = params.get(cid)
        if dev is None:
            return None
        if self._fe_src.get(cid) != id(dev):
            self._fe_host[cid] = dev.detach().cpu().numpy().astype(np.float32, copy=False)
            self._fe_src[cid] = id(dev)
        return self._fe_host[cid]

    def try_shed(self, request: ScoreRequest) -> Optional[ScoreResult]:
        """Answer a request FE-only on the host, IF overload is active
        and every random-effect entity of the request is absent or
        non-resident (the full path would score it FE-only through the
        cold slot anyway — shedding changes latency, not semantics).
        Returns None when the request must take the device path."""
        if not self.active:
            return None
        scorer = self._scorer
        if scorer is None:
            return None
        artifact = scorer.artifact
        routing = getattr(scorer, "_routing", None)
        cold: List[str] = []
        for cid, _, re_type in self._re_specs:
            eid = request.entity_ids.get(re_type)
            if eid is None:
                cold.append(cid)
                continue
            if type(eid) is not str:
                eid = str(eid)
            row = int(
                artifact.tables[cid].entity_index.get_indices([eid])[0]
            )
            if row < 0:
                cold.append(cid)
                continue
            if routing is None:
                return None  # no cheap residency probe: keep the device path
            coord = routing[cid]
            if (
                row < coord._slot_of.size
                and coord._slot_of[row] >= 0
            ):
                return None  # resident row: a shed would change the score
            cold.append(cid)
        z = float(request.offset)
        for cid, shard in self._fe_specs:
            w = self._fe_vector(cid)
            if w is None:
                return None
            feats = request.features.get(shard)
            if feats:
                for i, v in feats.items():
                    z += float(v) * float(w[i])
        with self._lock:
            self.shed_total += 1
        return ScoreResult(
            request_id=request.request_id,
            score=z,
            mean=float(_host_mean(scorer.task, z)),
            cold_coordinates=tuple(cold),
        )

    # ------------------------------------------------------------ lifecycle

    def start(self, interval_s: Optional[float] = None) -> "OverloadController":
        """Optional background poller (the batcher drain paths already
        poll; this covers servers whose traffic can stall entirely, so
        recovery is observed even with zero drains)."""
        if self._thread is not None:
            raise RuntimeError("overload controller already started")
        interval = (
            self.poll_interval_s if interval_s is None else float(interval_s)
        )
        self._stop_evt = threading.Event()

        def _loop():
            while not self._stop_evt.is_set():
                self.poll()
                self._stop_evt.wait(interval)

        self._thread = threading.Thread(
            target=_loop, name="overload-controller", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the background poller and restore every attached
        batcher's native deadline."""
        if self._thread is not None:
            self._stop_evt.set()
            self._thread.join()
            self._thread = None
        with self._lock:
            if self.active:
                self.active = False
                self.recoveries += 1
            for batcher, native in self._batchers.values():
                if native is not None:
                    batcher.max_wait_s = native

    def __enter__(self) -> "OverloadController":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ----------------------------------------------------------- reporting

    def status(self) -> dict:
        """``/varz`` + scenario-doc contribution."""
        with self._lock:
            return {
                "active": self.active,
                "last_burn_rate": round(self.last_burn, 4),
                "burn_high": self.burn_high,
                "burn_low": self.burn_low,
                "shrink_factor": self.shrink_factor,
                "activations": self.activations,
                "recoveries": self.recoveries,
                "shed_total": self.shed_total,
                "attached_batchers": len(self._batchers),
            }

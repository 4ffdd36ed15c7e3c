"""Continuous microbatching: requests join in-flight buckets to a deadline.

Port of ``photon_ml_tpu/serving/continuous.py``, with one difference: a
worker that crashes outside ``score_batch`` (which resolves its own
errors) puts the unresolved requests of its batch back at the head of
their lane before its supervisor restarts it, where the reference leaves
their handles unresolved.

``MicroBatcher`` seals a batch at submit time: the submitting caller
scores a full bucket inline, and deadline draining only happens when the
caller remembers to ``poll()``. Under load that serializes admission and
scoring in one thread, and a request arriving just after a seal waits a
full scoring pass before its bucket even forms.

The continuous batcher decouples the two: ``submit`` is an O(1) enqueue
returning a :class:`PendingResult`; a dedicated scoring thread drains the
queue whenever a full max-size bucket is pending OR the oldest request
has waited ``max_wait_s`` — so requests keep joining the forming bucket
right up to its deadline while the previous bucket is still on device.
Shapes stay fixed: a drain pads to one of ``bucket_sizes``, and the
compiled-program count per scorer stays at ``len(bucket_sizes)``.

Backpressure bounds the tail: ``max_queue`` caps pending requests, and a
full queue blocks ``submit`` — p99 latency is then roughly
``max_queue / throughput + one bucket's scoring time`` instead of
unbounded queue growth.

Two priority lanes keep serving work ahead of everything else: the
``live`` lane (default) holds request traffic; the ``background`` lane
(``submit(..., priority="background")``) holds admission warmups, swap
probes, and nearline replays, and drains ONLY when no live request is
pending — background work can never queue ahead of a live request. Each
lane is independently capped at ``max_queue``, so a background flood
cannot backpressure live submitters.

Two optional controls act at the queue boundary: a
:class:`~photon_ml_tpu_torch.serving.tenancy.quota.TenantQuota` (``quota=``)
is consulted at DRAIN time — a tenant over budget has its requests
resolved with an error before they reach the device, charged to that
tenant's own error budget via the plane — and an attached
:class:`~photon_ml_tpu_torch.serving.overload.OverloadController` may answer
FE-only-able requests at SUBMIT time while the SLO budget is burning.

``scorers`` accepts one scorer or several replicas (multi-scorer mode:
one ``GameScorer`` per device, shared routing index) — drained buckets
round-robin across replicas, one scoring thread per replica, so replica
scoring overlaps wherever the backend allows.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch.resilience.supervisor import SupervisedThread
from photon_ml_tpu_torch.serving.batcher import DEFAULT_BUCKET_SIZES
from photon_ml_tpu_torch.serving.metrics import ServingMetrics
from photon_ml_tpu_torch.serving.requestplane import tenant_of_request_id
from photon_ml_tpu_torch.serving.scorer import ScoreRequest, ScoreResult
from photon_ml_tpu_torch.telemetry import span


class PendingResult:
    """Handle for one submitted request; ``result()`` blocks until its
    bucket is scored. Deliberately lighter than ``concurrent.futures``:
    no per-handle lock/condition — completion is signalled through the
    batcher's single condition, so creating one costs an allocation, not
    kernel objects."""

    __slots__ = ("_batcher", "value", "error", "done")

    def __init__(self, batcher: "ContinuousBatcher"):
        self._batcher = batcher
        self.value: Optional[ScoreResult] = None
        self.error: Optional[BaseException] = None
        self.done = False

    def result(self, timeout: Optional[float] = None) -> ScoreResult:
        if not self.done:
            self._batcher._wait_for(self, timeout)
        if self.error is not None:
            raise self.error
        return self.value  # type: ignore[return-value]


class ContinuousBatcher:
    def __init__(
        self,
        scorers,
        bucket_sizes: Sequence[int] = DEFAULT_BUCKET_SIZES,
        metrics: Optional[ServingMetrics] = None,
        max_wait_s: float = 0.002,
        max_queue: Optional[int] = None,
        clock: Callable[[], float] = time.perf_counter,
        plane=None,
        quota=None,
    ):
        scorers = (
            list(scorers) if isinstance(scorers, (list, tuple)) else [scorers]
        )
        if not scorers:
            raise ValueError("need at least one scorer")
        if max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
        buckets = sorted({int(b) for b in bucket_sizes})
        if not buckets or buckets[0] < 1:
            raise ValueError(f"bucket sizes must be positive, got {bucket_sizes}")
        for scorer in scorers:
            for cid, cache in getattr(scorer, "caches", {}).items():
                if cache.capacity < buckets[-1]:
                    raise ValueError(
                        f"hot-entity cache for {cid!r} holds {cache.capacity} "
                        f"rows < max bucket size {buckets[-1]}"
                    )
        self._scorers = scorers
        self.bucket_sizes: Tuple[int, ...] = tuple(buckets)
        self.max_bucket = buckets[-1]
        self.max_wait_s = float(max_wait_s)
        self.max_queue = (
            int(max_queue) if max_queue is not None else 2 * self.max_bucket
        )
        if self.max_queue < self.max_bucket:
            raise ValueError(
                f"max_queue {self.max_queue} < max bucket {self.max_bucket}"
            )
        self._metrics = metrics
        # request plane (serving/requestplane.py): lifecycle sampling +
        # SLO feed; None (the default) costs one check per drained batch
        self._plane = plane
        # tenant token bucket (tenancy/quota.py), consulted at DRAIN time:
        # an over-budget tenant's requests resolve with an error instead of
        # occupying device bucket slots
        self._quota = quota
        # set by OverloadController.attach(); consulted at submit (shed)
        # and polled from the drain path
        self._overload = None
        self._stage_capable: dict = {}
        self._clock = clock
        self._cond = threading.Condition()
        self._pending: "deque[Tuple[ScoreRequest, float, PendingResult]]" = (
            deque()
        )
        # background lane: drains only when the live lane is empty
        self._pending_bg: (
            "deque[Tuple[ScoreRequest, float, PendingResult]]"
        ) = deque()
        self.quota_shed_total = 0
        self._inflight = 0  # requests popped but not yet resolved
        self._running = False
        self._stop_event = threading.Event()
        self._threads: List[SupervisedThread] = []
        self._scorer_errors = 0

    # ------------------------------------------------------------ lifecycle

    def start(
        self, max_restarts: int = 5, emitter=None
    ) -> "ContinuousBatcher":
        with self._cond:
            if self._running:
                raise RuntimeError("batcher already running")
            self._running = True
        self._stop_event = threading.Event()
        # mode="loop": _serve_loop returns cleanly when _running flips
        # False; a crash anywhere else is contained and the loop re-enters
        # after backoff instead of silently stranding its replica.
        self._threads = [
            SupervisedThread(
                f"serving-batcher-{i}",
                (lambda s=scorer: self._serve_loop(s)),
                mode="loop",
                stop_event=self._stop_event,
                max_restarts=max_restarts,
                emitter=emitter,
            )
            for i, scorer in enumerate(self._scorers)
        ]
        for t in self._threads:
            t.start()
        return self

    def stop(self) -> None:
        with self._cond:
            self._running = False
            self._cond.notify_all()
        self._stop_event.set()
        for t in self._threads:
            t.join()
        self._threads = []
        # resolve anything stranded (stop before flush): submitters must
        # not block forever on a dead batcher
        with self._cond:
            for lane in (self._pending, self._pending_bg):
                while lane:
                    _, _, handle = lane.popleft()
                    handle.error = RuntimeError(
                        "batcher stopped before scoring"
                    )
                    handle.done = True
            self._cond.notify_all()

    def __enter__(self) -> "ContinuousBatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def thread_stats(self) -> List[dict]:
        return [t.stats() for t in self._threads]

    def health(self) -> dict:
        """Healthy while at least one replica worker is not dead; every
        dead worker contributes a ``degraded`` reason."""
        workers = [t.health() for t in self._threads]
        degraded = [w["degraded"] for w in workers if not w["healthy"]]
        doc = {
            "healthy": not workers or len(degraded) < len(workers),
            "workers": workers,
            "scorer_errors": self._scorer_errors,
        }
        if degraded:
            doc["degraded"] = "; ".join(degraded)
        return doc

    # --------------------------------------------------------------- intake

    @property
    def queue_depth(self) -> int:
        return len(self._pending) + len(self._pending_bg)

    def submit(
        self, request: ScoreRequest, priority: str = "live"
    ) -> PendingResult:
        """Enqueue one request (blocks only on backpressure)."""
        return self.submit_many((request,), priority=priority)[0]

    def submit_many(
        self, requests: Sequence[ScoreRequest], priority: str = "live"
    ) -> List[PendingResult]:
        """Enqueue a burst under one lock acquisition (amortizes the
        condition handshake for high-rate closed-loop clients).

        ``priority="background"`` routes to the background lane, which
        drains only when no live request is pending. While an attached
        overload controller is active, live requests it can answer
        FE-only are resolved here without ever entering the queue."""
        if priority not in ("live", "background"):
            raise ValueError(f"unknown priority {priority!r}")
        handles = [PendingResult(self) for _ in requests]
        pairs = list(zip(requests, handles))
        ovl = self._overload
        if ovl is not None and priority == "live" and ovl.active:
            kept = []
            shed_ids: List[str] = []
            for req, handle in pairs:
                res = ovl.try_shed(req)
                if res is None:
                    kept.append((req, handle))
                else:
                    handle.value = res
                    handle.done = True
                    shed_ids.append(req.request_id)
            pairs = kept
            if shed_ids:
                plane = self._plane
                if plane is not None:
                    # shed answers ARE completions (FE-only, ~0 queue
                    # wait): feeding them lets the burn rate recover
                    lat = np.zeros(len(shed_ids), dtype=np.float64)
                    if getattr(plane, "wants_request_ids", False):
                        plane.observe_complete(lat, request_ids=shed_ids)
                    else:
                        plane.observe_complete(lat)
        lane = self._pending if priority == "live" else self._pending_bg
        with self._cond:
            if not self._running:
                raise RuntimeError("batcher is not running — call start()")
            i = 0
            while i < len(pairs):
                while len(lane) >= self.max_queue and self._running:
                    self._cond.wait()
                if not self._running:
                    raise RuntimeError("batcher stopped")
                room = self.max_queue - len(lane)
                now = self._clock()
                # C-level bulk extend: the lock is held, so per-item
                # appends would serialize against the scoring threads
                lane.extend(
                    (req, now, handle)
                    for req, handle in pairs[i : i + room]
                )
                i += room
                self._cond.notify_all()
        return handles

    def flush(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted request has been scored."""
        deadline = None if timeout is None else self._clock() + timeout
        with self._cond:
            while self._pending or self._pending_bg or self._inflight:
                remaining = (
                    None if deadline is None else deadline - self._clock()
                )
                if remaining is not None and remaining <= 0:
                    raise TimeoutError("flush timed out")
                self._cond.wait(remaining)

    def _wait_for(
        self, handle: PendingResult, timeout: Optional[float]
    ) -> None:
        deadline = None if timeout is None else self._clock() + timeout
        with self._cond:
            while not handle.done:
                remaining = (
                    None if deadline is None else deadline - self._clock()
                )
                if remaining is not None and remaining <= 0:
                    raise TimeoutError("result not ready")
                self._cond.wait(remaining)

    # -------------------------------------------------------------- serving

    def _bucket_for(self, n: int) -> int:
        for b in self.bucket_sizes:
            if b >= n:
                return b
        return self.max_bucket

    def _serve_loop(self, scorer) -> None:
        while True:
            batch = None
            with self._cond:
                while self._running:
                    # live lane first; background only when live is empty
                    lane = self._pending if self._pending else self._pending_bg
                    n = len(lane)
                    if n >= self.max_bucket:
                        break
                    if n:
                        oldest_wait = self._clock() - lane[0][1]
                        if oldest_wait >= self.max_wait_s:
                            break
                        self._cond.wait(self.max_wait_s - oldest_wait)
                    else:
                        self._cond.wait()
                if not self._running:
                    return
                lane = self._pending if self._pending else self._pending_bg
                take = min(len(lane), self.max_bucket)
                if take == len(lane):
                    batch = list(lane)
                    lane.clear()
                else:
                    batch = [lane.popleft() for _ in range(take)]
                self._inflight += take
                # queue room just opened: wake blocked submitters (and any
                # sibling replica thread waiting for work)
                self._cond.notify_all()
            try:
                self._score(scorer, batch)
            except BaseException:
                # a crash outside score_batch's own containment (the clock,
                # the quota, the metrics) must not strand the batch: its
                # unresolved requests go back to the head of their lane
                # for the restarted worker, then the supervisor sees the
                # crash
                with self._cond:
                    unresolved = [item for item in batch if not item[2].done]
                    lane.extendleft(reversed(unresolved))
                    self._inflight -= len(unresolved)
                    self._cond.notify_all()
                raise

    def _supports_stages(self, scorer) -> bool:
        """Whether this replica's ``score_batch`` accepts a stage clock
        (checked once per scorer: callers may pass stage-less scorers)."""
        key = id(scorer)
        cap = self._stage_capable.get(key)
        if cap is None:
            import inspect

            try:
                cap = "stages" in inspect.signature(
                    scorer.score_batch
                ).parameters
            except (TypeError, ValueError):
                cap = False
            self._stage_capable[key] = cap
        return cap

    def _apply_quota(self, batch):
        """Drain-time tenant admission: requests from a tenant whose token
        bucket is exhausted resolve with an error here — charged to that
        tenant's own error budget through the plane — instead of occupying
        device bucket slots ahead of in-budget tenants. Untagged requests
        (no ``tenant!`` prefix) always pass."""
        quota = self._quota
        kept = []
        shed = []
        for item in batch:
            tenant = tenant_of_request_id(item[0].request_id)
            if tenant is None or quota.try_admit(tenant):
                kept.append(item)
            else:
                shed.append(item)
        if shed:
            shed_ids = [req.request_id for req, _, _ in shed]
            with self._cond:
                for _, _, handle in shed:
                    handle.error = RuntimeError(
                        "request shed: tenant over quota at drain"
                    )
                    handle.done = True
                self.quota_shed_total += len(shed)
                self._inflight -= len(shed)
                self._cond.notify_all()
            plane = self._plane
            if plane is not None:
                if getattr(plane, "wants_request_ids", False):
                    plane.observe_errors(len(shed), request_ids=shed_ids)
                else:
                    plane.observe_errors(len(shed))
        return kept

    def _score(self, scorer, batch) -> None:
        if self._quota is not None:
            batch = self._apply_quota(batch)
            if not batch:
                if self._overload is not None:
                    self._overload.maybe_poll()
                return
        n = len(batch)
        dequeued = self._clock()
        bucket = self._bucket_for(n)
        plane = self._plane
        sampled: Optional[List[int]] = None
        stages: Optional[dict] = None
        if plane is not None:
            sampled = plane.sample_indices(
                [req.request_id for req, _, _ in batch]
            )
            if sampled and self._supports_stages(scorer):
                stages = {}
        results: Optional[List[ScoreResult]] = None
        error: Optional[BaseException] = None
        try:
            with span("serve/drain", n=n, bucket=bucket):
                if stages is not None:
                    results = scorer.score_batch(
                        [req for req, _, _ in batch], bucket, stages=stages
                    )
                else:
                    results = scorer.score_batch(
                        [req for req, _, _ in batch], bucket
                    )
        except BaseException as e:  # resolve handles, keep the loop alive
            error = e
            self._scorer_errors += 1
        done = self._clock()
        with self._cond:
            for i, (_, _, handle) in enumerate(batch):
                if error is None:
                    handle.value = results[i]
                else:
                    handle.error = error
                handle.done = True
            self._inflight -= n
            self._cond.notify_all()
        if plane is not None and error is not None:
            if getattr(plane, "wants_request_ids", False):
                plane.observe_errors(
                    n, request_ids=[req.request_id for req, _, _ in batch]
                )
            else:
                plane.observe_errors(n)
        if error is None and (self._metrics is not None or plane is not None):
            enqueued = np.fromiter(
                (t for _, t, _ in batch), dtype=np.float64, count=n
            )
            latencies = done - enqueued
            if self._metrics is not None:
                self._metrics.observe_batch(
                    n_real=n, bucket_size=bucket,
                    queue_depth=len(self._pending),
                )
                self._metrics.observe_queue_waits(dequeued - enqueued)
                self._metrics.observe_latencies(latencies, bucket_size=bucket)
            if plane is not None:
                if getattr(plane, "wants_request_ids", False):
                    # multi-tenant attribution: the id list is built only
                    # when the plane carries per-tenant SLO trackers
                    plane.observe_complete(
                        latencies,
                        request_ids=[req.request_id for req, _, _ in batch],
                    )
                else:
                    plane.observe_complete(latencies)
                if sampled:
                    plane.record_batch(
                        "continuous", bucket, n,
                        [
                            (batch[i][0].request_id, batch[i][1])
                            for i in sampled
                        ],
                        dequeued, stages, done,
                    )
        if self._overload is not None:
            # drain-path control step (rate-limited inside the controller):
            # the freshly fed SLO window drives shrink/shed for the NEXT
            # submissions, no dedicated poller thread required
            self._overload.maybe_poll()

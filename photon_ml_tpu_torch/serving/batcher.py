"""Request microbatcher: coalesce requests into fixed-shape padded batches.

Per-request scoring would make a device dispatch the price of every
request, and per-request shapes a new score signature per request. The
batcher holds a FIFO of pending requests and drains them in batches padded
to one of a small, fixed set of bucket sizes — so the scorer sees at most
``len(bucket_sizes)`` distinct shapes, ever.

Draining is synchronous: ``submit`` drains a full max-size batch whenever
enough requests are pending and returns any completed results; ``flush``
drains the remainder through the smallest bucket that fits. A real server
runs the deadline policy instead: construct with ``max_wait_s`` and call
``poll()`` from its event loop — once the OLDEST pending request has
waited past the deadline, everything pending drains through the smallest
fitting buckets, bounding queue wait without manual ``flush`` calls.

Two priority lanes mirror the continuous batcher: ``live`` (default)
holds request traffic; ``background`` holds admission warmups and
nearline replays and drains only when no live request is pending, so
background work never seals a bucket ahead of a live request. An
optional ``quota`` (tenancy token bucket) is consulted at drain time:
an over-budget tenant's requests are dropped from the bucket and
reported to the plane as errors charged to that tenant, instead of
occupying padded device slots.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch.serving.metrics import ServingMetrics
from photon_ml_tpu_torch.serving.requestplane import tenant_of_request_id
from photon_ml_tpu_torch.serving.scorer import GameScorer, ScoreRequest, ScoreResult
from photon_ml_tpu_torch.telemetry import span

DEFAULT_BUCKET_SIZES = (1, 2, 4, 8, 16, 32)


class MicroBatcher:
    def __init__(
        self,
        scorer: GameScorer,
        bucket_sizes: Sequence[int] = DEFAULT_BUCKET_SIZES,
        metrics: Optional[ServingMetrics] = None,
        clock: Callable[[], float] = time.perf_counter,
        max_wait_s: Optional[float] = None,
        plane=None,
        quota=None,
    ):
        if max_wait_s is not None and max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
        buckets = sorted({int(b) for b in bucket_sizes})
        if not buckets or buckets[0] < 1:
            raise ValueError(f"bucket sizes must be positive, got {bucket_sizes}")
        self.bucket_sizes: Tuple[int, ...] = tuple(buckets)
        self.max_bucket = buckets[-1]
        for cid, cache in scorer.caches.items():
            if cache.capacity < self.max_bucket:
                raise ValueError(
                    f"hot-entity cache for {cid!r} holds {cache.capacity} "
                    f"rows < max bucket size {self.max_bucket}; a single "
                    f"batch could evict rows it is about to gather"
                )
        self._scorer = scorer
        self._metrics = metrics
        # request plane (serving/requestplane.py): lifecycle sampling +
        # SLO feed; None (the default) costs one check per drained batch
        self._plane = plane
        # tenant token bucket (tenancy/quota.py), consulted at DRAIN time
        self._quota = quota
        # set by OverloadController.attach(); consulted at submit (shed)
        # and polled from the drain path
        self._overload = None
        self._stage_capable: Optional[bool] = None
        self._clock = clock
        self.max_wait_s = max_wait_s
        self._pending: "deque[Tuple[ScoreRequest, float]]" = deque()
        # background lane: drains only when the live lane is empty
        self._pending_bg: "deque[Tuple[ScoreRequest, float]]" = deque()
        self.quota_shed_total = 0

    @property
    def queue_depth(self) -> int:
        return len(self._pending) + len(self._pending_bg)

    def _bucket_for(self, n: int) -> int:
        for b in self.bucket_sizes:
            if b >= n:
                return b
        return self.max_bucket

    def _drain_full(self, out: List[ScoreResult]) -> None:
        """Drain full live buckets; background buckets only once the live
        lane is empty (lane ordering: background never seals a bucket
        ahead of a live request)."""
        while len(self._pending) >= self.max_bucket:
            out.extend(self._drain(self.max_bucket))
        while (
            not self._pending and len(self._pending_bg) >= self.max_bucket
        ):
            out.extend(self._drain(self.max_bucket, lane=self._pending_bg))

    def submit(
        self, request: ScoreRequest, priority: str = "live"
    ) -> List[ScoreResult]:
        """Enqueue one request; returns results completed by this call
        (empty until a full max-size batch has accumulated)."""
        # single-request fast path: this runs once per request on the
        # sealed serving loop, so it must not pay submit_many's framing
        ovl = self._overload
        if priority != "live" or (ovl is not None and ovl.active):
            return self.submit_many((request,), priority=priority)
        self._pending.append((request, self._clock()))
        if len(self._pending) < self.max_bucket:
            return []
        out: List[ScoreResult] = []
        self._drain_full(out)
        return out

    def submit_many(
        self, requests: Sequence[ScoreRequest], priority: str = "live"
    ) -> List[ScoreResult]:
        """Enqueue a pre-collected run of requests in one call (the
        tenancy plane's bulk replay path). Same drain policy as
        :meth:`submit` — full max-size batches drain as they accumulate —
        but one clock read and one Python frame for the whole run instead
        of one per request. ``priority="background"`` routes to the
        background lane (drained only when no live request is pending).
        While an attached overload controller is active, live requests it
        can answer FE-only are resolved inline without queueing."""
        if priority not in ("live", "background"):
            raise ValueError(f"unknown priority {priority!r}")
        if not requests:
            return []
        out: List[ScoreResult] = []
        ovl = self._overload
        if ovl is not None and priority == "live" and ovl.active:
            kept = []
            for r in requests:
                res = ovl.try_shed(r)
                if res is None:
                    kept.append(r)
                else:
                    out.append(res)
            if out:
                plane = self._plane
                if plane is not None:
                    # shed answers ARE completions (FE-only, ~0 queue
                    # wait): feeding them lets the burn rate recover
                    lat = np.zeros(len(out), dtype=np.float64)
                    if getattr(plane, "wants_request_ids", False):
                        plane.observe_complete(
                            lat,
                            request_ids=[r.request_id for r in out],
                        )
                    else:
                        plane.observe_complete(lat)
            requests = kept
        now = self._clock()
        lane = self._pending if priority == "live" else self._pending_bg
        lane.extend((r, now) for r in requests)
        self._drain_full(out)
        return out

    def flush(self) -> List[ScoreResult]:
        """Score everything still pending (live lane first, then
        background, through the smallest buckets that fit)."""
        out: List[ScoreResult] = []
        while self._pending:
            out.extend(self._drain(min(len(self._pending), self.max_bucket)))
        while self._pending_bg:
            out.extend(
                self._drain(
                    min(len(self._pending_bg), self.max_bucket),
                    lane=self._pending_bg,
                )
            )
        return out

    def poll(self, now: Optional[float] = None) -> List[ScoreResult]:
        """Deadline check: when the OLDEST pending request has waited at
        least ``max_wait_s``, drain everything pending through the smallest
        fitting buckets (younger requests ride along — padding slots are
        cheaper than a second dispatch). Otherwise a no-op. ``now`` defaults
        to the batcher's clock; pass it explicitly from an event loop that
        already read the time. The background lane is deadline-drained only
        once the live lane is empty."""
        if self.max_wait_s is None:
            raise ValueError(
                "poll() needs a deadline: construct the batcher with "
                "max_wait_s"
            )
        if now is None:
            now = self._clock()
        out: List[ScoreResult] = []
        while self._pending and now - self._pending[0][1] >= self.max_wait_s:
            out.extend(self._drain(min(len(self._pending), self.max_bucket)))
        while (
            not self._pending
            and self._pending_bg
            and now - self._pending_bg[0][1] >= self.max_wait_s
        ):
            out.extend(
                self._drain(
                    min(len(self._pending_bg), self.max_bucket),
                    lane=self._pending_bg,
                )
            )
        return out

    def _supports_stages(self) -> bool:
        """Whether the scorer's ``score_batch`` accepts a stage clock
        (checked once: callers may pass scorers without stage support)."""
        cap = self._stage_capable
        if cap is None:
            import inspect

            try:
                cap = "stages" in inspect.signature(
                    self._scorer.score_batch
                ).parameters
            except (TypeError, ValueError):
                cap = False
            self._stage_capable = cap
        return cap

    def _drain(self, n: int, lane=None) -> List[ScoreResult]:
        if lane is None:
            lane = self._pending
        batch = [lane.popleft() for _ in range(n)]
        if self._quota is not None:
            batch = self._apply_quota(batch)
            if not batch:
                if self._overload is not None:
                    self._overload.maybe_poll()
                return []
            n = len(batch)
        dequeued = self._clock()
        bucket = self._bucket_for(n)
        plane = self._plane
        sampled: Optional[List[int]] = None
        stages: Optional[dict] = None
        if plane is not None:
            sampled = plane.sample_indices(
                [req.request_id for req, _ in batch]
            )
            if sampled and self._supports_stages():
                stages = {}
        with span("serve/drain", n=n, bucket=bucket):
            if stages is not None:
                results = self._scorer.score_batch(
                    [req for req, _ in batch], bucket, stages=stages
                )
            else:
                results = self._scorer.score_batch(
                    [req for req, _ in batch], bucket
                )
        done = self._clock()
        if self._metrics is not None or plane is not None:
            enqueued = np.fromiter(
                (t for _, t in batch), dtype=np.float64, count=n
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
                        request_ids=[req.request_id for req, _ in batch],
                    )
                else:
                    plane.observe_complete(latencies)
                if sampled:
                    plane.record_batch(
                        "sealed", bucket, n,
                        [
                            (batch[i][0].request_id, batch[i][1])
                            for i in sampled
                        ],
                        dequeued, stages, done,
                    )
        if self._overload is not None:
            # drain-path control step (rate-limited inside the controller)
            self._overload.maybe_poll()
        return results

    def _apply_quota(self, batch):
        """Drain-time tenant admission: requests from a tenant whose
        token bucket is exhausted are dropped from the bucket here and
        reported as errors charged to that tenant, instead of occupying
        padded device slots ahead of in-budget tenants. Untagged requests
        (no ``tenant!`` prefix) always pass."""
        quota = self._quota
        kept = []
        shed_ids: List[str] = []
        for item in batch:
            tenant = tenant_of_request_id(item[0].request_id)
            if tenant is None or quota.try_admit(tenant):
                kept.append(item)
            else:
                shed_ids.append(item[0].request_id)
        if shed_ids:
            self.quota_shed_total += len(shed_ids)
            plane = self._plane
            if plane is not None:
                if getattr(plane, "wants_request_ids", False):
                    plane.observe_errors(
                        len(shed_ids), request_ids=shed_ids
                    )
                else:
                    plane.observe_errors(len(shed_ids))
        return kept

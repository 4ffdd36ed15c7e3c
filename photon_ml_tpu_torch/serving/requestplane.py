"""Request plane: sampled per-request lifecycle tracing for the serving path.

The serving stack exposes aggregate reservoir percentiles (``metrics.py``),
but an aggregate p99 cannot say WHICH stage ate the budget — queue wait,
batch fill, entity routing, device dispatch, the device gather itself, or
an interference source off the request path (an admission scatter holding
the write lock, a hot-swap blackout). This module adds the missing
per-request view the way Snap ML attributes cost per pipeline level
(arxiv 1803.06333): a deterministic seeded sampler tags ~1/N requests at
submit, the batcher and scorer stamp monotonic timestamps at each stage
boundary, and the finished trace is drained to the run ledger as a
schema-validated ``request`` record plus a bounded in-memory ring for the
live ``/requests`` introspection route.

Cost discipline — the reason sampling exists at all:

- **Disabled (no plane attached) is the default** and costs one
  ``is None`` check per drained batch. The request-plane disabled-path
  parity gate pins replay scores bitwise-identical with the plane off.
- **Unsampled requests** in a batch that carries no sampled request cost
  one hash probe per request and nothing else: no stage clock is
  allocated, the scorer takes no timestamps.
- **Sampled requests** share their batch's stage stamps (stages are batch
  boundaries, queue wait is per-request), so a sampled batch costs a
  handful of ``perf_counter`` calls and one ledger line per sampled
  request — never a per-request device sync.

Stage semantics (all monotonic ``perf_counter`` seconds, telescoping so
the per-stage durations sum EXACTLY to the end-to-end latency):

====================  ====================================================
``queue``             submit → batch formed (bucket fill or deadline)
``featurize``         batch formed → sparse features packed/padded
``route``             featurize done → entity rows resolved to slots
``dispatch``          route done → device program dispatched (H2D + call)
``device``            dispatch returned → results materialized on host
``reply``             host results → caller's handle resolved
====================  ====================================================

Interference accounting: off-request-path work that can stall scoring
(admission scatters under the write lock, hot-swap blackouts) registers
``note_interference(kind, start, end)`` spans; each sampled request
records its overlap with them, so a p99 regression under swap load shows
up as ``swap_pause`` seconds inside the affected requests instead of
unexplained ``dispatch`` time.
"""

from __future__ import annotations

import threading
import time
import zlib
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

# batch-level stage boundaries the scorer stamps into the stage clock dict
STAGE_FEATURIZE_DONE = "featurize_done"
STAGE_ROUTE_DONE = "route_done"
STAGE_DISPATCH_DONE = "dispatch_done"
STAGE_DEVICE_DONE = "device_done"

# per-request exclusive stages, in timeline order
REQUEST_STAGES = (
    "queue",
    "featurize",
    "route",
    "dispatch",
    "device",
    "reply",
)

# interference kinds folded into sampled records (seconds of overlap with
# the request's submit→reply window)
INTERFERENCE_KINDS = ("swap_pause", "admission")

# tenant prefix separator inside request ids: the tenancy plane submits
# requests as "<tenant>!<request_id>" so per-tenant SLO attribution needs
# no extra per-request field anywhere in the batcher/scorer path
TENANT_SEP = "!"


def tenant_of_request_id(request_id: str) -> Optional[str]:
    """The tenant a request id carries (``None`` for untagged ids)."""
    sep = request_id.find(TENANT_SEP)
    return request_id[:sep] if sep > 0 else None


def sample_hash(request_id: str, seed: int) -> int:
    """Deterministic 32-bit hash of a request id under a seed. Stateless —
    the same (id, seed) samples identically regardless of submission order
    or which batcher thread drains it."""
    return zlib.crc32(request_id.encode("utf-8", "surrogatepass"), seed & 0xFFFFFFFF)


class RequestPlane:
    """Collector for sampled request lifecycles + interference spans.

    Attach one instance per serving process: the batchers probe it per
    drained batch, the scorers stamp stage boundaries into the clock dict
    it hands out, admission/hot-swap register interference spans, and
    finished records land in the ledger (when given) and a bounded ring
    the live ``/requests`` route reads.

    ``sample_rate`` is the N of "sample ~1/N requests": 1 samples every
    request (tests, scenario harness), 0 disables sampling entirely while
    keeping the SLO feed alive. The sampler is a seeded hash of the
    request id — deterministic and thread-free.
    """

    def __init__(
        self,
        sample_rate: int = 64,
        seed: int = 0,
        ledger=None,
        capacity: int = 4096,
        slo=None,
        clock: Callable[[], float] = time.perf_counter,
        interference_capacity: int = 512,
        tenant_slos: Optional[Dict[str, object]] = None,
        tenant_of: Optional[Callable[[str], Optional[str]]] = None,
    ):
        if sample_rate < 0:
            raise ValueError(f"sample_rate must be >= 0, got {sample_rate}")
        self.sample_rate = int(sample_rate)
        self.seed = int(seed)
        self._ledger = ledger
        self._slo = slo
        self._clock = clock
        # per-tenant SLO trackers (tenancy plane): completions are
        # attributed by resolving each request id through ``tenant_of``
        # (default: the "<tenant>!" id prefix). Empty/None = single-tenant
        # process; the batchers then never materialize id lists.
        self.tenant_slos: Dict[str, object] = dict(tenant_slos or {})
        self._tenant_of = tenant_of or tenant_of_request_id
        self.tenant_requests: Dict[str, int] = {}
        self.tenant_errors: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._records: Deque[dict] = deque(maxlen=max(1, int(capacity)))
        self._interference: Deque[Tuple[str, float, float]] = deque(
            maxlen=max(1, int(interference_capacity))
        )
        self.sampled_total = 0
        self.requests_total = 0
        self.errors_total = 0

    # ------------------------------------------------------------- sampling

    def sampled(self, request_id: str) -> bool:
        """Whether this request id is tagged for lifecycle tracing."""
        rate = self.sample_rate
        if rate <= 0:
            return False
        if rate == 1:
            return True
        return sample_hash(request_id, self.seed) % rate == 0

    def sample_indices(self, request_ids: Sequence[str]) -> List[int]:
        """Indices of sampled ids within one drained batch (empty list =
        the batch carries no sampled request and needs no stage clock)."""
        rate = self.sample_rate
        if rate <= 0:
            return []
        if rate == 1:
            return list(range(len(request_ids)))
        seed = self.seed
        return [
            i
            for i, rid in enumerate(request_ids)
            if sample_hash(rid, seed) % rate == 0
        ]

    # --------------------------------------------------------- interference

    def note_interference(self, kind: str, start: float, end: float) -> None:
        """Register an off-request-path stall window (``clock`` timebase):
        admission scatters, hot-swap blackouts. Sampled requests record
        their overlap with these spans at reply time."""
        if end <= start:
            return
        with self._lock:
            self._interference.append((str(kind), float(start), float(end)))

    def _interference_overlap(
        self, t_start: float, t_end: float
    ) -> Dict[str, float]:
        out: Dict[str, float] = {}
        with self._lock:
            spans = list(self._interference)
        for kind, s, e in spans:
            ov = min(t_end, e) - max(t_start, s)
            if ov > 0:
                out[kind] = out.get(kind, 0.0) + ov
        return out

    # ------------------------------------------------------------ recording

    @property
    def wants_request_ids(self) -> bool:
        """Whether the batchers should hand ``observe_complete`` /
        ``observe_errors`` the batch's request ids (only multi-tenant
        attribution needs them; the single-tenant path skips the list)."""
        return bool(self.tenant_slos)

    def observe_complete(
        self, latencies, errors: int = 0, request_ids=None
    ) -> None:
        """Per-batch completion feed (EVERY request, sampled or not): keeps
        the SLO tracker and the aggregate counters honest at O(1) per
        batch. ``latencies`` is an array-like of seconds. ``request_ids``
        (aligned with ``latencies``; only handed over when
        :attr:`wants_request_ids`) routes each completion to its tenant's
        SLO tracker as well."""
        n = len(latencies)
        self.requests_total += n
        self.errors_total += int(errors)
        if self._slo is not None:
            self._slo.observe_many(latencies, errors=errors)
        if self.tenant_slos and request_ids is not None:
            by: Dict[str, List[float]] = {}
            for rid, lat in zip(request_ids, latencies):
                tenant = self._tenant_of(rid)
                if tenant is not None and tenant in self.tenant_slos:
                    by.setdefault(tenant, []).append(float(lat))
            for tenant, lats in by.items():
                self.tenant_requests[tenant] = (
                    self.tenant_requests.get(tenant, 0) + len(lats)
                )
                self.tenant_slos[tenant].observe_many(lats)

    def observe_errors(self, n: int, request_ids=None) -> None:
        """Requests that failed before producing a latency (scorer error
        resolved through their handles)."""
        self.errors_total += int(n)
        if self._slo is not None:
            self._slo.observe_many((), errors=n)
        if self.tenant_slos and request_ids is not None:
            for rid in request_ids:
                tenant = self._tenant_of(rid)
                if tenant is not None and tenant in self.tenant_slos:
                    self.observe_tenant_errors(tenant, 1)

    def observe_tenant_errors(self, tenant: str, n: int) -> None:
        """Charge ``n`` failed/shed requests to ONE tenant's error budget
        (quota sheds land here — on the shedding tenant, never on the
        global SLO or on other tenants)."""
        slo = self.tenant_slos.get(tenant)
        if slo is not None:
            slo.observe_many((), errors=n)
        self.tenant_errors[tenant] = self.tenant_errors.get(tenant, 0) + int(n)

    def record_batch(
        self,
        batcher: str,
        bucket: int,
        n_real: int,
        entries: Sequence[Tuple[str, float]],
        t_dequeue: float,
        stages: Optional[dict],
        t_reply: float,
    ) -> None:
        """Finalize the sampled requests of one drained batch.

        ``entries`` are ``(request_id, t_submit)`` pairs for the SAMPLED
        requests only; ``stages`` is the clock dict the scorer stamped
        (missing boundaries collapse to zero-duration stages, so a scorer
        without stage support still yields queue/device-lumped records).
        """
        stages = stages or {}
        fd = stages.get(STAGE_FEATURIZE_DONE, t_dequeue)
        rd = stages.get(STAGE_ROUTE_DONE, fd)
        dd = stages.get(STAGE_DISPATCH_DONE, rd)
        vd = stages.get(STAGE_DEVICE_DONE, dd)
        for request_id, t_submit in entries:
            # clamp the boundary chain monotonic: a stage boundary can
            # never precede the previous one (or the submit itself)
            b0 = t_submit
            b1 = max(b0, t_dequeue)
            b2 = max(b1, fd)
            b3 = max(b2, rd)
            b4 = max(b3, dd)
            b5 = max(b4, vd)
            b6 = max(b5, t_reply)
            rec = {
                "request_id": str(request_id),
                "batcher": batcher,
                "bucket": int(bucket),
                "n_real": int(n_real),
                "stages": {
                    "queue": b1 - b0,
                    "featurize": b2 - b1,
                    "route": b3 - b2,
                    "dispatch": b4 - b3,
                    "device": b5 - b4,
                    "reply": b6 - b5,
                },
                "total_s": b6 - b0,
            }
            interference = self._interference_overlap(b0, b6)
            if interference:
                rec["interference"] = {
                    f"{k}_s": round(v, 9) for k, v in sorted(interference.items())
                }
            self.sampled_total += 1
            with self._lock:
                self._records.append(rec)
            if self._ledger is not None:
                self._ledger.write("request", **rec)

    # ------------------------------------------------------------ reporting

    def records(self) -> List[dict]:
        """Snapshot of the in-memory ring (most recent ``capacity``
        sampled records), shaped like the ledger's ``request`` records."""
        with self._lock:
            return [dict(r) for r in self._records]

    def reset_records(self) -> None:
        """Drop the in-memory ring (scenario harness: one ring per
        scenario). Ledger records and totals are untouched."""
        with self._lock:
            self._records.clear()

    def live_report(self) -> dict:
        """The tail-latency attribution over the in-memory ring — the
        ``/requests`` introspection payload. Mirrors
        ``analyze_run --requests`` over a ledger."""
        from photon_ml_tpu_torch.telemetry.analyze import request_report

        report = request_report(
            [dict(r, type="request") for r in self.records()]
        )
        doc = {
            "sample_rate": self.sample_rate,
            "seed": self.seed,
            "sampled_total": self.sampled_total,
            "requests_total": self.requests_total,
            "errors_total": self.errors_total,
        }
        if report is not None:
            doc.update(report)
        if self._slo is not None:
            doc["slo"] = self._slo.status()
        if self.tenant_slos:
            doc["tenants"] = {
                tenant: {
                    "requests": self.tenant_requests.get(tenant, 0),
                    "errors": self.tenant_errors.get(tenant, 0),
                    "slo": slo.status(),
                }
                for tenant, slo in sorted(self.tenant_slos.items())
            }
        return doc

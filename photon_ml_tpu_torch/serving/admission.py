"""Asynchronous admission of cold-tail entities into device headroom.

Port of ``photon_ml_tpu/serving/admission.py`` (same queueing, staging,
publication order, fault sites and statistics).

The sharded scorer serves entities beyond its device budget FE-only (cold
slot) and reports them here; a background step copies their coefficient
rows host→device OFF the request path — the serving analogue of the
pipelined host↔accelerator movement in Snap ML / the GPU-DUHL scheme:
request latency never waits on a host copy, it only determines whether
THIS request sees the row or the next one does.

Two properties keep the request path clean:

- **Fixed-shape writes.** Every admission batch is padded to exactly
  ``admit_batch`` rows (pad writes aim zero values at shard 0's cold
  slot, which keeps it zero and makes duplicate pad indices harmless), so
  a step is one in-place row write of one shape per table half.
- **Double-buffered staging.** Rows are gathered from the (possibly
  mmap'd) host backing store into one of two staging buffers, alternating
  per step.

The writes are issued on the scorer's device stream
(``scorer.device_stream``), the stream its gathers run on, so a gather
issued after a step reads the admitted rows.

Publication ordering (see ``routing.py``): evictions unpublish first,
device content is written to EVERY scorer replica next, routing publishes
last — a reader never gathers another entity's bytes.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from photon_ml_tpu_torch.resilience.failures import record_failure
from photon_ml_tpu_torch.resilience.faultpoints import fault_point, register_fault_site
from photon_ml_tpu_torch.resilience.retry import DEFAULT_IO_RETRY
from photon_ml_tpu_torch.resilience.supervisor import SupervisedThread
from photon_ml_tpu_torch.telemetry import span

FAULT_STEP = register_fault_site(
    "serve.admission.step",
    "admission controller step(): an uncaught error here used to kill the"
    " daemon silently; now the supervisor restarts it",
)
FAULT_STAGE = register_fault_site(
    "serve.admission.stage",
    "host-row gather into the staging buffer (mmap-backed IO; retried)",
)


class AdmissionController:
    """Admits deferred entity rows into the headroom slots of one or more
    scorer replicas' :class:`~photon_ml_tpu_torch.serving.sharded.ShardedReTable`
    s. Construct with every replica's scorer so a row becomes resident on
    all devices before routing publishes it (the routing index is shared).

    Drive it synchronously with :meth:`step` (replay loop, tests) or as a
    background thread via :meth:`start`/:meth:`stop`.
    """

    def __init__(
        self,
        scorers,
        admit_batch: int = 64,
        max_queue: int = 65536,
    ):
        if admit_batch < 1:
            raise ValueError(f"admit_batch must be >= 1, got {admit_batch}")
        scorers = list(scorers) if isinstance(scorers, (list, tuple)) else [scorers]
        if not scorers:
            raise ValueError("need at least one scorer")
        self._scorers = scorers
        self.admit_batch = int(admit_batch)
        self.max_queue = int(max_queue)
        self._lock = threading.Lock()
        # per-coordinate FIFO of deferred rows; OrderedDict dedups repeats
        # of a hot-but-not-yet-admitted entity while keeping arrival order
        self._queues: Dict[str, "OrderedDict[int, None]"] = {}
        # double staging buffers per coordinate, allocated lazily at the
        # first admit (dim known then); index flips every step
        self._staging: Dict[str, List[np.ndarray]] = {}
        self._flip: Dict[str, int] = {}
        self._thread: Optional[SupervisedThread] = None
        self._stop = threading.Event()
        # request plane (serving/requestplane.py): admit steps hold the
        # scorers' write locks, so their windows are interference sampled
        # requests attribute their stalls to
        self.request_plane = None
        self.admitted_total = 0
        self.evicted_total = 0
        self.deferred_total = 0
        self.dropped_total = 0  # queue overflow (admission can't keep up)
        self.steps = 0
        self.admit_failures = 0  # per-coordinate admit errors (requeued)

    # -------------------------------------------------------------- intake

    def note_deferred(self, cid: str, rows: np.ndarray) -> None:
        """Record rows a request batch served FE-only (called by the scorer
        on the request path — O(deferred) dict inserts, no device work)."""
        rows = np.asarray(rows, dtype=np.int64).ravel()
        if rows.size == 0:
            return
        with self._lock:
            q = self._queues.get(cid)
            if q is None:
                q = self._queues[cid] = OrderedDict()
            self.deferred_total += rows.size
            for r in rows.tolist():
                if r in q:
                    continue
                if len(q) >= self.max_queue:
                    self.dropped_total += 1
                    continue
                q[r] = None

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._queues.values())

    @property
    def scorers(self) -> List[object]:
        """The scorer replicas this controller writes before publishing."""
        return list(self._scorers)

    def _requeue(self, cid: str, rows: np.ndarray) -> None:
        """Put rows back at the queue HEAD so the next step takes them
        first (they were dequeued earliest)."""
        with self._lock:
            q = self._queues.get(cid)
            if q is None:
                q = self._queues[cid] = OrderedDict()
            for r in rows.tolist()[::-1]:
                q[r] = None
                q.move_to_end(r, last=False)

    # ------------------------------------------------------------- admit

    def step(self) -> int:
        """Admit up to ``admit_batch`` rows per coordinate. Returns the
        number of rows admitted across coordinates.

        One coordinate's failure must not starve the others (or kill a
        background thread): a failed admit puts its rows back at the
        queue head, records the failure, and the loop moves on — the
        next step naturally retries them."""
        fault_point(FAULT_STEP)
        admitted = 0
        for cid in list(self._queues):
            with self._lock:
                q = self._queues[cid]
                take = min(len(q), self.admit_batch)
                rows = [q.popitem(last=False)[0] for _ in range(take)]
            if not rows:
                continue
            batch = np.asarray(rows, dtype=np.int64)
            try:
                admitted += self._admit(cid, batch)
            except Exception as exc:  # noqa: BLE001 - contained per-cid
                self._requeue(cid, batch)
                self.admit_failures += 1
                record_failure(
                    "admit_failed",
                    "serve.admission.step",
                    f"{type(exc).__name__}: {exc}",
                    coordinate=cid,
                    rows=int(batch.size),
                )
        if admitted:
            self.steps += 1
        return admitted

    def _admit(self, cid: str, rows: np.ndarray) -> int:
        while True:
            primary = self._scorers[0]._providers[cid]
            routing = primary.routing
            # routing.lock serializes this step against hot-swap
            # update_rows/rebind on other threads: allocate's
            # check-then-pop and the write-everywhere-then-publish
            # sequence must not interleave with theirs
            with routing.lock:
                if self._scorers[0]._providers[cid] is not primary:
                    # a rebind swapped the provider (and its routing)
                    # between the read above and the lock acquisition;
                    # retry against the new pair
                    continue
                if any(
                    s._providers[cid].routing is not routing
                    for s in self._scorers[1:]
                ):
                    # mid-fan-out of a regrowing coordinated hot swap:
                    # replica tables briefly disagree on layout, so slots
                    # allocated here could land out of bounds on a
                    # not-yet-rebound replica — requeue for a later step
                    self._requeue(cid, rows)
                    return 0
                return self._admit_locked(cid, primary, routing, rows)

    def _admit_locked(self, cid: str, primary, routing, rows) -> int:
        # a hot swap can defer rows from a newer entity index before this
        # coordinate's routing has grown; they re-enter the queue through
        # route() once the swap lands, so just skip them this step
        rows = rows[rows < routing.n_rows]
        # rows can have been admitted since they were queued (hot-swap
        # update_rows, or a previous step when the same row was queued twice
        # under different coordinates); they may also have been evicted
        # again — that is fine, admission is idempotent on content
        fresh = rows[routing._slot_of[rows] < 0]
        if fresh.size == 0:
            return 0
        # a single step can only claim slots that are free or already
        # admitted (rows admitted THIS step are not evictable until
        # published); overflow goes back to the queue head for next step
        capacity = routing.free_slots + len(routing._admitted)
        if capacity == 0:
            self.dropped_total += int(fresh.size)
            return 0
        if fresh.size > capacity:
            overflow = fresh[capacity:]
            fresh = fresh[:capacity]
            self._requeue(cid, overflow)
        t_admit0 = time.perf_counter() if self.request_plane is not None else 0.0
        with span("serve/admit", cid=cid, rows=int(fresh.size)):
            k = self.admit_batch
            shards = np.zeros(k, dtype=np.int32)
            # pad writes target shard 0's cold slot with zeros: the cold
            # slot stays zero and every step writes one shape
            slots = np.full(k, routing.cold_slot, dtype=np.int32)
            a_shards, a_slots, evicted = routing.allocate(fresh.size)
            shards[: fresh.size] = a_shards
            slots[: fresh.size] = a_slots
            buf = self._stage(cid, primary, fresh, k)
            # importance plane: the staged rows ARE the admitted content,
            # so their L2 norms are free here (no-op under the default
            # eviction policy)
            routing.note_row_norms(
                fresh, np.linalg.norm(buf[: fresh.size], axis=1)
            )
            for scorer in self._scorers:
                provider = scorer._providers[cid]
                # double-buffered providers: keep the spare generation half
                # converged (invariant: both halves identical outside an
                # in-flight flip) so the next hot-swap flip doesn't lose
                # admitted rows. No write_lock needed — the request path
                # never captures the spare half, and routing.lock (held
                # here) keeps the generation index stable.
                spare = getattr(provider, "spare_gen", None)
                if spare is not None:
                    provider.write_slots(shards, slots, buf, gen=spare)
                # the active half is written under the replica's
                # write_lock, so it never lands between the scoring
                # thread's table capture and the issue of its gathers
                with scorer.write_lock:
                    provider.write_slots(shards, slots, buf)
            routing.publish(fresh, a_shards, a_slots)
            self.admitted_total += int(fresh.size)
            self.evicted_total += len(evicted)
        if self.request_plane is not None:
            self.request_plane.note_interference(
                "admission", t_admit0, time.perf_counter()
            )
        return int(fresh.size)

    def _stage(self, cid: str, provider, rows: np.ndarray, k: int) -> np.ndarray:
        """Gather host rows into the next staging buffer (double-buffered:
        the buffer written last step may still back an in-flight device
        copy, so this step fills the other one)."""
        bufs = self._staging.get(cid)
        dim = provider._backing.shape[1]
        if bufs is None or bufs[0].shape != (k, dim):
            bufs = self._staging[cid] = [
                np.zeros((k, dim), dtype=np.float32) for _ in range(2)
            ]
            self._flip[cid] = 0
        self._flip[cid] ^= 1
        buf = bufs[self._flip[cid]]
        buf[:] = 0.0
        if rows.size:
            # mmap-backed gather: page-in can hit transient IO errors, and
            # the step holds routing.lock — retry in place (state untouched
            # until the buffer is written) rather than unwinding the admit
            def _gather():
                fault_point(FAULT_STAGE)
                buf[: rows.size] = provider.host_rows(rows)

            DEFAULT_IO_RETRY.run("serve.admission.stage", _gather)
        return buf

    def warmup(self) -> None:
        """Run every replica's fixed-shape admission write once (and
        allocate the staging buffers) before serving: an all-pad batch
        writes zeros at shard 0's cold slot, so content is untouched but
        the first real admit finds everything allocated."""
        k = self.admit_batch
        shards = np.zeros(k, dtype=np.int32)
        for scorer in self._scorers:
            for cid, provider in scorer._providers.items():
                slots = np.full(k, provider.cold_slot, dtype=np.int32)
                buf = self._stage(
                    cid, provider, np.empty(0, dtype=np.int64), k
                )
                with scorer.write_lock:
                    provider.write_slots(shards, slots, buf)

    # --------------------------------------------------------- background

    def start(
        self,
        interval_s: float = 0.001,
        max_restarts: int = 5,
        emitter=None,
    ) -> None:
        """Run :meth:`step` on a supervised background thread every
        ``interval_s`` (sooner when a step admitted a full batch — drain
        bursts fast). A crash in :meth:`step` is captured and the tick
        restarted with backoff up to ``max_restarts``; past the cap the
        thread is declared dead and :meth:`health` turns degraded while
        the scorer keeps serving cold entities FE-only."""
        if self._thread is not None:
            raise RuntimeError("admission thread already running")
        self._stop.clear()

        def _tick():
            n = self.step()
            if n < self.admit_batch:
                self._stop.wait(interval_s)

        self._thread = SupervisedThread(
            "serving-admission",
            _tick,
            mode="tick",
            stop_event=self._stop,
            max_restarts=max_restarts,
            emitter=emitter,
        )
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None

    def drain(self, max_steps: int = 1 << 20) -> int:
        """Synchronously admit until the queue is empty (tests, shutdown)."""
        total = 0
        for _ in range(max_steps):
            n = self.step()
            total += n
            if n == 0 and self.queue_depth == 0:
                break
        return total

    def stats(self) -> Dict[str, float]:
        # eviction reasons, aggregated over the (shared) routing truth —
        # scorer 0's providers see every eviction the replicas share
        evicted_by_policy = {"oldest": 0, "importance": 0}
        for provider in getattr(self._scorers[0], "_providers", {}).values():
            r = provider.routing
            evicted_by_policy["oldest"] += getattr(r, "evicted_oldest", 0)
            evicted_by_policy["importance"] += getattr(
                r, "evicted_importance", 0
            )
        stats = {
            "admit_batch": self.admit_batch,
            "admitted_total": self.admitted_total,
            "evicted_total": self.evicted_total,
            "deferred_total": self.deferred_total,
            "dropped_total": self.dropped_total,
            "queue_depth": self.queue_depth,
            "steps": self.steps,
            "replicas": len(self._scorers),
            "evicted_by_policy": evicted_by_policy,
            "admit_failures": self.admit_failures,
            "thread_restarts": 0,
            "thread_crashes": 0,
            "thread_dead": False,
        }
        thread = self._thread
        if isinstance(thread, SupervisedThread):
            sup = thread.stats()
            stats["thread_restarts"] = sup["restarts"]
            stats["thread_crashes"] = sup["crashes"]
            stats["thread_dead"] = sup["dead"]
            stats["supervisor"] = sup
        return stats

    def health(self) -> Dict[str, object]:
        """Health contribution for ``/healthz``: degraded (unhealthy)
        once the supervised thread is declared dead — serving itself
        stays up, cold entities just score FE-only forever."""
        thread = self._thread
        if isinstance(thread, SupervisedThread):
            doc = thread.health()
            doc["running"] = thread.is_alive()
            return doc
        return {"healthy": True, "running": thread is not None}

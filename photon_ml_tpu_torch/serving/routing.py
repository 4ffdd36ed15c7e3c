"""Entity→(shard, slot) routing index for sharded device RE tables.

The single-table scorer resolves an entity to ONE row index in one device
table. The sharded scorer splits each random-effect table across ``S``
device shards (one per mesh device in multi-scorer mode), so resolution
becomes two coordinates: which shard holds the row, and which slot within
that shard. This module owns that mapping — pure host state, shared by
every scorer replica so they stay mutually consistent, with no device
arrays of its own.

Layout: the base resident set (rows ``0..R-1`` of the packed table, the
hottest rows when the artifact is popularity-sorted, all rows when the
device budget covers the table) is placed CYCLICALLY: global row ``r``
lives at ``(r % S, r // S)`` — the grid layout of
``parallel/grid_features.py`` applied to table rows, balancing both
capacity and gather traffic across shards for any contiguous hot prefix.
Rows beyond the budget start non-resident (slot −1) and are admitted
later into headroom slots by ``serving/admission.py``; when headroom runs
out the oldest ADMITTED row is evicted (the base set is pinned).

Publication ordering contract (what makes lock-free readers safe): a row
becomes resident only AFTER its device content is written (``publish`` is
the last step), and is evicted by first clearing ``slot_of`` (readers
immediately fall back to the cold slot → FE-only score) and only then
reusing the slot's device storage. A reader can therefore never gather
another entity's coefficients; the worst case is one FE-only score during
the handover, identical to the cold-entity degradation.

That contract covers READERS only. WRITERS (the background admission
thread, hot-swap row updates, rebinds) mutate ``_free``/``_admitted``/
``slot_of`` non-atomically, so every mutation sequence must hold
``CoordinateRouting.lock`` — otherwise two threads can pop the same free
slot or publish two rows into one slot. Lock ordering across the serving
stack: ``routing.lock`` (outer) → ``scorer.write_lock`` (inner); the
scoring thread takes only ``write_lock``, so the pair cannot deadlock.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np


class CoordinateRouting:
    """Routing state for ONE random-effect coordinate.

    ``num_shards`` device shards of ``shard_capacity`` data slots each
    (slot ``shard_capacity`` is every shard's permanently-zero cold slot).
    ``resident_rows`` rows of the backing table start device-resident in
    the cyclic layout; the remaining device slots are admission headroom.
    """

    #: batches between EWMA halvings of the request-frequency plane
    FREQ_DECAY_EVERY = 64

    def __init__(
        self,
        n_rows: int,
        num_shards: int,
        shard_capacity: int,
        resident_rows: Optional[int] = None,
        eviction_policy: str = "oldest",
        score_delta: bool = True,
    ):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        if shard_capacity < 1:
            raise ValueError(
                f"shard_capacity must be >= 1, got {shard_capacity}"
            )
        if eviction_policy not in ("oldest", "importance"):
            raise ValueError(
                "eviction_policy must be 'oldest' or 'importance', got "
                f"{eviction_policy!r}"
            )
        self.n_rows = int(n_rows)
        self.num_shards = int(num_shards)
        self.shard_capacity = int(shard_capacity)
        self.eviction_policy = eviction_policy
        # serializes WRITERS (allocate/publish/grow/unpublish and every
        # multi-step sequence built on them); re-entrant so a caller
        # holding it for a compound mutation can still call the
        # individual methods. Acquire BEFORE any scorer write_lock.
        self.lock = threading.RLock()
        self.cold_slot = self.shard_capacity
        device_rows = self.num_shards * self.shard_capacity
        base = device_rows if resident_rows is None else int(resident_rows)
        base = max(0, min(base, self.n_rows, device_rows))
        self.base_rows = base  # pinned: never evicted

        # global row -> (shard, slot); slot -1 = not device-resident
        self._shard_of = np.zeros(max(self.n_rows, 1), dtype=np.int32)
        self._slot_of = np.full(max(self.n_rows, 1), -1, dtype=np.int32)
        if base:
            r = np.arange(base)
            self._shard_of[:base] = r % self.num_shards
            self._slot_of[:base] = r // self.num_shards

        # free device slots beyond the base set, round-robin across shards
        # (same cyclic order as the base layout)
        free = np.arange(base, device_rows)
        self._free: Deque[Tuple[int, int]] = deque(
            zip(
                (free % self.num_shards).tolist(),
                (free // self.num_shards).tolist(),
            )
        )
        # admitted (evictable) rows, oldest first
        self._admitted: Deque[int] = deque()

        # importance plane (DuHL-style cache value, arxiv 1702.07005):
        # per-row EWMA request frequency × coefficient-row magnitude — the
        # magnitude bounds the score delta vs the FE-only fallback
        # (|Δscore| <= ||w_r||·||x||), so freq × norm approximates the
        # expected score impact of keeping the row resident. Tracked only
        # under the "importance" policy (the default path allocates
        # nothing); both planes are stats-grade — written without the
        # routing lock from the scoring thread; eviction reads them under
        # the lock, and a torn read can at worst mis-rank one victim,
        # never corrupt placement.
        if eviction_policy == "importance":
            self._freq = np.zeros(max(self.n_rows, 1), dtype=np.float64)
            self._norm = np.zeros(max(self.n_rows, 1), dtype=np.float32)
        else:
            self._freq = None
            self._norm = None
        # MEASURED score impact: per-row EWMA of |score − fe_only_score|
        # observed on actual requests (the realized counterpart of the
        # freq × norm Cauchy–Schwarz BOUND above). importance_of takes the
        # max of the two — the bound covers rows never yet measured (just
        # admitted, or resident before the first scored hit), the
        # measurement rescues rows whose bound is loose in either
        # direction. Same stats-grade write discipline as _freq.
        self.score_delta = bool(score_delta) and eviction_policy == "importance"
        if self.score_delta:
            self._sdelta = np.zeros(max(self.n_rows, 1), dtype=np.float64)
        else:
            self._sdelta = None
        self._freq_batches = 0

        # lookup accounting (reset via reset_counters)
        self.resident_lookups = 0
        self.deferred_lookups = 0  # known entity, not yet device-resident
        self.cold_lookups = 0  # entity absent from the model
        self.admitted_total = 0
        self.evicted_total = 0
        self.evicted_oldest = 0
        self.evicted_importance = 0

    # ---------------------------------------------------------------- route

    def route(
        self, entity_rows: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized batch routing: global table rows (−1 = unknown) →
        int32 ``(shards, slots)`` arrays plus the unique DEFERRED rows
        (known entities currently not device-resident — they score through
        the cold slot this batch and should be queued for admission)."""
        rows = np.asarray(entity_rows, dtype=np.int64)
        shards = np.zeros(rows.shape, dtype=np.int32)
        slots = np.full(rows.shape, self.cold_slot, dtype=np.int32)
        known = rows >= 0
        n_known = int(np.count_nonzero(known))
        self.cold_lookups += rows.size - n_known
        if not n_known:
            return shards, slots, np.empty(0, dtype=np.int64)
        krows = rows[known]
        # a concurrent hot swap can hand out rows from a newer entity
        # index before this coordinate's routing has grown; such rows are
        # deferred (cold slot now, admitted once the swap lands), never an
        # out-of-bounds read of the placement arrays
        in_range = krows < self._slot_of.size
        safe = np.where(in_range, krows, 0)
        kslots = np.where(in_range, self._slot_of[safe], -1)
        kshards = np.where(in_range, self._shard_of[safe], 0)
        resident = kslots >= 0
        n_res = int(np.count_nonzero(resident))
        self.resident_lookups += n_res
        self.deferred_lookups += n_known - n_res
        out_slots = np.where(resident, kslots, self.cold_slot)
        out_shards = np.where(resident, kshards, 0)
        slots[known] = out_slots
        shards[known] = out_shards
        deferred = (
            np.unique(krows[~resident])
            if n_res < n_known
            else np.empty(0, dtype=np.int64)
        )
        return shards, slots, deferred

    # ------------------------------------------------- importance tracking

    @property
    def wants_feature_norms(self) -> bool:
        """Whether the scorer's route step should compute per-request
        feature-vector norms for :meth:`note_requests` (only the
        importance policy consumes them; the default path skips the
        O(B·k) norm entirely)."""
        return self._freq is not None

    def note_requests(
        self,
        entity_rows: np.ndarray,
        feature_norms: Optional[np.ndarray] = None,
    ) -> None:
        """Fold one request batch into the EWMA frequency plane (called by
        the scorer's route step; no-op under the default policy). Every
        ``FREQ_DECAY_EVERY`` batches the whole plane halves, so frequency
        is an exponential window over recent traffic, not an all-time
        count that would pin formerly-hot rows forever.

        ``feature_norms`` (aligned with ``entity_rows``) weights each
        request by its feature-vector magnitude ``||x||`` instead of 1.0:
        combined with the per-row coefficient norm (:meth:`note_row_norms`)
        the importance score becomes ``EWMA(Σ||x||) × ||w_r||`` — a
        Cauchy–Schwarz bound on the row's cumulative score delta vs the
        FE-only fallback, not just its hit count. Callers without norms
        fall back to pure frequency."""
        if self._freq is None:
            return
        rows = np.asarray(entity_rows, dtype=np.int64).ravel()
        keep = (rows >= 0) & (rows < self._freq.size)
        if keep.any():
            if feature_norms is not None:
                norms = np.asarray(feature_norms, dtype=np.float64).ravel()
                np.add.at(self._freq, rows[keep], norms[keep])
            else:
                np.add.at(self._freq, rows[keep], 1.0)
        self._freq_batches += 1
        if self._freq_batches >= self.FREQ_DECAY_EVERY:
            self._freq_batches = 0
            self._freq *= 0.5
            if self._sdelta is not None:
                self._sdelta *= 0.5

    def note_row_norms(self, rows: np.ndarray, norms: np.ndarray) -> None:
        """Record the L2 magnitude of rows' coefficient content (called on
        admission and hot-swap writes; no-op under the default policy)."""
        if self._norm is None:
            return
        rows = np.asarray(rows, dtype=np.int64).ravel()
        norms = np.asarray(norms, dtype=np.float32).ravel()
        keep = (rows >= 0) & (rows < self._norm.size)
        if keep.any():
            self._norm[rows[keep]] = norms[keep]

    @property
    def wants_score_deltas(self) -> bool:
        """Whether the scorer should compute measured per-request
        |score − fe_only| contributions for :meth:`note_score_deltas`
        (only the importance policy with the score-delta signal enabled
        consumes them — the default path never pays for the extra gather)."""
        return self._sdelta is not None

    def note_score_deltas(
        self, entity_rows: np.ndarray, deltas: np.ndarray
    ) -> None:
        """Fold one batch of MEASURED per-request score impacts
        (|score − fe_only_score| attributable to this coordinate) into the
        EWMA plane; decayed on the same cadence as the frequency plane
        (inside :meth:`note_requests`). No-op unless score-delta tracking
        is on. Non-resident rows gather the zero cold slot, so their
        measured contribution is 0 — the freq × norm bound governs them
        until first residency."""
        if self._sdelta is None:
            return
        rows = np.asarray(entity_rows, dtype=np.int64).ravel()
        deltas = np.asarray(deltas, dtype=np.float64).ravel()
        keep = (rows >= 0) & (rows < self._sdelta.size)
        if keep.any():
            np.add.at(self._sdelta, rows[keep], np.abs(deltas[keep]))

    def importance_of(self, rows: np.ndarray) -> np.ndarray:
        """max(freq × max(norm, ε), measured score delta) per row — ε
        keeps frequency meaningful for rows admitted through paths that
        never reported a norm; the measured plane (when tracked) rescues
        rows whose Cauchy–Schwarz bound is loose."""
        if self._freq is None:
            return np.zeros(np.asarray(rows).size, dtype=np.float64)
        rows = np.asarray(rows, dtype=np.int64).ravel()
        bound = self._freq[rows] * np.maximum(
            self._norm[rows].astype(np.float64), 1e-12
        )
        if self._sdelta is None:
            return bound
        return np.maximum(bound, self._sdelta[rows])

    def is_resident(self, row: int) -> bool:
        return 0 <= row < self.n_rows and self._slot_of[row] >= 0

    def placement(self, row: int) -> Tuple[int, int]:
        """(shard, slot) of a resident row (slot −1 when not resident)."""
        return int(self._shard_of[row]), int(self._slot_of[row])

    # ----------------------------------------------------- slot allocation

    def allocate(self, k: int) -> Tuple[np.ndarray, np.ndarray, List[int]]:
        """Claim ``k`` device slots for admission. Returns int arrays
        ``(shards, slots)`` plus the list of rows EVICTED to make room
        (already unpublished here — the caller must zero/overwrite their
        device slots before publishing new occupants). Raises when the
        coordinate has fewer than ``k`` evictable slots in total.

        Victim selection is the ``eviction_policy``: ``oldest`` (default,
        the historical FIFO — byte-identical behavior) pops the
        longest-admitted row; ``importance`` evicts the admitted rows with
        the LOWEST freq × norm score (see :meth:`importance_of`), so a hot
        long-tail row survives arbitrarily many admission waves while a
        one-hit row is recycled first — the DuHL cache policy applied to
        device residency."""
        with self.lock:
            if self.eviction_policy == "importance":
                return self._allocate_importance(k)
            shards = np.empty(k, dtype=np.int32)
            slots = np.empty(k, dtype=np.int32)
            evicted: List[int] = []
            for i in range(k):
                if self._free:
                    shard, slot = self._free.popleft()
                elif self._admitted:
                    victim = self._admitted.popleft()
                    shard, slot = self.placement(victim)
                    # unpublish BEFORE the slot is reused: readers of the
                    # victim fall back to FE-only from this point on
                    self._slot_of[victim] = -1
                    self.evicted_total += 1
                    self.evicted_oldest += 1
                    evicted.append(victim)
                else:
                    raise RuntimeError(
                        f"no admission headroom: {self.base_rows} base rows "
                        f"fill all {self.num_shards}x{self.shard_capacity} "
                        "device slots — raise the device budget or lower "
                        "the resident base"
                    )
                shards[i] = shard
                slots[i] = slot
            return shards, slots, evicted

    def _allocate_importance(
        self, k: int
    ) -> Tuple[np.ndarray, np.ndarray, List[int]]:
        """allocate() under the importance policy (caller holds the lock).

        Victims are chosen by POSITION in the admitted deque, not by row
        value: the deque can hold stale entries for rows already
        unpublished by a hot swap (and, after a re-admission, duplicates),
        so value-based removal would corrupt the capacity bookkeeping.
        Only the first live position of each row is evictable; stale
        positions are dropped during the rebuild."""
        shards = np.empty(k, dtype=np.int32)
        slots = np.empty(k, dtype=np.int32)
        evicted: List[int] = []
        take_free = min(k, len(self._free))
        for i in range(take_free):
            shards[i], slots[i] = self._free.popleft()
        need = k - take_free
        if need == 0:
            return shards, slots, evicted
        adm = np.fromiter(
            self._admitted, dtype=np.int64, count=len(self._admitted)
        )
        live = self._slot_of[adm] >= 0
        if live.any():
            # duplicates (re-published rows): only the first position per
            # row is "the" resident entry
            first = np.zeros(adm.size, dtype=bool)
            _, first_pos = np.unique(adm, return_index=True)
            first[first_pos] = True
            live &= first
        live_pos = np.nonzero(live)[0]
        if need > live_pos.size:
            raise RuntimeError(
                f"no admission headroom: {self.base_rows} base rows "
                f"fill all {self.num_shards}x{self.shard_capacity} "
                "device slots — raise the device budget or lower "
                "the resident base"
            )
        score = self.importance_of(adm[live_pos])
        if need < live_pos.size:
            pick = live_pos[np.argpartition(score, need - 1)[:need]]
        else:
            pick = live_pos
        for i, pos in enumerate(pick):
            victim = int(adm[pos])
            shard, slot = self.placement(victim)
            self._slot_of[victim] = -1
            self.evicted_total += 1
            self.evicted_importance += 1
            evicted.append(victim)
            shards[take_free + i] = shard
            slots[take_free + i] = slot
        # rebuild the deque: surviving live entries keep their order;
        # picked and stale positions drop out
        drop = set(int(p) for p in pick)
        stale = set(int(p) for p in np.nonzero(~live)[0])
        self._admitted = deque(
            int(r)
            for pos, r in enumerate(adm)
            if pos not in drop and pos not in stale
        )
        return shards, slots, evicted

    def publish(
        self, rows: np.ndarray, shards: np.ndarray, slots: np.ndarray
    ) -> None:
        """Make admitted rows visible to routing. Call ONLY after their
        device content is written in every scorer replica."""
        with self.lock:
            rows = np.asarray(rows, dtype=np.int64)
            self._shard_of[rows] = np.asarray(shards, dtype=np.int32)
            self._slot_of[rows] = np.asarray(slots, dtype=np.int32)
            self._admitted.extend(int(r) for r in rows)
            self.admitted_total += rows.size

    def grow(self, n_rows: int) -> None:
        """Extend the row space (hot-swap appended new entities to the
        backing table). New rows start non-resident; device capacity is
        unchanged — admission headroom absorbs them."""
        with self.lock:
            n_rows = int(n_rows)
            if n_rows <= self.n_rows:
                return
            extra = n_rows - self._slot_of.size
            if extra > 0:
                # over-allocate in chunks: a nearline loop claiming a few
                # dozen fresh overlay rows per applied delta would
                # otherwise memcpy the whole placement array every tick.
                # Rows past n_rows stay unroutable (no id maps to them)
                # and carry the non-resident defaults.
                extra = max(extra, min(4096, self._slot_of.size))
                # build the grown arrays fully, then install: lock-free
                # route() readers only ever see a complete placement array
                shard_of = np.concatenate(
                    [self._shard_of, np.zeros(extra, dtype=np.int32)]
                )
                slot_of = np.concatenate(
                    [self._slot_of, np.full(extra, -1, dtype=np.int32)]
                )
                self._shard_of = shard_of
                self._slot_of = slot_of
                if self._freq is not None:
                    self._freq = np.concatenate(
                        [self._freq, np.zeros(extra, dtype=np.float64)]
                    )
                    self._norm = np.concatenate(
                        [self._norm, np.zeros(extra, dtype=np.float32)]
                    )
                if self._sdelta is not None:
                    self._sdelta = np.concatenate(
                        [self._sdelta, np.zeros(extra, dtype=np.float64)]
                    )
            self.n_rows = n_rows

    def unpublish(self, rows: np.ndarray) -> None:
        """Drop rows from routing (hot-swap invalidation). Their slots are
        NOT freed for reuse — a subsequent admission re-publishes them."""
        with self.lock:
            rows = np.asarray(rows, dtype=np.int64)
            keep = rows[(rows >= 0) & (rows < self.n_rows)]
            self._slot_of[keep] = -1

    # ------------------------------------------------------------ counters

    @property
    def resident_rows(self) -> int:
        return int(np.count_nonzero(self._slot_of[: self.n_rows] >= 0))

    @property
    def device_rows(self) -> int:
        return self.num_shards * self.shard_capacity

    @property
    def free_slots(self) -> int:
        return len(self._free)

    def reset_counters(self) -> None:
        self.resident_lookups = 0
        self.deferred_lookups = 0
        self.cold_lookups = 0

    def stats(self) -> Dict[str, float]:
        total = (
            self.resident_lookups + self.deferred_lookups + self.cold_lookups
        )
        out = {
            "num_shards": self.num_shards,
            "shard_capacity": self.shard_capacity,
            "device_rows": self.device_rows,
            "resident_rows": self.resident_rows,
            "base_rows": self.base_rows,
            "resident_lookups": self.resident_lookups,
            "deferred_lookups": self.deferred_lookups,
            "cold_lookups": self.cold_lookups,
            "total_lookups": total,
            "admitted_total": self.admitted_total,
            "evicted_total": self.evicted_total,
            "eviction_policy": self.eviction_policy,
            "evicted_oldest": self.evicted_oldest,
            "evicted_importance": self.evicted_importance,
        }
        if self._freq is not None:
            with self.lock:
                adm = np.fromiter(
                    self._admitted, dtype=np.int64, count=len(self._admitted)
                )
                adm = adm[self._slot_of[adm] >= 0] if adm.size else adm
            imp = self.importance_of(adm)
            out["importance_mean"] = float(imp.mean()) if imp.size else 0.0
            out["importance_max"] = float(imp.max()) if imp.size else 0.0
            out["score_delta"] = self.score_delta
        return out


class RoutingIndex:
    """Per-coordinate :class:`CoordinateRouting`, shared across every
    scorer replica in multi-scorer mode (one device table per replica, ONE
    routing truth — replicas can only disagree about content mid-admission,
    never about where a row lives)."""

    def __init__(self, coordinates: Dict[str, CoordinateRouting]):
        self.coordinates = dict(coordinates)

    def __getitem__(self, cid: str) -> CoordinateRouting:
        return self.coordinates[cid]

    def __contains__(self, cid: str) -> bool:
        return cid in self.coordinates

    def stats(self) -> Dict[str, Dict[str, float]]:
        return {cid: c.stats() for cid, c in self.coordinates.items()}

    def reset_counters(self) -> None:
        for c in self.coordinates.values():
            c.reset_counters()


def build_routing(
    re_tables: Dict[str, int],
    num_shards: int,
    device_budget_rows: Optional[int] = None,
    headroom_fraction: float = 0.25,
    eviction_policy: str = "oldest",
    score_delta: bool = True,
) -> RoutingIndex:
    """Routing for a set of RE coordinates (``cid -> n_rows``).

    ``device_budget_rows`` caps TOTAL device data rows per coordinate
    (across shards). ``None`` = full residency: every row resident, plus
    ``headroom_fraction`` extra slots so hot-swaps can append new entities
    without a table rebuild. A finite budget splits into a resident base
    (the first ``(1 - headroom_fraction) * budget`` rows — the packed
    table's hot prefix) and admission headroom for the long tail.
    ``eviction_policy`` picks the admission victim rule: ``oldest`` (FIFO,
    the default) or ``importance`` (evict lowest importance score);
    ``score_delta`` additionally tracks measured |score − fe_only| per row
    under the importance policy (see ``note_score_deltas``).
    """
    coords: Dict[str, CoordinateRouting] = {}
    for cid, n_rows in re_tables.items():
        n_rows = int(n_rows)
        if device_budget_rows is None:
            base = n_rows
            budget = n_rows + max(num_shards, int(n_rows * headroom_fraction))
        else:
            budget = max(int(device_budget_rows), num_shards)
            base = min(n_rows, int(budget * (1.0 - headroom_fraction)))
            if budget >= n_rows + num_shards:
                base = n_rows  # budget covers the table: all pinned
        cap = max(1, -(-budget // num_shards))  # ceil
        coords[cid] = CoordinateRouting(
            n_rows=n_rows,
            num_shards=num_shards,
            shard_capacity=cap,
            resident_rows=base,
            eviction_policy=eviction_policy,
            score_delta=score_delta,
        )
    return RoutingIndex(coords)

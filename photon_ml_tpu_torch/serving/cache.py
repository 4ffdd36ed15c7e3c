"""Hot-entity cache: device-resident LRU over RE coefficient rows.

The packed RE table (``artifact.ServingTable.weights``) is the host-side
backing store — potentially a memory-mapped ``(n_entities, dim)`` file for
million-entity coordinates. Serving gathers one row per request; keeping the
full table on device wastes HBM and keeping none forces a host→device copy
per request. Entity popularity is heavy-tailed (the Snap ML observation:
hot model state belongs device-resident behind a hierarchical cache), so a
small device table of the hottest rows makes the steady-state gather never
leave the card.

Layout: a tensor ``[capacity + 1, dim]`` on the scorer's device. Slots
``0..capacity-1`` hold cached entity rows; slot ``capacity`` is permanently
zero — the *cold slot* that unknown entities gather from, which realizes the
FE-only fallback (RE prior mean = 0) without any branching in the scorer.
Misses within one batch are filled with one in-place row write
(``index_copy_`` of unique slots: no accumulation, no atomics).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.device import DEFAULT_DEVICE, DeviceLike, resolve_device


class HotEntityCache:
    """LRU cache of backing-store rows on device.

    ``lookup`` maps backing-table row indices (−1 = unknown entity) to slots
    in the device ``table``; rows already cached are hits, others are copied
    in from the backing store (evicting least-recently-used slots when
    full). Rows referenced by the *current* batch are pinned: they cannot be
    evicted by later misses in the same lookup, so a batch is always
    internally consistent. That requires ``capacity >= distinct entities per
    batch``; the scorer enforces ``capacity >= max bucket size``.
    """

    def __init__(
        self,
        backing: np.ndarray,
        capacity: int,
        device: DeviceLike = DEFAULT_DEVICE,
    ):
        if backing.ndim != 2:
            raise ValueError(f"backing store must be 2-D, got {backing.shape}")
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        self.device = resolve_device(device)
        self._backing = backing
        self.capacity = int(capacity)
        self.cold_slot = self.capacity
        self._table = torch.zeros(
            (self.capacity + 1, backing.shape[1]),
            dtype=torch.float32, device=self.device,
        )
        # entity row -> slot, in LRU order (oldest first)
        self._slot_of: "OrderedDict[int, int]" = OrderedDict()
        self._free: List[int] = list(range(self.capacity - 1, -1, -1))
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.cold = 0  # lookups of entities absent from the model

    @property
    def table(self) -> torch.Tensor:
        """Device tensor [capacity + 1, dim]; last row is the zero cold slot."""
        return self._table

    def lookup(self, entity_rows: np.ndarray) -> np.ndarray:
        """Backing rows (−1 = cold) → device slots, filling misses.

        Returns an int32 array the same length as ``entity_rows``.
        """
        entity_rows = np.asarray(entity_rows, dtype=np.int64)
        slots = np.full(len(entity_rows), self.cold_slot, dtype=np.int32)
        pinned: set = set()
        fill_slots: List[int] = []
        fill_rows: List[int] = []
        for i, row in enumerate(entity_rows):
            row = int(row)
            if row < 0:
                self.cold += 1
                continue
            slot = self._slot_of.get(row)
            if slot is not None:
                self.hits += 1
                self._slot_of.move_to_end(row)
            else:
                self.misses += 1
                slot = self._allocate_slot(pinned)
                self._slot_of[row] = slot
                fill_slots.append(slot)
                fill_rows.append(row)
            pinned.add(slot)
            slots[i] = slot
        if fill_slots:
            rows = np.ascontiguousarray(
                self._backing[np.asarray(fill_rows)], dtype=np.float32
            )
            # the slots of one fill are distinct: an in-place row copy
            self._table.index_copy_(
                0,
                torch.from_numpy(np.asarray(fill_slots, dtype=np.int64)).to(
                    self.device
                ),
                torch.from_numpy(rows).to(self.device),
            )
        return slots

    def _allocate_slot(self, pinned: set) -> int:
        if self._free:
            return self._free.pop()
        for row, slot in self._slot_of.items():  # oldest first
            if slot not in pinned:
                del self._slot_of[row]
                self.evictions += 1
                return slot
        raise RuntimeError(
            f"cache capacity {self.capacity} smaller than the distinct "
            f"entities of one batch — raise capacity above the largest "
            f"bucket size"
        )

    def invalidate(self, rows) -> int:
        """Drop the given backing rows from the device table if resident
        (hot-swap: only the rows a delta touched get invalidated; everything
        else stays warm). Freed slots are reused by later misses — stale
        values linger in device memory but are unreachable. Returns how many
        resident rows were dropped."""
        dropped = 0
        for row in np.asarray(rows, dtype=np.int64).ravel():
            slot = self._slot_of.pop(int(row), None)
            if slot is not None:
                self._free.append(slot)
                dropped += 1
        return dropped

    def rebind(self, backing: np.ndarray) -> int:
        """Point the cache at a new backing store (hot-swap / rollback:
        the delta-applied table replaces the old array in O(1) — the device
        table and its resident rows are kept). The caller must ``invalidate``
        the rows whose CONTENT changed; rows beyond the new store's end
        (rollback after appends) are dropped here. Returns the number of
        rows dropped for being out of range."""
        if backing.ndim != 2 or backing.shape[1] != self._backing.shape[1]:
            raise ValueError(
                f"rebind backing shape {backing.shape} incompatible with "
                f"cached row dim {self._backing.shape[1]}"
            )
        out_of_range = [
            row for row in self._slot_of if row >= backing.shape[0]
        ]
        self._backing = backing
        return self.invalidate(out_of_range) if out_of_range else 0

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def cached_entities(self) -> List[int]:
        """Backing rows currently resident, LRU → MRU (test/debug hook)."""
        return list(self._slot_of)

    def stats(self) -> Dict[str, float]:
        return {
            "capacity": self.capacity,
            "resident": len(self._slot_of),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "cold_lookups": self.cold,
            "hit_rate": round(self.hit_rate(), 6),
        }

"""Hierarchical device residency for streamed training (DuHL / Snap ML).

Port of ``photon_ml_tpu/streaming/residency.py`` (numpy only, copied): for
the same gaps its pin and evict decisions equal the JAX package's.

Streamed solves re-upload every block to the device on every pass even
though the per-block duality-gap probe says exactly which blocks still
carry objective mass. "Large-Scale Stochastic Learning using GPUs"
(arXiv 1702.07005) keeps only the largest-gap working set device-resident;
Snap ML (arXiv 1803.06333) frames the system as a hierarchy of data
partitions — disk, host RAM, device HBM — with the next level's transfer
pipelined under the current level's solve. This module is the HBM level
plus the interface that unifies all three:

* :class:`ResidencyManager` owns a bounded set of device-resident
  ``DeviceBlock`` uploads (capped by a block and/or byte budget). Resident
  blocks keep their BASE offsets — the CD residual is re-fused per pass by
  the existing fixed-shape program, so persistence never staleness-poisons
  the objective — and are served straight from HBM, skipping their
  host-to-device copy entirely. The non-resident remainder streams through the
  ordinary double-buffered prefetcher, whose H2D overlaps the resident
  blocks' solve work.
* The resident set is picked from staleness-decayed per-block gap
  estimates (the same ``score · decay^age`` bookkeeping as the stochastic
  :class:`~photon_ml_tpu_torch.streaming.gapsched.GapScheduler`); re-pinning
  happens only between epochs (``repin``), never mid-pass, so a pass's
  arithmetic visit order — and therefore the accumulation trajectory — is
  untouched by eviction.
* :func:`residency_hierarchy` reports per-level hit/byte accounting for
  the three levels that already exist separately: the mmap ``BlockCache``
  (disk), the decode-pool file LRU (RAM), and the resident set (HBM).

Everything here is host-side numpy/dict bookkeeping: no device program is
added, and a fit with a manager attached is bitwise the fit without one
(tests/test_torch_streaming.py pins this).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from photon_ml_tpu_torch.telemetry import get_registry


@dataclasses.dataclass
class ResidencyStats:
    """Host-side accounting of one manager's lifetime."""

    hbm_hit_blocks: int = 0    # block serves that skipped the upload
    hbm_hit_bytes: int = 0     # H2D bytes those serves avoided
    stored_blocks: int = 0     # uploads retained as resident (pins)
    evicted_blocks: int = 0    # residents dropped (gap decay or failure)
    repins: int = 0            # between-epoch re-pin rounds


class ResidencyManager:
    """Gap-pinned bounded set of device-resident blocks.

    Parameters
    ----------
    num_blocks:
        Blocks in the streamed plan (fixed for the manager's lifetime).
    block_bytes:
        H2D bytes of ONE uploaded block for the shard(s) this manager
        serves. Block shapes are fixed by the plan, so the per-block cost
        is uniform and the byte budget reduces to a block budget.
    max_blocks:
        Resident-block cap; 0 means "bytes only".
    max_bytes:
        Resident-byte cap; ``None`` means "blocks only". The effective
        capacity is the tighter of the two, and must admit at least one
        block — a residency plane that can pin nothing is a
        misconfiguration, not a silent no-op.
    decay:
        Per-epoch staleness discount on a block's last measured gap
        (``score · decay^age``), mirroring the GapScheduler: a once-hot
        block cannot stay pinned forever on stale evidence.
    """

    def __init__(
        self,
        num_blocks: int,
        block_bytes: int,
        max_blocks: int = 0,
        max_bytes: Optional[int] = None,
        decay: float = 0.6,
    ) -> None:
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        if block_bytes < 1:
            raise ValueError(f"block_bytes must be >= 1, got {block_bytes}")
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        if max_blocks < 0:
            raise ValueError(f"max_blocks must be >= 0, got {max_blocks}")
        capacity = int(max_blocks) if max_blocks else int(num_blocks)
        if max_bytes is not None:
            capacity = min(capacity, int(max_bytes) // int(block_bytes))
        if capacity < 1:
            raise ValueError(
                f"residency budget admits no blocks (max_blocks={max_blocks},"
                f" max_bytes={max_bytes}, block_bytes={block_bytes})"
            )
        # pinning EVERYTHING is allowed (tiny datasets) but the budget is
        # still honored: capacity never exceeds the plan
        self.num_blocks = int(num_blocks)
        self.block_bytes = int(block_bytes)
        self.capacity = min(capacity, self.num_blocks)
        self.decay = float(decay)
        # -1.0 sentinel = never measured. Unlike the scheduler's +inf
        # bootstrap (which must VISIT unmeasured blocks first), residency
        # must never pin on no evidence once measurements exist — the
        # bootstrap resident set is simply first-come up to capacity.
        self.scores = np.full(self.num_blocks, -1.0, dtype=np.float64)
        self.age = np.zeros(self.num_blocks, dtype=np.int64)
        self.excluded = np.zeros(self.num_blocks, dtype=bool)
        self.epoch = 0
        self.stats = ResidencyStats()
        self.decisions: List[dict] = []
        self._entries: Dict[int, object] = {}  # block -> DeviceBlock
        # None = bootstrap (admit first-come); set after the first repin
        self._target: Optional[set] = None

    # -- inspection -------------------------------------------------------

    @property
    def resident_blocks(self) -> int:
        return len(self._entries)

    @property
    def resident_bytes(self) -> int:
        return len(self._entries) * self.block_bytes

    def resident_indices(self) -> List[int]:
        return sorted(self._entries)

    def is_resident(self, block: int) -> bool:
        return int(block) in self._entries

    def effective_scores(self) -> np.ndarray:
        """Staleness-discounted gap scores; unmeasured and excluded blocks
        sink to ``-inf`` so they can never displace measured evidence."""
        eff = self.scores * np.power(self.decay, self.age)
        eff[self.scores < 0.0] = -np.inf
        eff[self.excluded] = -np.inf
        return eff

    # -- serving ----------------------------------------------------------

    def get(self, block: int):
        """The resident DeviceBlock for ``block`` or ``None``. A hit is an
        upload that never happened — accounted in blocks and bytes."""
        entry = self._entries.get(int(block))
        if entry is not None:
            self.stats.hbm_hit_blocks += 1
            self.stats.hbm_hit_bytes += self.block_bytes
            reg = get_registry()
            reg.count("stream.residency.hbm_hit_blocks")
            reg.count("stream.residency.h2d_saved_bytes", self.block_bytes)
        return entry

    def offer(self, block: int, entry) -> bool:
        """Offer a freshly uploaded DeviceBlock for pinning. Admitted when
        the block is wanted (in the repin target, or first-come during
        bootstrap) and the budget has room. The entry MUST carry base
        (unfused) offsets — the caller fuses the CD residual per pass."""
        b = int(block)
        if b in self._entries or self.excluded[b]:
            return False
        if len(self._entries) >= self.capacity:
            return False
        if self._target is not None and b not in self._target:
            return False
        self._entries[b] = entry
        self.stats.stored_blocks += 1
        self._decide("pin", b, byte_delta=self.block_bytes)
        return True

    # -- feedback / re-pinning -------------------------------------------

    def update_gaps(self, gaps: Dict[int, float]) -> None:
        """Fold measured per-block gap estimates in (epoch end): every
        block ages one epoch, measured blocks reset to the new magnitude."""
        self.age += 1
        for block, gap in gaps.items():
            b = int(block)
            if not 0 <= b < self.num_blocks:
                raise IndexError(
                    f"gap update for block {b} outside [0, {self.num_blocks})"
                )
            self.scores[b] = abs(float(gap))
            self.age[b] = 0

    def repin(self) -> List[int]:
        """Recompute the target resident set from effective scores and
        evict residents that fell out (gap decay). Called ONLY between
        epochs — mid-pass the resident set is frozen so the pass's
        arithmetic order is deterministic. Returns the new target.

        Deterministic under a fixed gap trajectory: the stable argsort on
        ``-eff`` breaks exact ties by block index, so two managers fed the
        same measurements pin the same sets.
        """
        eff = self.effective_scores()
        ranked = np.argsort(-eff, kind="stable")
        target = [int(b) for b in ranked[: self.capacity] if eff[b] > -np.inf]
        self._target = set(target)
        for b in sorted(self._entries):
            if b not in self._target:
                self._evict(b)
        self.epoch += 1
        self.stats.repins += 1
        reg = get_registry()
        reg.gauge("stream.residency.resident_blocks", float(len(self._entries)))
        reg.gauge("stream.residency.resident_bytes", float(self.resident_bytes))
        reg.gauge("stream.residency.target_blocks", float(len(self._target)))
        reg.gauge("stream.residency.capacity_blocks", float(self.capacity))
        return target

    def mark_failed(self, blocks) -> None:
        """Permanently failed blocks (on_block_error=skip) leave the
        residency plane entirely: evicted if resident, never pinned again.
        The GapScheduler forwards its own ``mark_failed`` here when a
        residency plane is attached (stochastic mode)."""
        for b in blocks:
            bi = int(b)
            if not 0 <= bi < self.num_blocks:
                continue
            self.excluded[bi] = True
            if self._target is not None:
                self._target.discard(bi)
            if bi in self._entries:
                self._evict(bi)

    def _evict(self, block: int) -> None:
        del self._entries[block]
        self.stats.evicted_blocks += 1
        self._decide("evict", block, byte_delta=-self.block_bytes)

    def _decide(self, action: str, block: int, byte_delta: int) -> None:
        eff = self.effective_scores()[block]
        self.decisions.append({
            "epoch": int(self.epoch),
            "action": action,
            "block": int(block),
            # -1.0 = pinned on bootstrap (no measurement yet)
            "gap_score": float(eff) if np.isfinite(eff) else -1.0,
            "byte_delta": int(byte_delta),
            "resident_blocks": int(len(self._entries)),
            "resident_bytes": int(self.resident_bytes),
        })

    def drain_decisions(self) -> List[dict]:
        """Pin/evict records accumulated since the last drain (consumed by
        the streamed coordinate into the progress ledger)."""
        out = self.decisions
        self.decisions = []
        return out

    def snapshot(self) -> dict:
        """Point-in-time summary for telemetry reports."""
        return {
            "capacity_blocks": int(self.capacity),
            "block_bytes": int(self.block_bytes),
            "resident_blocks": int(self.resident_blocks),
            "resident_bytes": int(self.resident_bytes),
            "resident_set": self.resident_indices(),
            "repins": int(self.stats.repins),
            "pins": int(self.stats.stored_blocks),
            "evictions": int(self.stats.evicted_blocks),
            "hbm_hit_blocks": int(self.stats.hbm_hit_blocks),
            "hbm_hit_bytes": int(self.stats.hbm_hit_bytes),
        }


def residency_hierarchy(source, manager: Optional[ResidencyManager] = None) -> dict:
    """Per-level hit/byte accounting of the disk → RAM → HBM hierarchy.

    * ``disk``  — the mmap :class:`~photon_ml_tpu_torch.streaming.blockcache.BlockCache`:
      decoded blocks spilled once and re-served as zero-copy memmap views.
    * ``ram``   — the decode pool's part-file LRU: a hit skips an Avro
      decode entirely.
    * ``hbm``   — the resident set: a hit skips the host-to-device upload.

    Levels a run does not use report zeros, so the dict shape is stable
    for its readers.
    """
    cache = getattr(source, "cache", None)
    disk = {
        "hit_blocks": int(cache.stats.hits) if cache is not None else 0,
        "load_s": float(cache.stats.load_s) if cache is not None else 0.0,
    }
    ram = {
        "file_cache_hits": int(getattr(source, "file_cache_hits", 0)),
        "files_decoded": int(getattr(source, "files_decoded", 0)),
    }
    hbm = (
        {
            "hit_blocks": int(manager.stats.hbm_hit_blocks),
            "saved_bytes": int(manager.stats.hbm_hit_bytes),
            "resident_blocks": int(manager.resident_blocks),
            "resident_bytes": int(manager.resident_bytes),
        }
        if manager is not None
        else {
            "hit_blocks": 0, "saved_bytes": 0,
            "resident_blocks": 0, "resident_bytes": 0,
        }
    )
    return {"disk": disk, "ram": ram, "hbm": hbm}

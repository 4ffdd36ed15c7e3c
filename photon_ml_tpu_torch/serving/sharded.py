"""Sharded device-resident serving: per-shard RE tables + entity routing.

Port of ``photon_ml_tpu/serving/sharded.py``. The single-table
:class:`~photon_ml_tpu_torch.serving.scorer.GameScorer` keeps one
``[rows+1, dim]`` device table per RE coordinate (or a host-side LRU cache
in front of it). Here each coordinate's table is partitioned into ``S``
shards (the cyclic row layout mirrors the grid placement of
``parallel/grid_features.py``), stacked as one tensor ``[S, cap+1, dim]``
on the scorer's device (or split over a serving mesh, below) — so a
batch of B requests becomes one gather
``table[shard, slot, idx]`` per coordinate, with no host work beyond the
O(B) routing-index probe. Each table is DOUBLE-BUFFERED (two halves): hot
swaps stage into the spare half and flip an index, so publishing a delta
never pauses the gather path (see :class:`ShardedReTable`).

Residency semantics, in order of degradation:

- resident entity  → its device row, bit-identical to the packed table;
- known, non-resident (cold long tail beyond the device budget) → the
  zero cold slot NOW + queued for asynchronous admission
  (``serving/admission.py``), so the next request finds it resident;
- unknown entity → the zero cold slot, the Photon-ML left-join FE-only
  fallback — same as the single-table scorer.

On a serving mesh of n positions with ``S % n == 0`` each generation half
of a table is split, as the reference splits it ``P(DATA_AXIS)``, into n
blocks of ``[S/n, cap+1, dim]``, block b on position b's device
(:class:`SplitTable`; positions that repeat one card split too): a batch
gathers each block's rows on that block's device and places them back by
row index on the batch's device, so each row's term comes from one block
and the scores are bitwise the one-table scorer's. With ``S % n != 0`` the
table stays whole on the mesh's first device, as in the reference.

Table writes are in place (``table[shards, slots] = values``: the tensor
and its ``data_ptr`` stay the same, no full-table copy, no accumulation);
a batch holds the scorer's ``write_lock`` from its routing to the issue of
its gathers, so no write lands between them (the reference routes outside
the lock, where a row evicted meanwhile can be gathered with its
successor's bytes);
writes padded to a fixed shape aim their pads at ``(0, cold_slot)`` with
zero values, so duplicate pad indices all write zero. Every write and
every gather of one scorer is issued on its device's default stream
(``scorer.device_stream``), whichever thread issues it, so a gather issued
after a write sees the row.

The scorer mirrors ``GameScorer``'s public surface (score_batch,
compile_count, hot-swap hooks) so ``MicroBatcher``/``ContinuousBatcher``
and ``replay_requests`` drive either interchangeably.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from photon_ml_tpu_torch.device import DEFAULT_DEVICE, DeviceLike, resolve_device
from photon_ml_tpu_torch.losses.pointwise import mean_function
from photon_ml_tpu_torch.serving.artifact import ServingArtifact
from photon_ml_tpu_torch.serving.routing import (
    CoordinateRouting,
    RoutingIndex,
    build_routing,
)
from photon_ml_tpu_torch.serving.scorer import (
    ScoreRequest,
    ScoreResult,
    device_stream,
    entity_rows_of,
    featurize_requests,
    note_signature,
    replace_fixed_effect,
    shard_nnz_of,
    structure_check,
    upload,
)
from photon_ml_tpu_torch.telemetry import span

# distinct (table shape, write rows) pairs written so far: the reference
# compiles one scatter program per pair, so this is its program count
_SCATTER_SIGNATURES: set = set()
_SCATTER_LOCK = threading.Lock()


def scatter_program_count() -> int:
    """Distinct (table shape, write size) signatures of table writes so
    far in this process — the number of scatter programs the reference
    compiles for the same writes."""
    return len(_SCATTER_SIGNATURES)


def _pow2_bucket(n: int) -> int:
    """Smallest power of two >= n: hot-swap writes pad to these buckets so
    the count of write signatures stays logarithmic in the largest write,
    not linear in distinct delta sizes."""
    return 1 << max(0, int(n) - 1).bit_length()


def serving_mesh(num_devices: Optional[int] = None,
                 device: DeviceLike = DEFAULT_DEVICE):
    """1-D serving mesh over the available devices (``parallel/mesh.py``):
    the visible cards on ``cuda``, the host on ``cpu``."""
    from photon_ml_tpu_torch.parallel.mesh import data_parallel_mesh

    return data_parallel_mesh(num_devices=num_devices, device=device)


def _mesh_devices(mesh, device: DeviceLike) -> List[torch.device]:
    """The devices of a serving mesh's positions in order (``[device]``
    without a mesh). A position naming a card this machine lacks raises:
    a mesh is never collapsed onto fewer cards than it names."""
    if mesh is None:
        return [resolve_device(device)]
    out = [resolve_device(d) for d in mesh.devices.flat]
    for d in out:
        if d.type == "cuda" and (d.index or 0) >= torch.cuda.device_count():
            raise ValueError(
                f"a serving mesh over {[str(x) for x in out]} names {d}, and this "
                f"machine has {torch.cuda.device_count()} card(s)")
    return out


class SplitTable:
    """One generation half of a table split over a serving mesh: block b
    holds shards ``[b·S/n, (b+1)·S/n)`` as ``[S/n, cap+1, dim]`` on
    ``devices[b]``. Writes go to the block of each row's shard; a batch is
    routed on the host into each block's rows (:meth:`route`) and gathered
    block by block (:meth:`gather`)."""

    def __init__(self, blocks: Sequence[torch.Tensor]):
        self.blocks = list(blocks)

    @property
    def per(self) -> int:
        return self.blocks[0].shape[0]

    @property
    def shape(self) -> Tuple[int, int, int]:
        b = self.blocks[0]
        return (self.per * len(self.blocks), b.shape[1], b.shape[2])

    @property
    def devices(self) -> List[torch.device]:
        return [b.device for b in self.blocks]

    def clone(self) -> "SplitTable":
        return SplitTable([b.clone() for b in self.blocks])

    def nbytes(self) -> int:
        return sum(int(b.numel()) * b.element_size() for b in self.blocks)

    def block_rows(self, shards: np.ndarray) -> List[np.ndarray]:
        """Per block, the positions in ``shards`` whose shard it holds."""
        blk = np.asarray(shards) // self.per
        return [np.nonzero(blk == b)[0] for b in range(len(self.blocks))]

    def write(self, shards: np.ndarray, slots: np.ndarray, values: np.ndarray) -> None:
        """``table[shards, slots] = values`` block by block, in place."""
        for b, (blk, rows) in enumerate(zip(self.blocks, self.block_rows(shards))):
            if rows.size == 0:
                continue
            with device_stream(blk.device):
                sh, sl, vals = upload(blk.device, [
                    np.asarray(shards, dtype=np.int64)[rows] - b * self.per,
                    np.asarray(slots, dtype=np.int64)[rows],
                    np.ascontiguousarray(values[rows])])
                blk[sh, sl] = vals

    def route(self, shards: np.ndarray, slots: np.ndarray, idx: np.ndarray) -> tuple:
        """A batch's ``(shard, slot)`` per row and its ``[B, nnz]`` column
        indices, split on the host by block: (the blocks with rows, and per
        such block its rows, local shards, slots and indices)."""
        present, arrays = [], []
        for b, rows in enumerate(self.block_rows(shards)):
            if rows.size:
                present.append(b)
                arrays += [rows, np.asarray(shards)[rows] - b * self.per,
                           np.asarray(slots)[rows], np.asarray(idx, dtype=np.int64)[rows]]
        return present, arrays

    def gather(self, present: Sequence[int], arrays: Sequence[torch.Tensor],
               shape) -> torch.Tensor:
        """``table[shards, slots, idx]`` of a batch routed by :meth:`route`
        (its arrays uploaded, four a block), ``[B, nnz]`` on their device:
        each block gathers its rows on its own device, and the rows are
        placed back by index (each row from one block)."""
        out = torch.empty(shape, dtype=self.blocks[0].dtype, device=arrays[0].device)
        for j, b in enumerate(present):
            blk = self.blocks[b]
            rows, sh, sl, idx = (a.to(blk.device) for a in arrays[4 * j:4 * j + 4])
            out[rows.to(out.device)] = blk[sh[:, None], sl[:, None], idx].to(out.device)
        return out


class ShardedReTable:
    """One RE coordinate's device storage for one scorer replica.

    DOUBLE-BUFFERED: two independent ``[S, cap+1, dim]`` tensors; shard
    ``s`` holds data slots ``0..cap-1`` plus the permanently-zero cold
    slot ``cap``. ``table`` always resolves the ACTIVE half via a
    generation index; hot-swap writes stage into the spare half off the
    request path and then flip the index (:meth:`update_rows`), so a swap
    never pauses the gather path. Outside an in-flight :meth:`update_rows`
    both halves hold identical bytes — steady-state writers (the admission
    tier) write both. Memory cost: 2x table bytes per coordinate.

    WHERE a row lives is owned by the shared :class:`CoordinateRouting`;
    this object owns only the bytes (each replica has its own copy of the
    bytes, all replicas share one routing truth).

    The host backing store (the packed artifact table, possibly mmap'd)
    stays authoritative for non-resident rows; hot-swap row updates that
    diverge from it are kept in an override map so an evicted row re-admits
    with its swapped content, not the stale packed bytes.

    On a ``mesh`` of n positions with ``S % n == 0`` each half is a
    :class:`SplitTable` of n blocks on the positions' devices; otherwise a
    tensor on the mesh's first device.
    """

    def __init__(
        self,
        backing: np.ndarray,
        routing: CoordinateRouting,
        mesh=None,
        device: DeviceLike = DEFAULT_DEVICE,
    ):
        if backing.ndim != 2:
            raise ValueError(f"backing store must be 2-D, got {backing.shape}")
        devices = _mesh_devices(mesh, device)
        self.device = devices[0]
        self._backing = backing
        self._overrides: Dict[int, np.ndarray] = {}
        self.routing = routing
        self._mesh = mesh
        S, cap, dim = routing.num_shards, routing.shard_capacity, backing.shape[1]
        base = routing.base_rows
        # the reference's rule: split when the shard count divides the
        # mesh's positions' count, else one table on the first device
        split = len(devices) > 1 and S % len(devices) == 0
        per = S // len(devices) if split else S
        blocks = []
        for b, dev in enumerate(devices if split else devices[:1]):
            with device_stream(dev):
                blk = torch.zeros((per, cap + 1, dim), dtype=torch.float32, device=dev)
                # cyclic layout: row r at (r % S, r // S), so shard s holds
                # rows s, s+S, ... in order — one host-to-device copy a
                # shard, with no [S, cap+1, dim] host staging array
                for s in range(b * per, min((b + 1) * per, base)):
                    rows = np.ascontiguousarray(backing[s:base:S], dtype=np.float32)
                    blk[s - b * per, : rows.shape[0]] = torch.from_numpy(rows).to(dev)
                blocks.append(blk)
        # both generation halves start converged (identical bytes)
        first = SplitTable(blocks) if split else blocks[0]
        self._tables = [first, first.clone()]
        self._gen = 0

    @property
    def split(self) -> bool:
        """Whether the halves are split over the mesh (:class:`SplitTable`)."""
        return isinstance(self._tables[0], SplitTable)

    # ------------------------------------------------------------- reading

    @property
    def table(self) -> torch.Tensor:
        """ACTIVE generation half — device tensor [S, cap+1, dim] (a
        :class:`SplitTable` on a splitting mesh); slot ``cap`` of every
        shard is the zero cold slot."""
        return self._tables[self._gen]

    @property
    def generation(self) -> int:
        """Index (0/1) of the active table half."""
        return self._gen

    @property
    def spare_gen(self) -> int:
        """Index of the spare (write-staging) table half."""
        return 1 - self._gen

    def flip(self) -> None:
        """Switch the active half. Callers must hold the owning scorer's
        ``write_lock`` (so no in-flight gather still references the half
        being retired) — see :meth:`update_rows`."""
        self._gen = 1 - self._gen

    @property
    def cold_slot(self) -> int:
        return self.routing.cold_slot

    @property
    def capacity(self) -> int:
        """Total device data rows across shards."""
        return self.routing.device_rows

    def host_rows(self, rows: np.ndarray) -> np.ndarray:
        """Authoritative host-side content for global rows: the backing
        store with hot-swap overrides applied; rows beyond the store (new
        entities appended by a swap) default to zero unless overridden."""
        rows = np.asarray(rows, dtype=np.int64)
        out = np.zeros((rows.size, self._backing.shape[1]), dtype=np.float32)
        in_store = rows < self._backing.shape[0]
        if in_store.any():
            out[in_store] = np.asarray(
                self._backing[rows[in_store]], dtype=np.float32
            )
        if self._overrides:
            for i, r in enumerate(rows):
                ov = self._overrides.get(int(r))
                if ov is not None:
                    out[i] = ov
        return out

    # ------------------------------------------------------------- writing

    def write_slots(
        self,
        shards: np.ndarray,
        slots: np.ndarray,
        values: np.ndarray,
        gen: Optional[int] = None,
    ) -> None:
        """Write rows into (shard, slot) storage in place — the table tensor
        keeps its storage, no shape change, no new score signature. Callers
        padding to a fixed batch shape (the admission tier) aim the pad
        writes at ``(0, cold_slot)`` with zero values, which keeps the cold
        slot zero and the write deterministic.

        ``gen`` selects the table half (default: active). Writes to the
        ACTIVE half need the owning scorer's ``write_lock`` so no gather is
        being issued against it; writes to the SPARE half need only
        ``routing.lock`` (which keeps the generation index stable and
        serializes writers) — the request path never reads that half."""
        g = self._gen if gen is None else int(gen)
        table = self._tables[g]
        values = np.ascontiguousarray(values, dtype=np.float32)
        sig = (tuple(table.shape), int(values.shape[0]))
        if sig not in _SCATTER_SIGNATURES:
            with _SCATTER_LOCK:
                _SCATTER_SIGNATURES.add(sig)
        if isinstance(table, SplitTable):
            table.write(shards, slots, values)
            return
        with device_stream(self.device):
            sh, sl, vals = upload(
                self.device,
                [np.asarray(shards, dtype=np.int64),
                 np.asarray(slots, dtype=np.int64), values],
            )
            table[sh, sl] = vals

    def update_rows(
        self,
        rows: np.ndarray,
        values: np.ndarray,
        replicas: Optional[Sequence[Tuple[object, "ShardedReTable"]]] = None,
    ) -> float:
        """Hot-swap hook: update/append global rows via a PAUSELESS
        generation flip. Resident rows are overwritten; non-resident rows
        are admitted immediately (allocating headroom slots, evicting the
        oldest admitted rows when full). Raises only when the coordinate
        has no headroom left for genuinely new rows. Returns the
        request-path blocking seconds: the width of the flip window during
        which every replica's ``write_lock`` is held (lock handoff only —
        no device work happens inside it).

        Three phases, all under ``routing.lock``:

        1. STAGE — pad every write to a power-of-two shape (pads aim zeros
           at shard 0's cold slot) and write it into every replica's SPARE
           half. No ``write_lock``: the request path gathers only the
           active half, and ``routing.lock`` keeps every ``_gen`` stable.
        2. FLIP — acquire EVERY replica's ``write_lock`` (once held, no
           gather is being issued on any replica) and flip all generation
           indexes, all-or-nothing. This is the only blocking window and
           the returned duration. New rows publish() only AFTER the flip.
        3. CONVERGE — replay the same writes into the old (now spare)
           halves; afterwards the invariant "both halves identical outside
           this call" holds again. The writes are ordered after every
           gather already issued on the stream, so none of those gathers
           reads the new bytes.

        ``replicas`` is the multi-scorer fan-out: ``(write_lock, table)``
        pairs for EVERY replica of this coordinate (including this one).
        Defaults to this table alone with no lock."""
        rows = np.asarray(rows, dtype=np.int64).ravel()
        values = np.asarray(values, dtype=np.float32).reshape(rows.size, -1)
        if rows.size == 0:
            return 0.0
        if replicas is None:
            replicas = [(contextlib.nullcontext(), self)]
        routing = self.routing
        with routing.lock:
            if rows.max() >= routing.n_rows:
                routing.grow(int(rows.max()) + 1)
            # importance plane: swapped-in content defines the rows' new
            # magnitude (no-op under the default eviction policy)
            routing.note_row_norms(rows, np.linalg.norm(values, axis=1))
            for _, table in replicas:
                for r, v in zip(rows, values):
                    table._overrides[int(r)] = np.array(v, dtype=np.float32)
            eff_slots = routing._slot_of[rows].copy()
            eff_shards = routing._shard_of[rows].copy()
            new_rows = np.unique(rows[eff_slots < 0])
            publish_args = None
            # (shards, slots, per-replica values) staged to BOTH halves
            writes: List[Tuple[np.ndarray, np.ndarray, List[np.ndarray]]] = []
            if new_rows.size:
                a_shards, a_slots, _ = routing.allocate(new_rows.size)
                n = int(new_rows.size)
                k = _pow2_bucket(n)
                shards = np.zeros(k, dtype=np.int32)
                slots = np.full(k, routing.cold_slot, dtype=np.int32)
                shards[:n] = a_shards
                slots[:n] = a_slots
                per_replica = []
                for _, table in replicas:
                    content = np.zeros((k, values.shape[1]), dtype=np.float32)
                    content[:n] = table.host_rows(new_rows)
                    per_replica.append(content)
                writes.append((shards, slots, per_replica))
                publish_args = (new_rows, a_shards, a_slots)
                # residency as it will stand after publish(): overlay the
                # fresh allocations on the current map (victims already
                # cleared by allocate)
                eff_slots = routing._slot_of[rows].copy()
                eff_shards = routing._shard_of[rows].copy()
                pos = {int(r): i for i, r in enumerate(new_rows)}
                for j, r in enumerate(rows):
                    i = pos.get(int(r))
                    if i is not None:
                        eff_slots[j] = a_slots[i]
                        eff_shards[j] = a_shards[i]
            resident = eff_slots >= 0
            if resident.any():
                n = int(resident.sum())
                k = _pow2_bucket(n)
                w_shards = np.zeros(k, dtype=np.int32)
                w_slots = np.full(k, routing.cold_slot, dtype=np.int32)
                w_shards[:n] = eff_shards[resident]
                w_slots[:n] = eff_slots[resident]
                w_values = np.zeros((k, values.shape[1]), dtype=np.float32)
                w_values[:n] = values[resident]
                writes.append((w_shards, w_slots, [w_values] * len(replicas)))
            if not writes:
                return 0.0
            # phase 1: stage into every spare half, off the request path
            for shards, slots, per_replica in writes:
                for (_, table), content in zip(replicas, per_replica):
                    table.write_slots(
                        shards, slots, content, gen=table.spare_gen
                    )
            # phase 2: the flip — the only request-path blocking window
            t0 = time.perf_counter()
            with contextlib.ExitStack() as stack:
                for lock, _ in replicas:
                    stack.enter_context(lock)
                for _, table in replicas:
                    table.flip()
            blocking_s = time.perf_counter() - t0
            if publish_args is not None:
                routing.publish(*publish_args)
            # phase 3: converge the retired halves (now spare)
            for shards, slots, per_replica in writes:
                for (_, table), content in zip(replicas, per_replica):
                    table.write_slots(
                        shards, slots, content, gen=table.spare_gen
                    )
            return blocking_s

    def fits(self, targets: np.ndarray) -> bool:
        """Whether a hot-swap touching these global rows stays in-shape:
        every non-resident target can claim a headroom slot (free or by
        evicting an admitted row)."""
        targets = np.asarray(targets, dtype=np.int64).ravel()
        with self.routing.lock:
            known = targets[targets < self.routing.n_rows]
            resident = (
                self.routing._slot_of[known] >= 0
                if known.size
                else np.empty(0, dtype=bool)
            )
            n_new = np.unique(targets).size - np.unique(known[resident]).size
            return n_new <= self.routing.free_slots + len(
                self.routing._admitted
            )

    def stats(self) -> Dict[str, float]:
        return self.routing.stats()


class ShardedGameScorer:
    """``GameScorer`` with sharded device-resident RE tables.

    Public surface mirrors :class:`GameScorer` (``score_batch`` /
    ``compile_count`` / hot-swap hooks / empty ``caches``), so every
    caller works unchanged. Differences:

    - RE coefficients come from one gather ``table[shard, slot, idx]``
      over the stacked ``[S, cap+1, dim]`` table per coordinate — the
      gathered values (and therefore the scores) are bit-identical to the
      single-table scorer's.
    - ``num_shards`` / ``device_budget_rows`` bound device memory; the
      long tail beyond the budget starts cold and is pulled on-device by
      an :class:`~photon_ml_tpu_torch.serving.admission.AdmissionController`
      attached via :meth:`attach_admission`.
    - ``routing`` may be a shared :class:`RoutingIndex` (multi-scorer
      mode: every replica gathers through the same entity placement).
    - ``device``, or a ``mesh``'s first position, is where the FE vectors,
      the batch and the unsplit tables live; a mesh of n positions with
      ``n`` dividing ``num_shards`` splits every RE table over them.
    """

    def __init__(
        self,
        artifact: ServingArtifact,
        max_nnz: Optional[Union[int, Dict[str, int]]] = None,
        num_shards: int = 4,
        device_budget_rows: Optional[int] = None,
        mesh=None,
        routing: Optional[RoutingIndex] = None,
        headroom_fraction: float = 0.25,
        eviction_policy: str = "oldest",
        score_delta: bool = True,
        device: DeviceLike = DEFAULT_DEVICE,
    ):
        self.device = _mesh_devices(mesh, device)[0]
        self._artifact = artifact
        self._task = artifact.task
        self.num_shards = int(num_shards)
        self.device_budget_rows = device_budget_rows
        dims = artifact.shard_dims()
        self._shard_nnz = shard_nnz_of(dims, max_nnz)
        self._shard_dim = dims

        self._fe_specs: List[Tuple[str, str]] = []
        self._re_specs: List[Tuple[str, str, str]] = []
        self.caches: Dict[str, object] = {}  # no host cache on this path
        self._providers: Dict[str, ShardedReTable] = {}
        self._mesh = mesh
        self._headroom_fraction = float(headroom_fraction)
        self._admission = None
        # multi-scorer mode: every replica sharing this scorer's routing
        # index (including self); hot-swap row admission writes all of
        # their tables before publishing. None = this scorer alone.
        self._replica_group: Optional[List["ShardedGameScorer"]] = None
        # serializes active-half table writes against the scoring thread:
        # it holds the lock from routing a batch until its gathers are
        # issued, writers (admission, hot swap) across their write
        self.write_lock = threading.Lock()
        fe_params: Dict[str, torch.Tensor] = {}
        re_rows = {
            cid: t.n_entities
            for cid, t in artifact.tables.items()
            if t.is_random_effect
        }
        if routing is None:
            # eviction_policy only applies when this scorer builds its own
            # routing; a shared RoutingIndex carries its own policy
            routing = build_routing(
                re_rows,
                num_shards=self.num_shards,
                device_budget_rows=device_budget_rows,
                headroom_fraction=self._headroom_fraction,
                eviction_policy=eviction_policy,
                score_delta=score_delta,
            )
        self._routing = routing
        for cid in sorted(artifact.tables):
            table = artifact.tables[cid]
            if table.is_random_effect:
                self._re_specs.append(
                    (cid, table.feature_shard, table.random_effect_type)
                )
                self._providers[cid] = ShardedReTable(
                    np.asarray(table.weights), routing[cid], mesh=mesh, device=self.device,
                )
            else:
                self._fe_specs.append((cid, table.feature_shard))
                with device_stream(self.device):
                    fe_params[cid] = torch.from_numpy(
                        np.array(table.weights, dtype=np.float32)
                    ).to(self.device)
        self._fe_params = fe_params
        self._signatures: set = set()

    # ---------------------------------------------------------- properties

    @property
    def compile_count(self) -> int:
        """Distinct score signatures so far — one per bucket size (and per
        table shape a rebind introduced)."""
        return len(self._signatures)

    @property
    def task(self):
        return self._task

    @property
    def artifact(self) -> ServingArtifact:
        return self._artifact

    @property
    def routing(self) -> RoutingIndex:
        return self._routing

    def cache_stats(self) -> Dict[str, Dict[str, float]]:
        return {}

    def residency_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-coordinate device residency + lookup accounting (the sharded
        replacement for ``cache_stats``/``cache_hit_rate``)."""
        return self._routing.stats()

    def table_bytes(self) -> int:
        """Bytes of every device table this scorer holds (both halves of
        each RE coordinate, and the FE vectors)."""
        total = sum(int(w.numel()) * w.element_size() for w in self._fe_params.values())
        for p in self._providers.values():
            total += sum(t.nbytes() if isinstance(t, SplitTable)
                         else int(t.numel()) * t.element_size() for t in p._tables)
        return total

    def attach_admission(self, controller) -> None:
        """Route deferred (known, non-resident) lookups to an admission
        controller; without one they are only counted. When the controller
        spans several replicas of this scorer's routing index, they become
        this scorer's replica group."""
        self._admission = controller
        peers = [
            s
            for s in getattr(controller, "scorers", [])
            if getattr(s, "_routing", None) is self._routing
        ]
        if len(peers) > 1 and self in peers:
            self.set_replica_group(peers)

    def set_replica_group(
        self, scorers: Sequence["ShardedGameScorer"]
    ) -> None:
        """Declare the replicas (including this scorer) that share this
        scorer's routing index, so row-level hot swaps keep the
        write-everywhere-before-publish ordering across all of them."""
        scorers = list(scorers)
        if self not in scorers:
            raise ValueError("replica group must include this scorer")
        for s in scorers:
            if s._routing is not self._routing:
                raise ValueError(
                    "replica group must share one routing index"
                )
        self._replica_group = scorers

    # ------------------------------------------------------ hot-swap hooks

    def set_artifact(self, artifact: ServingArtifact) -> None:
        """Flip the artifact reference (entity indexes) under
        ``write_lock``."""
        structure_check(self, artifact)
        # grow every RE coordinate's routing BEFORE the new entity indexes
        # go live: a concurrent score_batch may resolve candidate-only
        # entities the instant the artifact reference flips, and route()
        # must already know the larger row space
        for cid, _, _ in self._re_specs:
            n_new = artifact.tables[cid].n_entities
            routing = self._routing[cid]
            if n_new > routing.n_rows:
                routing.grow(n_new)
        with self.write_lock:
            self._artifact = artifact

    def update_fixed_effect(self, cid: str, weights: np.ndarray) -> None:
        """Replace one FE vector: the new tensor is built off the request
        path and installed under ``write_lock``."""
        staged = dict(self._fe_params)
        with device_stream(self.device):
            replace_fixed_effect(staged, cid, weights)
        with self.write_lock:
            self._fe_params[cid] = staged[cid]

    def update_random_effect_rows(
        self, cid: str, rows: np.ndarray, values: np.ndarray
    ) -> float:
        """Returns the request-path blocking seconds — the generation-flip
        window of :meth:`ShardedReTable.update_rows`."""
        provider = self._providers.get(cid)
        if provider is None:
            raise ValueError(f"{cid!r} is not a random-effect coordinate")
        group = self._replica_group or [self]
        # routing.lock (taken inside update_rows) is the OUTER lock; each
        # replica's write_lock is taken only across the generation flip
        return provider.update_rows(
            rows,
            values,
            replicas=[(s.write_lock, s._providers[cid]) for s in group],
        )

    def rebind_random_effect(self, cid: str, backing: np.ndarray) -> bool:
        """Rebuild one coordinate's device shards from a new backing table.
        Stays in-shape (False) when the shared routing's shard capacity
        already accommodates the new row count — then only the bytes are
        rebuilt; grows the routing (True, one new signature) otherwise."""
        provider = self._providers.get(cid)
        if provider is None:
            raise ValueError(f"{cid!r} is not a random-effect coordinate")
        backing = np.asarray(backing)
        n_new = backing.shape[0]
        routing = self._routing[cid]
        with routing.lock:
            old_cap = routing.shard_capacity
            if n_new > routing.device_rows or routing.n_rows != n_new:
                fresh = build_routing(
                    {cid: n_new},
                    num_shards=routing.num_shards,
                    device_budget_rows=self.device_budget_rows,
                    headroom_fraction=self._headroom_fraction,
                )[cid]
                if fresh.shard_capacity < old_cap:
                    # never shrink a shared layout other replicas still
                    # serve
                    fresh = CoordinateRouting(
                        n_rows=n_new,
                        num_shards=routing.num_shards,
                        shard_capacity=old_cap,
                        resident_rows=fresh.base_rows,
                    )
                self._routing.coordinates[cid] = fresh
                routing = fresh
            # build the replacement table OUTSIDE write_lock — concurrent
            # scoring keeps gathering the old provider; only the pointer
            # install blocks
            fresh_provider = ShardedReTable(backing, routing, mesh=self._mesh,
                                            device=self.device)
            with self.write_lock:
                self._providers[cid] = fresh_provider
            return routing.shard_capacity != old_cap

    def restore_random_effect(
        self, cid: str, provider, routing=None
    ) -> None:
        """Rollback hook: reinstall a snapshotted provider and — when the
        forward swap regrew the shared layout — the routing coordinate it
        was built against, as ONE step."""
        current = self._routing[cid]
        with current.lock:
            if routing is not None and routing is not current:
                self._routing.coordinates[cid] = routing
            with self.write_lock:
                self._providers[cid] = provider

    # -------------------------------------------------------------- scoring

    def _featurize(self, requests: Sequence[ScoreRequest], bucket: int):
        return featurize_requests(
            requests, len(requests), bucket, self._shard_nnz, self._shard_dim
        )

    def score_batch(
        self,
        requests: Sequence[ScoreRequest],
        bucket_size: Optional[int] = None,
        stages: Optional[dict] = None,
        view: Optional[Tuple[ServingArtifact, Dict[str, torch.Tensor]]] = None,
    ) -> List[ScoreResult]:
        """Score one bucket. ``view`` is the multi-model hook: an
        ``(artifact, fe_params)`` pair that overrides WHICH entity indexes
        resolve rows and WHICH fixed-effect tensors the batch reads — same
        shapes, so no new score signature, and the same shared RE tables.
        The tenancy plane's ``VariantRegistry`` builds one view per
        variant; ``view=None`` is the plain single-model path, bitwise
        unchanged."""
        n = len(requests)
        bucket = int(bucket_size) if bucket_size is not None else n
        if n == 0:
            return []
        if n > bucket:
            raise ValueError(f"{n} requests do not fit bucket size {bucket}")
        with span("serve/score_batch", n=n, bucket=bucket):
            return self._score_batch_impl(requests, n, bucket, stages, view)

    def _score_batch_impl(
        self,
        requests: Sequence[ScoreRequest],
        n: int,
        bucket: int,
        stages: Optional[dict] = None,
        view: Optional[Tuple[ServingArtifact, Dict[str, torch.Tensor]]] = None,
    ) -> List[ScoreResult]:
        with span("serve/featurize", n=n):
            shards, offsets = self._featurize(requests, bucket)
        order = list(shards)
        # the featurized arrays go up before write_lock: they depend on no
        # routing decision (the "featurize" stage closes with their copy
        # queued)
        with device_stream(self.device):
            feats = upload(
                self.device,
                [offsets]
                + [shards[s][0] for s in order]
                + [shards[s][1].astype(np.int64) for s in order],
            )
        if stages is not None:
            stages["featurize_done"] = time.perf_counter()
        # write_lock spans routing through the issue of the gathers: no
        # admission or hot-swap write to the active half, and no flip, can
        # land between a row's routing and its gather. (A writer evicts a
        # row and then writes another entity's bytes into its slot; with
        # routing outside the lock a batch that routed the evicted row
        # just before could gather the newcomer's coefficients.) On one
        # stream, writes issued after the gathers run after them. Inside
        # it nothing waits for the device: the route arrays' copy is
        # queued like the gathers.
        with self.write_lock, device_stream(self.device):
            # the artifact and FE tensors are read under the lock: a swap
            # installs them under it too
            artifact, fe_params = (
                (self._artifact, self._fe_params) if view is None else view
            )
            route_arrays, layout, cold, sdelta_rows = self._route(
                requests, n, bucket, shards, artifact
            )
            if stages is not None:
                # the "route" stage includes any write_lock wait
                stages["route_done"] = time.perf_counter()
            out = self._gather_score(
                bucket, order, feats, upload(self.device, route_arrays), layout,
                list(sdelta_rows), fe_params,
            )
            if stages is not None:
                # the copies and launches are asynchronous: this boundary
                # closes dispatch; the host copy below waits for the H2D
                # copies and the device
                stages["dispatch_done"] = time.perf_counter()
        with device_stream(self.device):
            host = torch.stack(out).cpu().numpy()
        z_list = host[0, :n].tolist()
        mean_list = host[1, :n].tolist()
        for j, (cid, rows_arr) in enumerate(sdelta_rows.items()):
            self._routing[cid].note_score_deltas(rows_arr, host[2 + j, :n])
        if stages is not None:
            stages["device_done"] = time.perf_counter()
        empty: Tuple[str, ...] = ()
        return [
            ScoreResult(
                request_id=req.request_id,
                score=z_list[i],
                mean=mean_list[i],
                cold_coordinates=tuple(cold[i]) if i in cold else empty,
            )
            for i, req in enumerate(requests)
        ]

    def _route(self, requests, n: int, bucket: int, shards, artifact):
        """Host routing of one batch through ``artifact``'s entity indexes:
        per RE coordinate the ``[bucket]`` shard and slot arrays (pads and
        FE-only rows at shard 0's cold slot), or for a split table each
        block's rows, shards, slots and column indices
        (:meth:`SplitTable.route`; ``layout`` names the blocks, None for a
        whole table), each request's cold coordinates, and the rows whose
        measured score deltas the importance plane wants."""
        route_arrays: List[np.ndarray] = []
        layout: List[Optional[List[int]]] = []
        cold: Dict[int, List[str]] = {}
        sdelta_rows: Dict[str, np.ndarray] = {}
        with span("serve/route", n=n):
            for cid, feature_shard, re_type in self._re_specs:
                table = artifact.tables[cid]
                entity_rows = entity_rows_of(requests, n, bucket, re_type, table)
                routing = self._routing[cid]
                cid_shards, cid_slots, deferred = routing.route(
                    entity_rows[:n]
                )
                # importance plane: fold this batch into the EWMA request
                # frequencies (no-op under the default eviction policy);
                # under the importance policy each request also deposits
                # its feature-vector norm
                if routing.wants_feature_norms:
                    vals = shards[feature_shard][0]
                    routing.note_requests(
                        entity_rows[:n],
                        feature_norms=np.linalg.norm(vals[:n], axis=1),
                    )
                else:
                    routing.note_requests(entity_rows[:n])
                if routing.wants_score_deltas:
                    sdelta_rows[cid] = entity_rows[:n].copy()
                if deferred.size and self._admission is not None:
                    self._admission.note_deferred(cid, deferred)
                full_shards = np.zeros(bucket, dtype=np.int64)
                full_slots = np.full(bucket, routing.cold_slot, dtype=np.int64)
                full_shards[:n] = cid_shards
                full_slots[:n] = cid_slots
                table = self._providers[cid].table
                if isinstance(table, SplitTable):
                    present, arrays = table.route(full_shards, full_slots,
                                                  shards[feature_shard][1])
                    layout.append(present)
                    route_arrays += arrays
                else:
                    layout.append(None)
                    route_arrays += [full_shards, full_slots]
                served_cold = np.nonzero(
                    full_slots[:n] == routing.cold_slot
                )[0]
                for i in served_cold:
                    cold.setdefault(int(i), []).append(cid)
        return route_arrays, layout, cold, sdelta_rows

    def _gather_score(self, bucket, order, feats, routed, layout,
                      delta_cids, fe_params) -> List[torch.Tensor]:
        """Issue one uploaded batch's score on the device: ``[z, mean]``
        plus, per coordinate in ``delta_cids``, ``|RE term|`` (the
        request's measured ``|score - fe_only_score|`` for it). ``feats``
        is ``[offsets, values per shard..., indices per shard...]`` in
        ``order``; ``routed`` the ``(shard, slot)`` arrays per RE
        coordinate, or for a split table its blocks' arrays (``layout``,
        :meth:`_route`); ``fe_params`` the FE tensors the batch reads."""
        k = len(order)
        vals = dict(zip(order, feats[1:1 + k]))
        idx = dict(zip(order, feats[1 + k:1 + 2 * k]))
        tables = [self._providers[cid].table for cid, _, _ in self._re_specs]
        note_signature(self._signatures, bucket, tables)
        with span("serve/gather_score", bucket=bucket):
            z = feats[0]
            for cid, shard in self._fe_specs:
                z = z + (vals[shard] * fe_params[cid][idx[shard]]).sum(dim=1)
            terms = {}
            at = 0
            for (cid, shard, _), table, present in zip(self._re_specs, tables, layout):
                if present is not None:
                    rows = table.gather(present, routed[at:at + 4 * len(present)],
                                        idx[shard].shape)
                    at += 4 * len(present)
                else:
                    sh, sl = routed[at], routed[at + 1]
                    at += 2
                    rows = table[sh[:, None], sl[:, None], idx[shard]]
                terms[cid] = (vals[shard] * rows).sum(dim=1)
                z = z + terms[cid]
            return [z, mean_function(self._task, z)] + [terms[c].abs() for c in delta_cids]

"""Variant registry: N GLMix model variants served by ONE sharded scorer.

Photon-ML deployments are inherently multi-model — A/B candidates,
per-market models, ramped rollouts — but N full scorers would cost N
device tables, N sets of score signatures, and N admission planes for models that
differ in a few thousand rows. This module serves every variant from the
shared scorer instead, exploiting the same structure the local/global
split of arxiv 1811.01564 exploits for training: a variant is a small
local deviation from the shared global model.

Mechanics (all riding the ``view`` hook of
:meth:`~photon_ml_tpu_torch.serving.sharded.ShardedGameScorer.score_batch`):

- **Shared FE base, per-variant FE override.** Fixed-effect vectors are
  device tensors a batch reads; a variant carries its own ``fe_params``
  dict (same keys, same shapes, on the scorer's device), so variant
  scoring adds no score signature.
- **Per-variant RE overlay rows in the shared tables.** A delta row for
  variant ``v`` is written to a FRESH global row of the shared
  routing/table space (allocated past the base row range) — copy-on-write
  even when the entity exists in the base, so no other variant ever
  gathers it. The variant's entity index is the base index behind an
  :class:`~photon_ml_tpu_torch.incremental.delta.OverlayIndexMap` redirecting
  just the touched entities to their private rows.
- **Fingerprint-chained per-variant deltas.** Each variant is an
  independent hash chain off the base artifact fingerprint
  (``delta.base_fingerprint`` must match the variant's chain head);
  applying, validating, and rolling back one variant never pauses or
  rewinds another — per-variant hot-swap isolation.

The ``base`` variant is special: it carries no view at all and scores
through the scorer's plain path, which makes single-variant tenancy
bitwise-identical to the non-tenant stack (the CI tenancy parity gate).

Port of ``photon_ml_tpu/serving/tenancy/variants.py``: a variant's FE
vector is a tensor of the base vector's shape on the lead scorer's device
(where the reference passes a jit argument); the overlay rows go through
the sharded scorer's ``update_random_effect_rows``.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch.incremental.delta import (
    DeltaArtifact,
    OverlayIndexMap,
    discover_deltas,
    load_delta,
)
from photon_ml_tpu_torch.serving.artifact import ServingArtifact
from photon_ml_tpu_torch.serving.scorer import device_stream, replace_fixed_effect

_log = logging.getLogger("photon_ml_tpu_torch.serving.tenancy")

BASE_VARIANT = "base"


@dataclasses.dataclass
class VariantState:
    """One variant's serving state. ``artifact``/``fe_params`` of ``None``
    mean "follow the live base scorer" (the base variant — and any variant
    that has not diverged yet), which is the zero-cost bitwise path."""

    variant_id: str
    generation: int = 0
    fingerprint: Optional[str] = None
    artifact: Optional[ServingArtifact] = None
    fe_params: Optional[Dict[str, object]] = None
    # cid -> entity id -> private global row in the SHARED table space
    overlay_rows: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict
    )
    swaps: int = 0
    rollbacks: int = 0

    @property
    def diverged(self) -> bool:
        return self.artifact is not None

    @property
    def overlay_row_count(self) -> int:
        return sum(len(m) for m in self.overlay_rows.values())


@dataclasses.dataclass
class VariantSwapReport:
    """Per-variant swap outcome (the tenancy analogue of ``SwapReport``)."""

    variant_id: str
    generation: int
    fingerprint: Optional[str]
    rows_updated: int
    new_overlay_rows: int
    blackout_s: float
    rolled_back: bool
    validation_metric: Optional[float] = None
    baseline_metric: Optional[float] = None


@dataclasses.dataclass
class _VariantUndo:
    """Inverse of one variant swap: the previous state object plus the old
    content of the variant-private rows the swap rewrote in place."""

    state: VariantState
    inplace: Dict[str, Tuple[np.ndarray, np.ndarray]]  # cid -> (rows, old)


class VariantScorer:
    """``score_batch`` facade for one variant: the shared scorer with the
    variant's ``(artifact, fe_params)`` view threaded through. Quacks
    enough like a ``GameScorer`` for ``MicroBatcher``/``ValidationGate``
    (``score_batch``/``compile_count``/``caches``)."""

    caches: Dict[str, object] = {}

    def __init__(self, registry: "VariantRegistry", variant_id: str, scorer=None):
        self._registry = registry
        self.variant_id = variant_id
        self._scorer = scorer if scorer is not None else registry.lead

    @property
    def compile_count(self) -> int:
        return self._scorer.compile_count

    @property
    def artifact(self):
        state = self._registry.state(self.variant_id)
        return state.artifact if state.diverged else self._scorer.artifact

    def cache_stats(self):
        return self._scorer.cache_stats()

    def residency_stats(self):
        fn = getattr(self._scorer, "residency_stats", None)
        return fn() if fn is not None else None

    def score_batch(self, requests, bucket_size=None, stages=None):
        view = self._registry.view(self.variant_id)
        if view is None:
            return self._scorer.score_batch(requests, bucket_size, stages=stages)
        return self._scorer.score_batch(
            requests, bucket_size, stages=stages, view=view
        )


class VariantRegistry:
    """Owns every variant's state and applies per-variant deltas to the
    shared scorer (all replicas).

    ``scorers`` is the replica list of ONE sharded scorer group (shared
    routing); the lead performs overlay writes, which fan out to every
    replica through ``update_random_effect_rows``'s
    write-everywhere-then-publish contract. ``base_fingerprint`` roots
    every variant's delta chain (the base artifact directory's content
    fingerprint when serving from disk; ``None`` for in-memory artifacts —
    chain checks then start from the first applied delta)."""

    def __init__(
        self,
        scorers,
        base_fingerprint: Optional[str] = None,
        gate=None,
        clock=time.perf_counter,
    ):
        scorers = (
            list(scorers) if isinstance(scorers, (list, tuple)) else [scorers]
        )
        if not scorers:
            raise ValueError("need at least one scorer")
        self._scorers = scorers
        self.lead = scorers[0]
        self.base_fingerprint = base_fingerprint
        self.gate = gate
        self._clock = clock
        self._lock = threading.RLock()
        self._states: Dict[str, VariantState] = {
            BASE_VARIANT: VariantState(
                variant_id=BASE_VARIANT, fingerprint=base_fingerprint
            )
        }
        self._undo: Dict[str, _VariantUndo] = {}
        self._baselines: Dict[str, float] = {}
        self._processed: Dict[str, set] = {}
        # next private global row per coordinate, past everything the base
        # artifact (and base hot swaps) can ever legitimately claim
        self._next_row: Dict[str, int] = {}
        self.delta_load_failures = 0

    # ------------------------------------------------------------ variants

    @property
    def variant_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._states)

    def add_variant(
        self, variant_id: str, fingerprint: Optional[str] = None
    ) -> VariantState:
        """Register a variant. It starts as an exact alias of the live
        base (no view, no overlay) and diverges on its first delta."""
        with self._lock:
            if variant_id in self._states:
                raise ValueError(f"variant {variant_id!r} already exists")
            state = VariantState(
                variant_id=variant_id,
                fingerprint=(
                    fingerprint
                    if fingerprint is not None
                    else self.base_fingerprint
                ),
            )
            self._states[variant_id] = state
            return state

    def state(self, variant_id: str) -> VariantState:
        with self._lock:
            state = self._states.get(variant_id)
            if state is None:
                raise KeyError(f"unknown variant {variant_id!r}")
            return state

    def view(self, variant_id: str):
        """The ``(artifact, fe_params)`` score view, or ``None`` for
        follow-the-base variants (the bitwise plain path)."""
        state = self.state(variant_id)
        if not state.diverged:
            return None
        return (state.artifact, state.fe_params)

    def scorer(self, variant_id: str, scorer=None) -> VariantScorer:
        self.state(variant_id)  # raise early on unknown ids
        return VariantScorer(self, variant_id, scorer=scorer)

    # ------------------------------------------------------------- swapping

    def _claim_rows(self, cid: str, k: int) -> List[int]:
        nxt = self._next_row.get(cid)
        if nxt is None:
            nxt = max(
                self.lead.routing[cid].n_rows,
                self.lead.artifact.tables[cid].n_entities,
            )
        rows = list(range(nxt, nxt + k))
        self._next_row[cid] = nxt + k
        return rows

    def apply_delta(self, variant_id: str, delta) -> VariantSwapReport:
        """Swap one delta (a ``DeltaArtifact`` or delta directory path)
        into ONE variant. Chain-checked against the variant's own head;
        every touched entity lands in (or stays in) the variant's private
        overlay rows, so concurrent scoring of other variants is never
        paused beyond the shared tables' ordinary row-write locking and
        never sees the new content."""
        if not isinstance(delta, DeltaArtifact):
            delta = load_delta(str(delta))
        with self._lock:
            return self._apply_delta_locked(variant_id, delta)

    def _apply_delta_locked(
        self, variant_id: str, delta: DeltaArtifact
    ) -> VariantSwapReport:
        state = self.state(variant_id)
        if (
            state.fingerprint is not None
            and delta.base_fingerprint is not None
            and delta.base_fingerprint != state.fingerprint
        ):
            raise ValueError(
                f"delta generation {delta.generation} chains to base "
                f"{delta.base_fingerprint}, variant {variant_id!r} is at "
                f"{state.fingerprint} — missing intermediate delta or wrong "
                "chain"
            )
        current_artifact = (
            state.artifact if state.diverged else self.lead.artifact
        )
        current_fe = (
            state.fe_params if state.diverged else self.lead._fe_params
        )

        # plan every mutation (and its inverse) before touching the tables
        import dataclasses as dc

        new_tables = dict(current_artifact.tables)
        overlay_rows = {
            cid: dict(m) for cid, m in state.overlay_rows.items()
        }
        write_plan: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        inplace_undo: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        new_overlay_rows = 0
        for cid, (ids, rows) in delta.re_rows.items():
            table = new_tables.get(cid)
            if table is None or not table.is_random_effect:
                raise ValueError(
                    f"delta touches {cid!r} which is not a random effect "
                    "of the base artifact"
                )
            if rows.shape[1] != table.dim:
                raise ValueError(
                    f"delta rows for {cid!r} have dim {rows.shape[1]}, "
                    f"base table has dim {table.dim}"
                )
            overlay = overlay_rows.setdefault(cid, {})
            targets = np.empty(len(ids), dtype=np.int64)
            added: Dict[str, int] = {}
            fresh_ids = [e for e in ids if e not in overlay]
            fresh_rows = (
                self._claim_rows(cid, len(fresh_ids)) if fresh_ids else []
            )
            fresh_iter = iter(fresh_rows)
            rewrite_pos: List[int] = []
            for i, eid in enumerate(ids):
                row = overlay.get(eid)
                if row is None:
                    # copy-on-write: even a base-resident entity gets a
                    # fresh private row for this variant
                    row = next(fresh_iter)
                    added[eid] = row
                    overlay[eid] = row
                    new_overlay_rows += 1
                else:
                    rewrite_pos.append(i)
                targets[i] = row
            if rewrite_pos:
                rewrite_rows = targets[np.asarray(rewrite_pos)]
                inplace_undo[cid] = (
                    rewrite_rows,
                    self.lead._providers[cid].host_rows(rewrite_rows),
                )
            write_plan[cid] = (targets, np.asarray(rows, dtype=np.float32))
            if added:
                new_tables[cid] = dc.replace(
                    table,
                    entity_index=OverlayIndexMap(table.entity_index, added),
                )
        new_fe = dict(current_fe)
        for cid, w in delta.fe_updates.items():
            table = new_tables.get(cid)
            if table is None or table.is_random_effect:
                raise ValueError(
                    f"delta replaces {cid!r} which is not a fixed effect "
                    "of the base artifact"
                )
            w = np.asarray(w, dtype=np.float32)
            if w.shape != (table.dim,):
                raise ValueError(
                    f"delta fixed-effect vector for {cid!r} has shape "
                    f"{w.shape}, base table has dim {table.dim}"
                )
            with device_stream(self.lead.device):
                replace_fixed_effect(new_fe, cid, w)
            new_tables[cid] = dc.replace(table, weights=w)

        undo = _VariantUndo(state=state, inplace=inplace_undo)

        if (
            self.gate is not None
            and variant_id not in self._baselines
        ):
            self._baselines[variant_id] = self.gate.evaluate(
                self.scorer(variant_id)
            )

        # --------------- the variant's blackout: shared-table writes ----
        # blackout_s is request-path blocking time: sharded leads stage
        # into the spare generation half and return only the flip window
        # (see ShardedReTable.update_rows); a None return (single-table
        # lead) keeps wall-clock accounting.
        t0 = time.perf_counter()
        nonblocking_s = 0.0
        for cid, (targets, values) in write_plan.items():
            u0 = time.perf_counter()
            ret = self.lead.update_random_effect_rows(cid, targets, values)
            if isinstance(ret, float):
                nonblocking_s += max(0.0, (time.perf_counter() - u0) - ret)
            routing = getattr(self.lead, "routing", None)
            if routing is not None and cid in routing:
                # importance plane: a freshly claimed overlay row enters
                # with zero request frequency and would be the first
                # eviction victim despite being this variant's only copy —
                # seed the claim as one request so freq × norm ranks it
                # like any just-requested row (note_row_norms already ran
                # inside update_rows). No-op under the default policy.
                routing[cid].note_requests(targets)
        new_state = VariantState(
            variant_id=variant_id,
            generation=state.generation + 1,
            fingerprint=(
                delta.fingerprint
                if delta.fingerprint is not None
                else state.fingerprint
            ),
            artifact=dc.replace(current_artifact, tables=new_tables),
            fe_params=new_fe,
            overlay_rows=overlay_rows,
            swaps=state.swaps + 1,
            rollbacks=state.rollbacks,
        )
        self._states[variant_id] = new_state
        blackout_s = max(0.0, time.perf_counter() - t0 - nonblocking_s)
        # ----------------------------------------------------------------

        validation_metric: Optional[float] = None
        rolled_back = False
        baseline = self._baselines.get(variant_id)
        if self.gate is not None:
            validation_metric = self.gate.evaluate(self.scorer(variant_id))
            floor = baseline - self.gate.max_auc_regression
            if not validation_metric >= floor:  # NaN fails too
                _log.warning(
                    "variant %r validation gate failed: %.6f < floor %.6f "
                    "— rolling back this variant only",
                    variant_id, validation_metric, floor,
                )
                self._undo[variant_id] = undo
                self.rollback(variant_id)
                rolled_back = True
            else:
                self._baselines[variant_id] = validation_metric
        if not rolled_back:
            self._undo[variant_id] = undo
        final = self.state(variant_id)
        return VariantSwapReport(
            variant_id=variant_id,
            generation=final.generation,
            fingerprint=final.fingerprint,
            rows_updated=delta.num_rows_updated,
            new_overlay_rows=new_overlay_rows,
            blackout_s=blackout_s,
            rolled_back=rolled_back,
            validation_metric=validation_metric,
            baseline_metric=baseline,
        )

    def rollback(self, variant_id: str) -> VariantState:
        """Restore ONE variant's previous generation: its old state object
        plus the old bytes of any variant-private rows the last swap
        rewrote in place. Rows the swap newly allocated stay written but
        unreachable (no index references them), so no other variant — and
        no replica — needs any work. Returns the restored state."""
        with self._lock:
            undo = self._undo.pop(variant_id, None)
            if undo is None:
                raise ValueError(
                    f"variant {variant_id!r} has no generation to roll back"
                )
            for cid, (rows, old_values) in undo.inplace.items():
                self.lead.update_random_effect_rows(cid, rows, old_values)
            restored = dataclasses.replace(
                undo.state, rollbacks=undo.state.rollbacks + 1
            )
            self._states[variant_id] = restored
            return restored

    # ------------------------------------------------------------- watching

    def poll_directory(
        self, variant_id: str, watch_dir: str
    ) -> List[VariantSwapReport]:
        """Apply newly published deltas under ``watch_dir`` to ONE variant
        (name order = chain order; unreadable or unappliable deltas are
        skipped with the live generation kept, like the hot-swap watcher)."""
        processed = self._processed.setdefault(variant_id, set())
        reports: List[VariantSwapReport] = []
        for path in discover_deltas(watch_dir):
            if path in processed:
                continue
            try:
                delta = load_delta(path)
            except Exception as exc:
                self.delta_load_failures += 1
                _log.warning(
                    "variant %r: skipping unreadable delta %s: %s",
                    variant_id, path, exc,
                )
                continue
            if (
                delta.fingerprint is not None
                and delta.fingerprint == self.state(variant_id).fingerprint
            ):
                processed.add(path)
                continue
            try:
                reports.append(self.apply_delta(variant_id, delta))
            except Exception as exc:
                self.delta_load_failures += 1
                _log.warning(
                    "variant %r: delta %s failed to apply: %s",
                    variant_id, path, exc,
                )
                continue
            processed.add(path)
        return reports

    # ------------------------------------------------------------ reporting

    def stats(self) -> Dict[str, Dict[str, object]]:
        with self._lock:
            return {
                vid: {
                    "generation": s.generation,
                    "fingerprint": s.fingerprint,
                    "diverged": s.diverged,
                    "overlay_rows": s.overlay_row_count,
                    "swaps": s.swaps,
                    "rollbacks": s.rollbacks,
                }
                for vid, s in sorted(self._states.items())
            }

"""Zero-downtime hot-swap of a live scorer's tables from delta artifacts.

The scorer's coefficient tables are device tensors read by every batch
(scorer.py), so new table CONTENT never adds a score signature — the swap
cost is the table mutation itself. The manager turns a published delta
into the narrowest possible mutation of a live ``GameScorer``:

- fixed effects: same-shape vector replacement;
- full-table RE coordinates: in-place row scatter on device when the rows
  fit the table's padding headroom, a rebuild at the next power-of-two
  size bucket when they don't (the one case that adds a signature,
  reported in ``SwapReport.regrew``);
- cache-backed RE coordinates: O(1) backing-store rebind + invalidation of
  only the touched rows — everything else stays warm on device.

The mutation runs in one critical section; its *blackout* is the
request-path BLOCKING time, not the section's wall clock — a sharded
scorer stages row content into the spare generation half of its
double-buffered device tables off the request path and blocks scoring only
for the atomic generation flip (microseconds), and installs a new FE vector
or artifact reference under its ``write_lock`` after building it off the
request path (the hooks return their blocking seconds), while the single-table
scorer's live-table mutation keeps wall-clock accounting. A generation
counter tracks the live version. An optional validation gate replays a
held-out slice through the swapped scorer and rolls back to the previous
generation when AUC regresses past a threshold — the inverse mutation is
applied from an undo snapshot of exactly the touched rows (on a sharded
scorer: the same stage-and-flip-back), so rollback is as cheap as the swap.

Port of ``photon_ml_tpu/serving/hotswap.py``. On a sharded scorer every
mutation lands under its ``write_lock``, which a batch holds from its
routing to the issue of its gathers: a swap never lands between a row's
routing and its gather.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from photon_ml_tpu_torch.resilience.failures import record_failure
from photon_ml_tpu_torch.resilience.faultpoints import fault_point, register_fault_site
from photon_ml_tpu_torch.resilience.retry import DEFAULT_IO_RETRY, RetryPolicy
from photon_ml_tpu_torch.serving.artifact import ServingArtifact
from photon_ml_tpu_torch.serving.cache import HotEntityCache
from photon_ml_tpu_torch.serving.metrics import ServingMetrics
from photon_ml_tpu_torch.serving.scorer import GameScorer, ScoreRequest
from photon_ml_tpu_torch.telemetry import span

_log = logging.getLogger("photon_ml_tpu_torch.serving.hotswap")

FAULT_DELTA_LOAD = register_fault_site(
    "serve.delta.load",
    "loading one published delta artifact inside the watch loop",
)

# Delta loads race the publisher: a partially-written or corrupt artifact
# must not kill the watcher OR advance the processed set — the old
# generation keeps serving and the same path is retried on the next poll
# (by then the atomic publish has usually completed).
_DELTA_RETRY = RetryPolicy(
    max_attempts=DEFAULT_IO_RETRY.max_attempts,
    base_delay_s=0.01,
    retryable=(OSError, ValueError, KeyError, EOFError),
)


@dataclasses.dataclass
class ValidationGate:
    """Held-out replay slice scored through the swapped scorer: the swap
    only sticks when AUC does not regress more than ``max_auc_regression``
    below the previous generation's AUC on the same slice.

    The baseline is (re)measured through the LIVE scorer right before the
    first swap and after every accepted one, so the comparison is always
    generation-to-generation on identical requests. Score the slice once
    through the scorer at startup (or reuse a serving bucket size) to keep
    the gate itself from adding a score signature during a swap. AUC is the
    port's evaluator, in float64 on the host."""

    requests: Sequence[ScoreRequest]
    labels: np.ndarray
    max_auc_regression: float = 0.01
    bucket_size: Optional[int] = None

    def evaluate(self, scorer: GameScorer) -> float:
        from photon_ml_tpu_torch.evaluation.evaluators import AUC

        bucket = self.bucket_size or len(self.requests)
        results = []
        for i in range(0, len(self.requests), bucket):
            results.extend(scorer.score_batch(
                self.requests[i:i + bucket], bucket_size=bucket
            ))
        scores = np.asarray([r.score for r in results], dtype=np.float32)
        labels = np.asarray(self.labels, dtype=np.float32)
        return AUC.evaluate(scores, labels, np.ones_like(labels))


@dataclasses.dataclass
class SwapReport:
    generation: int
    fingerprint: Optional[str]
    coordinates: Tuple[str, ...]
    rows_updated: int
    blackout_s: float
    staleness_s: Optional[float]
    rolled_back: bool
    validation_metric: Optional[float]
    baseline_metric: Optional[float]
    regrew: Tuple[str, ...]  # full tables rebuilt at a larger size bucket
    compiles_added: int


@dataclasses.dataclass
class _Undo:
    """Inverse of one swap: enough to restore the previous generation."""

    artifact: ServingArtifact
    fingerprint: Optional[str]
    fe: Dict[str, np.ndarray]
    re_inplace: Dict[str, Tuple[np.ndarray, np.ndarray]]  # cid -> (rows, old)
    # cid -> (previous provider, the routing coordinate it was built
    # against, or None for non-sharded providers). A regrowing rebind
    # replaces the shared routing coordinate too, so rollback must restore
    # the (provider, routing) pair together — a provider gathered through a
    # mismatched layout serves other rows' bytes.
    re_rebuilt: Dict[str, Tuple[object, Optional[object]]]
    cache_rebinds: Dict[str, Tuple[object, np.ndarray]]  # cid -> (old backing, rows)


class HotSwapManager:
    """Applies delta artifacts to a live :class:`GameScorer`.

    ``fingerprint`` roots the hash chain — pass the base artifact
    directory's content fingerprint (``incremental.fingerprint_dir``) when
    serving from disk; ``None`` disables chain verification (in-memory
    artifacts have no content identity). One level of undo is kept: a
    failed validation gate (or an explicit ``rollback()``) restores the
    previous generation."""

    def __init__(
        self,
        scorer: GameScorer,
        fingerprint: Optional[str] = None,
        gate: Optional[ValidationGate] = None,
        metrics: Optional[ServingMetrics] = None,
        emitter=None,
        model_id: Optional[str] = None,
        clock=time.time,
    ):
        self._scorer = scorer
        self.fingerprint = fingerprint
        self.gate = gate
        self.generation = 0
        self._metrics = metrics
        self._emitter = emitter
        self._model_id = model_id or scorer.artifact.model_name
        self._clock = clock
        self._baseline_metric: Optional[float] = None
        self._undo: Optional[_Undo] = None
        self._processed_dirs: set = set()
        self.delta_load_failures = 0

    # ------------------------------------------------------------- swapping

    def apply_delta(self, delta) -> SwapReport:
        """Swap one delta (a ``DeltaArtifact`` or a delta directory path)
        into the live scorer. Raises on a broken fingerprint chain; returns
        a report (``rolled_back=True`` when the validation gate rejected
        the candidate and the previous generation was restored)."""
        with span(
            "serve/hotswap_apply", model_id=self._model_id, generation=self.generation
        ):
            return self._apply_delta_impl(delta)

    def _apply_delta_impl(self, delta) -> SwapReport:
        from photon_ml_tpu_torch.incremental.delta import (
            DeltaArtifact,
            apply_delta as fold_delta,
            load_delta,
        )

        if not isinstance(delta, DeltaArtifact):
            delta = load_delta(str(delta))
        if (
            self.fingerprint is not None
            and delta.base_fingerprint is not None
            and delta.base_fingerprint != self.fingerprint
        ):
            raise ValueError(
                f"delta generation {delta.generation} chains to base "
                f"{delta.base_fingerprint}, live scorer is at "
                f"{self.fingerprint} — missing intermediate delta or wrong "
                "base artifact"
            )

        old_artifact = self._scorer.artifact
        candidate = fold_delta(old_artifact, delta)

        # establish the gate baseline through the LIVE scorer before any
        # mutation (also notes the gate's bucket signature, so post-swap
        # evaluation adds none)
        if self.gate is not None and self._baseline_metric is None:
            self._baseline_metric = self.gate.evaluate(self._scorer)

        # plan every mutation (and its inverse) outside the critical section
        fe_plan: Dict[str, np.ndarray] = dict(delta.fe_updates)
        undo = _Undo(
            artifact=old_artifact,
            fingerprint=self.fingerprint,
            fe={
                cid: np.array(old_artifact.tables[cid].weights, dtype=np.float32)
                for cid in fe_plan
            },
            re_inplace={},
            re_rebuilt={},
            cache_rebinds={},
        )
        inplace_plan: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        rebind_plan: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        cache_plan: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        for cid, (ids, _) in delta.re_rows.items():
            if not ids:
                continue
            new_table = candidate.tables[cid]
            old_table = old_artifact.tables[cid]
            targets = np.asarray(
                new_table.entity_index.get_indices(ids), dtype=np.int64
            )
            values = np.asarray(new_table.weights, dtype=np.float32)[targets]
            provider = self._scorer._providers[cid]
            if isinstance(provider, HotEntityCache):
                cache_plan[cid] = (np.asarray(new_table.weights), targets)
                undo.cache_rebinds[cid] = (old_table.weights, targets)
                continue
            fits = getattr(provider, "fits", None)
            if (
                fits(targets)
                if fits is not None
                else targets.max() < provider.capacity
            ):
                inplace_plan[cid] = (targets, values)
                n_old = old_table.n_entities
                old_rows = np.zeros_like(values)
                in_base = targets < n_old
                if in_base.any():
                    old_rows[in_base] = np.asarray(
                        old_table.weights, dtype=np.float32
                    )[targets[in_base]]
                undo.re_inplace[cid] = (targets, old_rows)
            else:
                rebind_plan[cid] = (np.asarray(new_table.weights), targets)
                undo.re_rebuilt[cid] = (
                    provider,
                    getattr(provider, "routing", None),
                )

        # ------------------------- critical section: the blackout -------
        # blackout_s is the REQUEST-PATH blocking time, not the wall clock
        # of the section: a sharded scorer's row updates stage into the
        # spare generation half off the request path and return only the
        # generation-flip window (see ShardedReTable.update_rows), so that
        # staging work is subtracted from the wall clock. Hooks returning
        # None (the artifact and FE installs, the single-table GameScorer's
        # live-table writes) keep the historical wall-clock accounting.
        compiles_before = self._scorer.compile_count
        t0 = time.perf_counter()
        nonblocking_s = 0.0
        regrew: List[str] = []
        self._scorer.set_artifact(candidate)
        for cid, w in fe_plan.items():
            self._scorer.update_fixed_effect(cid, w)
        for cid, (rows, values) in inplace_plan.items():
            u0 = time.perf_counter()
            ret = self._scorer.update_random_effect_rows(cid, rows, values)
            if isinstance(ret, float):
                nonblocking_s += max(
                    0.0, (time.perf_counter() - u0) - ret
                )
        for cid, (backing, _) in rebind_plan.items():
            if self._scorer.rebind_random_effect(cid, backing):
                regrew.append(cid)
        for cid, (backing, rows) in cache_plan.items():
            cache = self._scorer.caches[cid]
            cache.rebind(backing)
            cache.invalidate(rows)
        blackout_s = max(0.0, time.perf_counter() - t0 - nonblocking_s)
        # ----------------------------------------------------------------

        self.generation += 1
        candidate_fp = delta.fingerprint
        now = self._clock()
        staleness_s = (
            max(0.0, now - delta.created_at_unix)
            if delta.created_at_unix
            else None
        )

        validation_metric: Optional[float] = None
        rolled_back = False
        if self.gate is not None:
            validation_metric = self.gate.evaluate(self._scorer)
            floor = self._baseline_metric - self.gate.max_auc_regression
            if not validation_metric >= floor:  # NaN fails the gate too
                _log.warning(
                    "validation gate failed: AUC %.6f < floor %.6f "
                    "(baseline %.6f - threshold %g) — rolling back to "
                    "generation %d",
                    validation_metric, floor, self._baseline_metric,
                    self.gate.max_auc_regression, self.generation - 1,
                )
                self._undo = undo
                self.rollback()
                rolled_back = True
            else:
                self._baseline_metric = validation_metric
        compiles_added = self._scorer.compile_count - compiles_before

        if not rolled_back:
            self.fingerprint = candidate_fp
            self._undo = undo
        report = SwapReport(
            generation=self.generation,
            fingerprint=self.fingerprint,
            coordinates=delta.coordinates(),
            rows_updated=delta.num_rows_updated,
            blackout_s=blackout_s,
            staleness_s=staleness_s,
            rolled_back=rolled_back,
            validation_metric=validation_metric,
            baseline_metric=self._baseline_metric,
            regrew=tuple(regrew),
            compiles_added=compiles_added,
        )
        if self._metrics is not None:
            self._metrics.observe_swap(
                generation=self.generation,
                rows_updated=report.rows_updated,
                blackout_s=blackout_s,
                staleness_s=staleness_s,
                rolled_back=rolled_back,
            )
        if self._emitter is not None:
            from photon_ml_tpu_torch.event import ModelSwapEvent

            self._emitter.send_event(
                ModelSwapEvent(
                    model_id=self._model_id,
                    generation=self.generation,
                    fingerprint=self.fingerprint,
                    coordinates=report.coordinates,
                    rows_updated=report.rows_updated,
                    blackout_s=blackout_s,
                    rolled_back=rolled_back,
                    validation_metric=validation_metric,
                )
            )
        return report

    def rollback(self) -> None:
        """Restore the previous generation from the undo snapshot (applies
        the inverse mutation: old artifact reference, old FE vectors, old
        rows scattered back, old providers for regrown tables, old cache
        backings with the touched rows re-invalidated)."""
        undo = self._undo
        if undo is None:
            raise ValueError("no previous generation to roll back to")
        self._scorer.set_artifact(undo.artifact)
        for cid, w in undo.fe.items():
            self._scorer.update_fixed_effect(cid, w)
        for cid, (rows, old_rows) in undo.re_inplace.items():
            self._scorer.update_random_effect_rows(cid, rows, old_rows)
        for cid, (provider, routing) in undo.re_rebuilt.items():
            restore = getattr(self._scorer, "restore_random_effect", None)
            if restore is not None:
                restore(cid, provider, routing)
            else:
                self._scorer._providers[cid] = provider
        for cid, (backing, rows) in undo.cache_rebinds.items():
            cache = self._scorer.caches[cid]
            cache.rebind(np.asarray(backing))
            cache.invalidate(rows)
        self.generation -= 1
        self.fingerprint = undo.fingerprint
        self._undo = None

    # ------------------------------------------------------------ watching

    def poll_directory_deltas(self, watch_dir: str):
        """Yield (path, delta) for unprocessed deltas without applying —
        used by :class:`CoordinatedHotSwap` to fan one delta out to every
        replica before marking it processed."""
        from photon_ml_tpu_torch.incremental.delta import discover_deltas, load_delta

        for path in discover_deltas(watch_dir):
            if path in self._processed_dirs:
                continue

            def _load(p=path):
                fault_point(FAULT_DELTA_LOAD)
                return load_delta(p)

            try:
                delta = _DELTA_RETRY.run("serve.delta.load", _load)
            except Exception as exc:
                # partial write or corruption: keep the live generation,
                # leave the path unprocessed so the next poll retries it
                # once the publisher finishes, and move on to any later
                # delta that IS complete.
                self.delta_load_failures += 1
                record_failure(
                    "delta_load_failed",
                    "serve.delta.load",
                    f"{type(exc).__name__}: {exc}",
                    path=str(path),
                )
                _log.warning(
                    "skipping unreadable delta %s (kept generation %d): %s",
                    path, self.generation, exc,
                )
                continue
            if (
                delta.fingerprint is not None
                and delta.fingerprint == self.fingerprint
            ):
                self._processed_dirs.add(path)
                continue
            yield path, delta

    def poll_directory(self, watch_dir: str) -> List[SwapReport]:
        """Apply any newly published deltas under ``watch_dir`` (``delta-*``
        directories, name order = chain order). Already-processed
        directories are skipped; a delta whose own fingerprint equals the
        live one is recognized as already applied. Safe to call from the
        serving loop between batches."""
        reports: List[SwapReport] = []
        for path, delta in self.poll_directory_deltas(watch_dir):
            try:
                reports.append(self.apply_delta(delta))
            except Exception as exc:
                # a delta that loads but won't apply (broken chain after a
                # skipped predecessor, corrupt content past the header)
                # must not kill the watch loop; the live generation stands.
                self.delta_load_failures += 1
                record_failure(
                    "delta_apply_failed",
                    "serve.delta.load",
                    f"{type(exc).__name__}: {exc}",
                    path=str(path),
                )
                _log.warning(
                    "delta %s failed to apply (kept generation %d): %s",
                    path, self.generation, exc,
                )
                continue
            self._processed_dirs.add(path)
        return reports


class CoordinatedHotSwap:
    """One hot-swap control plane over N scorer replicas (multi-scorer
    mode): a delta is applied to EVERY replica's :class:`HotSwapManager`
    before it counts as processed, so all devices serve the same
    generation. Replicas sharing a routing index coordinate implicitly —
    the first replica's swap allocates/publishes any new rows, later
    replicas find them resident and only rewrite the bytes on their own
    device tables.

    A replica that rolls back (validation gate) aborts the fan-out and
    rolls back the replicas already swapped, so the group never splits
    across generations."""

    def __init__(self, managers: Sequence[HotSwapManager]):
        managers = list(managers)
        if not managers:
            raise ValueError("need at least one HotSwapManager")
        self._managers = managers

    @property
    def managers(self) -> List[HotSwapManager]:
        return list(self._managers)

    @property
    def generation(self) -> int:
        return self._managers[0].generation

    def apply_delta(self, delta) -> List[SwapReport]:
        """Apply one delta to every replica. Returns one report per replica
        actually swapped (all of them, or the prefix up to and including a
        rolled-back one — whose predecessors are rolled back again here)."""
        reports: List[SwapReport] = []
        for i, mgr in enumerate(self._managers):
            report = mgr.apply_delta(delta)
            reports.append(report)
            if report.rolled_back:
                for prev in self._managers[:i]:
                    prev.rollback()
                break
        return reports

    def poll_directory(self, watch_dir: str) -> List[SwapReport]:
        """Fan newly published deltas out to every replica (lead replica
        discovers; a delta is marked processed on all replicas only after
        the full fan-out)."""
        lead = self._managers[0]
        reports: List[SwapReport] = []
        for path, delta in list(lead.poll_directory_deltas(watch_dir)):
            group = self.apply_delta(delta)
            reports.extend(group)
            if not any(r.rolled_back for r in group):
                for mgr in self._managers:
                    mgr._processed_dirs.add(path)
        return reports

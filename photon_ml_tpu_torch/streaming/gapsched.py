"""Gap-guided block scheduling for stochastic streaming (DuHL).

Port of ``photon_ml_tpu/streaming/gapsched.py`` (numpy only, copied): for
the same gaps and seed its decisions equal the JAX package's.

"Large-Scale Stochastic Learning using GPUs" (arXiv 1702.07005) keeps on
the accelerator only the working set with the largest duality-gap
contribution, swapping blocks in by importance instead of round-robin.
The signal: ``BlockStatsProbe`` computes the per-block
first-order gap surrogate ``f_k + <w, g_k>`` on every progress-enabled
streamed solve. This module is the consumer — a scheduler that turns those
per-block scores into the visit order of the stochastic streaming mode.

The scheduler is deliberately simple and fully host-side (numpy only; it
adds no device program):

* each block carries a **gap score** — the magnitude of its most recent
  gap estimate. Unvisited blocks hold an ``+inf`` sentinel so the first
  epoch (and any epoch where new blocks appear) is a full bootstrap pass;
* scores **decay exponentially with staleness**: a block last visited
  ``a`` epochs ago competes with ``score · decay^a``, so a once-important
  block cannot monopolize the schedule on stale evidence;
* an **ε-greedy exploration floor** always re-visits the stalest blocks
  regardless of score, so every block's estimate is refreshed within
  ``~1/explore`` epochs even if its last measured gap was tiny;
* the selected set is ordered by **part file** (``group_by_part_file``),
  not raw priority: same-file blocks stay adjacent so the decode LRU in
  ``streaming/blocks.py`` decodes each part file at most once per epoch —
  importance ordering must not thrash the file cache it is trying to
  out-run.

The solver feeds measured gaps back via :meth:`update` at each epoch end;
``epoch_order`` emits the next visit order. Decisions are recorded per
epoch (and exported as ``stream.gap_sched.*`` gauges) so the progress
ledger and the ``--auto-tune`` judge can see what the scheduler did.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from photon_ml_tpu_torch.streaming.blocks import BlockPlan, group_by_part_file
from photon_ml_tpu_torch.telemetry import get_registry


class GapScheduler:
    """Per-block gap-score bookkeeping + epoch visit-order emission.

    Parameters
    ----------
    num_blocks:
        Blocks in the streamed plan (fixed for the scheduler's lifetime).
    plan:
        Optional :class:`BlockPlan` for part-file-aware ordering of the
        selected set. Without a plan the selected blocks are visited in
        plain priority order.
    decay:
        Per-epoch staleness discount applied to a block's last measured
        score (``score · decay^age``). Smaller decays forget faster.
    explore:
        Exploration floor: every epoch at least
        ``max(1, round(explore · num_blocks))`` of the *stalest* blocks
        are visited regardless of score.
    visit_fraction:
        Share of blocks visited per scheduled epoch (the working set).
        The actual visit count is ``max(1, ceil(fraction · num_blocks))``
        plus any exploration picks not already selected.
    """

    def __init__(
        self,
        num_blocks: int,
        plan: Optional[BlockPlan] = None,
        decay: float = 0.6,
        explore: float = 0.1,
        visit_fraction: float = 0.5,
        seed: int = 0,
    ) -> None:
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        if not 0.0 <= explore <= 1.0:
            raise ValueError(f"explore must be in [0, 1], got {explore}")
        if not 0.0 < visit_fraction <= 1.0:
            raise ValueError(
                f"visit_fraction must be in (0, 1], got {visit_fraction}"
            )
        self.num_blocks = int(num_blocks)
        self.plan = plan
        self.decay = float(decay)
        self.explore = float(explore)
        self.visit_fraction = float(visit_fraction)
        # +inf sentinel = never measured: such a block outranks every
        # measured one, so bootstrap epochs visit everything first
        self.scores = np.full(self.num_blocks, np.inf, dtype=np.float64)
        self.age = np.zeros(self.num_blocks, dtype=np.int64)
        # failure plane: blocks that permanently failed to build under
        # on_block_error=skip — never scheduled again this run
        self.excluded = np.zeros(self.num_blocks, dtype=bool)
        self.epoch = 0
        self.decisions: List[dict] = []
        self._rng = np.random.default_rng(seed)
        # HBM residency plane (streaming/residency.py): when attached, the
        # scheduler's epoch-end gap feedback doubles as the residency
        # plane's repin signal, and permanently failed blocks are evicted
        # from the resident set the moment they are excluded here
        self._residency = None

    def attach_residency(self, manager) -> None:
        """Couple a :class:`~photon_ml_tpu_torch.streaming.residency.ResidencyManager`
        to this scheduler's gap feedback: ``update`` forwards measurements
        and triggers the between-epoch repin; ``mark_failed`` evicts."""
        self._residency = manager

    # -- scheduling -------------------------------------------------------

    def effective_scores(self) -> np.ndarray:
        """Staleness-discounted scores (``+inf`` where never measured)."""
        eff = self.scores * np.power(self.decay, self.age)
        eff[~np.isfinite(self.scores)] = np.inf
        return eff

    def epoch_order(self) -> np.ndarray:
        """The next epoch's visit order (int64 block indices).

        Unmeasured blocks always rank first (bootstrap); afterwards the
        top-``visit_fraction`` by effective score are selected, plus the
        exploration picks — the stalest blocks not already selected.
        """
        eff = self.effective_scores()
        # excluded (permanently failed) blocks sink below every candidate
        # and never re-enter the schedule — not even as exploration picks
        available = int(self.num_blocks - np.sum(self.excluded))
        if available == 0:
            raise RuntimeError(
                "gap scheduler: every block is excluded (permanent"
                " failures) — nothing left to schedule"
            )
        eff[self.excluded] = -np.inf
        n_visit = max(1, math.ceil(self.visit_fraction * self.num_blocks))
        n_visit = max(
            n_visit,
            int(np.sum(~np.isfinite(self.scores) & ~self.excluded)),
        )
        n_visit = min(n_visit, available)
        # stable argsort on (-eff) keeps index order among exact ties —
        # deterministic schedules for a deterministic gap history
        ranked = np.argsort(-eff, kind="stable")
        selected = ranked[:n_visit]
        chosen = np.zeros(self.num_blocks, dtype=bool)
        chosen[selected] = True

        n_explore = max(1, int(round(self.explore * self.num_blocks)))
        rest = np.nonzero(~chosen & ~self.excluded)[0]
        explored = np.zeros(0, dtype=np.int64)
        if rest.size:
            # stalest first; ties broken uniformly so exploration does not
            # systematically favor low block indices
            tie = self._rng.random(rest.size)
            stale_rank = np.lexsort((tie, -self.age[rest]))
            explored = rest[stale_rank[: min(n_explore, rest.size)]]
            chosen[explored] = True

        priority = np.concatenate([selected, explored]).astype(np.int64)
        if self.plan is not None:
            order = np.asarray(
                group_by_part_file(priority, self.plan), dtype=np.int64
            )
        else:
            order = priority

        finite = self.scores[np.isfinite(self.scores)]
        decision = {
            "epoch": int(self.epoch),
            "visited": int(order.size),
            "explored": int(explored.size),
            "num_blocks": int(self.num_blocks),
            "unvisited": int(np.sum(~np.isfinite(self.scores) & ~self.excluded)),
            "excluded": int(np.sum(self.excluded)),
            "score_max": float(finite.max()) if finite.size else 0.0,
            "score_mean": float(finite.mean()) if finite.size else 0.0,
        }
        self.decisions.append(decision)
        reg = get_registry()
        reg.gauge("stream.gap_sched.visited_blocks", float(order.size))
        reg.gauge("stream.gap_sched.explored_blocks", float(explored.size))
        reg.gauge(
            "stream.gap_sched.visit_fraction",
            float(order.size) / float(self.num_blocks),
        )
        reg.gauge("stream.gap_sched.unvisited", decision["unvisited"])
        reg.gauge("stream.gap_sched.score_max", decision["score_max"])
        reg.gauge("stream.gap_sched.score_mean", decision["score_mean"])
        self.epoch += 1
        return order

    # -- feedback ---------------------------------------------------------

    def update(self, gaps: Dict[int, float]) -> None:
        """Fold measured per-block gap estimates back in (epoch end).

        Every block ages one epoch; the visited blocks' scores are reset
        to the new measurement (magnitude — the first-order surrogate can
        go slightly negative near the optimum) with age 0.
        """
        self.age += 1
        for block, gap in gaps.items():
            b = int(block)
            if not 0 <= b < self.num_blocks:
                raise IndexError(
                    f"gap update for block {b} outside [0, {self.num_blocks})"
                )
            self.scores[b] = abs(float(gap))
            self.age[b] = 0
        if self._residency is not None and gaps:
            # same signal, second consumer: the epoch boundary is the only
            # legal repin point (never mid-pass)
            self._residency.update_gaps(gaps)
            self._residency.repin()

    def mark_failed(self, blocks) -> None:
        """Exclude permanently failed blocks (on_block_error=skip) from
        all future schedules. Idempotent; feedback for an excluded block
        is simply never measured again."""
        for b in blocks:
            bi = int(b)
            if 0 <= bi < self.num_blocks:
                self.excluded[bi] = True
        if self._residency is not None:
            # a block that cannot build must not stay pinned in HBM
            self._residency.mark_failed(blocks)

    def drain_decisions(self) -> List[dict]:
        """Per-epoch decision records accumulated since the last drain
        (consumed by the coordinate into the progress ledger)."""
        out = self.decisions
        self.decisions = []
        return out

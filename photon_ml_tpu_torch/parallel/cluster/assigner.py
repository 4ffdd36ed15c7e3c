"""Gap-balanced cross-host block assignment.

Port of ``photon_ml_tpu/parallel/cluster/assigner.py``, the same code (host
numpy), so both packages make the same decisions. The gap scheduler
(``streaming/gapsched.py``) orders one host's visits by staleness-decayed
duality-gap importance; this is the same ledger across hosts: every
full-batch pass visits every block exactly once, so the only freedom is
which host streams which blocks. The assigner partitions blocks so each
host's share of the total gap mass stays balanced, by the LPT greedy (sort
by score, give each block to the lightest host; with uniform scores this
is a round-robin of balanced counts).

A block's score decays by ``decay**age``, ``age`` counting passes since its
gap was last measured. The distributed pass is synchronous (the
coordinator's sum is the epoch barrier), so gradients are never stale; the
assignment signal is at most one pass old and used for load balance only.

Host failure: ``mark_host_failed`` removes the host from the rotation and
``reassign`` splits its in-flight blocks over the survivors; blocks are
never excluded for a host's death (another host can stream them).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np


class BlockAssigner:
    """Partition ``num_blocks`` streamed blocks across hosts, rebalanced
    per pass from the shared gap ledger."""

    def __init__(
        self,
        num_blocks: int,
        hosts: Sequence[int],
        decay: float = 0.6,
    ):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        if not list(hosts):
            raise ValueError("need at least one host")
        if not (0.0 < decay <= 1.0):
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        self.num_blocks = int(num_blocks)
        self.live_hosts: List[int] = sorted(int(h) for h in hosts)
        self.failed_hosts: List[int] = []
        self.decay = float(decay)
        # uniform bootstrap: before any gap is measured LPT reduces to
        # balanced block counts, which is the right prior for equal-cost
        # blocks
        self.scores = np.ones(self.num_blocks, dtype=np.float64)
        self.age = np.zeros(self.num_blocks, dtype=np.int64)
        self.excluded = np.zeros(self.num_blocks, dtype=bool)
        self._decisions: List[dict] = []
        self._last_assignment: Optional[Dict[int, List[int]]] = None

    # -- ledger ------------------------------------------------------------

    def effective_scores(self) -> np.ndarray:
        return self.scores * np.power(self.decay, self.age)

    def update(self, gaps: Dict[int, float]) -> None:
        """Fold one pass's measured per-block gaps into the ledger."""
        self.age += 1
        for block, gap in gaps.items():
            b = int(block)
            if 0 <= b < self.num_blocks:
                self.scores[b] = abs(float(gap))
                self.age[b] = 0

    def mark_blocks_failed(self, blocks: Iterable[int]) -> None:
        """Permanently failed blocks (bad bytes on every host) leave the
        rotation entirely — mirrors GapScheduler.mark_failed."""
        for b in blocks:
            if 0 <= int(b) < self.num_blocks:
                self.excluded[int(b)] = True

    # -- partition ---------------------------------------------------------

    def _lpt(
        self, blocks: np.ndarray, hosts: Sequence[int]
    ) -> Dict[int, List[int]]:
        """Longest-processing-time greedy over effective gap scores:
        deterministic (stable sort, host order fixed), near-balanced in
        both score mass and count."""
        eff = self.effective_scores()
        order = blocks[np.argsort(-eff[blocks], kind="stable")]
        load = {h: 0.0 for h in hosts}
        count = {h: 0 for h in hosts}
        out: Dict[int, List[int]] = {h: [] for h in hosts}
        for b in order:
            # lightest score load first; ties (uniform bootstrap) break by
            # count then host id, so the bootstrap is a clean round-robin
            h = min(hosts, key=lambda x: (load[x], count[x], x))
            out[h].append(int(b))
            load[h] += float(eff[b])
            count[h] += 1
        # blocks stream in index order per host: consecutive blocks share
        # part files, so the worker's decode LRU actually gets hits
        for h in out:
            out[h].sort()
        return out

    def predicted_shares(
        self, assignment: Dict[int, List[int]]
    ) -> Dict[int, float]:
        """Each host's share of the total effective gap mass its slice
        carries — the LPT objective, i.e. the assigner's implicit
        prediction of relative per-host work. The coordinator's skew
        profile compares this against measured per-host busy time
        (assignment-quality feedback: a future skew-aware assigner
        actuates on the gap between the two)."""
        eff = self.effective_scores()
        assigned = [b for blks in assignment.values() for b in blks]
        total = max(float(eff[assigned].sum()), 1e-30) if assigned else 1e-30
        return {
            int(h): float(eff[blks].sum()) / total if blks else 0.0
            for h, blks in assignment.items()
        }

    def assign(self) -> Dict[int, List[int]]:
        """The per-pass partition of every non-excluded block over the
        live hosts."""
        if not self.live_hosts:
            raise RuntimeError("no live hosts left to assign blocks to")
        blocks = np.flatnonzero(~self.excluded)
        assignment = self._lpt(blocks, self.live_hosts)
        if assignment != self._last_assignment:
            # a line-searching solve runs many passes per iteration; only
            # partition CHANGES are ledger-worthy
            self._last_assignment = assignment
            shares = self.predicted_shares(assignment)
            self._decisions.append({
                "event": "rebalance",
                "hosts": {
                    str(h): len(blks) for h, blks in assignment.items()
                },
                "score_share": {
                    str(h): round(shares[h], 4) for h in assignment
                },
            })
        return assignment

    # -- failure -----------------------------------------------------------

    def mark_host_failed(self, host: int) -> None:
        host = int(host)
        if host in self.live_hosts:
            self.live_hosts.remove(host)
            self.failed_hosts.append(host)
        self._decisions.append({"event": "host_failed", "host": host})

    def reassign(self, blocks: Sequence[int]) -> Dict[int, List[int]]:
        """Split a dead host's unfinished blocks over the survivors."""
        if not self.live_hosts:
            raise RuntimeError(
                "every host failed; nothing left to reassign to"
            )
        targets = self._lpt(
            np.asarray(sorted(int(b) for b in blocks), dtype=np.int64),
            self.live_hosts,
        )
        targets = {h: blks for h, blks in targets.items() if blks}
        self._decisions.append({
            "event": "reassign",
            "blocks": sorted(int(b) for b in blocks),
            "targets": {str(h): blks for h, blks in targets.items()},
        })
        return targets

    def drain_decisions(self) -> List[dict]:
        out, self._decisions = self._decisions, []
        return out

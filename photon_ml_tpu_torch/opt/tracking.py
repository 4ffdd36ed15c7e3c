"""Host-side optimization telemetry: per-solve and per-coordinate trackers.

Port of ``photon_ml_tpu/opt/tracking.py`` (reference
OptimizationStatesTracker.scala:31, FixedEffectOptimizationTracker.scala,
RandomEffectOptimizationTracker.scala): the host view of the device-side
``SolveResult`` history, as loggable summaries. One process holds every
lane, so results come to the host with ``.cpu()``. ``TransferStats`` is
the reference's score-plane accounting; the port has the device plane only,
so its row-transfer counts stay 0 unless a caller moves a row-length score
array across.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from photon_ml_tpu_torch.opt.state import SolveResult
from photon_ml_tpu_torch.types import ConvergenceReason


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


@dataclasses.dataclass(frozen=True)
class OptimizationStatesTracker:
    """History of one optimizer run (OptimizationStatesTracker.scala:31)."""

    values: np.ndarray  # [iterations+1] objective per iteration (trimmed)
    iterations: int
    convergence_reason: ConvergenceReason
    elapsed_seconds: Optional[float] = None
    grad_norm: Optional[float] = None  # at the final iterate

    @classmethod
    def from_result(
        cls, result: SolveResult, elapsed_seconds: Optional[float] = None
    ) -> "OptimizationStatesTracker":
        """From a one-lane result (a fixed effect's solve)."""
        if result.w.shape[0] != 1:
            raise ValueError(f"one solve's tracker takes a one-lane result, got {result.w.shape[0]}")
        iters = int(result.iterations[0])
        return cls(
            values=_host(result.value_history[0])[: iters + 1],
            iterations=iters,
            convergence_reason=ConvergenceReason(int(result.reason[0])),
            elapsed_seconds=elapsed_seconds,
            grad_norm=float(result.grad_norm[0]),
        )

    @property
    def converged(self) -> bool:
        return self.convergence_reason is not ConvergenceReason.NOT_CONVERGED

    def to_summary_string(self) -> str:
        head = f"{self.iterations} iterations, reason={self.convergence_reason.name}"
        if self.values.size:
            head += f", f0={self.values[0]:.6g}, f*={self.values[-1]:.6g}"
        if self.elapsed_seconds is not None:
            head += f", {self.elapsed_seconds:.3f}s"
        return head


@dataclasses.dataclass(frozen=True)
class FixedEffectOptimizationTracker:
    """One tracker per fixed-effect update (FixedEffectOptimizationTracker.scala)."""

    states: OptimizationStatesTracker

    def to_summary_string(self) -> str:
        return f"fixed-effect solve: {self.states.to_summary_string()}"


@dataclasses.dataclass(frozen=True)
class RandomEffectOptimizationTracker:
    """Convergence telemetry over per-entity solves
    (RandomEffectOptimizationTracker.scala): reason counts, iteration and
    final-objective distributions over the real entities."""

    num_entities: int
    reason_counts: Dict[ConvergenceReason, int]
    iteration_stats: Dict[str, float]  # min/max/mean/p50/p90
    value_stats: Dict[str, float]

    @classmethod
    def from_results(
        cls, results: List[SolveResult], real_counts: Optional[List[int]] = None
    ) -> "RandomEffectOptimizationTracker":
        """``results``: one batched SolveResult a bucket; ``real_counts``
        (per bucket) leaves padding lanes out, None = every lane."""
        if real_counts is None:
            real_counts = [res.reason.shape[0] for res in results]
        pairs = list(zip(results, real_counts))
        reason_all = np.concatenate([_host(r.reason)[:k] for r, k in pairs] or [np.zeros(0, np.int64)])
        iter_all = np.concatenate([_host(r.iterations)[:k] for r, k in pairs] or [np.zeros(0, np.int64)])
        value_all = np.concatenate([_host(r.value)[:k] for r, k in pairs] or [np.zeros(0, np.float32)])
        counts = {
            r: int(np.sum(reason_all == r.value))
            for r in ConvergenceReason
            if np.any(reason_all == r.value)
        }
        return cls(
            num_entities=int(reason_all.size),
            reason_counts=counts,
            iteration_stats=_stats(iter_all.astype(np.float64)),
            value_stats=_stats(value_all.astype(np.float64)),
        )

    def to_summary_string(self) -> str:
        reason_part = ", ".join(
            f"{r.name}={c}" for r, c in sorted(self.reason_counts.items(), key=lambda kv: kv[0].value)
        )
        it = self.iteration_stats
        return (
            f"random-effect solves over {self.num_entities} entities: "
            f"[{reason_part}] iterations(mean={it.get('mean', 0):.1f}, "
            f"p50={it.get('p50', 0):.0f}, p90={it.get('p90', 0):.0f}, "
            f"max={it.get('max', 0):.0f})"
        )


@dataclasses.dataclass(frozen=True)
class SolverStats:
    """Per-bucket telemetry of the convergence-adaptive random-effect driver.

    ``executed_lane_iterations`` counts the lane iterations dispatched (Σ
    over rounds of width × the round's advance); ``lockstep_lane_iterations``
    what one lockstep dispatch would run (entities × the slowest entity's
    iterations). The reference's ``chunk_retraces`` (jit traces) has no
    counterpart here: nothing is traced.
    """

    bucket: int
    optimizer: str                 # 'lbfgs' | 'owlqn' | 'tron'
    num_entities: int
    rounds: int
    chunk_iters: int
    dispatch_widths: tuple         # lanes per round (the power-of-two ladder)
    iterations_p50: float
    iterations_p99: float
    iterations_max: int
    sum_entity_iterations: int
    executed_lane_iterations: int
    lockstep_lane_iterations: int
    converged: int                 # entities with reason != NOT_CONVERGED

    @classmethod
    def of_bucket(cls, bucket: int, optimizer: str, chunk_iters: int, widths, executed,
                  iterations: np.ndarray, reasons: np.ndarray) -> "SolverStats":
        """From a bucket's final per-entity iterations and reasons;
        ``executed`` None = one lockstep dispatch."""
        its = iterations.astype(np.int64)
        max_its = int(its.max()) if its.size else 0
        lockstep = its.size * max_its
        return cls(
            bucket=bucket, optimizer=optimizer, num_entities=int(its.size),
            rounds=len(widths), chunk_iters=chunk_iters, dispatch_widths=tuple(widths),
            iterations_p50=float(np.percentile(its, 50)) if its.size else 0.0,
            iterations_p99=float(np.percentile(its, 99)) if its.size else 0.0,
            iterations_max=max_its, sum_entity_iterations=int(its.sum()),
            executed_lane_iterations=lockstep if executed is None else int(executed),
            lockstep_lane_iterations=lockstep,
            converged=int(np.sum(reasons != ConvergenceReason.NOT_CONVERGED.value)),
        )

    @property
    def wasted_lane_fraction(self) -> float:
        """Share of executed lane iterations spent on lanes already done or
        padding (0 = perfect packing)."""
        if self.executed_lane_iterations == 0:
            return 0.0
        return 1.0 - self.sum_entity_iterations / self.executed_lane_iterations

    @property
    def lane_iteration_savings(self) -> float:
        """lockstep / executed (≥ 1)."""
        if self.executed_lane_iterations == 0:
            return 1.0
        return self.lockstep_lane_iterations / self.executed_lane_iterations

    def to_summary_string(self) -> str:
        return (
            f"bucket {self.bucket} ({self.optimizer}, {self.num_entities} entities): "
            f"{self.rounds} rounds of K={self.chunk_iters} at widths "
            f"{list(self.dispatch_widths)}, iterations(p50={self.iterations_p50:.0f}, "
            f"p99={self.iterations_p99:.0f}, max={self.iterations_max}), "
            f"lane-iters executed={self.executed_lane_iterations} vs "
            f"lockstep={self.lockstep_lane_iterations} "
            f"({self.lane_iteration_savings:.2f}x saved, "
            f"wasted={self.wasted_lane_fraction:.1%}), "
            f"converged={self.converged}/{self.num_entities}"
        )


@dataclasses.dataclass
class TransferStats:
    """Score-plane transfer accounting for one coordinate-descent run.

    The CD driver owns one instance per ``run`` and counts every row-length
    (``num_rows``) score array that crosses the host/device boundary, plus
    the full host score-plane re-sums the legacy host plane performs. On the
    device plane the steady state is zero row transfers and zero host sums —
    tests and the ``bench.py --cd-scores`` contract gate on exactly that.
    """

    score_plane: str               # 'host' | 'device'
    num_rows: int
    bytes_per_row_array: int = 0   # num_rows * 4 (f32), set in __post_init__
    coordinate_updates: int = 0
    outer_iterations: int = 0
    host_score_sums: int = 0       # full C-way score-plane re-sums on host
    device_plane_updates: int = 0  # incremental total += new - old updates
    row_transfers_h2d: int = 0     # row-length arrays pushed host -> device
    row_transfers_d2h: int = 0     # row-length arrays pulled device -> host

    def __post_init__(self) -> None:
        self.bytes_per_row_array = int(self.num_rows) * 4

    def record_h2d(self, arrays: int = 1) -> None:
        self.row_transfers_h2d += int(arrays)

    def record_d2h(self, arrays: int = 1) -> None:
        self.row_transfers_d2h += int(arrays)

    @property
    def row_bytes_h2d(self) -> int:
        return self.row_transfers_h2d * self.bytes_per_row_array

    @property
    def row_bytes_d2h(self) -> int:
        return self.row_transfers_d2h * self.bytes_per_row_array

    @property
    def row_bytes_total(self) -> int:
        return self.row_bytes_h2d + self.row_bytes_d2h

    def per_outer_iteration(self) -> Dict[str, float]:
        """Steady-state rates: row arrays / bytes / sums per outer iteration."""
        it = max(self.outer_iterations, 1)
        return {
            "row_transfers_per_iter": (
                (self.row_transfers_h2d + self.row_transfers_d2h) / it
            ),
            "row_bytes_per_iter": self.row_bytes_total / it,
            "host_score_sums_per_iter": self.host_score_sums / it,
        }

    def snapshot(self) -> Dict[str, object]:
        out = {
            "score_plane": self.score_plane,
            "num_rows": self.num_rows,
            "coordinate_updates": self.coordinate_updates,
            "outer_iterations": self.outer_iterations,
            "host_score_sums": self.host_score_sums,
            "device_plane_updates": self.device_plane_updates,
            "row_transfers_h2d": self.row_transfers_h2d,
            "row_transfers_d2h": self.row_transfers_d2h,
            "row_bytes_h2d": self.row_bytes_h2d,
            "row_bytes_d2h": self.row_bytes_d2h,
        }
        out.update(self.per_outer_iteration())
        return out

    def to_summary_string(self) -> str:
        return (
            f"score plane '{self.score_plane}' over {self.num_rows} rows: "
            f"{self.coordinate_updates} updates in {self.outer_iterations} "
            f"outer iterations, {self.host_score_sums} host score sums, "
            f"{self.device_plane_updates} device plane updates, "
            f"row transfers h2d={self.row_transfers_h2d} "
            f"d2h={self.row_transfers_d2h} "
            f"({self.row_bytes_total / 1e6:.3f} MB)"
        )


def _stats(x: np.ndarray) -> Dict[str, float]:
    if x.size == 0:
        return {}
    return {
        "min": float(np.min(x)),
        "max": float(np.max(x)),
        "mean": float(np.mean(x)),
        "p50": float(np.percentile(x, 50)),
        "p90": float(np.percentile(x, 90)),
    }

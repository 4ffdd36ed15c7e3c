"""Block-sharded GLM solving over streamed fixed-shape blocks.

Port of ``photon_ml_tpu/streaming/solver.py``. Two modes, both built on
the port's optimizer primitives:

* ``solve_streaming`` — EXACT full-batch L-BFGS out of core. The GLM
  objective is a sum over rows plus an L2 term, so accumulating per-block
  ``value_and_grad`` (called with l2=0) across all blocks, in visit order,
  and adding ``0.5·λ·w·w / λ·w`` once reproduces the full-batch objective
  and gradient (weight-0 padding rows are algebraic no-ops). Each block's
  Xᵀc is a fixed-order ``ops.features.scatter_add`` (never an atomic
  ``index_add_`` on the card), so a pass is bitwise repeatable, and equal
  visit orders give bitwise equal fits: residency on or off, a cold
  (decode) or warm (cache) pass. Directions and curvature updates are
  ``opt/lbfgs.py``'s one-lane forms; convergence uses ``opt/state.py``'s
  absolute-tolerance predicates; the line search is backtracking Armijo,
  one streamed pass per trial.

* ``solve_streaming_stochastic`` — the resumable seam
  (``solve_init``/``solve_chunk``/``solve_finalize``, opt/solve.py) run per
  visited block group: shuffled block order per epoch (or a
  :class:`~photon_ml_tpu_torch.streaming.gapsched.GapScheduler`'s order),
  ``chunk_iters`` solver iterations per group, warm-started ``w`` carried
  between groups, λ scaled by the group's weight fraction.

The per-block programs (:class:`StreamPrograms`) are plain torch functions
built once per objective; ``stream_trace_counts()`` counts their
constructions (and the stochastic step's), which must not grow with the
number of blocks, passes or fits.

Results carry the port's leading lane axis: one lane.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.losses.objective import GlmObjective
from photon_ml_tpu_torch.ops.data import LabeledData
from photon_ml_tpu_torch.ops.features import EllFeatures
from photon_ml_tpu_torch.opt.config import GlmOptimizationConfiguration, OptimizerType
from photon_ml_tpu_torch.opt.lbfgs import (
    resolve_history_dtype,
    two_loop_direction_one,
    update_history_one,
)
from photon_ml_tpu_torch.opt.solve import solve_chunk, solve_finalize, solve_init
from photon_ml_tpu_torch.opt.state import SolveResult, absolute_tolerances
from photon_ml_tpu_torch.telemetry import note_jit_trace
from photon_ml_tpu_torch.types import ConvergenceReason

_TRACE_COUNTS: Counter = Counter()


def _note_trace(program: str, kind: str = "trace") -> None:
    """Count one construction of a streamed program."""
    _TRACE_COUNTS[(program, kind)] += 1
    note_jit_trace(program, kind)


def stream_trace_counts() -> Dict[Tuple[str, str], int]:
    """(program, kind) -> number of constructions of streamed programs."""
    return dict(_TRACE_COUNTS)


def reset_stream_trace_counts() -> None:
    _TRACE_COUNTS.clear()


# BlockFn: fresh iterable of per-block LabeledData (offsets already fused
# with the CD residual). Each call streams one full pass from disk.
BlockFn = Callable[[], Iterable]


class BlockStatsProbe:
    """Per-block convergence-plane collector for one streamed solve.

    When a probe is passed to ``solve_streaming`` the accumulation pass runs
    ``acc_vg_probe`` instead of ``acc_vg``: the same accumulation plus three
    scalar reductions per block — the block's partial loss, partial
    gradient norm, and a first-order Fenchel duality-gap surrogate
    ``f_k + <w, g_k>`` (the DuHL-style block importance score of
    arxiv 1702.07005). ``last_pass`` holds the scalars of the most recent
    completed pass. With no probe the plain accumulation runs, and the
    probe adds reductions only, never to f or g: a probed solve is bitwise
    the plain one.
    """

    def __init__(self) -> None:
        self._pending: List[tuple] = []
        self._futures: List[tuple] = []
        self._visit_pending: List[int] = []
        self._visit: List[int] = []
        self._resolved: Optional[List[dict]] = None

    def begin_pass(self) -> None:
        self._pending = []
        self._visit_pending = []

    def on_block(self, partial_loss, partial_grad_norm, gap_estimate) -> None:
        self._pending.append((partial_loss, partial_grad_norm, gap_estimate))

    def note_visit(self, block: int) -> None:
        """Attribution hook: the block generator records each yielded
        block's TRUE index so ``last_pass`` labels stats by it instead of
        by position (a degraded pass, on_block_error=skip, or the residency
        plane's merge would otherwise misattribute every stat after the
        first gap)."""
        self._visit_pending.append(int(block))

    def end_pass(self) -> None:
        # keep the device scalars; only the final completed pass is ever
        # read, so they go to the host in the last_pass property — no sync
        # on the intermediate line-search passes
        self._futures = self._pending
        self._visit = self._visit_pending
        self._pending = []
        self._visit_pending = []
        self._resolved = None

    @property
    def has_measurements(self) -> bool:
        """True once at least one streamed pass completed (the residency
        plane repins only on measured evidence)."""
        return bool(self._futures)

    @property
    def last_pass(self) -> List[dict]:
        if self._resolved is None:
            labels = (
                self._visit
                if len(self._visit) == len(self._futures)
                else list(range(len(self._futures)))
            )
            self._resolved = [
                {
                    "block": labels[i],
                    "partial_loss": float(f),
                    "partial_grad_norm": float(g),
                    "gap_estimate": float(gap),
                }
                for i, (f, g, gap) in enumerate(self._futures)
            ]
        return self._resolved


class StreamPrograms:
    """The per-block programs of one streamed solve, built once per
    objective (``for_objective`` memoizes) and reused across every block,
    every pass, and every CD outer iteration."""

    _CACHE: Dict[GlmObjective, "StreamPrograms"] = {}

    @classmethod
    def for_objective(cls, objective: GlmObjective) -> "StreamPrograms":
        cached = cls._CACHE.get(objective)
        if cached is None:
            cached = cls._CACHE[objective] = cls(objective)
        return cached

    def __init__(self, objective: GlmObjective):
        vg = objective.value_and_grad

        def acc_vg(w, data, f_acc, g_acc):
            # the gradient accumulates in place (the JAX package donates
            # it), so a pass allocates one gradient a block
            f, g = vg(w, data, 0.0)
            return f_acc + f, g_acc.add_(g)

        def acc_vg_probe(w, data, f_acc, g_acc):
            f, g = vg(w, data, 0.0)
            gap = f + torch.dot(w, g)
            return f_acc + f, g_acc.add_(g), f, torch.linalg.vector_norm(g), gap

        def gap_probe(w, data):
            # the standalone gap scalar for the stochastic scheduler; read
            # on the host once an epoch
            f, g = vg(w, data, 0.0)
            return f + torch.dot(w, g)

        def finalize(f, g, w, l2):
            f_reg = f + 0.5 * l2 * torch.dot(w, w)
            g_reg = g + l2 * w
            return f_reg, g_reg, torch.linalg.vector_norm(g_reg)

        def direction(g, s_hist, y_hist, rho, count):
            d = two_loop_direction_one(g, s_hist, y_hist, rho, count)
            dphi0 = torch.dot(d, g)
            bad = dphi0 >= 0
            d = torch.where(bad, -g, d)
            dphi0 = torch.where(bad, -torch.dot(g, g), dphi0)
            return d, dphi0, torch.linalg.vector_norm(d)

        def step(w, d, t):
            return w + t * d

        def hist_update(s_hist, y_hist, rho, count, w_old, w_new, g_old, g_new):
            s = (w_new - w_old).to(s_hist.dtype)
            y = (g_new - g_old).to(y_hist.dtype)
            return update_history_one(s_hist, y_hist, rho, count, s, y)

        self.acc_vg = acc_vg
        self.acc_vg_probe = acc_vg_probe
        self.gap_probe = gap_probe
        self.finalize = finalize
        self.direction = direction
        self.step = step
        self.hist_update = hist_update
        for name in ("stream_vg", "stream_vg_probe", "stream_gap_probe",
                     "stream_finalize", "stream_direction", "stream_step",
                     "stream_history"):
            _note_trace(name)


@dataclasses.dataclass
class StreamSolveInfo:
    """Host-side accounting of one streamed solve."""

    passes: int = 0          # streamed accumulation passes over the dataset
    blocks: int = 0          # total blocks visited
    iterations: int = 0
    line_search_trials: int = 0


def _full_pass(
    programs: StreamPrograms, w, make_blocks: BlockFn, dim: int, l2, info,
    probe: Optional[BlockStatsProbe] = None,
):
    """One streamed accumulation of the EXACT full-batch (value, grad)."""
    f = torch.zeros((), dtype=w.dtype, device=w.device)
    g = torch.zeros((dim,), dtype=w.dtype, device=w.device)
    if probe is None:
        for data in make_blocks():
            f, g = programs.acc_vg(w, data, f, g)
            info.blocks += 1
    else:
        probe.begin_pass()
        for data in make_blocks():
            f, g, bf, bg, bgap = programs.acc_vg_probe(w, data, f, g)
            probe.on_block(bf, bg, bgap)
            info.blocks += 1
        probe.end_pass()
    info.passes += 1
    return programs.finalize(f, g, w, l2)


def _one_lane(w, value, grad_norm, iterations: int, reason: ConvergenceReason,
              history: List[float], max_iter: int) -> SolveResult:
    value_history = np.full((1, max_iter + 1), np.nan, dtype=np.float32)
    value_history[0, : len(history)] = history
    dev = w.device
    return SolveResult(
        w=w.unsqueeze(0),
        value=value.reshape(1),
        grad_norm=grad_norm.reshape(1),
        iterations=torch.tensor([iterations], dtype=torch.int64, device=dev),
        reason=torch.tensor([reason.value], dtype=torch.int64, device=dev),
        value_history=torch.from_numpy(value_history).to(dev),
    )


def solve_streaming(
    objective: GlmObjective,
    w0,
    make_blocks: Optional[BlockFn],
    configuration: GlmOptimizationConfiguration,
    l2_weight: Optional[float] = None,
    info: Optional[StreamSolveInfo] = None,
    probe: Optional[BlockStatsProbe] = None,
) -> SolveResult:
    """Exact full-batch L-BFGS with the dataset streamed per pass, from
    ``w0`` [d] (its device is the solve's).

    The line search is backtracking Armijo (each trial = one streamed
    value-and-grad pass, so the accepted point's gradient is free); with
    all blocks visited per pass the trajectory optimizes the same
    full-batch objective as the in-memory solver and converges to the same
    optimum within solver tolerance. The JAX package's ``pass_fn`` seam
    (the cluster plane's distributed pass) is not ported (ROADMAP.md,
    Queue A item 8, The cluster plane).
    """
    if make_blocks is None:
        raise ValueError("solve_streaming needs make_blocks")
    cfg = configuration.optimizer_config
    if cfg.optimizer is OptimizerType.TRON:
        raise ValueError(
            "streaming full-batch mode supports first-order solvers (LBFGS);"
            " TRON needs Hessian-vector passes — use the in-memory trainer"
        )
    if configuration.l1_weight > 0:
        raise ValueError(
            "streaming full-batch mode does not support L1/OWL-QN yet; "
            "use stochastic mode or the in-memory trainer"
        )
    info = info if info is not None else StreamSolveInfo()
    w = torch.as_tensor(w0, dtype=torch.float32)
    dim = w.shape[-1]
    l2 = torch.tensor(
        configuration.l2_weight if l2_weight is None else l2_weight,
        dtype=w.dtype, device=w.device,
    )
    programs = StreamPrograms.for_objective(objective)

    def _pass(w_at):
        return _full_pass(programs, w_at, make_blocks, dim, l2, info, probe)

    f, g, g_norm = _pass(w)
    abs_f_tol, abs_g_tol = absolute_tolerances(f, g_norm, cfg.tolerance)
    abs_f_tol = float(abs_f_tol)
    abs_g_tol = float(abs_g_tol)

    m = cfg.history_length
    hdtype = resolve_history_dtype(cfg, w.dtype)
    s_hist = torch.zeros((m, dim), dtype=hdtype, device=w.device)
    y_hist = torch.zeros((m, dim), dtype=hdtype, device=w.device)
    rho = torch.zeros((m,), dtype=w.dtype, device=w.device)
    count = torch.zeros((), dtype=torch.int64, device=w.device)

    history = [float(f)]
    reason = ConvergenceReason.MAX_ITERATIONS
    if float(g_norm) <= abs_g_tol:
        reason = ConvergenceReason.GRADIENT_CONVERGED

    it = 0
    while it < cfg.max_iterations and reason is ConvergenceReason.MAX_ITERATIONS:
        d, dphi0, d_norm = programs.direction(g, s_hist, y_hist, rho, count)
        dphi0_f = float(dphi0)
        # Breeze's firstStepSize heuristic, then the quasi-Newton step t=1
        t = 1.0 / max(float(d_norm), 1e-12) if int(count) == 0 else 1.0
        f_host = float(f)

        accepted = None
        for _ in range(max(1, cfg.max_line_search_iterations)):
            info.line_search_trials += 1
            w_try = programs.step(w, d, t)
            f_try, g_try, g_try_norm = _pass(w_try)
            if float(f_try) <= f_host + 1e-4 * t * dphi0_f:
                accepted = (w_try, f_try, g_try, g_try_norm)
                break
            t *= 0.5
        if accepted is None:
            reason = ConvergenceReason.OBJECTIVE_NOT_IMPROVING
            break

        w_new, f_new, g_new, g_new_norm = accepted
        count = programs.hist_update(s_hist, y_hist, rho, count, w, w_new, g, g_new)
        it += 1
        info.iterations = it
        history.append(float(f_new))
        if float(g_new_norm) <= abs_g_tol:
            reason = ConvergenceReason.GRADIENT_CONVERGED
        elif abs(f_host - float(f_new)) <= abs_f_tol:
            reason = ConvergenceReason.FUNCTION_VALUES_CONVERGED
        w, f, g, g_norm = w_new, f_new, g_new, g_new_norm

    return _one_lane(w, f, g_norm, it, reason, history, cfg.max_iterations)


def _group_data(datas: List[LabeledData]) -> LabeledData:
    """Concatenate a fixed-size group of identically-shaped block
    LabeledData along rows."""
    if len(datas) == 1:
        return datas[0]
    feats = [d.features for d in datas]
    return LabeledData(
        features=EllFeatures(
            values=torch.cat([f.values for f in feats]),
            indices=torch.cat([f.indices for f in feats]),
            num_cols=feats[0].num_cols,
        ),
        labels=torch.cat([d.labels for d in datas]),
        offsets=torch.cat([d.offsets for d in datas]),
        weights=torch.cat([d.weights for d in datas]),
    )


# (objective, configuration, chunk_iters) -> init→chunk→finalize step
_STOCHASTIC_CACHE: Dict[Tuple, Callable] = {}


def _stochastic_step(
    objective: GlmObjective,
    cfg: GlmOptimizationConfiguration,
    chunk_iters: int,
) -> Callable:
    key = (objective, cfg, int(chunk_iters))
    cached = _STOCHASTIC_CACHE.get(key)
    if cached is not None:
        return cached

    def group_step(w_in, data, l2_eff):
        state = solve_init(objective, w_in.unsqueeze(0), data, cfg, l2_weight=l2_eff)
        state = solve_chunk(
            objective, state, data, cfg, l2_weight=l2_eff, num_iters=chunk_iters,
        )
        return solve_finalize(state, cfg)

    _note_trace("stream_stochastic_chunk")
    _STOCHASTIC_CACHE[key] = group_step
    return group_step


def _run_stochastic(
    objective: GlmObjective,
    w,
    make_blocks_ordered: Callable[[Optional[np.ndarray]], Iterable],
    cfg: GlmOptimizationConfiguration,
    num_blocks: int,
    total_weight: float,
    epochs: int,
    chunk_iters: int,
    blocks_per_update: int,
    seed: int,
    l2_full: float,
    info: StreamSolveInfo,
    scheduler=None,
) -> SolveResult:
    """The stochastic epoch loop.

    With no scheduler the visit order is the blind per-epoch
    ``rng.permutation`` (``np.random.default_rng(seed)``, the JAX
    package's orders). With a :class:`GapScheduler` the order comes from
    ``scheduler.epoch_order()`` and each visited block's first-order gap is
    probed at the iterate it was visited with; the epoch-end read feeds the
    magnitudes back via ``scheduler.update`` — one host sync per epoch.
    """
    rng = np.random.default_rng(seed)
    group_step = _stochastic_step(objective, cfg, chunk_iters)
    gap_probe = (
        StreamPrograms.for_objective(objective).gap_probe
        if scheduler is not None
        else None
    )

    def flush(group, group_weight, w):
        # ragged final group: pad with repeats of the last block so the
        # group's shape stays fixed
        while len(group) < blocks_per_update:
            group.append(group[-1])
        frac = group_weight / max(total_weight, 1e-30)
        result = group_step(w, _group_data(group), l2_full * frac)
        info.iterations += int(result.iterations[0])
        return result

    result = None
    for _ in range(max(1, epochs)):
        if scheduler is None:
            order = rng.permutation(num_blocks)
        else:
            order = scheduler.epoch_order()
        epoch_blocks = len(order)
        gap_futures: List = []
        visited: List[int] = []
        group: List = []
        group_weight = 0.0
        blocks_seen = 0
        for blk in make_blocks_ordered(order):
            # the stream may yield fewer blocks than ordered (degraded
            # on_block_error=skip); gap attribution follows the block's
            # OWN index
            idx = getattr(blk, "index", -1)
            visited.append(
                int(idx) if int(idx) >= 0 else int(order[blocks_seen])
            )
            if gap_probe is not None:
                gap_futures.append(gap_probe(w, blk.data))
            group.append(blk.data)
            group_weight += blk.weight_sum
            blocks_seen += 1
            info.blocks += 1
            if len(group) == blocks_per_update or blocks_seen == epoch_blocks:
                result = flush(group, group_weight, w)
                w = result.w[0]
                group = []
                group_weight = 0.0
        if group:
            # a skipped block kept blocks_seen short of epoch_blocks, so
            # the in-loop boundary never flushed the tail
            result = flush(group, group_weight, w)
            w = result.w[0]
        if scheduler is not None:
            missing = set(int(b) for b in order) - set(visited)
            if missing:
                # ordered but never yielded: permanently failed and
                # skipped — exclude from every later epoch's schedule
                scheduler.mark_failed(sorted(missing))
            scheduler.update(
                {visited[pos]: float(v) for pos, v in enumerate(gap_futures)}
            )
        info.passes += 1
    if result is None:
        raise RuntimeError(
            "no blocks streamed (every block failed or was skipped)"
        )
    return result


def solve_streaming_stochastic(
    objective: GlmObjective,
    w0,
    make_blocks_ordered: Callable[[Optional[np.ndarray]], Iterable],
    configuration: GlmOptimizationConfiguration,
    num_blocks: int,
    total_weight: float,
    epochs: int = 5,
    chunk_iters: int = 4,
    blocks_per_update: int = 1,
    seed: int = 0,
    l2_weight: Optional[float] = None,
    info: Optional[StreamSolveInfo] = None,
    scheduler=None,
) -> SolveResult:
    """Stochastic block-sharded solving on the resumable solver seam.

    Per epoch the block order is reshuffled — or, when a
    :class:`~photon_ml_tpu_torch.streaming.gapsched.GapScheduler` is passed,
    chosen by staleness-decayed duality-gap importance (DuHL, arxiv
    1702.07005); every ``blocks_per_update`` consecutive blocks form one
    update group, solved with
    ``solve_init → solve_chunk(num_iters=chunk_iters) → solve_finalize``
    warm-started from the running ``w``. λ is scaled by the group's share
    of the total example weight so each group optimizes a consistently
    regularized subproblem.
    """
    info = info if info is not None else StreamSolveInfo()
    return _run_stochastic(
        objective,
        torch.as_tensor(w0, dtype=torch.float32),
        make_blocks_ordered,
        configuration,
        num_blocks,
        total_weight,
        epochs,
        chunk_iters,
        blocks_per_update,
        seed,
        float(configuration.l2_weight if l2_weight is None else l2_weight),
        info,
        scheduler=scheduler,
    )


def streamed_objective_value(
    objective: GlmObjective,
    w,
    make_blocks: BlockFn,
    dim: int,
    l2: float,
    info: Optional[StreamSolveInfo] = None,
) -> float:
    """Exact full-batch objective at ``w`` via one streamed pass (used to
    report the full-batch objective after a stochastic run)."""
    programs = StreamPrograms.for_objective(objective)
    info = info if info is not None else StreamSolveInfo()
    w = torch.as_tensor(w, dtype=torch.float32)
    f, _, _ = _full_pass(
        programs, w, make_blocks, dim,
        torch.tensor(l2, dtype=torch.float32, device=w.device), info,
    )
    return float(f)

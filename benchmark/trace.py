"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over the
window, recording the card's activity alone (host operators would add
their own recording to a host-paced window), read from the profiler's raw
results; and a log of the shape of every launch of the program's
hand-written kernels, for their least times.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

# the hand-written kernel a device event launches, by a part of its name
# (merge kernels by their term type, which names the kernel's wrapper)
KERNELS = (
    ("RoundedProduct", "csc_rmatvec_bf16"),
    ("Product", "csc_rmatvec_f32"),
    ("GatherBf16", "csr_matvec_bf16"),
    ("GatherF32", "csr_matvec_f32"),
    ("batched_warp_kernel", "fused_value_grad_batched_f32"),
    ("batched_tiles_kernel", "fused_value_grad_batched_f32"),
    ("batched_rows_kernel", "fused_value_grad_batched_f32"),
)
# events that finish the launch before them on the stream: the merge
# path's carry rounds and the CSR column blocks' sum
CONTINUATIONS = ("carry_kernel", "sum_blocks_kernel")
MARKER_CYCLES = 1000


def family(name: str) -> Tuple[Optional[str], bool]:
    """(the hand-written kernel an event belongs to or None, whether the
    event continues the launch before it)."""
    if "merge_kernel" in name or "batched_" in name:
        for part, kernel in KERNELS:
            if part in name:
                return kernel, False
    return None, any(part in name for part in CONTINUATIONS)


def device_events(prof) -> List[tuple]:
    """(name, start ns, end ns) of every device event of a finished
    profiler run, from its raw results (building the profiler's own event
    objects costs tens of microseconds an event)."""
    from torch.autograd import DeviceType

    try:
        return [(e.name(), e.start_ns(), e.end_ns())
                for e in prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA]
    except AttributeError:
        return [(e.name, int(e.time_range.start * 1000), int(e.time_range.end * 1000))
                for e in prof.events() if e.device_type == DeviceType.CUDA]


class DeviceTrace:
    """Profiles the card from ``start()`` to ``stop()``; ``offset_ns`` maps
    the host's ``perf_counter_ns`` onto the trace's clock, from a marker
    kernel launched on an idle card right after a host reading, at the
    start and at the stop. The events kept are those between the two; a
    second profiler session in one process can lose the start marker, and
    then the stop marker alone sets the offset."""

    def __init__(self):
        self.prof = None
        self.events: List[tuple] = []
        self.offset_ns = 0

    @staticmethod
    def _mark() -> int:
        torch.cuda.synchronize()
        host = time.perf_counter_ns()
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
        return host

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._host_marks = [self._mark()]

    def stop(self) -> None:
        self._host_marks.append(self._mark())
        self.prof.__exit__(None, None, None)
        events = sorted(device_events(self.prof), key=lambda e: e[1])
        self.prof = None
        marks = [i for i, e in enumerate(events)
                 if "spin_kernel" in e[0] or "sleep" in e[0].lower()]
        if not marks:
            raise RuntimeError("the device trace holds no marker kernel")
        last = marks[-1]
        self.offset_ns = events[last][1] - self._host_marks[1]
        first = marks[-2] if len(marks) > 1 else -1
        self.events = events[first + 1:last]

    def window(self, start_s: float, end_s: float) -> List[tuple]:
        """The events inside a host window of perf_counter seconds."""
        lo = int(start_s * 1e9) + self.offset_ns
        hi = int(end_s * 1e9) + self.offset_ns
        return [e for e in self.events if e[2] > lo and e[1] < hi]


def busy_intervals(events: List[tuple]) -> List[Tuple[int, int]]:
    """The union of the events' intervals, merged, in order."""
    merged: List[List[int]] = []
    for _, a, b in sorted(events, key=lambda e: e[1]):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def kernel_seconds(events: List[tuple]) -> Dict[str, float]:
    """Device seconds of each hand-written kernel's launches: its own events
    and the carry rounds and block sums that follow them on the stream."""
    out: Dict[str, float] = {}
    current = None
    for name, a, b in sorted(events, key=lambda e: e[1]):
        kernel, continues = family(name)
        if kernel is not None:
            current = kernel
        elif not continues:
            current = None
            continue
        if current is not None:
            out[current] = out.get(current, 0.0) + (b - a) / 1e9
    return out


class ShapeLog:
    """Within the block, every launch of the fixed-effect kernels and of the
    batched value+gradient kernel (a call on CUDA tensors) records its
    kernel and its least seconds at its shape. The wrappers call the
    program's own functions and return what they return."""

    def __init__(self):
        self.launches: List[Tuple[str, float]] = []

    def __enter__(self):
        from benchmark import roofline
        from photon_ml_tpu_torch.ops import fused_perm, pallas_kernels

        log = self.launches
        csr, csc = fused_perm.csr_matvec_f32, fused_perm.csc_rmatvec_f32
        vg = pallas_kernels.fused_value_grad_batched_f32

        def csr_matvec_f32(row_ptr, col_idx, vals, w, dim, split=None, blocks=1):
            if w.device.type == "cuda":
                n = (row_ptr.numel() - 1) // blocks
                log.append(("csr_matvec_f32", roofline.csr_matvec_s(n, col_idx.numel(), dim)))
            return csr(row_ptr, col_idx, vals, w, dim, split, blocks)

        def csc_rmatvec_f32(col_ptr, row_idx, vals, c, num_rows, transform="id", split=None):
            if c.device.type == "cuda":
                log.append(("csc_rmatvec_f32", roofline.csc_rmatvec_s(
                    num_rows, row_idx.numel(), col_ptr.numel() - 1)))
            return csc(col_ptr, row_idx, vals, c, num_rows, transform, split)

        def fused_value_grad_batched_f32(X, y, off, wt, w, kind):
            if X.device.type == "cuda":
                log.append(("fused_value_grad_batched_f32", roofline.value_grad_s(*X.shape)))
            return vg(X, y, off, wt, w, kind)

        self._saved = [(fused_perm, "csr_matvec_f32", csr), (fused_perm, "csc_rmatvec_f32", csc),
                       (pallas_kernels, "fused_value_grad_batched_f32", vg)]
        fused_perm.csr_matvec_f32 = csr_matvec_f32
        fused_perm.csc_rmatvec_f32 = csc_rmatvec_f32
        pallas_kernels.fused_value_grad_batched_f32 = fused_value_grad_batched_f32
        return self

    def __exit__(self, *exc):
        for module, name, fn in self._saved:
            setattr(module, name, fn)

    def bound_seconds(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for kernel, s in self.launches:
            out[kernel] = out.get(kernel, 0.0) + s
        return out

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for kernel, _ in self.launches:
            out[kernel] = out.get(kernel, 0) + 1
        return out


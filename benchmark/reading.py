"""What a ``--trace 1`` run hands each per-layer metric's reader
(``metrics/<name>.py``, a function ``read(reading) -> float or None``).
A reader that finds nothing to read returns None, and the metric is left
out of the result line."""

from __future__ import annotations

import dataclasses
from typing import Dict, List


@dataclasses.dataclass
class Reading:
    spans: List[dict]                # the benchmark's and the program's, perf_counter seconds
    window: tuple                    # (start, end) of the measured window, perf_counter seconds
    jobs: int                        # jobs finished in the window
    fe_iterations: List[int]         # fixed-effect L-BFGS iterations of each job
    model_work_s: List[float]        # least seconds of each job's model work
    kernel_bound_s: Dict[str, float]   # Σ least seconds of the window's launches, by kernel
    kernel_device_s: Dict[str, float]  # Σ device seconds of those launches in the trace
    busy_s: float                    # union of the device's event intervals in the window

    def total(self, name: str, in_window: bool = True) -> float:
        """Seconds of the spans called ``name`` (inside the window only, or
        all of them)."""
        lo, hi = self.window if in_window else (float("-inf"), float("inf"))
        return sum(s["dur"] for s in self.spans
                   if s["name"] == name and lo <= s["start"] <= hi)

    def has(self, name: str, in_window: bool = True) -> bool:
        lo, hi = self.window if in_window else (float("-inf"), float("inf"))
        return any(s["name"] == name and lo <= s["start"] <= hi for s in self.spans)

    def roofline(self, kernels) -> float:
        """Σ least time over Σ device time of the kernels' launches, in %,
        or None where the trace holds none of them."""
        device = sum(self.kernel_device_s.get(k, 0.0) for k in kernels)
        if device <= 0:
            return None
        return 100.0 * sum(self.kernel_bound_s.get(k, 0.0) for k in kernels) / device

"""Slice sampling for marginalizing GP kernel hyperparameters.

Reference parity: SliceSampler.scala:53 — coordinate-wise slice sampling
with randomized direction order, step-out slice finding, and shrink-on-reject;
on a degenerate shrink the slice resets to the full range (:115-131).
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np


class SliceSampler:
    """Draws samples from an unnormalized log-density ``logp``.

    ``range_`` bounds each coordinate (the reference defaults to
    (log 1e-5, log 1e5), matching kernel length-scale bounds).
    """

    def __init__(
        self,
        logp: Callable[[np.ndarray], float],
        range_: Tuple[float, float] = (math.log(1e-5), math.log(1e5)),
        step_size: float = 1.0,
        rng: np.random.Generator = None,
    ) -> None:
        self.logp = logp
        self.range = range_
        self.step_size = step_size
        self.rng = rng if rng is not None else np.random.default_rng()

    def draw(self, x: np.ndarray) -> np.ndarray:
        """One full sweep: sample along every coordinate in random order."""
        x = np.asarray(x, dtype=float).copy()
        for i in self.rng.permutation(x.shape[0]):
            x = self._draw_along(x, int(i))
        return x

    def _draw_along(self, x: np.ndarray, i: int) -> np.ndarray:
        # log U for U~Uniform(0,1] is -Exp(1); avoids log(0) from the
        # half-open uniform sampler.
        y = -self.rng.exponential() + self.logp(x)
        lower, upper = self._step_out(x, y, i)
        lo_bound, hi_bound = self.range
        while True:
            new_x = x.copy()
            new_x[i] = self.rng.uniform(lower, upper)
            if self.logp(new_x) > y:
                return new_x
            # shrink the slice toward x; on degenerate shrink reset to range
            if new_x[i] < x[i]:
                lower = new_x[i]
            elif new_x[i] > x[i]:
                upper = new_x[i]
            else:
                lower, upper = lo_bound, hi_bound

    def _step_out(self, x: np.ndarray, y: float, i: int) -> Tuple[float, float]:
        lo_bound, hi_bound = self.range
        lower = x.copy()
        lower[i] -= self.rng.uniform() * self.step_size
        upper = lower.copy()
        upper[i] += self.step_size
        while self.logp(lower) > y and lower[i] > lo_bound:
            lower[i] -= self.step_size
        while self.logp(upper) > y and upper[i] < hi_bound:
            upper[i] += self.step_size
        # The loops step first and test second, so clamp the final slice to
        # the declared range — samples must respect the kernel bounds.
        return (
            max(float(lower[i]), lo_bound),
            min(float(upper[i]), hi_bound),
        )

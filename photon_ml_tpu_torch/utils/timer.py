"""Phase timing utilities (reference util/Timed.scala:33, Timer.scala:182).

Port of ``photon_ml_tpu/utils/timer.py``, a copy.

The reference wraps every driver phase in ``Timed { }`` blocks writing to a
driver-side logger; here the same pattern is a context manager that logs
wall-clock per phase and can be queried afterwards (bench/driver code uses it).

Both ``Timer`` and ``Timed`` are thin shims over the telemetry span API
(:mod:`photon_ml_tpu_torch.telemetry.span`) so there is exactly ONE timing path:
when span tracing is enabled each phase also lands in the trace/ledger as a
span; when disabled the span still measures but records nowhere but here.
``Timer`` is thread-safe and keeps phases that raise (accumulated in
``durations`` as before, flagged in ``failures``).
"""

from __future__ import annotations

import logging
import threading
from contextlib import contextmanager
from typing import Dict, Iterator

from photon_ml_tpu_torch.telemetry.span import timed_span

logger = logging.getLogger("photon_ml_tpu_torch")


class Timer:
    """Accumulates named phase durations (thread-safe). Phases that raise
    are still accumulated and additionally counted in ``failures``."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.durations: Dict[str, float] = {}
        self.failures: Dict[str, int] = {}

    @contextmanager
    def time(self, name: str) -> Iterator[None]:
        sp = timed_span(name)
        try:
            with sp:
                yield
        finally:
            with self._lock:
                self.durations[name] = (
                    self.durations.get(name, 0.0) + sp.duration_s
                )
                if sp.failed:
                    self.failures[name] = self.failures.get(name, 0) + 1
            if sp.failed:
                logger.info(
                    "phase %s FAILED (%s) after %.3fs",
                    name, sp.error, sp.duration_s,
                )
            else:
                logger.info("phase %s took %.3fs", name, sp.duration_s)

    def failed(self, name: str) -> bool:
        """True when at least one run of ``name`` raised."""
        with self._lock:
            return self.failures.get(name, 0) > 0


@contextmanager
def Timed(name: str) -> Iterator[None]:
    """Standalone timed block, logging at INFO."""
    sp = timed_span(name)
    try:
        with sp:
            yield
    finally:
        if sp.failed:
            logger.info(
                "phase %s FAILED (%s) after %.3fs", name, sp.error, sp.duration_s
            )
        else:
            logger.info("phase %s took %.3fs", name, sp.duration_s)

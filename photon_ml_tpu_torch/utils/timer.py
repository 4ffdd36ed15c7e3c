"""Phase timing for the drivers (reference util/Timed.scala:33,
Timer.scala:182).

Own copy of ``photon_ml_tpu/utils/timer.py`` without its telemetry spans
(not ported): a context manager that logs the wall-clock seconds of each
phase and accumulates them by name. Phases that raise are accumulated too
and counted in ``failures``.
"""

from __future__ import annotations

import logging
import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator

logger = logging.getLogger("photon_ml_tpu_torch")


class Timer:
    """Accumulates named phase durations (thread-safe)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.durations: Dict[str, float] = {}
        self.failures: Dict[str, int] = {}

    @contextmanager
    def time(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        failed = None
        try:
            yield
        except BaseException as e:
            failed = e
            raise
        finally:
            seconds = time.perf_counter() - t0
            with self._lock:
                self.durations[name] = self.durations.get(name, 0.0) + seconds
                if failed is not None:
                    self.failures[name] = self.failures.get(name, 0) + 1
            if failed is not None:
                logger.info("phase %s FAILED (%r) after %.3fs", name, failed, seconds)
            else:
                logger.info("phase %s took %.3fs", name, seconds)

    def failed(self, name: str) -> bool:
        """True when at least one run of ``name`` raised."""
        with self._lock:
            return self.failures.get(name, 0) > 0

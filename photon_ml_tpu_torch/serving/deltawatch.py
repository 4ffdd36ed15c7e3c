"""Supervised background delta watcher: the ``--watch-deltas`` loop as a
daemon that survives its own crashes.

``serve_game --watch-deltas`` used to poll inline between request
batches; anything long-running (a sidecar thread, a notebook serving
loop) had to spin its own bare thread around
:meth:`HotSwapManager.poll_directory` — and one uncaught exception there
silently froze the model at its current generation forever.

:class:`DeltaWatcher` runs the poll on a :class:`SupervisedThread`
(mode="tick"): a crash in discovery or apply is recorded, the loop
restarts with backoff, and past the restart cap the watcher is declared
dead — serving keeps answering on the last good generation while
``health()`` reports the degraded reason for ``/healthz``.

Unreadable or partially-written deltas never reach the supervisor at
all: :meth:`HotSwapManager.poll_directory` already retries the load and
skips (without marking processed) on failure, so the common corruption
case costs a failure record, not a thread restart.

Port of ``photon_ml_tpu/serving/deltawatch.py`` on the port's
:class:`~photon_ml_tpu_torch.resilience.supervisor.SupervisedThread`.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from photon_ml_tpu_torch.resilience.supervisor import SupervisedThread
from photon_ml_tpu_torch.serving.hotswap import SwapReport

__all__ = ["DeltaWatcher"]

_MAX_KEPT_REPORTS = 64


class DeltaWatcher:
    """Polls ``watch_dir`` for published deltas and applies them through
    ``manager`` (a :class:`HotSwapManager` or :class:`CoordinatedHotSwap`
    — anything with ``poll_directory``) every ``interval_s`` seconds on a
    supervised daemon thread."""

    def __init__(
        self,
        manager,
        watch_dir: str,
        interval_s: float = 1.0,
        max_restarts: int = 5,
        emitter=None,
    ):
        if not hasattr(manager, "poll_directory"):
            raise TypeError(
                f"manager {type(manager).__name__} has no poll_directory"
            )
        self._manager = manager
        self.watch_dir = str(watch_dir)
        self.interval_s = float(interval_s)
        self._max_restarts = int(max_restarts)
        self._emitter = emitter
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._thread: Optional[SupervisedThread] = None
        self.polls = 0
        self.swaps = 0
        self._reports: List[SwapReport] = []

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "DeltaWatcher":
        if self._thread is not None:
            raise RuntimeError("delta watcher already running")
        self._stop.clear()
        self._thread = SupervisedThread(
            "serving-deltawatch",
            self._tick,
            mode="tick",
            stop_event=self._stop,
            max_restarts=self._max_restarts,
            emitter=self._emitter,
        )
        self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = 5.0) -> None:
        if self._thread is None:
            return
        self._thread.stop(timeout)
        self._thread = None

    def __enter__(self) -> "DeltaWatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------- the tick
    def _tick(self) -> None:
        reports = self._manager.poll_directory(self.watch_dir)
        with self._lock:
            self.polls += 1
            if reports:
                self.swaps += len(reports)
                self._reports.extend(reports)
                del self._reports[:-_MAX_KEPT_REPORTS]
        self._stop.wait(self.interval_s)

    def poll_now(self) -> List[SwapReport]:
        """One synchronous poll on the caller's thread (tests, warmup)."""
        reports = self._manager.poll_directory(self.watch_dir)
        with self._lock:
            self.polls += 1
            if reports:
                self.swaps += len(reports)
                self._reports.extend(reports)
                del self._reports[:-_MAX_KEPT_REPORTS]
        return reports

    def drain_reports(self) -> List[SwapReport]:
        with self._lock:
            out, self._reports = self._reports, []
        return out

    # -------------------------------------------------------------- readers
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            doc: Dict[str, Any] = {
                "watch_dir": self.watch_dir,
                "polls": self.polls,
                "swaps": self.swaps,
                "running": self._thread is not None,
            }
        if self._thread is not None:
            doc["supervisor"] = self._thread.stats()
        return doc

    def health(self) -> Dict[str, Any]:
        if self._thread is None:
            return {"healthy": True, "name": "serving-deltawatch",
                    "running": False}
        doc = self._thread.health()
        doc["running"] = True
        return doc

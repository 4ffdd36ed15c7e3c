"""Supervised background threads: crash containment for daemons.

Every long-lived background thread in the system — the admission
controller, the continuous batcher's per-replica workers, the delta
watcher — used to be a bare ``threading.Thread``: one uncaught exception
and the daemon died *silently* while the rest of the process kept
running degraded with no signal (the admission ``_run`` loop was the
motivating bug). :class:`SupervisedThread` wraps the body:

* a crash is **captured**, recorded as a structured failure +
  ``resilience.thread.*`` counters + an optional :class:`AnomalyEvent`,
  never propagated to nowhere;
* the body is **restarted** after deterministic exponential backoff, up
  to ``max_restarts``;
* past the cap the thread is declared **dead**: one final
  ``thread_dead`` record, the ``on_dead`` callback fires, and
  :meth:`health` turns unhealthy so ``/healthz`` can flip to 503 with a
  ``degraded`` reason — while the rest of the process keeps serving.

Two body shapes:

* ``mode="tick"`` — ``target()`` is one iteration; the supervisor loops
  it until the stop event is set (the body does its own idle waiting).
* ``mode="loop"`` — ``target()`` runs its own long loop and returns on
  clean shutdown; a return without a crash ends the thread.

Restarts re-enter ``target`` on the same OS thread (no respawn), so
``Thread`` identity, name, and daemon-ness are stable for the thread's
whole supervised life.
"""
from __future__ import annotations

import logging
import threading
import traceback
from typing import Any, Callable, Dict, Optional

from photon_ml_tpu_torch.resilience.failures import record_failure

__all__ = ["SupervisedThread"]

logger = logging.getLogger(__name__)


class SupervisedThread:
    def __init__(
        self,
        name: str,
        target: Callable[[], Any],
        *,
        mode: str = "tick",
        stop_event: Optional[threading.Event] = None,
        max_restarts: int = 5,
        restart_backoff_s: float = 0.05,
        backoff: float = 2.0,
        max_backoff_s: float = 2.0,
        daemon: bool = True,
        emitter: Optional[Any] = None,
        on_dead: Optional[Callable[["SupervisedThread"], None]] = None,
    ):
        if mode not in ("tick", "loop"):
            raise ValueError(f"mode must be 'tick' or 'loop', got {mode!r}")
        self.name = name
        self._target = target
        self._mode = mode
        self.stop_event = stop_event if stop_event is not None else threading.Event()
        self.max_restarts = int(max_restarts)
        self.restart_backoff_s = float(restart_backoff_s)
        self.backoff = float(backoff)
        self.max_backoff_s = float(max_backoff_s)
        self._emitter = emitter
        self._on_dead = on_dead
        self._thread = threading.Thread(
            target=self._run, name=name, daemon=daemon
        )
        self._lock = threading.Lock()
        self.crashes = 0
        self.restarts = 0
        self.dead = False
        self.last_error: Optional[str] = None

    # ------------------------------------------------------------ control
    def start(self) -> None:
        self._thread.start()

    def stop(self, timeout: Optional[float] = 5.0) -> None:
        self.stop_event.set()
        if self._thread.is_alive():
            self._thread.join(timeout)

    def join(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout)

    def is_alive(self) -> bool:
        return self._thread.is_alive()

    # ------------------------------------------------------------ the loop
    def _run(self) -> None:
        while not self.stop_event.is_set():
            try:
                if self._mode == "tick":
                    self._target()
                    continue
                self._target()
                return  # loop body exited cleanly
            except BaseException as exc:  # noqa: BLE001 - that's the job
                if self.stop_event.is_set():
                    return  # shutdown race: drop the error quietly
                if not self._note_crash(exc):
                    return  # declared dead
                # deterministic backoff before re-entering the body; the
                # stop event interrupts the wait so shutdown stays fast
                n = min(self.restarts, 16)
                delay = min(
                    self.restart_backoff_s * (self.backoff ** (n - 1)),
                    self.max_backoff_s,
                )
                if self.stop_event.wait(delay):
                    return

    def _note_crash(self, exc: BaseException) -> bool:
        """Record one crash; True = restart, False = declared dead."""
        tb = traceback.format_exception_only(type(exc), exc)[-1].strip()
        with self._lock:
            self.crashes += 1
            self.last_error = tb
            dying = self.crashes > self.max_restarts
            if not dying:
                self.restarts += 1
        from photon_ml_tpu_torch.telemetry.metrics import get_registry

        reg = get_registry()
        reg.count("resilience.thread.crashes")
        reg.count(f"resilience.thread.{self.name}.crashes")
        record_failure(
            "thread_crash", f"thread.{self.name}", tb, crashes=self.crashes
        )
        logger.warning(
            "supervised thread %s crashed (%d/%d): %s",
            self.name, self.crashes, self.max_restarts + 1, tb,
        )
        self._emit_anomaly("thread_crash", tb)
        if dying:
            with self._lock:
                self.dead = True
            reg.count("resilience.thread.deaths")
            reg.count(f"resilience.thread.{self.name}.deaths")
            record_failure(
                "thread_dead",
                f"thread.{self.name}",
                f"gave up after {self.crashes} crashes: {tb}",
            )
            self._emit_anomaly("thread_dead", tb)
            if self._on_dead is not None:
                try:
                    self._on_dead(self)
                except Exception:
                    logger.exception("on_dead callback raised")
            return False
        reg.count("resilience.thread.restarts")
        reg.count(f"resilience.thread.{self.name}.restarts")
        return True

    def _emit_anomaly(self, kind: str, detail: str) -> None:
        if self._emitter is None:
            return
        try:
            from photon_ml_tpu_torch.event import AnomalyEvent

            self._emitter.send_event(
                AnomalyEvent(
                    kind=kind,
                    coordinate_id=self.name,
                    outer_iteration=-1,
                    objective_value=float("nan"),
                    detail=detail,
                )
            )
        except Exception:
            logger.exception("anomaly emission raised")

    # ------------------------------------------------------------ readers
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "name": self.name,
                "alive": self._thread.is_alive(),
                "dead": self.dead,
                "crashes": self.crashes,
                "restarts": self.restarts,
                "last_error": self.last_error,
            }

    def health(self) -> Dict[str, Any]:
        """Health contribution: unhealthy once declared dead."""
        with self._lock:
            doc: Dict[str, Any] = {
                "healthy": not self.dead,
                "name": self.name,
                "restarts": self.restarts,
            }
            if self.dead:
                doc["degraded"] = (
                    f"thread {self.name} dead after {self.crashes} crashes:"
                    f" {self.last_error}"
                )
            return doc

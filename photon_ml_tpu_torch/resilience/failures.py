"""Structured failure records: the shared sink for every resilience event.

Retry exhaustion, supervised-thread crashes, skipped blocks, and rejected
delta artifacts all funnel through :func:`record_failure`, which

* appends a structured record to a bounded in-process ring (the failure
  flight recorder — :func:`recent_failures` feeds ``/healthz`` detail and
  post-mortems),
* bumps ``resilience.failures`` / ``resilience.failures.<kind>`` counters
  in the process-global :class:`MetricsRegistry`,
* logs one WARNING, and
* fans out to registered sinks (the training progress ledger attaches one
  so resilience events land next to convergence records; sink errors are
  swallowed — a broken observer must never re-fail the failure path).

Records carry no wall-clock field at the resilience layer: ordering is the
monotonically increasing ``seq``. Timestamps belong to whichever sink
persists the record (the progress ledger stamps its own).
"""
from __future__ import annotations

import logging
import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "record_failure",
    "recent_failures",
    "add_failure_sink",
    "remove_failure_sink",
    "clear_failures",
]

logger = logging.getLogger(__name__)

_LOCK = threading.Lock()
_RING: deque = deque(maxlen=256)
_SINKS: List[Callable[[Dict[str, Any]], None]] = []
_SEQ = 0


def record_failure(
    kind: str,
    site: str,
    detail: str = "",
    **extra: Any,
) -> Dict[str, Any]:
    """Record one resilience event. ``kind`` is the failure class
    (``retry_exhausted``, ``thread_crash``, ``thread_dead``,
    ``block_skipped``, ``delta_rejected``, ...); ``site`` names the seam
    or thread."""
    global _SEQ
    with _LOCK:
        _SEQ += 1
        rec: Dict[str, Any] = {
            "seq": _SEQ,
            "kind": str(kind),
            "site": str(site),
            "detail": str(detail),
        }
        for key, value in extra.items():
            rec[key] = value
        _RING.append(rec)
        sinks = list(_SINKS)
    from photon_ml_tpu_torch.telemetry.metrics import get_registry

    reg = get_registry()
    reg.count("resilience.failures")
    reg.count(f"resilience.failures.{kind}")
    logger.warning("resilience: %s at %s: %s", kind, site, detail)
    for sink in sinks:
        try:
            sink(dict(rec))
        except Exception:  # noqa: BLE001 - observers must not re-fail us
            logger.exception("resilience failure sink raised")
    return rec


def recent_failures(n: Optional[int] = None) -> List[Dict[str, Any]]:
    """Most recent failure records, oldest first."""
    with _LOCK:
        items = list(_RING)
    return items if n is None else items[-n:]


def add_failure_sink(sink: Callable[[Dict[str, Any]], None]) -> None:
    with _LOCK:
        if sink not in _SINKS:
            _SINKS.append(sink)


def remove_failure_sink(sink: Callable[[Dict[str, Any]], None]) -> None:
    with _LOCK:
        if sink in _SINKS:
            _SINKS.remove(sink)


def clear_failures() -> None:
    """Drop the ring (tests). Sinks stay attached."""
    global _SEQ
    with _LOCK:
        _RING.clear()
        _SEQ = 0

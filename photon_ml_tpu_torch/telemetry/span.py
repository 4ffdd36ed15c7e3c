"""Hierarchical span tracer.

One process-global :class:`Tracer` collects :class:`SpanRecord`\\ s from
``with span("cd/outer_iter", outer=3):`` blocks.  Nesting is tracked with a
:mod:`contextvars` variable, so spans opened on different threads (or in
different asyncio tasks) chain to the right parent without any locking on
the hot path — the only lock is taken once per span, on close, to append
the finished record.

The disabled path is near-free: :func:`span` returns a singleton no-op
context manager (no allocation, no clock read), so instrumentation can stay
on hot loops unconditionally.  Spans that exit via an exception are kept
and tagged ``failed=True`` with the exception type name.

Optionally a span can request *device-sync* timing: the enter/exit clock
reads are preceded by a barrier, so the measured wall time covers device
work issued inside the block instead of just the Python time spent
enqueueing it. The barrier synchronizes the current CUDA stream of the
current device, never the whole device: a worker of the async schedule
(``algorithm/schedule.py``) runs on a stream of its own, and a
device-wide sync on its path would serialize the workers. Without CUDA
in the process the barrier does nothing. It catches nothing.

Port of ``photon_ml_tpu/telemetry/span.py``; only the barrier differs.
"""
from __future__ import annotations

import contextvars
import dataclasses
import itertools
import threading
import time
from typing import Any, Dict, List, Optional

import torch

__all__ = [
    "SpanRecord",
    "Tracer",
    "get_tracer",
    "span",
    "timed_span",
    "enable_tracing",
    "disable_tracing",
]


@dataclasses.dataclass
class SpanRecord:
    """A finished span. ``start_s`` is seconds since the tracer's origin
    (``Tracer.origin_unix`` converts it to wall-clock time)."""

    span_id: int
    parent_id: Optional[int]
    name: str
    path: str
    depth: int
    start_s: float
    duration_s: float
    thread_id: int
    thread_name: str
    failed: bool = False
    error: Optional[str] = None
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)


class _NoopSpan:
    """Singleton returned when tracing is disabled. Accepts the same calls
    as a live span so call sites never branch."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set_attrs(self, **attrs) -> "_NoopSpan":
        return self


NOOP_SPAN = _NoopSpan()

# The innermost live span for the current thread/task (None at top level).
_CURRENT: contextvars.ContextVar[Optional["_LiveSpan"]] = contextvars.ContextVar(
    "photon_ml_tpu_torch_current_span", default=None
)


def _device_barrier() -> None:
    """Block until the work enqueued on the current thread's current CUDA
    stream has retired. Used for device-sync spans. A process that has not
    initialized CUDA has enqueued nothing on a card: nothing to wait for."""
    if torch.cuda.is_initialized():
        torch.cuda.current_stream().synchronize()


class _LiveSpan:
    __slots__ = (
        "_tracer",
        "name",
        "attrs",
        "span_id",
        "parent_id",
        "path",
        "depth",
        "duration_s",
        "failed",
        "error",
        "_token",
        "_start",
        "_sync",
    )

    def __init__(self, tracer: "Tracer", name: str, sync: bool, attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._sync = sync
        self.span_id = next(tracer._ids)
        self.parent_id: Optional[int] = None
        self.path = name
        self.depth = 1
        self.duration_s = 0.0
        self.failed = False
        self.error: Optional[str] = None
        self._token: Optional[contextvars.Token] = None
        self._start = 0.0

    def set_attrs(self, **attrs) -> "_LiveSpan":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_LiveSpan":
        parent = _CURRENT.get()
        if parent is not None:
            self.parent_id = parent.span_id
            self.path = f"{parent.path}/{self.name}"
            self.depth = parent.depth + 1
        self._token = _CURRENT.set(self)
        if self._sync:
            _device_barrier()
        self._start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._sync:
            _device_barrier()
        end = time.perf_counter()
        if self._token is not None:
            _CURRENT.reset(self._token)
        self.duration_s = end - self._start
        self.failed = exc_type is not None
        self.error = exc_type.__name__ if exc_type is not None else None
        # timed_span measures even with tracing off; only record when on
        if self._tracer.enabled:
            thread = threading.current_thread()
            self._tracer._record(
                SpanRecord(
                    span_id=self.span_id,
                    parent_id=self.parent_id,
                    name=self.name,
                    path=self.path,
                    depth=self.depth,
                    start_s=self._start - self._tracer.origin_perf,
                    duration_s=self.duration_s,
                    thread_id=thread.ident or 0,
                    thread_name=thread.name,
                    failed=self.failed,
                    error=self.error,
                    attrs=self.attrs,
                )
            )
        return False  # never swallow exceptions


class Tracer:
    """Thread-safe collector of finished spans.

    ``enabled`` gates collection: when False, :meth:`span` hands back the
    shared no-op singleton. ``device_sync`` master-switches per-span barrier
    requests (so a run can ask for wall-only timing even at instrumented
    call sites that request a sync).
    """

    def __init__(self, enabled: bool = False, device_sync: bool = True):
        self.enabled = enabled
        self.device_sync = device_sync
        self._lock = threading.Lock()
        self._spans: List[SpanRecord] = []
        self._ids = itertools.count(1)
        # Anchor for converting perf_counter readings to wall-clock time.
        self.origin_perf = time.perf_counter()
        self.origin_unix = time.time()

    # ------------------------------------------------------------- control
    def span(self, name: str, device_sync: bool = False, **attrs):
        if not self.enabled:
            return NOOP_SPAN
        return _LiveSpan(self, name, device_sync and self.device_sync, attrs)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    # ------------------------------------------------------------- access
    def _record(self, record: SpanRecord) -> None:
        with self._lock:
            self._spans.append(record)

    def spans(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._spans)

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


_TRACER = Tracer(enabled=False)


def get_tracer() -> Tracer:
    """The process-global tracer used by :func:`span`."""
    return _TRACER


def span(name: str, device_sync: bool = False, **attrs):
    """Open a span on the global tracer. Near-free when tracing is off:
    a single attribute check then the shared no-op context manager."""
    t = _TRACER
    if not t.enabled:
        return NOOP_SPAN
    return _LiveSpan(t, name, device_sync and t.device_sync, attrs)


def timed_span(name: str, **attrs) -> _LiveSpan:
    """An ALWAYS-measuring span: times the block whether or not tracing is
    on, exposing ``duration_s``/``failed``/``error`` afterwards, and lands
    in the tracer only when it is enabled. This is the single timing path
    behind ``utils.timer.Timer``/``Timed``."""
    return _LiveSpan(_TRACER, name, False, attrs)


def enable_tracing(device_sync: bool = True, clear: bool = True) -> Tracer:
    """Turn on the global tracer (optionally clearing prior spans)."""
    if clear:
        _TRACER.clear()
    _TRACER.device_sync = device_sync
    _TRACER.enabled = True
    return _TRACER


def disable_tracing() -> None:
    _TRACER.enabled = False

"""Overlapped coordinate-descent schedule: the in-flight work executor.

Port of ``photon_ml_tpu/algorithm/schedule.py``. The sync CD loop
serializes every coordinate update, so the card idles through every
host-driven phase boundary. The async schedule pipelines that work instead:
solves are dispatched onto a small worker pool and reconciled into the
device score plane in dispatch order, with a ``staleness`` bound on how
many unreconciled updates a dispatch may ignore.

:class:`ScheduleExecutor` is the piece both overlap sites share (the CD
loop's coordinate pipeline and ``train_random_effects``'s bucket
overlap): a thin wrapper over :class:`~concurrent.futures.ThreadPoolExecutor`
that copies the dispatching thread's contextvars into the worker, and on a
CUDA device gives every worker a CUDA stream of its own:

* ``submit`` records an event on the dispatching thread's current stream;
  the worker's stream waits on it before the work is enqueued, so the
  work sees everything the dispatcher enqueued before it (the residual);
  the tensors of ``inputs`` are marked as used on the worker's stream
  (``record_stream``), so the caching allocator does not hand their memory
  to the dispatcher while the worker still reads it;
* the work runs under ``torch.cuda.stream(worker stream)``: every kernel
  and every host pull (``.cpu()``, ``bool()``) inside it goes to, and
  syncs, that stream alone;
* ``InFlight.result`` makes the taking thread's current stream wait on an
  event recorded after the work, and marks every tensor of the result as
  used on that stream: the tensors were allocated on the worker's stream.

On the CPU the executor is plain threads. A worker's exception re-raises in
the thread that takes its result.

Each unit of work runs inside a telemetry span (default name
``cd/overlap``; ``re/solve_bucket`` for RE bucket overlap), opened in the
worker inside the dispatching thread's copied contextvars context, so it
chains under the span that was open at the call site (parent id and path
in the run ledger). The span asks for no barrier: a barrier inside it
would sync the worker's own stream only.

Determinism: the executor imposes no ordering; callers get it by
construction. The CD loop computes every residual on the dispatching thread
at dispatch time and folds results back in dispatch order, so the trained
trajectory depends only on the ``staleness`` bound, never on thread timing;
RE bucket solves are mutually independent, and no kernel on the path adds
with atomics, so any completion order gives bitwise the same per-bucket
results.
"""

from __future__ import annotations

import collections
import contextvars
import dataclasses
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Deque, Optional

import torch

from photon_ml_tpu_torch.telemetry.span import span

__all__ = ["SCHEDULES", "InFlight", "ScheduleExecutor", "record_stream"]

# The CD schedule axis. "sync" is the default and follows the strictly
# sequential trajectory bitwise; "async" pipelines solves with bounded
# staleness.
SCHEDULES = ("sync", "async")

_PRIMITIVES = (str, bytes, int, float, bool, type(None))


def record_stream(obj: Any, stream: torch.cuda.Stream) -> None:
    """``record_stream(stream)`` on every CUDA tensor inside ``obj``
    (tensors, lists, tuples, dicts, dataclasses). Lists and dicts of plain
    values (entity ids, id maps) are skipped after a look at one element."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            obj.record_stream(stream)
        return
    if isinstance(obj, _PRIMITIVES):
        return
    if isinstance(obj, dict):
        values = list(obj.values())
        if values and _plain(values[0]):
            return
        for v in values:
            record_stream(v, stream)
        return
    if isinstance(obj, (list, tuple)):
        if obj and _plain(obj[0]):
            return
        for v in obj:
            record_stream(v, stream)
        return
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            record_stream(getattr(obj, f.name, None), stream)


def _plain(x: Any) -> bool:
    if isinstance(x, _PRIMITIVES):
        return True
    return isinstance(x, (list, tuple)) and bool(x) and isinstance(x[0], _PRIMITIVES)


class InFlight:
    """One dispatched unit of work: the submit key plus its future."""

    __slots__ = ("key", "future", "attrs", "_device")

    def __init__(self, key: Any, future: Future, attrs: dict,
                 device: Optional[torch.device]):
        self.key = key
        self.future = future
        self.attrs = attrs
        self._device = device

    def done(self) -> bool:
        return self.future.done()

    def result(self) -> Any:
        """Block until the work completes. Worker exceptions re-raise here,
        on the thread that reconciles the result. On a CUDA device the
        taking thread's current stream waits for the work, and the result's
        tensors are marked as used on that stream."""
        out = self.future.result()
        if self._device is None:
            return out
        out, done = out
        stream = torch.cuda.current_stream(self._device)
        stream.wait_event(done)
        record_stream(out, stream)
        return out


class ScheduleExecutor:
    """Bounded worker pool owning the in-flight queue of an overlapped run.

    ``max_in_flight`` caps both the pool width and therefore how many
    solves can make progress concurrently; callers additionally bound the
    *unreconciled* count (the staleness window) on their side. ``device``:
    on a CUDA device each worker runs its work on a CUDA stream of its own
    (see the module docstring); otherwise the workers are plain threads.
    """

    def __init__(self, max_in_flight: int = 2, name: str = "cd-sched",
                 device: Optional[torch.device] = None):
        if max_in_flight < 1:
            raise ValueError(
                f"max_in_flight must be >= 1, got {max_in_flight}"
            )
        self.max_in_flight = max_in_flight
        device = torch.device(device) if device is not None else None
        self._device = device if device is not None and device.type == "cuda" else None
        # the dispatching thread's stream: every submit comes from the
        # thread that made the executor
        self._parent = (torch.cuda.current_stream(self._device)
                        if self._device is not None else None)
        self._local = threading.local()
        self._pool = ThreadPoolExecutor(
            max_workers=max_in_flight, thread_name_prefix=name,
            initializer=self._init_worker,
        )
        self._queue: Deque[InFlight] = collections.deque()

    def _init_worker(self) -> None:
        # the worker's stream, made once. PyTorch hands streams out of a
        # fixed pool in turn, so two executors' workers may share one: that
        # orders their work and changes no result (every cross-stream
        # dependency goes through an event)
        if self._device is not None:
            self._local.stream = torch.cuda.Stream(self._device)

    # ----------------------------------------------------------- dispatch
    def submit(self, key: Any, fn: Callable[[], Any], inputs: Any = (),
               span_name: str = "cd/overlap", **attrs: Any) -> InFlight:
        """Dispatch ``fn`` onto the pool inside a ``span_name`` span
        carrying ``attrs``. ``inputs``: tensors (or containers of them)
        made on the dispatching stream that ``fn`` reads; they are kept
        from reuse until the worker's stream is done with them. The
        dispatching thread's contextvars context (the live span among
        them) is entered in the worker."""
        ctx = contextvars.copy_context()
        dev = self._device

        def _in_span() -> Any:
            with span(span_name, **attrs):
                return fn()

        if dev is None:
            future = self._pool.submit(ctx.run, _in_span)
        else:
            ready = torch.cuda.Event()
            ready.record(self._parent)

            def _run() -> Any:
                stream = self._local.stream
                stream.wait_event(ready)
                record_stream(inputs, stream)
                with torch.cuda.stream(stream):
                    out = ctx.run(_in_span)
                    done = torch.cuda.Event()
                    done.record(stream)
                return out, done

            future = self._pool.submit(_run)
        work = InFlight(key, future, dict(attrs), dev)
        self._queue.append(work)
        return work

    # -------------------------------------------------------------- queue
    def __len__(self) -> int:
        return len(self._queue)

    def oldest(self) -> Optional[InFlight]:
        return self._queue[0] if self._queue else None

    def pop_oldest(self) -> InFlight:
        """Remove and return the oldest in-flight work (FIFO — the
        reconciliation order of the bounded-staleness schedule)."""
        return self._queue.popleft()

    def drain(self) -> list:
        """Block until every queued work item completes; returns their
        results in dispatch order and empties the queue."""
        out = []
        while self._queue:
            out.append(self._queue.popleft().result())
        return out

    # ---------------------------------------------------------- lifecycle
    def shutdown(self, wait: bool = True) -> None:
        self._pool.shutdown(wait=wait)

    def __enter__(self) -> "ScheduleExecutor":
        return self

    def __exit__(self, *exc) -> bool:
        self.shutdown(wait=True)
        return False

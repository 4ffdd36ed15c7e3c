"""In-process event pub/sub: the drivers' observability extension point.

Copy of the training events of ``photon_ml_tpu/event.py`` (reference
photon-client event/{Event,EventEmitter,EventListener}.scala; events fired
from Driver.scala:120,162,186). Listeners are registered by instance, or by
dotted class name (the reference's ``--event-listeners`` flag,
Params.scala:186), and receive every event; a listener's exception is
logged and counted, never raised into training. The scoring, hot-swap,
transfer and anomaly events are declared here for the telemetry sinks
(``telemetry/sinks.py``); the convergence watchdog sends ``AnomalyEvent``.
"""

from __future__ import annotations

import dataclasses
import importlib
import logging
from typing import Any, Dict, List, Optional, Tuple

_log = logging.getLogger("photon_ml_tpu_torch.event")


@dataclasses.dataclass(frozen=True)
class Event:
    """Base event (reference event/Event.scala:27)."""


@dataclasses.dataclass(frozen=True)
class PhotonSetupEvent(Event):
    """Driver configured and about to run (Driver.scala:120)."""

    params: Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TrainingStartEvent(Event):
    """Training phase entered (Driver.scala:162)."""

    task: str


@dataclasses.dataclass(frozen=True)
class PhotonOptimizationLogEvent(Event):
    """Per-model optimization telemetry (Driver.scala:186)."""

    coordinate_id: Optional[str]
    regularization_weight: float
    objective_value: float
    iterations: int
    convergence_reason: str


@dataclasses.dataclass(frozen=True)
class TrainingFinishEvent(Event):
    """Training phase finished."""

    task: str
    wall_seconds: float


@dataclasses.dataclass(frozen=True)
class ScoringStartEvent(Event):
    """Online/offline scoring phase entered (serving replay, serve CLI)."""

    model_id: str
    num_requests: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ScoringFinishEvent(Event):
    """Scoring phase finished; carries the serving metrics snapshot."""

    model_id: str
    num_requests: int
    wall_seconds: float
    metrics: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class ModelSwapEvent(Event):
    """A hot-swap attempt on a live scorer (serving.hotswap). Fired for
    successful swaps AND rollbacks (``rolled_back`` distinguishes them)."""

    model_id: str
    generation: int
    fingerprint: Optional[str]
    coordinates: Tuple[str, ...]
    rows_updated: int
    blackout_s: float
    rolled_back: bool = False
    validation_metric: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class SolverStatsEvent(Event):
    """Per-bucket telemetry of the convergence-adaptive random-effect
    driver (``opt.tracking.SolverStats``), sent by coordinate descent after
    each random-effect update."""

    coordinate_id: Optional[str]
    bucket: int
    optimizer: str
    num_entities: int
    rounds: int
    dispatch_widths: Tuple[int, ...]
    iterations_p50: float
    iterations_p99: float
    executed_lane_iterations: int
    lockstep_lane_iterations: int
    wasted_lane_fraction: float

    @classmethod
    def from_stats(cls, coordinate_id: Optional[str], stats) -> "SolverStatsEvent":
        return cls(
            coordinate_id=coordinate_id,
            bucket=stats.bucket,
            optimizer=stats.optimizer,
            num_entities=stats.num_entities,
            rounds=stats.rounds,
            dispatch_widths=tuple(stats.dispatch_widths),
            iterations_p50=stats.iterations_p50,
            iterations_p99=stats.iterations_p99,
            executed_lane_iterations=stats.executed_lane_iterations,
            lockstep_lane_iterations=stats.lockstep_lane_iterations,
            wasted_lane_fraction=stats.wasted_lane_fraction,
        )


@dataclasses.dataclass(frozen=True)
class TransferStatsEvent(Event):
    """Per-outer-iteration score-plane transfer accounting from the
    coordinate-descent driver (opt.tracking.TransferStats deltas): row-length
    score arrays moved host<->device plus host score-plane re-sums. On the
    device plane the steady state is all-zero row transfers."""

    score_plane: str
    outer_iteration: int
    num_rows: int
    row_transfers_h2d: int
    row_transfers_d2h: int
    row_bytes_h2d: int
    row_bytes_d2h: int
    host_score_sums: int
    device_plane_updates: int


@dataclasses.dataclass(frozen=True)
class AnomalyEvent(Event):
    """The divergence watchdog tripped during training: a non-finite
    objective, an objective increase beyond tolerance, or repeated
    line-search failure while the gradient is still large. ``kind`` names
    the trigger; ``detail`` carries the offending values. Listeners see it
    before the driver aborts (the /healthz endpoint flips unhealthy on the
    same signal)."""

    kind: str
    coordinate_id: Optional[str]
    outer_iteration: int
    objective_value: float
    detail: Dict[str, Any] = dataclasses.field(default_factory=dict)


class EventListener:
    """Receives every event of an emitter (EventListener.scala)."""

    def on_event(self, event: Event) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def close(self) -> None:
        """Called when the emitter shuts down."""


class EventEmitter:
    """Owner of a listener list (reference EventEmitter.scala:24)."""

    def __init__(self) -> None:
        self._listeners: List[EventListener] = []
        #: listener exceptions caught by ``send_event`` / ``clear_listeners``
        self.listener_errors: int = 0

    def register_listener(self, listener: EventListener) -> None:
        self._listeners.append(listener)

    def register_listener_class(self, dotted_name: str) -> None:
        """Instantiate a listener from ``package.module.ClassName`` (the
        reference's ``--event-listeners`` contract, Params.scala:186)."""
        module_name, _, class_name = dotted_name.rpartition(".")
        if not module_name:
            raise ValueError(f"listener name must be dotted path, got {dotted_name!r}")
        try:
            module = importlib.import_module(module_name)
        except ImportError as e:
            raise ValueError(
                f"cannot register event listener {dotted_name!r}: module "
                f"{module_name!r} failed to import ({e})"
            ) from e
        try:
            cls = getattr(module, class_name)
        except AttributeError:
            raise ValueError(
                f"cannot register event listener {dotted_name!r}: module "
                f"{module_name!r} has no attribute {class_name!r}"
            ) from None
        try:
            listener = cls()
        except TypeError as e:
            raise ValueError(
                f"cannot register event listener {dotted_name!r}: "
                f"{class_name!r} is not an instantiable listener class ({e})"
            ) from e
        if not hasattr(listener, "on_event"):
            raise ValueError(
                f"cannot register event listener {dotted_name!r}: "
                f"{class_name!r} has no on_event method"
            )
        self.register_listener(listener)

    def send_event(self, event: Event) -> None:
        for listener in self._listeners:
            try:
                listener.on_event(event)
            except Exception:  # noqa: BLE001 - a listener must not stop training
                self.listener_errors += 1
                _log.exception("event listener %r failed", listener)

    def clear_listeners(self) -> None:
        for listener in self._listeners:
            try:
                listener.close()
            except Exception:  # noqa: BLE001
                self.listener_errors += 1
                _log.exception("event listener %r failed to close", listener)
        self._listeners = []

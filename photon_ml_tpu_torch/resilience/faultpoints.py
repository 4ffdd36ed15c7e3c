"""Deterministic fault-injection sites: the chaos seam of the failure plane.

The reference Photon-ML inherited fault tolerance from Spark and never had
to *test* it — lineage recompute was exercised by every flaky executor in
the fleet. This runtime has no fleet doing free chaos testing, so the
failure plane carries its own: every hardened IO seam and background
thread declares a named **fault point** (``fault_point("stream.read_part_file")``)
that tests and the CI chaos gate can arm to raise a fault at a precise,
reproducible moment.

Design contract (mirrors the telemetry disabled-path contract):

* **Disabled path is a dict-miss no-op.** When nothing is armed the whole
  call is one falsy check on an empty dict — no RNG draw, no counter, no
  lock. Arming machinery must be bitwise-invisible to training/serving
  output; the CI disabled-path parity gate pins this by diffing model
  bytes with and without a never-firing armed site.
* **Deterministic triggers.** ``once:N`` fires exactly on the Nth call,
  ``every:N`` on every Nth call, ``prob:P[:seed]`` draws from a dedicated
  per-site ``random.Random(seed)`` — independent of global RNG state and
  reproducible across runs. No wall clock anywhere.
* **Sites self-register at import** via :func:`register_fault_site`, so
  the chaos harness can enumerate every seam
  (:func:`registered_fault_sites`) and assert coverage.

Arming: ``PHOTON_FAULTS="site=once:2,site2=every:5,site3=prob:0.5:7"`` or
programmatic :func:`configure_faults` / :func:`arm_fault`. Injected
faults raise :class:`InjectedFault` (an ``OSError`` subclass, so every
transient-IO retry classification catches it) unless the spec appends
``!fatal``, which raises :class:`FatalInjectedFault` — classified as
non-retryable, for exercising exhaustion/degraded paths.
"""
from __future__ import annotations

import os
import random
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional

__all__ = [
    "InjectedFault",
    "FatalInjectedFault",
    "FaultSpec",
    "register_fault_site",
    "registered_fault_sites",
    "fault_point",
    "configure_faults",
    "arm_fault",
    "disarm_fault",
    "reset_faults",
    "armed_faults",
    "fault_stats",
    "parse_fault_env",
]

_ENV_VAR = "PHOTON_FAULTS"


class InjectedFault(OSError):
    """Raised by an armed fault point. Subclasses ``OSError`` so the
    default transient-IO retry classification treats it as retryable —
    a chaos run exercises the exact recovery path a real flaky read
    would take."""


class FatalInjectedFault(RuntimeError):
    """Non-retryable injected fault (``!fatal`` suffix): exercises retry
    exhaustion, supervisor death, and degraded modes."""


@dataclass
class FaultSpec:
    """One armed site. ``mode``: ``once`` (fire exactly on call number
    ``param``), ``every`` (every ``param``-th call), ``prob`` (each call
    fires with probability ``param`` from a seeded per-site RNG)."""

    site: str
    mode: str                     # "once" | "every" | "prob"
    param: float                  # N for once/every, p for prob
    seed: int = 0                 # prob mode only
    fatal: bool = False
    calls: int = 0
    trips: int = 0
    _rng: Optional[random.Random] = field(default=None, repr=False)

    def __post_init__(self) -> None:
        if self.mode not in ("once", "every", "prob"):
            raise ValueError(f"unknown fault mode {self.mode!r}")
        if self.mode in ("once", "every") and int(self.param) < 1:
            raise ValueError(f"{self.mode} trigger needs N >= 1")
        if self.mode == "prob":
            if not (0.0 <= self.param <= 1.0):
                raise ValueError("prob trigger needs 0 <= p <= 1")
            self._rng = random.Random(self.seed)

    def should_fire(self) -> bool:
        self.calls += 1
        if self.mode == "once":
            fire = self.calls == int(self.param)
        elif self.mode == "every":
            fire = self.calls % int(self.param) == 0
        else:  # prob
            fire = self._rng.random() < self.param
        if fire:
            self.trips += 1
        return fire


# site name -> human description; populated at import time by every module
# that owns a fault point, so the chaos harness can enumerate the seams.
_SITES: Dict[str, str] = {}
# site name -> FaultSpec; EMPTY unless explicitly armed. fault_point()'s
# disabled path is a single falsy check on this dict.
_ARMED: Dict[str, FaultSpec] = {}
_LOCK = threading.Lock()
_ENV_LOADED = False


def register_fault_site(name: str, description: str) -> str:
    """Declare a named injection seam (idempotent). Returns the name so
    modules can bind it to a constant at import."""
    with _LOCK:
        _SITES.setdefault(name, description)
    return name


def registered_fault_sites() -> Dict[str, str]:
    """All declared sites (name -> description). The chaos harness
    asserts its coverage list matches this exactly."""
    _load_env_once()
    with _LOCK:
        return dict(_SITES)


def parse_fault_env(value: str) -> Dict[str, FaultSpec]:
    """Parse a ``PHOTON_FAULTS`` string:
    ``site=once:2,site2=every:5,site3=prob:0.25:7,site4=once:1!fatal``."""
    specs: Dict[str, FaultSpec] = {}
    for item in value.split(","):
        item = item.strip()
        if not item:
            continue
        if "=" not in item:
            raise ValueError(f"bad fault spec {item!r} (want site=mode:...)")
        site, _, trigger = item.partition("=")
        site = site.strip()
        fatal = trigger.endswith("!fatal")
        if fatal:
            trigger = trigger[: -len("!fatal")]
        parts = trigger.split(":")
        mode = parts[0].strip()
        if mode in ("once", "every"):
            if len(parts) != 2:
                raise ValueError(f"bad fault spec {item!r} (want {mode}:N)")
            spec = FaultSpec(site, mode, float(int(parts[1])), fatal=fatal)
        elif mode == "prob":
            if len(parts) not in (2, 3):
                raise ValueError(
                    f"bad fault spec {item!r} (want prob:p[:seed])"
                )
            seed = int(parts[2]) if len(parts) == 3 else 0
            spec = FaultSpec(site, mode, float(parts[1]), seed=seed, fatal=fatal)
        else:
            raise ValueError(f"unknown fault mode {mode!r} in {item!r}")
        specs[site] = spec
    return specs


def _load_env_once() -> None:
    global _ENV_LOADED
    if _ENV_LOADED:
        return
    with _LOCK:
        if _ENV_LOADED:
            return
        _ENV_LOADED = True
        value = os.environ.get(_ENV_VAR, "")
        if value:
            _ARMED.update(parse_fault_env(value))


def configure_faults(specs: Dict[str, FaultSpec] | str) -> None:
    """Replace the armed set (programmatic equivalent of the env var).
    Accepts either a parsed dict or a raw spec string."""
    if isinstance(specs, str):
        specs = parse_fault_env(specs)
    global _ENV_LOADED
    with _LOCK:
        _ENV_LOADED = True  # explicit config overrides env loading
        _ARMED.clear()
        _ARMED.update(specs)


def arm_fault(
    site: str,
    mode: str,
    param: float,
    seed: int = 0,
    fatal: bool = False,
) -> FaultSpec:
    """Arm one site, keeping others as they are."""
    spec = FaultSpec(site, mode, param, seed=seed, fatal=fatal)
    _load_env_once()
    with _LOCK:
        _ARMED[site] = spec
    return spec


def disarm_fault(site: str) -> None:
    with _LOCK:
        _ARMED.pop(site, None)


def reset_faults() -> None:
    """Disarm everything and forget the env was read (tests)."""
    global _ENV_LOADED
    with _LOCK:
        _ARMED.clear()
        _ENV_LOADED = False


def armed_faults() -> Dict[str, FaultSpec]:
    _load_env_once()
    with _LOCK:
        return dict(_ARMED)


def fault_stats() -> Dict[str, Dict[str, int]]:
    """Per-armed-site call/trip counts (chaos assertions read this)."""
    with _LOCK:
        return {
            name: {"calls": spec.calls, "trips": spec.trips}
            for name, spec in _ARMED.items()
        }


def fault_point(name: str) -> None:
    """The injection seam. Unarmed: one falsy check on an empty dict —
    no lock, no RNG, bitwise-invisible. Armed: consult the site's
    deterministic trigger and raise when it fires."""
    if not _ARMED and _ENV_LOADED:
        return
    _load_env_once()
    spec = _ARMED.get(name)
    if spec is None:
        return
    with _LOCK:
        fire = spec.should_fire()
    if not fire:
        return
    # counted outside the lock: the registry has its own
    from photon_ml_tpu_torch.telemetry.metrics import get_registry

    get_registry().count(f"resilience.fault.{name}.trips")
    exc = FatalInjectedFault if spec.fatal else InjectedFault
    raise exc(f"injected fault at {name} (call {spec.calls})")

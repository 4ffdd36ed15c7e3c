"""Failure plane: fault injection, retry/backoff, supervised threads.

Port of ``photon_ml_tpu/resilience``, a copy. Without Spark, training
loses the fault tolerance the reference Photon-ML inherited from it
(lineage recompute, task retry). This package is the replacement — three
small pieces every hot path plugs into:

* :mod:`~photon_ml_tpu_torch.resilience.faultpoints` — named, seeded,
  deterministic fault-injection sites (``PHOTON_FAULTS=``); the disabled
  path is a dict-miss no-op, bitwise-invisible to training output.
* :mod:`~photon_ml_tpu_torch.resilience.retry` — :class:`RetryPolicy` with
  bounded attempts, deterministic backoff/jitter, and retryable-exception
  classification, wired into every transient-IO seam.
* :mod:`~photon_ml_tpu_torch.resilience.supervisor` — :class:`SupervisedThread`
  crash containment for background daemons: capture → record → restart
  with backoff → declared dead + ``/healthz`` degraded.

Shared accounting lives in :mod:`~photon_ml_tpu_torch.resilience.failures`
(structured failure ring + ``resilience.*`` counters + sink fan-out).
See docs/RELIABILITY.md for the fault-point catalog and degraded modes.
"""
from photon_ml_tpu_torch.resilience.failures import (
    add_failure_sink,
    clear_failures,
    recent_failures,
    record_failure,
    remove_failure_sink,
)
from photon_ml_tpu_torch.resilience.faultpoints import (
    FatalInjectedFault,
    FaultSpec,
    InjectedFault,
    arm_fault,
    armed_faults,
    configure_faults,
    disarm_fault,
    fault_point,
    fault_stats,
    parse_fault_env,
    register_fault_site,
    registered_fault_sites,
    reset_faults,
)
from photon_ml_tpu_torch.resilience.retry import (
    DEFAULT_IO_RETRY,
    RetryExhausted,
    RetryPolicy,
)
from photon_ml_tpu_torch.resilience.supervisor import SupervisedThread

__all__ = [
    "InjectedFault",
    "FatalInjectedFault",
    "FaultSpec",
    "fault_point",
    "register_fault_site",
    "registered_fault_sites",
    "configure_faults",
    "arm_fault",
    "disarm_fault",
    "reset_faults",
    "armed_faults",
    "fault_stats",
    "parse_fault_env",
    "RetryPolicy",
    "RetryExhausted",
    "DEFAULT_IO_RETRY",
    "SupervisedThread",
    "record_failure",
    "recent_failures",
    "add_failure_sink",
    "remove_failure_sink",
    "clear_failures",
]

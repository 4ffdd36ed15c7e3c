"""Bounded retry with deterministic backoff for transient-IO seams.

Spark gave the reference Photon-ML task retry for free; here every IO
seam that can fail transiently — part-file decode, block-cache load/
store, delta-artifact loads, admission scatter — wraps its body in a
:class:`RetryPolicy`:

* **bounded attempts** with exponential backoff capped at ``max_delay_s``;
* **deterministic jitter** — a hash of ``(site, attempt)`` rather than a
  global RNG draw, so retry timing never perturbs seeded randomness
  anywhere else (bitwise-invisibility contract) and chaos runs replay
  identically;
* **classification** — ``retryable`` exception types minus explicit
  ``non_retryable`` carve-outs (``FileNotFoundError`` is a normal cache
  miss, not a transient fault; :class:`FatalInjectedFault` exercises the
  exhaustion path);
* **accounting** — ``resilience.retry.<site>.{attempts,retries,exhausted,
  recovered}`` counters plus a structured failure record (and anomaly
  fan-out) on exhaustion.

Sleeps go through the policy's injectable ``sleep`` so tests run at full
speed. The singleton :data:`DEFAULT_IO_RETRY` is what the built-in seams
use; callers needing different bounds construct their own policy.
"""
from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Any, Callable, Optional, Tuple, Type

from photon_ml_tpu_torch.resilience.failures import record_failure
from photon_ml_tpu_torch.resilience.faultpoints import FatalInjectedFault

__all__ = ["RetryPolicy", "RetryExhausted", "DEFAULT_IO_RETRY"]


class RetryExhausted(RuntimeError):
    """All attempts failed. ``__cause__`` is the final underlying error."""

    def __init__(self, site: str, attempts: int, last: BaseException):
        super().__init__(
            f"{site}: {attempts} attempts exhausted "
            f"({type(last).__name__}: {last})"
        )
        self.site = site
        self.attempts = attempts
        self.last = last


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Deterministic bounded retry. ``run(site, fn)`` returns ``fn()``'s
    value, retrying classified-transient failures; raises
    :class:`RetryExhausted` (cause = last error) when attempts run out,
    and re-raises non-retryable errors immediately."""

    max_attempts: int = 3
    base_delay_s: float = 0.02
    max_delay_s: float = 2.0
    backoff: float = 2.0
    jitter: float = 0.25          # fraction of the delay, deterministic
    retryable: Tuple[Type[BaseException], ...] = (OSError, TimeoutError)
    non_retryable: Tuple[Type[BaseException], ...] = (
        FileNotFoundError,
        IsADirectoryError,
        NotADirectoryError,
        FatalInjectedFault,
    )
    sleep: Callable[[float], None] = time.sleep

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")

    def is_retryable(self, exc: BaseException) -> bool:
        if isinstance(exc, self.non_retryable):
            return False
        return isinstance(exc, self.retryable)

    def delay_for(self, site: str, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (1-based). Jitter is a
        pure function of (site, attempt): no RNG state touched."""
        delay = self.base_delay_s * (self.backoff ** (attempt - 1))
        delay = min(delay, self.max_delay_s)
        frac = zlib.crc32(f"{site}:{attempt}".encode()) / 2**32
        return delay * (1.0 + self.jitter * frac)

    def run(
        self,
        site: str,
        fn: Callable[..., Any],
        *args: Any,
        on_retry: Optional[Callable[[int, BaseException], None]] = None,
        **kwargs: Any,
    ) -> Any:
        from photon_ml_tpu_torch.telemetry.metrics import get_registry

        reg = get_registry()
        last: Optional[BaseException] = None
        for attempt in range(1, self.max_attempts + 1):
            reg.count(f"resilience.retry.{site}.attempts")
            try:
                result = fn(*args, **kwargs)
            except BaseException as exc:  # noqa: BLE001 - classified below
                last = exc
                if not self.is_retryable(exc):
                    raise
                if attempt == self.max_attempts:
                    break
                reg.count(f"resilience.retry.{site}.retries")
                if on_retry is not None:
                    on_retry(attempt, exc)
                self.sleep(self.delay_for(site, attempt))
                continue
            if attempt > 1:
                reg.count(f"resilience.retry.{site}.recovered")
            return result
        reg.count(f"resilience.retry.{site}.exhausted")
        record_failure(
            "retry_exhausted",
            site,
            f"{self.max_attempts} attempts: {type(last).__name__}: {last}",
            attempts=self.max_attempts,
            error=type(last).__name__,
        )
        raise RetryExhausted(site, self.max_attempts, last) from last


# The policy every built-in transient-IO seam uses. Three attempts with
# ~20/40ms backoff: enough to ride out EINTR-class flakes without turning
# a permanently bad file into a multi-second stall.
DEFAULT_IO_RETRY = RetryPolicy()

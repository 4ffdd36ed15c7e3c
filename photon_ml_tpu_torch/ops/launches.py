"""Launch counts of the port's hand-written kernels.

Each kernel wrapper adds one to its count where it launches its kernel on
the card, and nowhere else (a wrapper that takes its plain version for a CPU
tensor counts nothing). A run that resets the counts, drives a path and
reads them back shows which kernels that path went through. The async
schedule launches from several threads at once, so counts change under a
lock.
"""

from __future__ import annotations

import threading
from typing import Dict

_counts: Dict[str, int] = {}
_lock = threading.Lock()


def register(name: str) -> None:
    _counts.setdefault(name, 0)


def record(name: str) -> None:
    with _lock:
        _counts[name] += 1


def reset() -> None:
    with _lock:
        for name in _counts:
            _counts[name] = 0


def counts() -> Dict[str, int]:
    with _lock:
        return dict(_counts)

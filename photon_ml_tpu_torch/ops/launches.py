"""Launch counts of the port's hand-written kernels.

Each kernel wrapper adds one to its count where it launches its kernel on
the card, and nowhere else (a wrapper that takes its plain version for a CPU
tensor counts nothing). A run that resets the counts, drives a path and
reads them back shows which kernels that path went through.
"""

from __future__ import annotations

from typing import Dict

_counts: Dict[str, int] = {}


def register(name: str) -> None:
    _counts.setdefault(name, 0)


def record(name: str) -> None:
    _counts[name] += 1


def reset() -> None:
    for name in _counts:
        _counts[name] = 0


def counts() -> Dict[str, int]:
    return dict(_counts)

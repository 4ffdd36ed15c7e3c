"""Threaded native argsort for the big host-side prep sorts.

Counterpart of ``photon_ml_tpu/utils/nativesort.py``:
``lexsort_pairs(major, minor)`` == ``np.lexsort((minor, major))`` (sort by
major, ties by minor, stable), computed by the threaded C++ radix sort in
``native/sortperm.cpp`` for at least 2^16 non-negative keys and by numpy
below that size or for negative keys. Both give the same permutation.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from photon_ml_tpu_torch.utils import nativelib

# below this numpy's constant factors win and threading is noise
_MIN_NATIVE = 1 << 16


def _library() -> ctypes.CDLL:
    lib = nativelib.load_library("sortperm")
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.argsort_pairs.restype = ctypes.c_int
    lib.argsort_pairs.argtypes = [ctypes.c_int64, i64p, i64p, i64p, ctypes.c_int]
    return lib


def lexsort_pairs(major: np.ndarray, minor: Optional[np.ndarray] = None) -> np.ndarray:
    """Stable argsort by (major, minor); equivalent to
    ``np.lexsort((minor, major))`` / ``np.argsort(major, kind="stable")``."""
    major = np.ascontiguousarray(major, dtype=np.int64)
    n = major.shape[0]
    if minor is not None:
        minor = np.ascontiguousarray(minor, dtype=np.int64)
        if minor.shape[0] != n:
            raise ValueError(f"minor key length {minor.shape[0]} != major length {n}")
    native = n >= _MIN_NATIVE and major.min() >= 0 and (minor is None or minor.min() >= 0)
    if not native:
        if minor is None:
            return np.argsort(major, kind="stable")
        return np.lexsort((minor, major))
    lib = _library()
    out = np.empty(n, dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    rc = lib.argsort_pairs(
        ctypes.c_int64(n),
        major.ctypes.data_as(i64p),
        minor.ctypes.data_as(i64p) if minor is not None else None,
        out.ctypes.data_as(i64p),
        ctypes.c_int(max(1, min(os.cpu_count() or 1, 16))),
    )
    if rc != 0:
        raise RuntimeError(f"native argsort_pairs failed (rc {rc})")
    return out

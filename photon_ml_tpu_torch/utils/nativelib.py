"""Build and load the port's host C++ components.

Counterpart of ``photon_ml_tpu/utils/nativelib.py``. Each source
``native/<name>.cpp`` (the Euler-split edge colorer of the routing plans,
the threaded radix argsort, the columnar Avro decoder, the off-heap index
store) is compiled by ``g++`` into a shared library under
``build/photon_ml_tpu_torch/`` at the root of the checkout, at first use,
then loaded with ``ctypes``. The library's file name carries a digest of
the source and of the link flags (``ldflags``, e.g. ``("-lz",)``, placed
after the source so that an ``--as-needed`` linker keeps them), so an
edited source or a changed flag is never served by a stale build; the
build goes to a temporary file that is renamed into place, so concurrent
processes building one library (test workers sharing a checkout) never
load a half-written library.

Unlike the reference, a failed build raises: the numpy colorer walks every
cycle in Python and would take hours at the widths the port routes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Sequence, Tuple

from photon_ml_tpu_torch.utils.cudalib import BUILD_DIR

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"

GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

# (name, ldflags) -> library, so that a call after the first does no file IO
_loaded: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}
_lock = threading.Lock()


def library_path(name: str, ldflags: Sequence[str] = ()) -> Path:
    src = NATIVE_DIR / f"{name}.cpp"
    h = hashlib.sha256(src.read_bytes())
    h.update("\0".join(ldflags).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _build(name: str, ldflags: Sequence[str]) -> None:
    lib = library_path(name, ldflags)
    if lib.exists():
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=str(BUILD_DIR), prefix=f"._{name}_")
    os.close(fd)
    try:
        try:
            subprocess.run(
                ["g++", *GXX_FLAGS, "-o", tmp, str(NATIVE_DIR / f"{name}.cpp"), *ldflags],
                check=True, capture_output=True, text=True,
            )
        except FileNotFoundError as e:
            raise RuntimeError(f"g++ not found; native/{name}.cpp is built at first use") from e
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f"g++ failed for native/{name}.cpp (rc {e.returncode}):\n"
                               f"{e.stdout}{e.stderr}") from e
        os.replace(tmp, str(lib))
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_library(name: str, ldflags: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded host library ``name`` linked with ``ldflags``, built first
    if needed; raises when it cannot be built."""
    key = (name, tuple(ldflags))
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            _build(name, key[1])
            lib = ctypes.CDLL(str(library_path(name, key[1])))
            _loaded[key] = lib
        return lib

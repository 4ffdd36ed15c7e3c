"""Build and load the port's hand-written CUDA kernels.

Each kernel source ``ops/csrc/<name>.cu`` exposes a plain C entry point and
is compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``build/photon_ml_tpu_torch/`` at the root of the checkout, at first use,
then loaded with ``ctypes``. The library's file name carries a digest of
the source and of the shared headers (``ops/csrc/*.cuh``), so an edited
source is never served by a stale build. Builds go
to a temporary file that is renamed into place, so concurrent builders
(test workers sharing a checkout) never load a half-written library.

Nothing here falls back: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC_DIR = Path(__file__).resolve().parent.parent / "ops" / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "photon_ml_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); the "
        "port's CUDA kernels are built from source at first use"
    )


def library_path(name: str) -> Path:
    """Where the library of ``ops/csrc/<name>.cu`` is built: its name
    carries a digest of the source and of every shared header (``*.cuh``)
    beside it."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start ``nvcc`` for one source; returns (process, tmp path, final path)
    or None when the library is already built."""
    lib = library_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=str(BUILD_DIR), prefix=f"._{name}_")
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, lib


def _finish_build(name: str, started) -> str:
    proc, tmp, lib = started
    try:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{out}")
        os.replace(tmp, str(lib))
        return out
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def build_libraries(names: Sequence[str]) -> Dict[str, str]:
    """Build every named kernel library, all ``nvcc`` processes started
    together; returns each build's compiler output (``-Xptxas -v``
    register/spill report), empty for a library that was already built."""
    started = {name: _start_build(name) for name in names}
    return {
        name: _finish_build(name, s) if s is not None else ""
        for name, s in started.items()
    }


def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build_libraries([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib

"""Per-uid on-disk cache directories (the Benes engine's routing plans).

Port of ``photon_ml_tpu/utils/cachedir.py``. A directory lives under the
system tempdir with the uid in its name, is created 0700, and is refused
when someone else owns it or group or other may write it: a directory
planted in the shared sticky tempdir is never trusted.

The JAX module's ``enable_compilation_cache`` points XLA's persistent
compile cache at such a directory. It has no counterpart here: eager
PyTorch compiles nothing per run, and the port's kernels are built once by
nvcc into the git-ignored ``build/photon_ml_tpu_torch/`` directory, keyed
by the digest of their sources (``utils/cudalib.py``).
"""

from __future__ import annotations

import os
import stat
import tempfile
from typing import Optional


def per_uid_cache_dir(name: str) -> Optional[str]:
    """``$TMPDIR/<name>_<uid>`` created 0700, or None when unavailable."""
    uid = os.getuid() if hasattr(os, "getuid") else 0
    path = os.path.join(tempfile.gettempdir(), f"{name}_{uid}")
    try:
        os.makedirs(path, mode=0o700, exist_ok=True)
        st = os.stat(path)
        if st.st_uid != uid or (st.st_mode & (stat.S_IWGRP | stat.S_IWOTH)):
            return None
    except OSError:
        return None
    return path

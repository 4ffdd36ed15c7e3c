"""Shared CLI plumbing used by the scoring driver: logger setup, output
removal, input column names.

Port of the parts of ``photon_ml_tpu/cli/common.py`` that ``score_game``
uses.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import sys
from typing import Dict, Optional

LOGGER_NAME = "photon_ml_tpu_torch"


def setup_logger(level: str = "INFO") -> logging.Logger:
    """Driver logging to stderr; ``PHOTON_LOG_LEVEL`` overrides ``level``.
    Idempotent: a second run in one process does not stack handlers."""
    logger = logging.getLogger(LOGGER_NAME)
    level = os.environ.get("PHOTON_LOG_LEVEL", level)
    resolved = getattr(logging, str(level).upper(), None)
    if not isinstance(resolved, int):
        logger.warning("unknown log level %r, falling back to INFO", level)
        resolved = logging.INFO
    logger.setLevel(resolved)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(name)s %(message)s"))
    logger.addHandler(handler)
    return logger


def delete_dirs_if_exist(*dirs: Optional[str]) -> None:
    """Remove stale output dirs (reference DELETE_OUTPUT_DIR_IF_EXISTS);
    None entries skipped."""
    for d in dirs:
        if d and os.path.isdir(d):
            shutil.rmtree(d)


def parse_input_columns(spec: Optional[str]) -> Dict[str, str]:
    """``--input-columns-names`` JSON → ``read_game_data`` field kwargs
    (reference InputColumnsNames: response/offset/weight/uid)."""
    if not spec:
        return {}
    raw_cols = json.loads(spec)
    allowed = {"response", "offset", "weight", "uid"}
    bad = set(raw_cols) - allowed
    if bad:
        raise ValueError(
            f"--input-columns-names has unknown keys {sorted(bad)}; "
            f"allowed: {sorted(allowed)}"
        )
    return {f"{k}_field": v for k, v in raw_cols.items()}

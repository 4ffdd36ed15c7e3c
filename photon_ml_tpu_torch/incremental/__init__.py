"""Nearline incremental training + delta artifact publishing.

Closes the train → serve → observe → retrain loop: ``incremental_update``
re-solves only the entities a fresh events batch touched (warm-started
through the estimator's own per-entity solvers), ``build_delta``/
``save_delta`` publish just those rows as a fingerprint-chained overlay,
and ``compact`` folds a delta chain back into a full serving artifact. The
serving-side consumer is ``photon_ml_tpu_torch.serving.hotswap``.

Port of ``photon_ml_tpu/incremental``: the re-solves run the port's
estimator on its device (``GameEstimator(device=...)``), and delta
directories are byte-equal to the JAX package's.
"""

from photon_ml_tpu_torch.incremental.delta import (
    DELTA_MANIFEST_FILE,
    DeltaArtifact,
    OverlayIndexMap,
    apply_delta,
    build_delta,
    compact,
    delta_dir_name,
    discover_deltas,
    fingerprint_dir,
    load_delta,
    rebase_delta,
    save_delta,
    verify_chain,
)
from photon_ml_tpu_torch.incremental.trainer import (
    IncrementalUpdate,
    incremental_update,
)

__all__ = [
    "DELTA_MANIFEST_FILE",
    "DeltaArtifact",
    "IncrementalUpdate",
    "OverlayIndexMap",
    "apply_delta",
    "build_delta",
    "compact",
    "delta_dir_name",
    "discover_deltas",
    "fingerprint_dir",
    "incremental_update",
    "load_delta",
    "rebase_delta",
    "save_delta",
    "verify_chain",
]

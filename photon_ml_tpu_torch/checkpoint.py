"""Mid-training checkpoint and resume for GAME coordinate descent.

Port of ``photon_ml_tpu/checkpoint.py``, in the same file format, so a
checkpoint written by either package loads in the other. After every outer
coordinate-descent iteration the training state (each coordinate's model in
its padded-block layout, the best-so-far models, the histories) is written
atomically (a temporary sibling directory, then a rename), so an
interrupted run resumes where it stopped. The reference has no
mid-training checkpoint (its recovery is Spark lineage recompute).

Models are ``.npz`` arrays with JSON metadata (bucket structure included),
not the Avro export format: a resume must restore the exact padded layouts
the coordinates were built with, and a layout fingerprint guards against
resuming with other data or configuration. One process writes. The fault
point ``train.checkpoint.publish`` sits between the fsync and the rename
(``resilience/faultpoints.py``): a fault there must leave the previous
checkpoint loadable.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.device import DEFAULT_DEVICE, DeviceLike, resolve_device
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.models.random_effect import RandomEffectModel
from photon_ml_tpu_torch.projector import ProjectorType
from photon_ml_tpu_torch.resilience.faultpoints import fault_point, register_fault_site
from photon_ml_tpu_torch.types import TaskType

STATE_FILE = "training-state.json"
_FORMAT_VERSION = 1
_TMP_PREFIX = ".ckpt-tmp-"
_OLD_PREFIX = ".ckpt-old-"

FAULT_PUBLISH = register_fault_site(
    "train.checkpoint.publish",
    "between the checkpoint tmp-dir fsync and the atomic rename — a fault "
    "here must leave the previous checkpoint loadable",
)


# ------------------------------------------------------------- serialization

def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _save_glm(d: str, m: GeneralizedLinearModel) -> dict:
    arrays = {"means": _np(m.coefficients.means)}
    if m.coefficients.variances is not None:
        arrays["variances"] = _np(m.coefficients.variances)
    np.savez(os.path.join(d, "glm.npz"), **arrays)
    return {"kind": "glm", "task": m.task.name}


def _load_glm(d: str, meta: dict, dev: torch.device) -> GeneralizedLinearModel:
    z = np.load(os.path.join(d, "glm.npz"))
    return GeneralizedLinearModel(
        coefficients=Coefficients(
            means=torch.from_numpy(z["means"]).to(dev),
            variances=torch.from_numpy(z["variances"]).to(dev) if "variances" in z else None,
        ),
        task=TaskType[meta["task"]],
    )


def _save_re(d: str, m: RandomEffectModel) -> dict:
    arrays = {}
    for b in range(len(m.coefficients)):
        arrays[f"coef_{b}"] = _np(m.coefficients[b])
        # int32 on disk, as the JAX package writes its index blocks
        arrays[f"idx_{b}"] = _np(m.proj_indices[b]).astype(np.int32)
        arrays[f"valid_{b}"] = _np(m.proj_valid[b])
        if m.variances[b] is not None:
            arrays[f"var_{b}"] = _np(m.variances[b])
    np.savez(os.path.join(d, "re.npz"), **arrays)
    return {
        "kind": "random_effect",
        "task": m.task.name,
        "random_effect_type": m.random_effect_type,
        "entity_ids": m.entity_ids,
        "global_dim": m.global_dim,
        "projector_type": m.projector_type.name,
        "projection_seed": m.projection_seed,
        "num_buckets": len(m.coefficients),
    }


def _load_re(d: str, meta: dict, dev: torch.device) -> RandomEffectModel:
    z = np.load(os.path.join(d, "re.npz"))
    nb = meta["num_buckets"]
    entity_ids: List[List[str]] = [list(ids) for ids in meta["entity_ids"]]

    def put(a: np.ndarray, dtype=None) -> torch.Tensor:
        return torch.from_numpy(a if dtype is None else a.astype(dtype)).to(dev)

    return RandomEffectModel(
        random_effect_type=meta["random_effect_type"],
        task=TaskType[meta["task"]],
        coefficients=[put(z[f"coef_{b}"]) for b in range(nb)],
        variances=[put(z[f"var_{b}"]) if f"var_{b}" in z else None for b in range(nb)],
        proj_indices=[put(z[f"idx_{b}"], np.int64) for b in range(nb)],
        proj_valid=[put(z[f"valid_{b}"]) for b in range(nb)],
        entity_ids=entity_ids,
        entity_to_loc={
            eid: (b, e) for b, ids in enumerate(entity_ids) for e, eid in enumerate(ids)
        },
        global_dim=meta["global_dim"],
        projector_type=ProjectorType[meta["projector_type"]],
        projection_seed=meta.get("projection_seed", 0),
    )


def _save_factored(d: str, m) -> dict:
    latent_dir = os.path.join(d, "latent")
    os.makedirs(latent_dir, exist_ok=True)
    latent_meta = _save_re(latent_dir, m.latent)
    np.savez(os.path.join(d, "projection.npz"), projection_matrix=_np(m.projection_matrix))
    return {
        "kind": "factored_random_effect",
        "task": m.task.name,
        "random_effect_type": m.random_effect_type,
        "latent": latent_meta,
    }


def _load_factored(d: str, meta: dict, dev: torch.device):
    from photon_ml_tpu_torch.algorithm.factored_random_effect import (
        FactoredRandomEffectModel,
    )

    z = np.load(os.path.join(d, "projection.npz"))
    return FactoredRandomEffectModel(
        random_effect_type=meta["random_effect_type"],
        task=TaskType[meta["task"]],
        latent=_load_re(os.path.join(d, "latent"), meta["latent"], dev),
        projection_matrix=torch.from_numpy(z["projection_matrix"]).to(dev),
    )


def _save_submodel(d: str, model) -> dict:
    from photon_ml_tpu_torch.algorithm.factored_random_effect import (
        FactoredRandomEffectModel,
    )

    os.makedirs(d, exist_ok=True)
    if isinstance(model, GeneralizedLinearModel):
        return _save_glm(d, model)
    if isinstance(model, RandomEffectModel):
        return _save_re(d, model)
    if isinstance(model, FactoredRandomEffectModel):
        return _save_factored(d, model)
    raise TypeError(f"cannot checkpoint sub-model type {type(model)}")


_LOADERS = {"glm": _load_glm, "random_effect": _load_re, "factored_random_effect": _load_factored}


def _load_submodel(d: str, meta: dict, dev: torch.device):
    loader = _LOADERS.get(meta["kind"])
    if loader is None:
        raise ValueError(f"unknown checkpoint sub-model kind: {meta['kind']}")
    return loader(d, meta, dev)


def model_fingerprint(models: Dict[str, object]) -> Dict[str, list]:
    """Shape signature per coordinate, a resume sanity check (bucket counts,
    entity counts and local dims must match the rebuilt datasets)."""
    out = {}
    for cid, m in models.items():
        if isinstance(m, GeneralizedLinearModel):
            out[cid] = ["glm", int(m.dim)]
        elif isinstance(m, RandomEffectModel):
            out[cid] = ["re"] + [list(c.shape) for c in m.coefficients]
        else:
            out[cid] = ["fre", list(m.projection_matrix.shape)] + [
                list(c.shape) for c in m.latent.coefficients
            ]
    return out


# ------------------------------------------------------------------ save/load

def _sweep_orphans(parent: str, keep: str) -> None:
    """Delete leftover ``.ckpt-tmp-*`` / ``.ckpt-old-*`` sibling directories
    (a kill between the two renames, or mid-build, leaks them). Runs after a
    successful save or load, so any such directory other than ``keep`` is
    an orphan (one writer per parent directory)."""
    try:
        names = os.listdir(parent)
    except OSError:
        return
    for name in names:
        if not (name.startswith(_TMP_PREFIX) or name.startswith(_OLD_PREFIX)):
            continue
        full = os.path.join(parent, name)
        if full != keep and os.path.isdir(full):
            shutil.rmtree(full, ignore_errors=True)


def _prune_numbered_siblings(directory: str, keep_last_n: int) -> None:
    """Keep the ``keep_last_n`` highest-numbered sibling checkpoints that
    share ``directory``'s prefix (``ckpt-000010``), delete the rest. Only
    directories that hold a checkpoint state file are touched."""
    if keep_last_n < 1:
        raise ValueError(f"keep_last_n must be >= 1, got {keep_last_n}")
    base = os.path.basename(os.path.abspath(directory))
    m = re.match(r"^(.*?)(\d+)$", base)
    if m is None:
        raise ValueError(
            f"keep_last_n needs an iteration-numbered checkpoint directory "
            f"name (e.g. 'ckpt-000010'), got {base!r}"
        )
    prefix = m.group(1)
    parent = os.path.dirname(os.path.abspath(directory)) or "."
    numbered = []
    for name in os.listdir(parent):
        mm = re.match(rf"^{re.escape(prefix)}(\d+)$", name)
        full = os.path.join(parent, name)
        if mm and os.path.isfile(os.path.join(full, STATE_FILE)):
            numbered.append((int(mm.group(1)), full))
    numbered.sort()
    for _, full in numbered[:-keep_last_n]:
        shutil.rmtree(full, ignore_errors=True)


def save_training_checkpoint(
    directory: str,
    models: Dict[str, object],
    state: dict,
    best_models: Optional[Dict[str, object]] = None,
    keep_last_n: Optional[int] = None,
) -> None:
    """Atomically write a checkpoint: build it in a temporary sibling
    directory, fsync the state file, then rename it over ``directory``. A
    successful save also sweeps orphaned temporary siblings, and
    ``keep_last_n`` prunes older iteration-numbered siblings (the directory
    name must end in digits, e.g. ``ckpt-000010``)."""
    parent = os.path.dirname(os.path.abspath(directory)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=_TMP_PREFIX, dir=parent)
    try:
        meta = {
            cid: _save_submodel(os.path.join(tmp, "models", cid), model)
            for cid, model in models.items()
        }
        best_meta = None
        if best_models is not None:
            best_meta = {
                cid: _save_submodel(os.path.join(tmp, "best", cid), model)
                for cid, model in best_models.items()
            }
        payload = {
            "version": _FORMAT_VERSION,
            "state": state,
            "models": meta,
            "best_models": best_meta,
            "fingerprint": model_fingerprint(models),
        }
        with open(os.path.join(tmp, STATE_FILE), "w") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        fault_point(FAULT_PUBLISH)
        # move the old checkpoint aside first, so that a kill at any point
        # leaves either the old or the new one loadable
        old = None
        if os.path.isdir(directory):
            old = tempfile.mkdtemp(prefix=_OLD_PREFIX, dir=parent)
            os.rmdir(old)
            os.replace(directory, old)
        os.replace(tmp, directory)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _sweep_orphans(parent, keep=tmp)
    if keep_last_n is not None:
        _prune_numbered_siblings(directory, keep_last_n)


def has_checkpoint(directory: str) -> bool:
    return os.path.isfile(os.path.join(directory, STATE_FILE))


def load_training_checkpoint(
    directory: str, device: DeviceLike = DEFAULT_DEVICE
) -> Tuple[Dict[str, object], dict, Optional[Dict[str, object]]]:
    """→ (models, state, best_models or None), the models on ``device``.

    A successful load also sweeps orphaned temporary siblings (resume is
    the earliest safe point to reclaim them); it runs after the state file
    parses, so a corrupt checkpoint never deletes what an operator might
    recover."""
    dev = resolve_device(device)
    directory = os.path.abspath(directory)
    with open(os.path.join(directory, STATE_FILE)) as f:
        payload = json.load(f)
    if payload.get("version") != _FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version: {payload.get('version')}")
    models = {
        cid: _load_submodel(os.path.join(directory, "models", cid), meta, dev)
        for cid, meta in payload["models"].items()
    }
    best = None
    if payload.get("best_models") is not None:
        best = {
            cid: _load_submodel(os.path.join(directory, "best", cid), meta, dev)
            for cid, meta in payload["best_models"].items()
        }
    _sweep_orphans(os.path.dirname(directory) or ".", keep=directory)
    return models, payload["state"], best

"""Carry a GAME model's weights across between the JAX package and the
port.

:func:`game_model_from_numpy` takes the arrays of a ``photon_ml_tpu``
``GameModel`` — a scoring model or a ``GameFit``'s trained models — as numpy
(``np.asarray`` of each device array) and builds the port's
:class:`~photon_ml_tpu_torch.models.game.GameModel` on a device, so that
both packages can score one model, or the port can warm-start training from
it (``GameEstimator.fit(initial_models=model.models)``).
:func:`game_model_to_numpy` is its inverse, for comparing the port's
fitted models with the reference's. Enum-valued fields (task, projector
type) may be given as this package's enums, as the JAX package's (matched
by name) or as strings. :func:`normalization_context_from_numpy` carries a
``NormalizationContext`` across the same way, from its ``factor`` and
``shift`` as numpy.

A model trained on a (data x feat) device grid in either package pads
each random-effect bucket's entity axis to the grid (lanes with no entity
id); :func:`game_model_from_numpy` trims those lanes, so a grid fit and a
single-device fit of either package compare, and warm-start one another,
from the same numpy arrays.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from photon_ml_tpu_torch.device import DEFAULT_DEVICE, DeviceLike, resolve_device
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.game import CoordinateMeta, GameModel
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.models.random_effect import RandomEffectModel
from photon_ml_tpu_torch.normalization import NormalizationContext
from photon_ml_tpu_torch.projector import ProjectorType
from photon_ml_tpu_torch.types import TaskType


def _task(task) -> TaskType:
    return TaskType[task if isinstance(task, str) else task.name]


def _projector(p) -> ProjectorType:
    return ProjectorType[p.upper() if isinstance(p, str) else p.name]


def game_model_from_numpy(
    coordinates: Mapping[str, Mapping[str, Any]],
    task,
    device: DeviceLike = DEFAULT_DEVICE,
) -> GameModel:
    """Build the port's GameModel from per-coordinate numpy arrays.

    ``coordinates`` maps a coordinate id to a dict with the coordinate
    metadata (``feature_shard``, and ``random_effect_type`` for a random
    effect; optional ``sparse_engine``) and either

    - a fixed effect: ``means`` [d] and optional ``variances`` [d]; or
    - a random effect: per-bucket lists ``coefficients`` [E_b, D_b],
      ``proj_indices`` [E_b, D_b], ``proj_valid`` [E_b, D_b] and optional
      ``variances``; ``entity_ids`` (per-bucket lists of ids),
      ``entity_to_loc`` (id -> (bucket, row)), ``global_dim``, and optional
      ``projector_type`` and ``projection_seed``.

    Insertion order of ``coordinates`` is the order scores are summed in.
    A bucket's rows past its ``entity_ids`` (a grid fit's entity padding)
    are dropped.
    """
    dev = resolve_device(device)
    task = _task(task)

    def t(a, dtype) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)  # a writable copy

    models: Dict[str, object] = {}
    meta: Dict[str, CoordinateMeta] = {}
    for cid, c in coordinates.items():
        meta[cid] = CoordinateMeta(
            feature_shard=c["feature_shard"],
            random_effect_type=c.get("random_effect_type"),
            sparse_engine=c.get("sparse_engine", "auto"),
        )
        if "means" in c:
            var = c.get("variances")
            models[cid] = GeneralizedLinearModel(
                coefficients=Coefficients(
                    means=t(c["means"], np.float32),
                    variances=None if var is None else t(var, np.float32),
                ),
                task=task,
            )
            continue
        n_buckets = len(c["coefficients"])
        variances = c.get("variances") or [None] * n_buckets
        real = [len(ids) for ids in c["entity_ids"]]

        def lanes(arrays, dtype):
            return [None if a is None else t(np.asarray(a)[:k], dtype)
                    for a, k in zip(arrays, real)]

        models[cid] = RandomEffectModel(
            random_effect_type=c["random_effect_type"],
            task=task,
            coefficients=lanes(c["coefficients"], np.float32),
            variances=lanes(variances, np.float32),
            proj_indices=lanes(c["proj_indices"], np.int64),
            proj_valid=lanes(c["proj_valid"], np.bool_),
            entity_ids=[[str(e) for e in ids] for ids in c["entity_ids"]],
            entity_to_loc={
                str(k): (int(b), int(e)) for k, (b, e) in c["entity_to_loc"].items()
            },
            global_dim=int(c["global_dim"]),
            projector_type=_projector(c.get("projector_type", ProjectorType.INDEX_MAP)),
            projection_seed=int(c.get("projection_seed", 0)),
        )
    return GameModel(models=models, meta=meta, task=task)


def game_model_to_numpy(model: GameModel) -> Dict[str, Dict[str, Any]]:
    """The port's GameModel as per-coordinate numpy arrays, in the form
    :func:`game_model_from_numpy` takes."""

    def arr(t):
        return None if t is None else t.detach().cpu().numpy()

    out: Dict[str, Dict[str, Any]] = {}
    for cid, sub in model.models.items():
        meta = model.meta[cid]
        c: Dict[str, Any] = {
            "feature_shard": meta.feature_shard,
            "random_effect_type": meta.random_effect_type,
            "sparse_engine": meta.sparse_engine,
        }
        if isinstance(sub, GeneralizedLinearModel):
            c["means"] = arr(sub.coefficients.means)
            c["variances"] = arr(sub.coefficients.variances)
        else:
            c.update(
                coefficients=[arr(w) for w in sub.coefficients],
                variances=[arr(v) for v in sub.variances],
                proj_indices=[arr(p) for p in sub.proj_indices],
                proj_valid=[arr(p) for p in sub.proj_valid],
                entity_ids=[list(ids) for ids in sub.entity_ids],
                entity_to_loc=dict(sub.entity_to_loc),
                global_dim=sub.global_dim,
                projector_type=sub.projector_type,
                projection_seed=sub.projection_seed,
            )
        out[cid] = c
    return out


def normalization_context_from_numpy(
    factor, shift, device: DeviceLike = DEFAULT_DEVICE
) -> NormalizationContext:
    """The port's NormalizationContext from ``factor`` and ``shift`` [d]
    arrays (``np.asarray`` of the JAX context's fields; None for a field the
    context does not have)."""
    dev = resolve_device(device)

    def t(a):
        return None if a is None else torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    return NormalizationContext(factor=t(factor), shift=t(shift))

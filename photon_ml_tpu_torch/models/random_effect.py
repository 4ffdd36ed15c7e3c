"""Random-effect model: one small GLM per entity, stored as padded blocks.

Port of ``photon_ml_tpu/models/random_effect.py`` (reference
RandomEffectModel.scala:38 and RandomEffectModelInProjectedSpace): the same
fields, with the per-bucket blocks as tensors on the model's device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.device import DEFAULT_DEVICE, DeviceLike, resolve_device
from photon_ml_tpu_torch.projector import ProjectorType, RandomProjectionMatrix
from photon_ml_tpu_torch.types import TaskType


@dataclasses.dataclass
class RandomEffectModel:
    """Per-bucket local-space coefficients (entity ``e`` of bucket ``b`` has
    local feature ``j`` = global feature ``proj_indices[b][e, j]`` where
    ``proj_valid[b][e, j]``)."""

    random_effect_type: str
    task: TaskType
    coefficients: List[torch.Tensor]            # per bucket [E_b, D_b] f32
    variances: List[Optional[torch.Tensor]]     # per bucket [E_b, D_b] or None
    proj_indices: List[torch.Tensor]            # per bucket [E_b, D_b] int64
    proj_valid: List[torch.Tensor]              # per bucket [E_b, D_b] bool
    entity_ids: List[List[str]]
    entity_to_loc: Dict[str, Tuple[int, int]]
    global_dim: int
    projector_type: ProjectorType = ProjectorType.INDEX_MAP
    projection_seed: int = 0

    def __post_init__(self) -> None:
        self._positions: Optional[Dict[str, int]] = None
        self._table: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    @property
    def device(self) -> torch.device:
        return self.coefficients[0].device

    @property
    def num_entities(self) -> int:
        return sum(len(ids) for ids in self.entity_ids)

    def back_projection_matrix(self, projected_dim: int) -> RandomProjectionMatrix:
        return RandomProjectionMatrix(
            projected_dim=projected_dim,
            global_dim=self.global_dim,
            seed=self.projection_seed,
        )

    def entity_positions(self, entity_ids) -> np.ndarray:
        """Per row, the entity's position in the bucket-concatenated entity
        order (bucket offset + row in bucket), or -1 for an entity the model
        has not seen. The id strings are looked up on the host once per
        distinct id."""
        if self._positions is None:
            offsets = np.cumsum([0] + [len(ids) for ids in self.entity_ids])
            self._positions = {
                eid: int(offsets[b]) + e for eid, (b, e) in self.entity_to_loc.items()
            }
        ids = np.asarray(entity_ids).astype(str)
        uniq, inverse = np.unique(ids, return_inverse=True)
        pos = np.fromiter(
            (self._positions.get(u, -1) for u in uniq.tolist()),
            dtype=np.int64, count=uniq.size,
        )
        return pos[inverse.reshape(-1)]

    def score_table(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sorted keys ``position * (global_dim + 1) + feature`` of every valid
        (entity, feature) pair, and the coefficient of each, on the model's
        device (built once). Scoring looks a nonzero up with one
        ``searchsorted``; a feature outside the entity's projected space has
        no key and scores 0."""
        if self._table is None:
            stride = self.global_dim + 1
            keys, weights = [], []
            base = 0
            for w, idx, valid in zip(self.coefficients, self.proj_indices, self.proj_valid):
                e, j = torch.nonzero(valid, as_tuple=True)
                keys.append((base + e) * stride + idx[e, j].long())
                weights.append(w[e, j])
                base += w.shape[0]
            keys_all = torch.cat(keys)
            keys_sorted, order = torch.sort(keys_all, stable=True)
            self._table = (keys_sorted, torch.cat(weights)[order])
        return self._table

    def items(self) -> Iterator[Tuple[str, Dict[int, float]]]:
        """Iterate (entity_id, sparse global coefficients) — export order."""
        b_full = None  # shared across buckets (same seed/global_dim/k)
        for b, ids in enumerate(self.entity_ids):
            w_b = self.coefficients[b].cpu().numpy()
            if self.projector_type is ProjectorType.RANDOM:
                if b_full is None:
                    proj = self.back_projection_matrix(w_b.shape[1])
                    b_full = proj.rows(np.arange(self.global_dim, dtype=np.int64))
                vals_b = w_b @ b_full.T  # [Eb, global_dim]
                for e, eid in enumerate(ids):
                    yield eid, {int(i): float(v) for i, v in enumerate(vals_b[e])}
                continue
            idx_b = self.proj_indices[b].cpu().numpy()
            val_b = self.proj_valid[b].cpu().numpy()
            for e, eid in enumerate(ids):
                yield eid, {
                    int(i): float(v)
                    for i, v, ok in zip(idx_b[e], w_b[e], val_b[e])
                    if ok
                }

    def variances_by_entity(self) -> Dict[str, Dict[int, float]]:
        """Per-entity sparse global-space variances (INDEX_MAP/IDENTITY only:
        variances are not back-projectable through a random projection)."""
        out: Dict[str, Dict[int, float]] = {}
        for b, ids in enumerate(self.entity_ids):
            if self.variances[b] is None:
                continue
            var_b = self.variances[b].cpu().numpy()
            idx_b = self.proj_indices[b].cpu().numpy()
            ok_b = self.proj_valid[b].cpu().numpy()
            for e, eid in enumerate(ids):
                out[eid] = {
                    int(i): float(v) for i, v, ok in zip(idx_b[e], var_b[e], ok_b[e]) if ok
                }
        return out

    @classmethod
    def from_entity_coefficients(
        cls,
        random_effect_type: str,
        task: TaskType,
        entity_coefficients: Dict[str, Dict[int, float]],
        global_dim: int,
        entity_variances: Optional[Dict[str, Dict[int, float]]] = None,
        device: DeviceLike = DEFAULT_DEVICE,
    ) -> "RandomEffectModel":
        """A single-bucket, INDEX_MAP-projected model from per-entity sparse
        global-space coefficients — the model-load path."""
        dev = resolve_device(device)
        ids = list(entity_coefficients)
        entity_variances = entity_variances or {}
        # local feature set per entity = union of mean and variance indices
        local: Dict[str, List[int]] = {
            eid: sorted(
                set(entity_coefficients[eid]) | set(entity_variances.get(eid, ()))
            )
            for eid in ids
        }
        d_local = max((len(f) for f in local.values()), default=1) or 1
        n = len(ids)
        idx = np.full((n, d_local), global_dim, dtype=np.int64)
        valid = np.zeros((n, d_local), dtype=bool)
        w = np.zeros((n, d_local), dtype=np.float32)
        var = np.zeros((n, d_local), dtype=np.float32)
        has_var = False
        for e, eid in enumerate(ids):
            coefs = entity_coefficients[eid]
            vars_e = entity_variances.get(eid)
            for j, i in enumerate(local[eid]):
                idx[e, j] = i
                w[e, j] = coefs.get(i, 0.0)
                valid[e, j] = True
                if vars_e is not None:
                    var[e, j] = vars_e.get(i, 0.0)
            has_var = has_var or vars_e is not None
        return cls(
            random_effect_type=random_effect_type,
            task=task,
            coefficients=[torch.from_numpy(w).to(dev)],
            variances=[torch.from_numpy(var).to(dev) if has_var else None],
            proj_indices=[torch.from_numpy(idx).to(dev)],
            proj_valid=[torch.from_numpy(valid).to(dev)],
            entity_ids=[ids],
            entity_to_loc={eid: (0, e) for e, eid in enumerate(ids)},
            global_dim=global_dim,
            projector_type=ProjectorType.INDEX_MAP,
        )

"""GAME model: named sub-models summed into one score.

Port of ``photon_ml_tpu/models/game.py`` (reference model/GameModel.scala:32
and the fixed/random-effect scoring semantics): a fixed-effect model scores
every row; a random-effect model scores rows whose entity it has seen, and
others contribute 0 (the reference's left join); so does a factored
random-effect model, through its projection matrix. Scoring runs as torch
ops on the model's device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

from photon_ml_tpu_torch.data.game_data import FeatureShard, GameData
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.models.random_effect import RandomEffectModel
from photon_ml_tpu_torch.ops.features import scatter_add
from photon_ml_tpu_torch.projector import ProjectorType
from photon_ml_tpu_torch.types import TaskType


@dataclasses.dataclass(frozen=True)
class CoordinateMeta:
    """What a coordinate consumes: which feature shard, and (for random
    effects) which id tag names its entity."""

    feature_shard: str
    random_effect_type: Optional[str] = None
    # sparse engine the coordinate was configured with (fixed effects)
    sparse_engine: str = "auto"


SubModel = Union[GeneralizedLinearModel, RandomEffectModel, "FactoredRandomEffectModel"]


@dataclasses.dataclass
class GameModel:
    models: Dict[str, SubModel]
    meta: Dict[str, CoordinateMeta]
    task: TaskType

    def __post_init__(self) -> None:
        for cid in self.models:
            if cid not in self.meta:
                raise ValueError(f"coordinate {cid} missing metadata")
        devices = {sub.device for sub in self.models.values()}
        if len(devices) > 1:
            raise ValueError(f"sub-models on several devices: {sorted(map(str, devices))}")

    @property
    def device(self) -> torch.device:
        return next(iter(self.models.values())).device

    def score_coordinate(self, cid: str, data: GameData) -> torch.Tensor:
        """Raw scores of one sub-model over GameData rows, on the model's
        device."""
        model = self.models[cid]
        m = self.meta[cid]
        shard = data.feature_shards[m.feature_shard]
        if isinstance(model, GeneralizedLinearModel):
            return model.compute_score(
                data.sparse_features(
                    m.feature_shard, engine=m.sparse_engine, device=model.device
                )
            )
        if m.random_effect_type is None:
            raise ValueError(f"random-effect coordinate {cid} names no id tag")
        entity_ids = data.id_tags[m.random_effect_type]
        if isinstance(model, RandomEffectModel):
            return _score_re_rows(model, shard, entity_ids, data.num_rows)
        return _score_factored_re_rows(model, shard, entity_ids, data.num_rows)

    def score(self, data: GameData) -> torch.Tensor:
        """Sum of sub-model scores per row (no offsets; reference
        GameModel.score). Evaluation adds data.offsets on top."""
        total = torch.zeros(data.num_rows, dtype=torch.float32, device=self.device)
        for cid in self.models:
            total += self.score_coordinate(cid, data)
        return total


def _score_factored_re_rows(model, shard: FeatureShard, entity_ids, num_rows: int) -> torch.Tensor:
    """Score arbitrary rows against a factored random-effect model, on the
    device: per nonzero (r, c, v), v·(B[c] · latent_{entity(r)}); rows whose
    entity is unseen score 0 (reference FactoredRandomEffectModel scoring
    through the projection matrix)."""
    B = model.projection_matrix
    dev = B.device
    out = torch.zeros(num_rows, dtype=torch.float32, device=dev)
    if len(shard.rows) == 0:
        return out
    if int(np.max(shard.cols)) >= B.shape[0]:
        raise ValueError(
            f"feature column {int(np.max(shard.cols))} outside the projection "
            f"matrix's {B.shape[0]} rows"
        )
    pos_of_row = torch.from_numpy(model.latent.entity_positions(entity_ids)).to(dev)
    rows = torch.from_numpy(shard.rows.astype("int64", copy=False)).to(dev)
    cols = torch.from_numpy(shard.cols.astype("int64", copy=False)).to(dev)
    vals = torch.from_numpy(shard.vals.astype("float32", copy=False)).to(dev)
    pos = pos_of_row[rows]
    latents = torch.cat(model.latent.coefficients)
    contrib = vals * (B[cols] * latents[pos.clamp(min=0)]).sum(dim=1)
    contrib = torch.where(pos >= 0, contrib, torch.zeros_like(contrib))
    return scatter_add(out, rows, contrib)


def _score_re_rows(
    model: RandomEffectModel, shard: FeatureShard, entity_ids, num_rows: int
) -> torch.Tensor:
    """Score arbitrary rows against per-entity local models, on the device.

    Per nonzero (r, c, v) of row r with entity e: v * w_e[c] when c lies in
    e's projected space, else 0 (the feature is dropped, reference
    index-map projection semantics). Rows whose entity is unseen score 0
    (reference RandomEffectModel left join).
    """
    dev = model.device
    out = torch.zeros(num_rows, dtype=torch.float32, device=dev)
    if len(shard.rows) == 0:
        return out
    pos_of_row = torch.from_numpy(model.entity_positions(entity_ids)).to(dev)
    rows = torch.from_numpy(shard.rows.astype("int64", copy=False)).to(dev)
    cols = torch.from_numpy(shard.cols.astype("int64", copy=False)).to(dev)
    vals = torch.from_numpy(shard.vals.astype("float32", copy=False)).to(dev)
    pos = pos_of_row[rows]
    seen = pos >= 0
    pos = pos.clamp(min=0)

    if model.projector_type is ProjectorType.RANDOM:
        # the model lives in the shared Gaussian-projected space: each
        # nonzero scores v * (B[c] . w_entity); B rows are regenerated on the
        # host for the distinct columns only
        uniq_c, inv = torch.unique(cols, return_inverse=True)
        k = model.coefficients[0].shape[1]
        b_rows = torch.from_numpy(
            model.back_projection_matrix(k).rows(uniq_c.cpu().numpy())
        ).to(dev)
        w_all = torch.cat(model.coefficients)
        contrib = vals * (b_rows[inv] * w_all[pos]).sum(dim=1)
    else:
        keys, weights = model.score_table()
        if keys.numel() == 0:
            return out
        stride = model.global_dim + 1
        query = pos * stride + cols
        j = torch.searchsorted(keys, query).clamp(max=keys.numel() - 1)
        # a column past the model's space would alias the next entity's key
        hit = (keys[j] == query) & (cols < stride)
        contrib = torch.where(hit, vals * weights[j], torch.zeros_like(vals))
    contrib = torch.where(seen, contrib, torch.zeros_like(contrib))
    return scatter_add(out, rows, contrib)

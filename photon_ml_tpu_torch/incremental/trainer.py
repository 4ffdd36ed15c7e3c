"""Nearline incremental trainer: warm-started re-solves of only the
entities a fresh events batch touched.

A full retrain re-solves every entity of every random-effect coordinate;
a nearline batch of events touches a tiny fraction of them. The per-entity
problems are independent (the whole point of the random-effect block
structure), so re-solving JUST the touched rows against the current fixed
effects produces exactly the rows a full warm-started CD pass would — the
incremental-equals-full property the regression test pins down.

The mechanism is the estimator's own machinery, not a parallel code path:
``GameEstimator.resolve_coordinate`` builds the coordinate's dataset over
the events batch (which by construction contains exactly the touched
entities), scores the other coordinates' models as residual offsets, and
re-runs the same batched per-entity solver (on the card its value and
gradient are the ``fused_value_grad_batched_f32`` kernel) with the old rows
as warm starts
(``align_warm_start`` joins them by entity id; unseen entities start at
zero, i.e. fresh rows). Fixed effects can optionally be refreshed first
with K frozen-RE passes over the events batch (on the card, an events shard
of at least 2^20 nonzeros runs the ``fused`` engine's ``csr_matvec_f32`` and
``csc_rmatvec_f32``).

Port of ``photon_ml_tpu/incremental/trainer.py``: the models, the re-solves
and the merged rows live on the estimator's device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from photon_ml_tpu_torch.data.game_data import GameData
from photon_ml_tpu_torch.estimators.game import (
    FixedEffectCoordinateConfiguration,
    GameEstimator,
    RandomEffectCoordinateConfiguration,
)
from photon_ml_tpu_torch.models.game import GameModel
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.models.random_effect import RandomEffectModel
from photon_ml_tpu_torch.parallel.mesh import fetch_global
from photon_ml_tpu_torch.telemetry import span


@dataclasses.dataclass
class IncrementalUpdate:
    """Result of one nearline update.

    ``re_updates[cid][entity_id]`` holds the re-solved sparse global-space
    coefficient row for every touched entity — exactly the payload of a
    delta artifact. ``models`` is the full merged sub-model map (old rows
    overlaid with the re-solved ones) unless the update ran with
    ``merge=False``, in which case RE entries contain only the touched
    entities."""

    models: Dict[str, object]
    re_updates: Dict[str, Dict[str, Dict[int, float]]]
    fe_updates: Dict[str, np.ndarray]
    touched_entities: Dict[str, Tuple[str, ...]]
    new_entities: Dict[str, Tuple[str, ...]]
    num_events: int
    # per-coordinate SolverStats (opt.tracking) from the warm-started RE
    # re-solves — the convergence-adaptive solver's lane telemetry; nearline
    # batches have the largest iteration skew so the savings show up here
    solver_stats: Dict[str, list] = dataclasses.field(default_factory=dict)
    # per-coordinate TransferStats (opt.tracking) from the same re-solves:
    # on the device score plane each re-solve uploads exactly one residual
    # array and regroups offsets on device (zero further row transfers)
    transfer_stats: Dict[str, object] = dataclasses.field(default_factory=dict)

    def game_model(self, estimator: GameEstimator) -> GameModel:
        return GameModel(
            models=dict(self.models), meta=estimator._meta(), task=estimator.task
        )


def _load_models(
    model: Union[GameModel, Dict[str, object], str], device,
) -> Dict[str, object]:
    if isinstance(model, GameModel):
        return dict(model.models)
    if isinstance(model, str):
        from photon_ml_tpu_torch.checkpoint import load_training_checkpoint

        models, _, _ = load_training_checkpoint(model, device=device)
        return models
    return dict(model)


def incremental_update(
    estimator: GameEstimator,
    model: Union[GameModel, Dict[str, object], str],
    events: GameData,
    refresh_fixed_iterations: int = 0,
    merge: bool = True,
) -> IncrementalUpdate:
    """Warm-started nearline update of ``model`` with a batch of new events.

    ``model`` may be a trained ``GameModel``, its sub-model dict, or a
    training checkpoint directory. Coordinates are visited in the
    estimator's ``update_order``: first ``refresh_fixed_iterations`` passes
    over the fixed-effect coordinates with the random effects frozen, then
    one warm-started re-solve per plain random-effect coordinate covering
    exactly the entities present in ``events`` (later coordinates see
    earlier re-solves through the residual offsets — the CD invariant).
    Factored RE coordinates are passed through untouched.

    ``merge=False`` skips folding the re-solved rows back into full RE
    models (``models[cid]`` then holds ONLY the touched entities) — the
    cheap mode for delta-publishing pipelines that never score the merged
    model host-side.
    """
    with span(
        "incremental/update",
        num_events=events.num_rows,
        refresh_fixed_iterations=int(refresh_fixed_iterations),
        merge=merge,
    ):
        return _incremental_update_impl(
            estimator, model, events, refresh_fixed_iterations, merge
        )


def _incremental_update_impl(
    estimator: GameEstimator,
    model: Union[GameModel, Dict[str, object], str],
    events: GameData,
    refresh_fixed_iterations: int,
    merge: bool,
) -> IncrementalUpdate:
    models = _load_models(model, estimator.device)
    fe_cids = [
        cid
        for cid in estimator.update_order
        if isinstance(
            estimator.coordinate_configs.get(cid),
            FixedEffectCoordinateConfiguration,
        )
    ]
    re_cids = [
        cid
        for cid in estimator.update_order
        if isinstance(
            estimator.coordinate_configs.get(cid),
            RandomEffectCoordinateConfiguration,
        )
    ]

    fe_updates: Dict[str, np.ndarray] = {}
    for _ in range(max(0, int(refresh_fixed_iterations))):
        for cid in fe_cids:
            with span("incremental/resolve", coordinate=cid, kind="fixed"):
                sub = estimator.resolve_coordinate(cid, events, models)
            assert isinstance(sub, GeneralizedLinearModel)
            models[cid] = sub
            fe_updates[cid] = np.asarray(
                fetch_global(sub.coefficients.means), dtype=np.float32
            )

    re_updates: Dict[str, Dict[str, Dict[int, float]]] = {}
    touched: Dict[str, Tuple[str, ...]] = {}
    new: Dict[str, Tuple[str, ...]] = {}
    solver_stats: Dict[str, list] = {}
    transfer_stats: Dict[str, object] = {}
    for cid in re_cids:
        old = models.get(cid)
        if old is not None and not isinstance(old, RandomEffectModel):
            raise ValueError(
                f"coordinate {cid!r}: expected a RandomEffectModel, got "
                f"{type(old).__name__}"
            )
        with span("incremental/resolve", coordinate=cid, kind="random"):
            sub = estimator.resolve_coordinate(cid, events, models)
        if estimator.last_resolve_stats:
            solver_stats[cid] = list(estimator.last_resolve_stats)
        if estimator.last_resolve_transfers is not None:
            transfer_stats[cid] = estimator.last_resolve_transfers
        rows = {str(eid): coefs for eid, coefs in sub.items()}
        touched[cid] = tuple(sorted(rows))
        known = set(old.entity_to_loc) if old is not None else set()
        new[cid] = tuple(sorted(set(rows) - known))
        re_updates[cid] = rows
        if merge and old is not None:
            merged = {str(eid): coefs for eid, coefs in old.items()}
            merged.update(rows)
            models[cid] = RandomEffectModel.from_entity_coefficients(
                random_effect_type=sub.random_effect_type,
                task=estimator.task,
                entity_coefficients=merged,
                global_dim=sub.global_dim,
                device=estimator.device,
            )
        else:
            # the re-solved model covers exactly the touched entities —
            # sufficient for the residual offsets of later coordinates
            # (every events row's entity for this RE type IS touched)
            models[cid] = sub

    return IncrementalUpdate(
        models=models,
        re_updates=re_updates,
        fe_updates=fe_updates,
        touched_entities=touched,
        new_entities=new,
        num_events=events.num_rows,
        solver_stats=solver_stats,
        transfer_stats=transfer_stats,
    )

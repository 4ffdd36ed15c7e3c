"""GAME training driver.

Port of ``photon_ml_tpu/cli/train_game.py`` (reference
cli/game/training/Driver.scala:50, run() :64-119): read Avro training data
(building the feature index maps) → read validation data → feature statistics and normalization contexts of
the fixed-effect shards when ``--normalization-type`` asks for them →
GameEstimator.fit by block coordinate descent → best model by the first
evaluator → save the model, in original-space coefficients
(Driver.scala:389-433). ``--summarization-output-dir`` or
``--save-feature-stats`` also write every shard's feature statistics as
``FeatureSummarizationResultAvro`` (ModelProcessingUtils.scala:560);
``--event-listeners`` registers listener classes (``event.py``);
``--checkpoint-dir`` writes the training state after every outer iteration
and resumes a checkpoint found there. Coordinates are fixed, random or
factored random effects. Training runs on ``--device`` (default ``cuda``;
``cpu`` only when asked).

Usage:
    python -m photon_ml_tpu_torch.cli.train_game \\
        --train-data-dirs data/train --validation-data-dirs data/test \\
        --coordinate-config game.json --task LOGISTIC_REGRESSION \\
        --output-dir out/ [--evaluator AUC] [--normalization-type STANDARDIZATION] \\
        [--checkpoint-dir ckpt/] [--device cpu]

The reference's other flags are not ported yet (ROADMAP.md, Queue A: The
rest of training).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.cli.common import (
    delete_dirs_if_exist,
    load_game_config,
    parse_input_columns,
    setup_logger,
)
from photon_ml_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from photon_ml_tpu_torch.estimators.game import (
    FixedEffectCoordinateConfiguration,
    GameEstimator,
    GameFit,
)
from photon_ml_tpu_torch.evaluation.evaluators import make_evaluator
from photon_ml_tpu_torch.event import (
    EventEmitter,
    PhotonOptimizationLogEvent,
    PhotonSetupEvent,
    TrainingFinishEvent,
    TrainingStartEvent,
)
from photon_ml_tpu_torch.indexmap import INTERCEPT_KEY, NAME_TERM_DELIMITER
from photon_ml_tpu_torch.io import schemas
from photon_ml_tpu_torch.io.avro import write_avro_file
from photon_ml_tpu_torch.io.data_reader import read_game_data
from photon_ml_tpu_torch.io.model_io import save_game_model
from photon_ml_tpu_torch.normalization import build_normalization_context
from photon_ml_tpu_torch.ops.data import LabeledData
from photon_ml_tpu_torch.stat.summary import summarize
from photon_ml_tpu_torch.types import NormalizationType, TaskType


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="photon-ml-tpu-torch train-game", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--train-data-dirs", nargs="+", required=True)
    p.add_argument("--validation-data-dirs", nargs="*", default=[])
    p.add_argument("--coordinate-config", required=True,
                   help="typed JSON config: feature shards + coordinates")
    p.add_argument("--task", required=True, choices=[t.name for t in TaskType])
    p.add_argument("--output-dir", required=True)
    p.add_argument("--num-outer-iterations", type=int, default=None,
                   help="overrides the config file's num_outer_iterations (default 1)")
    p.add_argument("--evaluator", nargs="+", default=None,
                   help="one or more of AUC, RMSE, PRECISION@k, or grouped "
                        "'AUC:userId'; the first selects the best model, all "
                        "are logged per coordinate update")
    p.add_argument("--normalization-type", default="NONE",
                   choices=[n.name for n in NormalizationType],
                   help="feature normalization of the fixed-effect shards, from "
                        "their summary statistics (STANDARDIZATION needs an "
                        "intercept)")
    p.add_argument("--summarization-output-dir", default=None,
                   help="write per-shard feature stats here instead of "
                        "<output-dir>/feature-stats (implies stats are "
                        "computed for every shard)")
    p.add_argument("--save-feature-stats", action="store_true",
                   help="write per-shard FeatureSummarizationResultAvro")
    p.add_argument("--event-listeners", nargs="*", default=[], metavar="module.Class",
                   help="EventListener classes to register (reference "
                        "--event-listeners, Params.scala:186)")
    p.add_argument("--log-file", default=None)
    p.add_argument("--compute-variance", action="store_true",
                   help="attach per-coefficient variances ~ 1/(H_jj+eps) to "
                        "FE and RE models (reference --compute-variance)")
    p.add_argument("--delete-output-dir-if-exists", action="store_true",
                   help="remove an existing --output-dir before writing")
    p.add_argument("--input-columns-names", default=None,
                   help="JSON map overriding input field names; keys: "
                        "response, offset, weight, uid")
    p.add_argument("--model-name", default="photon-ml-tpu-game")
    p.add_argument("--checkpoint-dir", default=None,
                   help="atomic per-outer-iteration training checkpoints; "
                        "an existing checkpoint there is resumed")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device to train on: 'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def _save_feature_stats(stats_base, shard, summary, index_map) -> None:
    """Per-shard stats under <stats_base>/<shard>."""
    write_feature_stats(os.path.join(stats_base, shard), summary, index_map)


def write_feature_stats(stats_dir, summary, index_map) -> None:
    """writeBasicStatistics parity (ModelProcessingUtils.scala:560):
    FeatureSummarizationResultAvro part files into ``stats_dir``."""
    os.makedirs(stats_dir, exist_ok=True)
    mean, var, mx, mn, nnz = (
        getattr(summary, f).cpu().numpy().astype(np.float64)
        for f in ("mean", "variance", "max_val", "min_val", "num_nonzeros")
    )

    def records():
        for i in range(len(mean)):
            key = index_map.get_feature_name(i)
            if key is None:
                continue
            name, _, term = key.partition(NAME_TERM_DELIMITER)
            yield {
                "featureName": name,
                "featureTerm": term,
                "metrics": {
                    "mean": float(mean[i]),
                    "variance": float(var[i]),
                    "min": float(mn[i]),
                    "max": float(mx[i]),
                    "numNonzeros": float(nnz[i]),
                },
            }

    write_avro_file(
        os.path.join(stats_dir, "part-00000.avro"),
        schemas.feature_summarization_schema(),
        records(),
    )


def run(args: argparse.Namespace) -> GameFit:
    logger = setup_logger(args.log_file)
    device = resolve_device(args.device)
    emitter = EventEmitter()
    for name in args.event_listeners:
        emitter.register_listener_class(name)
    try:
        return _run(args, logger, device, emitter)
    finally:
        # listeners flush and close even when the run fails
        emitter.clear_listeners()


def _run(args: argparse.Namespace, logger, device, emitter: EventEmitter) -> GameFit:
    t_start = time.perf_counter()
    emitter.send_event(PhotonSetupEvent(params=vars(args)))
    durations = {}

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        durations[name] = time.perf_counter() - t0
        return out

    shard_configs, coordinates, update_order, raw_config = load_game_config(
        args.coordinate_config
    )
    col_names = parse_input_columns(args.input_columns_names)
    if args.delete_output_dir_if_exists:
        delete_dirs_if_exist(args.output_dir)
    id_tags = sorted({
        c.data.random_effect_type
        for c in coordinates.values()
        if not isinstance(c, FixedEffectCoordinateConfiguration)
    })
    data, index_maps, _ = timed(
        "read training data", read_game_data, args.train_data_dirs, shard_configs,
        None, id_tags=id_tags, **col_names,
    )
    logger.info("training rows: %d on %s", data.num_rows, device)

    # a grouped evaluator's tag must be read even when no coordinate uses it
    val_tags = list(id_tags)
    for spec in args.evaluator or []:
        tag = spec.partition(":")[2].strip()
        if tag and tag not in val_tags:
            val_tags.append(tag)
    validation_data = None
    if args.validation_data_dirs:
        validation_data, _, _ = timed(
            "read validation data", read_game_data, args.validation_data_dirs,
            shard_configs, index_maps, id_tags=val_tags, **col_names,
        )
        logger.info("validation rows: %d", validation_data.num_rows)

    norm_type = NormalizationType[args.normalization_type]
    normalization, intercept_indices = {}, {}
    fe_shards = {
        c.feature_shard for c in coordinates.values()
        if isinstance(c, FixedEffectCoordinateConfiguration)
    }
    # stats of the fixed-effect shards for normalization; of every shard
    # when they are written out
    stats_base = args.summarization_output_dir or (
        os.path.join(args.output_dir, "feature-stats") if args.save_feature_stats else None
    )
    stat_shards = list(shard_configs) if stats_base else sorted(fe_shards)
    if norm_type is not NormalizationType.NONE or stats_base:
        for sid in stat_shards:
            t0 = time.perf_counter()
            labeled = LabeledData.create(
                data.sparse_features(sid, engine="auto", device=device),
                torch.from_numpy(data.labels).to(device),
                weights=torch.from_numpy(data.weights).to(device),
            )
            summary = summarize(labeled)
            durations[f"feature stats [{sid}]"] = time.perf_counter() - t0
            if stats_base:
                _save_feature_stats(stats_base, sid, summary, index_maps[sid])
            icpt = index_maps[sid].get_index(INTERCEPT_KEY)
            intercept_indices[sid] = icpt if icpt >= 0 else None
            if norm_type is not NormalizationType.NONE and sid in fe_shards:
                normalization[sid] = build_normalization_context(
                    norm_type, mean=summary.mean, variance=summary.variance,
                    max_magnitude=summary.max_abs, intercept_index=intercept_indices[sid],
                )

    evaluator, extra = None, []
    if validation_data is not None and args.evaluator:
        evaluator = make_evaluator(args.evaluator[0], validation_data)
        extra = [make_evaluator(s, validation_data) for s in args.evaluator[1:]]

    estimator = GameEstimator(
        task=TaskType[args.task],
        coordinates=coordinates,
        update_order=update_order,
        num_outer_iterations=(
            args.num_outer_iterations
            if args.num_outer_iterations is not None
            else int(raw_config.get("num_outer_iterations", 1))
        ),
        evaluator=evaluator,
        extra_evaluators=extra,
        compute_variance=args.compute_variance,
        normalization=normalization,
        intercept_indices=intercept_indices,
        device=device,
        emitter=emitter,
    )
    emitter.send_event(TrainingStartEvent(task=args.task))
    fit = timed("fit", estimator.fit, data, validation_data=validation_data,
                checkpoint_dir=args.checkpoint_dir)
    for cid, value in fit.objective_history:
        emitter.send_event(PhotonOptimizationLogEvent(
            coordinate_id=cid,
            regularization_weight=coordinates[cid].optimizer.regularization_weight,
            objective_value=value,
            iterations=-1,  # per-coordinate iteration counts live in the trackers
            convergence_reason="",
        ))
        logger.info("objective [%s]: %.6f", cid, value)
    if fit.validation_metric is not None:
        logger.info("validation metric: %.6f", fit.validation_metric)

    timed(
        "save model", save_game_model, fit.model, os.path.join(args.output_dir, "best"),
        index_maps=index_maps, model_name=args.model_name, configurations=raw_config,
    )
    logger.info("model saved to %s", os.path.join(args.output_dir, "best"))
    emitter.send_event(TrainingFinishEvent(
        task=args.task, wall_seconds=time.perf_counter() - t_start
    ))
    for name, seconds in durations.items():
        logger.info("timing %-20s %.3fs", name, seconds)
    return fit


def main(argv: Optional[List[str]] = None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())

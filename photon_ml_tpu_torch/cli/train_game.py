"""GAME training driver.

Port of ``photon_ml_tpu/cli/train_game.py`` (reference
cli/game/training/Driver.scala:50, run() :64-119): read Avro training data
(building the feature index maps) → read validation data → GameEstimator.fit
by block coordinate descent → best model by the first evaluator → save the
model (Driver.scala:389-433). Training runs on ``--device`` (default
``cuda``; ``cpu`` only when asked).

Usage:
    python -m photon_ml_tpu_torch.cli.train_game \\
        --train-data-dirs data/train --validation-data-dirs data/test \\
        --coordinate-config game.json --task LOGISTIC_REGRESSION \\
        --output-dir out/ [--evaluator AUC] [--device cpu]

The reference's other flags are not ported yet (ROADMAP.md, Queue A).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional

from photon_ml_tpu_torch.cli.common import (
    delete_dirs_if_exist,
    load_game_config,
    parse_input_columns,
    setup_logger,
)
from photon_ml_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from photon_ml_tpu_torch.estimators.game import (
    GameEstimator,
    GameFit,
    RandomEffectCoordinateConfiguration,
)
from photon_ml_tpu_torch.evaluation.evaluators import make_evaluator
from photon_ml_tpu_torch.io.data_reader import read_game_data
from photon_ml_tpu_torch.io.model_io import save_game_model
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
                   help="only NONE is ported so far")
    p.add_argument("--compute-variance", action="store_true",
                   help="attach per-coefficient variances ~ 1/(H_jj+eps) to "
                        "FE and RE models (reference --compute-variance)")
    p.add_argument("--delete-output-dir-if-exists", action="store_true",
                   help="remove an existing --output-dir before writing")
    p.add_argument("--input-columns-names", default=None,
                   help="JSON map overriding input field names; keys: "
                        "response, offset, weight, uid")
    p.add_argument("--model-name", default="photon-ml-tpu-game")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device to train on: 'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def run(args: argparse.Namespace) -> GameFit:
    logger = setup_logger()
    device = resolve_device(args.device)
    if args.normalization_type != "NONE":
        raise NotImplementedError(
            f"--normalization-type {args.normalization_type} needs "
            "build_normalization_context and stat/summary.py, which are not "
            "ported yet (ROADMAP.md, Queue A)"
        )
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
        if isinstance(c, RandomEffectCoordinateConfiguration)
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
        device=device,
    )
    fit = timed("fit", estimator.fit, data, validation_data=validation_data)
    for cid, value in fit.objective_history:
        logger.info("objective [%s]: %.6f", cid, value)
    if fit.validation_metric is not None:
        logger.info("validation metric: %.6f", fit.validation_metric)

    timed(
        "save model", save_game_model, fit.model, os.path.join(args.output_dir, "best"),
        index_maps=index_maps, model_name=args.model_name, configurations=raw_config,
    )
    logger.info("model saved to %s", os.path.join(args.output_dir, "best"))
    for name, seconds in durations.items():
        logger.info("timing %-20s %.3fs", name, seconds)
    return fit


def main(argv: Optional[List[str]] = None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""GAME scoring driver.

Port of ``photon_ml_tpu/cli/score_game.py`` (reference
cli/game/scoring/Driver.scala:37, run() :176-209): read data (response
optional) → load the GAME model → score → write ScoringResultAvro → optional
evaluation. ``--date-range`` / ``--date-days-ago`` expand each data dir to
its daily yyyy/MM/dd subdirs. Scoring runs on ``--device`` (default
``cuda``; ``cpu`` only when asked). ``--telemetry-out`` writes a JSONL run
ledger (the phases as spans, the scoring start and finish events, the
metrics) and ``--trace-out`` a Chrome trace. ``--offheap-indexmap-dir``
scores through the off-heap index stores of ``build_index`` (one
subdirectory a feature shard) instead of maps rebuilt from the model;
``--model-id`` stamps the output records; ``--log-data-and-model-stats``
logs the dataset's entity counts and the model's sizes;
``--event-listeners`` registers listener classes (they receive
``ScoringStartEvent`` and ``ScoringFinishEvent``); ``--log-file`` also
writes the log to a file. The multi-host flags are item 8 of ROADMAP.md
Queue A.

Usage:
    python -m photon_ml_tpu_torch.cli.score_game \
        --data-dirs data/test --model-dir out/best \
        --output-dir scores/ --evaluator AUC [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.cli.common import (
    add_telemetry_args,
    delete_dirs_if_exist,
    expand_data_dirs,
    finish_telemetry,
    load_index_maps,
    parse_input_columns,
    setup_logger,
    start_telemetry,
)
from photon_ml_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from photon_ml_tpu_torch.evaluation.evaluators import make_evaluator
from photon_ml_tpu_torch.event import EventEmitter, ScoringFinishEvent, ScoringStartEvent
from photon_ml_tpu_torch.io.data_reader import FeatureShardConfiguration, read_game_data
from photon_ml_tpu_torch.io.model_io import load_game_model, load_game_model_metadata
from photon_ml_tpu_torch.io.scores_io import ScoredItem, save_scores
from photon_ml_tpu_torch.utils.timer import Timer


def _positive_int(v: str) -> int:
    n = int(v)
    if n < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {n}")
    return n


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="photon-ml-tpu-torch score-game", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--data-dirs", nargs="+", required=True)
    p.add_argument("--date-range", default=None,
                   help="yyyyMMdd-yyyyMMdd; expands each data dir to its "
                        "daily yyyy/MM/dd subdirs (reference --date-range)")
    p.add_argument("--date-days-ago", default=None,
                   help="start-end days ago, e.g. 90-1 (reference "
                        "--date-range-days-ago)")
    p.add_argument("--model-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--model-id", default=None,
                   help="modelId stamped on ScoringResultAvro records "
                        "(defaults to the saved model name)")
    p.add_argument("--offheap-indexmap-dir", default=None,
                   help="score through prebuilt off-heap index stores "
                        "instead of the maps reconstructed from the model "
                        "(reference --offheap-indexmap-dir)")
    p.add_argument("--num-output-files", type=_positive_int, default=None,
                   help="partition the score output into this many part "
                        "files (reference --num-files)")
    p.add_argument("--evaluator", default=None,
                   help="optional metric over scored data, e.g. AUC, "
                        "'RMSE:userId', or 'PRECISION@5:userId'")
    p.add_argument("--delete-output-dir-if-exists", action="store_true",
                   help="remove an existing --output-dir before writing")
    p.add_argument("--random-effect-id-set", default=None,
                   help="comma-separated random effect types to read from "
                        "the records, overriding the set derived from the model")
    p.add_argument("--input-columns-names", default=None,
                   help="JSON map overriding input field names; keys: "
                        "response, offset, weight, uid")
    p.add_argument("--missing-entity-policy", choices=("fe-only", "error"),
                   default="fe-only",
                   help="rows naming entities absent from the model: "
                        "'fe-only' (default) scores them with the fixed "
                        "effects only (RE contribution 0, the reference "
                        "left-join semantics); 'error' fails fast instead")
    p.add_argument("--log-data-and-model-stats", action="store_true",
                   help="log dataset stats (rows, per-id-tag entity counts "
                        "and samples-per-entity) and per-coordinate model "
                        "sizes (reference --log-game-dataset-and-model-stats)")
    p.add_argument("--event-listeners", nargs="*", default=[],
                   metavar="module.Class",
                   help="EventListener classes to register")
    p.add_argument("--log-file", default=None)
    add_telemetry_args(p)
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device to score on: 'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def _log_data_and_model_stats(logger, data, model, id_tags) -> None:
    """Reference logGameDataSet/logGameModel (scoring Driver.scala:88-103):
    the dataset summary (samples per id-tag entity) and the model sizes."""
    logger.info("dataset stats: numSamples: %d", data.num_rows)
    for tag in id_tags:
        ids = data.id_tags.get(tag)
        if ids is None:
            continue
        _, counts = np.unique(np.asarray(ids), return_counts=True)
        logger.info(
            "dataset stats: samples per %s: entities=%d mean=%.2f "
            "stdev=%.2f min=%d max=%d",
            tag, counts.size, counts.mean(), counts.std(), counts.min(), counts.max(),
        )
    for cid, sub in model.models.items():
        coef = getattr(sub, "coefficients", None)
        if coef is not None and hasattr(coef, "means"):
            logger.info("model stats [%s]: fixed effect, %d coefficients",
                        cid, int(coef.means.shape[0]))
        elif hasattr(sub, "num_entities"):
            logger.info("model stats [%s]: random effect '%s', %d entities",
                        cid, getattr(sub, "random_effect_type", "?"), sub.num_entities)
        else:
            logger.info("model stats [%s]: %s", cid, type(sub).__name__)


def _check_missing_entities(model, data) -> None:
    """--missing-entity-policy=error: fail when the dataset names
    random-effect entities the model has never seen."""
    problems = []
    for cid, sub in model.models.items():
        re_type = model.meta[cid].random_effect_type
        if not re_type:
            continue
        ids = data.id_tags.get(re_type)
        if ids is None:
            continue
        # a factored model knows its entities by its latent factors
        loc = getattr(sub, "latent", sub).entity_to_loc
        missing = sorted({str(e) for e in ids if str(e) not in loc})
        if missing:
            problems.append(
                f"[{cid}] {len(missing)} unknown {re_type!r} entities "
                f"(e.g. {missing[:5]})"
            )
    if problems:
        raise ValueError(
            "--missing-entity-policy=error: the dataset references "
            "entities absent from the model: " + "; ".join(problems)
        )


def run(args: argparse.Namespace) -> Optional[float]:
    """Score the data; returns the evaluator's metric (None without one)."""
    logger = setup_logger(args.log_file)
    device = resolve_device(args.device)
    timer = Timer()
    emitter = EventEmitter()
    for name in args.event_listeners:
        emitter.register_listener_class(name)
    telemetry = start_telemetry(args, "score_game", emitter=emitter)
    t_start = time.perf_counter()
    try:
        return _run_scoring(args, logger, device, timer, emitter, t_start)
    finally:
        # listeners flush and close even when the run fails; telemetry
        # finishes after them so that every bridged event is in the ledger
        emitter.clear_listeners()
        finish_telemetry(telemetry, phases=dict(timer.durations))


def _run_scoring(args, logger, device, timer: Timer, emitter: EventEmitter,
                 t_start: float) -> Optional[float]:
    # a bad date spec must fail before the (possibly huge) model load
    data_dirs = expand_data_dirs(args.data_dirs, args.date_range, args.date_days_ago)
    metadata = load_game_model_metadata(args.model_dir)
    model_id = args.model_id or metadata.get("modelName", "game-model")

    # the saved config names the shard → feature bags mapping; without it,
    # each shard reads the record field of the same name
    shard_bags = {}
    cfg = metadata.get("configurations") or {}
    for sid, s in (cfg.get("feature_shards") or {}).items():
        shard_bags[sid] = FeatureShardConfiguration(
            feature_bags=s["feature_bags"],
            add_intercept=bool(s.get("add_intercept", True)),
        )

    preloaded_maps = None
    if args.offheap_indexmap_dir:
        if not shard_bags:
            raise ValueError(
                "--offheap-indexmap-dir needs the model metadata to name "
                "its feature shards (configurations.feature_shards); this "
                "model carries none, so the off-heap stores cannot be "
                "bound to shards"
            )
        with timer.time("load index maps"):
            preloaded_maps = load_index_maps(args.offheap_indexmap_dir, shard_bags)
        logger.info("scoring through off-heap index stores for shards: %s",
                    sorted(preloaded_maps))

    with timer.time("load model"):
        model, index_maps = load_game_model(
            args.model_dir, index_maps=preloaded_maps, device=device)
    for sid in index_maps:
        shard_bags.setdefault(sid, FeatureShardConfiguration(feature_bags=[sid]))

    if args.random_effect_id_set:
        id_tags = sorted(
            t.strip() for t in args.random_effect_id_set.split(",") if t.strip()
        )
    else:
        id_tags = sorted(
            {m.random_effect_type for m in model.meta.values() if m.random_effect_type}
        )
    # a grouped evaluator's tag must be read even if no sub-model uses it
    if args.evaluator and ":" in args.evaluator:
        tag = args.evaluator.partition(":")[2].strip()
        if tag and tag not in id_tags:
            id_tags.append(tag)

    with timer.time("read data"):
        data, _, uids = read_game_data(
            data_dirs, shard_bags, index_maps,
            id_tags=id_tags, is_response_required=False,
            **parse_input_columns(args.input_columns_names),
        )
    logger.info("scoring rows: %d on %s", data.num_rows, device)
    emitter.send_event(ScoringStartEvent(model_id=model_id, num_requests=data.num_rows))

    if args.log_data_and_model_stats:
        _log_data_and_model_stats(logger, data, model, id_tags)

    if args.missing_entity_policy == "error":
        _check_missing_entities(model, data)

    with timer.time("score"):
        scores = (model.score(data) + _to(data.offsets, device)).cpu().numpy()

    if args.delete_output_dir_if_exists:
        delete_dirs_if_exist(args.output_dir)

    file_sizes = None
    if args.num_output_files:
        # exactly N part files (reference --num-files), the first rows % N
        # of them one record larger
        nf = args.num_output_files
        base, rem = divmod(data.num_rows, nf)
        file_sizes = [base + (1 if i < rem else 0) for i in range(nf)]
    with timer.time("save scores"):
        n = save_scores(
            args.output_dir,
            (
                ScoredItem(
                    prediction_score=float(s),
                    label=None if np.isnan(lab) else float(lab),
                    weight=float(w),
                    uid=uid,
                    id_tags={t: str(data.id_tags[t][i]) for t in id_tags},
                )
                for i, (s, lab, w, uid) in enumerate(
                    zip(scores, data.labels, data.weights, uids)
                )
            ),
            model_id=model_id,
            file_sizes=file_sizes,
        )
    logger.info("saved %d scores to %s", n, args.output_dir)

    metric = None
    if args.evaluator:
        have_labels = ~np.isnan(data.labels)
        if have_labels.any():
            # group ids must align with the labeled subset being evaluated
            sub = data.slice_rows(have_labels) if not have_labels.all() else data
            ev = make_evaluator(args.evaluator, sub)
            metric = ev.evaluate(
                _to(scores[have_labels], device),
                _to(data.labels[have_labels], device),
                _to(data.weights[have_labels], device),
            )
            logger.info("%s: %.6f", ev.name, metric)
    emitter.send_event(ScoringFinishEvent(
        model_id=model_id,
        num_requests=data.num_rows,
        wall_seconds=time.perf_counter() - t_start,
        metrics={} if metric is None else {"evaluator_metric": metric},
    ))
    for name, seconds in timer.durations.items():
        logger.info("timing %-20s %.3fs", name, seconds)
    return metric


def _to(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def main(argv: Optional[List[str]] = None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""GAME nearline update CLI: fold a batch of new events into a trained
model and publish a delta artifact.

Port of ``photon_ml_tpu/cli/update_game.py``, with the same flags and
summary, on ``--device`` (default ``cuda``; ``cpu`` only when asked). The
deltas it writes are byte-equal to the JAX CLI's for the same numbers.

The offline CLI (``train_game``) runs full block coordinate descent from
scratch; this CLI is the nearline half of the loop — it warm-starts from
an already-trained model (model dir or training checkpoint), re-solves ONLY
the per-entity random-effect rows touched by the new events (optionally
refreshing the fixed effects first with the random effects frozen), and
writes the result as a versioned *delta* directory that chains to the base
serving artifact by content fingerprint. A live server picks deltas up with
``serve_game --watch-deltas`` (or ``HotSwapManager.poll_directory``) and
applies them between requests without restarting.

Usage:
    # publish one delta from a batch of fresh events
    python -m photon_ml_tpu_torch.cli.update_game \
        --base-artifact-dir out/artifact --model-dir out/best \
        --coordinate-config game.json --events-data-dirs data/new \
        --output-dir out/deltas

    # periodically: fold the accumulated chain back into a full artifact
    python -m photon_ml_tpu_torch.cli.update_game \
        --base-artifact-dir out/artifact --model-dir out/best \
        --coordinate-config game.json --events-data-dirs data/new \
        --output-dir out/deltas --compact-into out/artifact.v2

    # the same on the host
    python -m photon_ml_tpu_torch.cli.update_game ... --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

from photon_ml_tpu_torch.cli.common import (
    add_telemetry_args,
    finish_telemetry,
    id_tags_needed,
    load_game_config,
    parse_input_columns,
    setup_logger,
    start_telemetry,
)
from photon_ml_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from photon_ml_tpu_torch.utils.timer import Timer


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="photon-ml-tpu update-game", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--base-artifact-dir", required=True,
                   help="serving artifact the delta chains to (feature "
                        "index maps are reused so featurization matches)")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--model-dir",
                     help="trained GAME model directory to warm-start from")
    src.add_argument("--checkpoint-dir",
                     help="training checkpoint directory to warm-start from")
    p.add_argument("--coordinate-config", required=True,
                   help="typed JSON coordinate-config file (same file used "
                        "to train the base model)")
    p.add_argument("--events-data-dirs", nargs="+", required=True,
                   help="Avro dirs holding the new-events batch")
    p.add_argument("--output-dir", required=True,
                   help="deltas root; the new delta lands at "
                        "<output-dir>/delta-NNNNNN")
    p.add_argument("--refresh-fixed-iterations", type=int, default=0,
                   help="fixed-effect refresh passes (random effects "
                        "frozen) before the per-entity re-solves")
    p.add_argument("--generation", type=int, default=None,
                   help="delta generation number (default: one past the "
                        "last delta already in --output-dir)")
    p.add_argument("--compact-into", default=None,
                   help="also fold base + full delta chain into a fresh "
                        "artifact at this directory")
    p.add_argument("--event-listeners", nargs="*", default=[],
                   help="dotted class paths registered on the event emitter")
    p.add_argument("--input-columns-names", default=None,
                   help="JSON map overriding input field names")
    p.add_argument("--log-file", default=None)
    add_telemetry_args(p)
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device to re-solve on: 'cuda' (default) or "
                        "'cpu'")
    return p.parse_args(argv)


def _chain_head(output_dir: str, base_artifact_dir: str):
    """(generation, base_fingerprint) for the next delta: chain to the last
    delta already published in ``output_dir``, else root at the base
    artifact's content fingerprint."""
    from photon_ml_tpu_torch.incremental import (
        discover_deltas,
        fingerprint_dir,
        load_delta,
    )

    existing = discover_deltas(output_dir)
    if existing:
        last = load_delta(existing[-1])
        return last.generation + 1, last.fingerprint
    return 1, fingerprint_dir(base_artifact_dir)


def run(args: argparse.Namespace) -> dict:
    from photon_ml_tpu_torch.event import EventEmitter, PhotonSetupEvent

    logger = setup_logger(args.log_file)
    device = resolve_device(args.device)
    timer = Timer()
    emitter = EventEmitter()
    for name in args.event_listeners:
        emitter.register_listener_class(name)
    telemetry = start_telemetry(args, "update_game", emitter=emitter)
    emitter.send_event(PhotonSetupEvent(params=vars(args)))
    t_start = time.perf_counter()
    try:
        return _run_update(args, logger, timer, emitter, device, t_start)
    finally:
        # listeners must flush/close even when the run fails; telemetry
        # finishes after them so every bridged event is in the ledger
        emitter.clear_listeners()
        finish_telemetry(telemetry, phases=dict(timer.durations))


def _run_update(args, logger, timer, emitter, device, t_start) -> dict:
    from photon_ml_tpu_torch.estimators.game import GameEstimator
    from photon_ml_tpu_torch.event import TrainingFinishEvent, TrainingStartEvent
    from photon_ml_tpu_torch.incremental import (
        build_delta,
        compact,
        delta_dir_name,
        discover_deltas,
        incremental_update,
        save_delta,
    )
    from photon_ml_tpu_torch.io.data_reader import read_game_data
    from photon_ml_tpu_torch.serving import load_artifact

    shard_configs, coordinates, update_order, _ = load_game_config(
        args.coordinate_config
    )

    with timer.time("load artifact"):
        artifact = load_artifact(args.base_artifact_dir)
    index_maps = dict(artifact.feature_index) or None
    if index_maps is None:
        logger.warning(
            "base artifact carries no feature index maps; indexes will be "
            "rebuilt from the events and may not match the model"
        )

    col_names = parse_input_columns(args.input_columns_names)
    with timer.time("read events"):
        events, _, _ = read_game_data(
            args.events_data_dirs,
            shard_configs,
            index_maps,
            id_tags=id_tags_needed(coordinates),
            **col_names,
        )
    logger.info("read %d new events", events.num_rows)

    estimator = GameEstimator(
        task=artifact.task,
        coordinates=coordinates,
        update_order=update_order,
        num_outer_iterations=1,
        emitter=emitter,
        device=device,
    )

    if args.model_dir:
        from photon_ml_tpu_torch.io.model_io import load_game_model

        with timer.time("load model"):
            model, _ = load_game_model(args.model_dir, device=device)
    else:
        model = args.checkpoint_dir  # incremental_update loads checkpoints

    emitter.send_event(TrainingStartEvent(task=artifact.task.name))
    with timer.time("incremental update"):
        update = incremental_update(
            estimator, model, events,
            refresh_fixed_iterations=args.refresh_fixed_iterations,
            merge=False,
        )

    generation, base_fp = _chain_head(args.output_dir, args.base_artifact_dir)
    if args.generation is not None:
        generation = args.generation
    delta_dir = os.path.join(args.output_dir, delta_dir_name(generation))
    with timer.time("publish delta"):
        delta = build_delta(
            update.re_updates, artifact,
            fe_updates=update.fe_updates or None,
            base_fingerprint=base_fp,
            generation=generation,
            created_at_unix=time.time(),
        )
        delta = save_delta(delta, delta_dir)
    logger.info(
        "published delta generation %d (%d rows) at %s",
        generation, delta.num_rows_updated, delta_dir,
    )

    compacted_fp = None
    if args.compact_into:
        with timer.time("compact"):
            compacted_fp = compact(
                args.base_artifact_dir,
                discover_deltas(args.output_dir),
                args.compact_into,
            )
        logger.info(
            "compacted chain into %s (fingerprint %s)",
            args.compact_into, compacted_fp,
        )

    emitter.send_event(TrainingFinishEvent(
        task=artifact.task.name,
        wall_seconds=time.perf_counter() - t_start,
    ))

    summary = {
        "delta_dir": delta_dir,
        "generation": generation,
        "fingerprint": delta.fingerprint,
        "base_fingerprint": base_fp,
        "rows_updated": delta.num_rows_updated,
        "num_events": update.num_events,
        "touched_entities": {
            cid: len(eids) for cid, eids in update.touched_entities.items()
        },
        "new_entities": {
            cid: len(eids) for cid, eids in update.new_entities.items()
        },
        "fixed_effects_refreshed": sorted(update.fe_updates),
    }
    if compacted_fp is not None:
        summary["compacted_into"] = args.compact_into
        summary["compacted_fingerprint"] = compacted_fp
    print(json.dumps(summary))

    for name, seconds in timer.durations.items():
        logger.info("timing %-20s %.3fs", name, seconds)
    return summary


def main(argv: Optional[List[str]] = None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())

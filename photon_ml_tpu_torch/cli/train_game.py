"""GAME training driver.

Port of ``photon_ml_tpu/cli/train_game.py`` (reference
cli/game/training/Driver.scala:50, run() :64-119): read Avro training data
(building the feature index maps; ``--train-date-range`` and the other date
flags expand each dir to its daily yyyy/MM/dd subdirs) → read validation
data → ``--check-data`` → feature statistics and normalization contexts of
the fixed-effect shards when ``--normalization-type`` asks for them →
GameEstimator.fit by block coordinate descent (``--schedule async`` with
``--staleness``: pipelined solves on CUDA streams; ``--updating-sequence``:
the order), or ``fit_multiple`` over the cross product of the config's
``regularization_weights`` sweep lists → ``--hyperparameter-tuning RANDOM``
or ``BAYESIAN`` trials warm-started from it (``--use-warm-start``) → the
best model by the first evaluator → save it (``--model-output-mode``: the
best under ``best/``, with ALL every swept configuration under
``all/<i>``), in original-space coefficients (Driver.scala:389-433).
``--summarization-output-dir`` or ``--save-feature-stats`` also write every
shard's feature statistics as ``FeatureSummarizationResultAvro``
(ModelProcessingUtils.scala:560); ``--event-listeners`` registers listener
classes (``event.py``); ``--checkpoint-dir`` writes the training state
after every outer iteration and resumes a checkpoint found there;
``--profile-dir`` writes a ``torch.profiler`` Chrome trace of the fit.
Coordinates are fixed, random or factored random effects. Training runs on
``--device`` (default ``cuda``; ``cpu`` only when asked).

Telemetry and resilience: ``--telemetry-out`` (a JSONL run ledger of
spans, events and metrics) and ``--trace-out`` (a Chrome trace);
``--progress-out`` (the convergence ledger, one record per coordinate
update and held-out evaluation; it arms the divergence watchdog, which
aborts the run with exit code 2 and saves no model); ``--introspect-port``
(``/progress``, ``/metrics``, ``/healthz``, ``/varz`` and
``/quitquitquit`` on 127.0.0.1), ``--introspect-port-file``,
``--introspect-hold``; ``--auto-tune`` (an A/B of the adaptive RE solver's
knobs on 1-outer-iteration trial fits, judged by a metric of the trial's
own registry, ``--auto-tune-judge``; the result in
``<output-dir>/auto-tune.json``, the winner in the model metadata's
``tuned_config``).

Usage:
    python -m photon_ml_tpu_torch.cli.train_game \\
        --train-data-dirs data/train --validation-data-dirs data/test \\
        --coordinate-config game.json --task LOGISTIC_REGRESSION \\
        --output-dir out/ [--evaluator AUC] [--normalization-type STANDARDIZATION] \\
        [--checkpoint-dir ckpt/] [--schedule async] [--device cpu]

``--offheap-indexmap-dir`` reads training and validation data through the
prebuilt off-heap index stores of ``build_index``, one subdirectory a
feature shard, instead of building the maps by a scan.

``--streaming`` trains out of core: the training set is streamed from disk
in fixed-shape blocks of ``--block-rows`` through a pinned host-to-device
prefetcher (``--prefetch-depth``, ``--decode-workers``), with a decoded
block cache (``--block-cache-dir``, ``--no-block-cache``), exact
full-batch or stochastic solves (``--stream-mode``, ``--gap-schedule``),
device-resident blocks (``--resident-blocks``, ``--resident-bytes``) and
``--on-block-error``; validation data is still read in memory.

Refused, naming their ROADMAP.md Queue A item: the device-grid, cluster
and multi-host flags (item 8).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.cli.common import (
    add_telemetry_args,
    coordinate_weight_sweeps,
    delete_dirs_if_exist,
    expand_data_dirs,
    finish_telemetry,
    id_tags_needed,
    load_game_config,
    load_index_maps,
    parse_input_columns,
    setup_logger,
    start_telemetry,
)
from photon_ml_tpu_torch.data.validators import validate_labeled_data
from photon_ml_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from photon_ml_tpu_torch.estimators.game import (
    FixedEffectCoordinateConfiguration,
    GameEstimator,
    GameFit,
)
from photon_ml_tpu_torch.estimators.tuning import (
    GameEstimatorEvaluationFunction,
    run_hyperparameter_tuning,
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
from photon_ml_tpu_torch.serving.introspect import IntrospectionServer
from photon_ml_tpu_torch.stat.summary import summarize
from photon_ml_tpu_torch.streaming import StreamingSource
from photon_ml_tpu_torch.telemetry import ConvergenceTracker, DivergenceError
from photon_ml_tpu_torch.telemetry.analyze import RunReport
from photon_ml_tpu_torch.telemetry.sinks import TelemetryEventListener
from photon_ml_tpu_torch.tuning import ab_candidates, get_knob, propose, run_ab_trials
from photon_ml_tpu_torch.types import NormalizationType, TaskType
from photon_ml_tpu_torch.utils.timer import Timer

# flags of the JAX package's train_game that need modules not ported yet,
# with the ROADMAP.md Queue A item that ports them
_CLUSTER = "item 8, The cluster plane"
_UNPORTED = {
    "parallel_data": _CLUSTER, "parallel_feat": _CLUSTER, "parallel_engine": _CLUSTER,
    "hosts": _CLUSTER, "cluster_block_latency_ms": _CLUSTER, "cluster_kill_host": _CLUSTER,
    "coordinator_address": _CLUSTER, "num_processes": _CLUSTER, "process_id": _CLUSTER,
}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="photon-ml-tpu-torch train-game", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--train-data-dirs", nargs="+", required=True)
    p.add_argument("--validation-data-dirs", nargs="*", default=[])
    p.add_argument("--train-date-range", default=None,
                   help="yyyyMMdd-yyyyMMdd; expands each data dir to its "
                        "daily yyyy/MM/dd subdirs (reference --train-date-range)")
    p.add_argument("--train-date-days-ago", default=None,
                   help="start-end days ago, e.g. 90-1")
    p.add_argument("--validation-date-range", default=None,
                   help="yyyyMMdd-yyyyMMdd for the validation dirs")
    p.add_argument("--validation-date-days-ago", default=None,
                   help="start-end days ago for the validation dirs")
    p.add_argument("--coordinate-config", required=True,
                   help="typed JSON config: feature shards + coordinates")
    p.add_argument("--updating-sequence", nargs="+", default=None,
                   help="coordinate update order; overrides the config "
                        "file's order (reference --updating-sequence)")
    p.add_argument("--task", required=True, choices=[t.name for t in TaskType])
    p.add_argument("--output-dir", required=True)
    p.add_argument("--num-outer-iterations", type=int, default=None,
                   help="overrides the config file's num_outer_iterations (default 1)")
    p.add_argument("--evaluator", nargs="+", default=None,
                   help="one or more of AUC, RMSE, PRECISION@k, or grouped "
                        "'AUC:userId'; the first selects the best model, all "
                        "are logged per coordinate update")
    p.add_argument("--offheap-indexmap-dir", default=None,
                   help="prebuilt off-heap index stores (build_index), one "
                        "subdirectory a feature shard")
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
    p.add_argument("--num-output-files-for-random-effect-model", type=int, default=1,
                   metavar="N",
                   help="partition each random-effect coordinate's "
                        "coefficients across N part files (reference "
                        "NUM_OUTPUT_FILES_FOR_RANDOM_EFFECT_MODEL)")
    p.add_argument("--model-output-mode", default="BEST", choices=["ALL", "BEST", "NONE"],
                   help="BEST saves the selected model under <output>/best; "
                        "ALL also every swept configuration under "
                        "<output>/all/<i>; NONE saves nothing (reference "
                        "ModelOutputMode)")
    p.add_argument("--delete-output-dir-if-exists", action="store_true",
                   help="remove an existing --output-dir before writing")
    p.add_argument("--check-data", action="store_true",
                   help="run per-task input validation over every feature "
                        "shard of the training and validation data before "
                        "training (reference CHECK_DATA)")
    p.add_argument("--input-columns-names", default=None,
                   help="JSON map overriding input field names; keys: "
                        "response, offset, weight, uid")
    p.add_argument("--hyperparameter-tuning", default="NONE",
                   choices=["NONE", "RANDOM", "BAYESIAN"])
    p.add_argument("--hyperparameter-tuning-iter", type=int, default=10)
    p.add_argument("--regularization-weight-range", default=None,
                   help="lower,upper bounds for tuned regularization "
                        "weights, e.g. 1e-4,1e4 (reference "
                        "--regularization-weight-range)")
    p.add_argument("--use-warm-start", dest="use_warm_start", action="store_true",
                   default=True,
                   help="warm-start tuning trials from the previous trial's "
                        "models (default on, reference USE_WARM_START)")
    p.add_argument("--no-warm-start", dest="use_warm_start", action="store_false")
    p.add_argument("--model-name", default="photon-ml-tpu-game")
    p.add_argument("--checkpoint-dir", default=None,
                   help="atomic per-outer-iteration training checkpoints; "
                        "an existing checkpoint there is resumed")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace of the fit "
                        "phase here (trace.json; view in Perfetto)")
    p.add_argument("--schedule", default="sync", choices=("sync", "async"),
                   help="coordinate-descent schedule: 'sync' (sequential, "
                        "bitwise-reproducible default) or 'async' "
                        "(bounded-staleness pipelined solves and random-effect "
                        "bucket overlap, each on its own CUDA stream)")
    p.add_argument("--staleness", type=int, default=1,
                   help="async schedule only: max unreconciled coordinate "
                        "updates a dispatch may ignore (0 = serialize, "
                        "bitwise equal to sync)")
    p.add_argument("--auto-tune", action="store_true",
                   help="A/B adaptive-RE solver configs on a 1-outer-"
                        "iteration trial fit before the real fit (judged by "
                        "the metrics registry); the winner trains the model "
                        "and is saved as the metadata's tuned_config")
    p.add_argument("--auto-tune-trials", type=int, default=2,
                   help="candidate configs trialed besides the incumbent "
                        "(default 2)")
    p.add_argument("--auto-tune-judge", default="autotune.wall_s",
                   help="registry metric that judges auto-tune trials, "
                        "minimized (default autotune.wall_s = trial "
                        "wall-clock)")
    p.add_argument("--auto-tune-report", default=None,
                   help="RunReport JSON from analyze_run; when given, trial "
                        "candidates come from the offline tuner's proposal "
                        "instead of ladder neighbors")
    p.add_argument("--progress-out", default=None, metavar="PROGRESS.jsonl",
                   help="write the convergence-plane ledger here: one JSONL "
                        "record per coordinate update (objective, grad norm, "
                        "coefficient delta, solver iterations) and per "
                        "held-out evaluation. "
                        "Replay with analyze_run --progress. Also arms the "
                        "divergence watchdog: NaN/Inf or increasing "
                        "objectives abort the run instead of saving garbage")
    p.add_argument("--introspect-port", type=int, default=None,
                   metavar="PORT",
                   help="serve live training introspection on "
                        "127.0.0.1:PORT (0 = ephemeral): /progress (JSON "
                        "convergence trace), /metrics (Prometheus), /healthz "
                        "(503 once the divergence watchdog trips), /varz. "
                        "Implies the convergence tracker even without "
                        "--progress-out")
    p.add_argument("--introspect-port-file", default=None,
                   help="write the bound introspection port here (for "
                        "--introspect-port 0)")
    p.add_argument("--introspect-hold", type=float, default=0.0,
                   metavar="SECONDS",
                   help="keep the introspection server up for at most this "
                        "long after training, until /quitquitquit")
    p.add_argument("--streaming", action="store_true",
                   help="out-of-core training: stream the training set from "
                        "disk in fixed-shape blocks through a pinned "
                        "host->device prefetcher instead of materializing "
                        "fixed-effect design matrices in memory (validation "
                        "data is still read in-memory)")
    p.add_argument("--block-rows", type=int, default=65536,
                   help="streaming: rows per example block; every block has "
                        "this exact (padded) shape (default 65536)")
    p.add_argument("--prefetch-depth", type=int, default=2,
                   help="streaming: staged blocks the background decode "
                        "thread may buffer ahead (0 = synchronous decode; "
                        "default 2 = double buffering). Host staging memory "
                        "is bounded by prefetch-depth x block bytes")
    p.add_argument("--block-cache-dir", default=None,
                   help="streaming: directory for the decoded block cache "
                        "(default: a '_block_cache' directory next to the "
                        "input data). The first pass decodes Avro once and "
                        "spills each padded block; later passes (and later "
                        "runs over identical inputs) reload blocks via mmap "
                        "with no decode work. Entries are keyed by a "
                        "fingerprint of the input files (path, size, "
                        "mtime_ns), block-rows, shard geometry and the "
                        "feature index maps (--offheap-indexmap-dir "
                        "contents included), so any input, index-map or "
                        "config change invalidates them")
    p.add_argument("--no-block-cache", action="store_true",
                   help="streaming: disable the decoded block cache and "
                        "re-decode Avro every pass")
    p.add_argument("--on-block-error", default="abort", choices=("abort", "skip"),
                   help="streaming: what to do when a block permanently "
                        "fails to decode after IO retries: 'abort' (default) "
                        "fails the fit; 'skip' drops the block from the "
                        "pass, records a resilience anomaly in the progress "
                        "ledger, and excludes it from gap scheduling")
    p.add_argument("--decode-workers", type=int, default=-1,
                   help="streaming: decode pool threads (-1 = auto: "
                        "cpu_count-1 capped at 16; 0 = synchronous decode in "
                        "the prefetch thread). Each worker decodes one part "
                        "file in a native call that releases the interpreter "
                        "lock")
    p.add_argument("--stream-mode", default="full", choices=("full", "stochastic"),
                   help="streaming solver: 'full' replays every block per "
                        "optimizer iteration (exact full-batch, default); "
                        "'stochastic' visits shuffled block groups per epoch")
    p.add_argument("--gap-schedule", action="store_true",
                   help="stochastic streaming only: visit blocks by "
                        "staleness-decayed duality-gap importance (DuHL) "
                        "instead of a blind per-epoch shuffle, with an "
                        "exploration floor refreshing stale blocks")
    p.add_argument("--resident-blocks", type=int, default=0, metavar="N",
                   help="streaming: keep up to N top-duality-gap blocks' "
                        "device tensors across passes; later passes upload "
                        "only the non-resident remainder, with the same fit "
                        "bitwise. 0 = off. Costs N x block upload bytes of "
                        "device memory")
    p.add_argument("--resident-bytes", type=int, default=None, metavar="B",
                   help="streaming: cap the resident set by device BYTES "
                        "instead of (or besides) --resident-blocks; the "
                        "tighter budget wins (B // block upload bytes "
                        "blocks)")
    add_telemetry_args(p)
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device to train on: 'cuda' (default) or 'cpu'")
    for flag, item in _UNPORTED.items():
        p.add_argument("--" + flag.replace("_", "-"), nargs="?", const=True, default=None,
                       help=f"not ported yet (ROADMAP.md, Queue A {item})")
    args = p.parse_args(argv)
    if args.staleness < 0:
        p.error("--staleness must be >= 0")
    if args.block_rows < 1:
        p.error("--block-rows must be >= 1")
    if args.prefetch_depth < 0:
        p.error("--prefetch-depth must be >= 0")
    if args.decode_workers < -1:
        p.error("--decode-workers must be >= -1 (-1 = auto)")
    if args.gap_schedule and not (args.streaming and args.stream_mode == "stochastic"):
        p.error(
            "--gap-schedule requires --streaming with "
            "--stream-mode stochastic (full-batch mode must visit every "
            "block per pass to stay exact)"
        )
    if args.resident_blocks < 0:
        p.error("--resident-blocks must be >= 0")
    if args.resident_bytes is not None and args.resident_bytes < 1:
        p.error("--resident-bytes must be >= 1")
    residency_on = args.resident_blocks > 0 or args.resident_bytes is not None
    if residency_on and not args.streaming:
        p.error("--resident-blocks/--resident-bytes require --streaming "
                "(they pin streamed block uploads)")
    if residency_on and args.stream_mode == "stochastic" and not args.gap_schedule:
        p.error("--resident-blocks/--resident-bytes with --stream-mode "
                "stochastic require --gap-schedule (the scheduler's gap "
                "feedback picks the resident set)")
    if args.introspect_port is not None and args.introspect_port < 0:
        p.error("--introspect-port must be >= 0 (0 = ephemeral)")
    return args


def _refuse_unported(args: argparse.Namespace) -> None:
    for flag, item in _UNPORTED.items():
        if getattr(args, flag) is not None:
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported yet (ROADMAP.md, Queue A {item})"
            )


def _default_block_cache_dir(train_dirs) -> str:
    """Default decoded-block cache location: a ``_block_cache`` directory
    next to the input part files (inside the first data directory, or
    beside the first file when inputs are listed as files), so the cache
    travels with, and is cleaned up with, the dataset; fingerprint keying
    makes sharing one directory across configurations safe."""
    first = str(train_dirs[0])
    base = first if os.path.isdir(first) else os.path.dirname(first)
    return os.path.join(base, "_block_cache")


def _check_streaming_compatible(args: argparse.Namespace) -> None:
    """--streaming replaces the in-memory training read; every flag whose
    implementation needs the materialized training GameData (or a second
    full-data pass) fails fast here rather than deep in the fit."""
    conflicts = [
        (args.compute_variance, "--compute-variance (Hessian-diagonal pass)"),
        (args.check_data, "--check-data (validates in-memory shards)"),
        (args.auto_tune, "--auto-tune (trial fits need in-memory data)"),
        (args.hyperparameter_tuning != "NONE", "--hyperparameter-tuning"),
        (args.normalization_type != "NONE",
         "--normalization-type (needs a streamed feature-stats pass)"),
        (bool(args.summarization_output_dir) or args.save_feature_stats,
         "feature-stats output (summarizes in-memory shards)"),
    ]
    bad = [name for flag, name in conflicts if flag]
    if bad:
        raise ValueError(
            "--streaming is incompatible with: " + "; ".join(bad)
            + ". Drop those flags or train in-memory."
        )


def _sweep_model_configs(sweeps, coordinates) -> List[dict]:
    """Cross product of the per-coordinate λ lists → ``fit_multiple``
    config maps (reference getAllModelConfigs)."""
    if not sweeps:
        return [{}]
    ids = sorted(sweeps)
    return [
        {cid: dataclasses.replace(coordinates[cid].optimizer, regularization_weight=w)
         for cid, w in zip(ids, combo)}
        for combo in itertools.product(*(sweeps[cid] for cid in ids))
    ]


def _apply_adaptive_knobs(coordinates: dict, knobs: dict) -> dict:
    """Return ``coordinates`` with the adaptive-RE knob values folded into
    every optimizer that carries an AdaptiveSolveConfig (frozen dataclasses
    throughout, so this is replace(), never mutation — the originals stay
    usable as the A/B control)."""
    out = {}
    for cid, cfg in coordinates.items():
        opt = getattr(cfg, "optimizer", None)
        adaptive = getattr(opt, "adaptive", None) if opt is not None else None
        if adaptive is None:
            out[cid] = cfg
            continue
        new_adaptive = dataclasses.replace(
            adaptive,
            chunk_iters=int(
                knobs.get("adaptive.chunk_iters", adaptive.chunk_iters)
            ),
            min_lanes=int(knobs.get("adaptive.min_lanes", adaptive.min_lanes)),
        )
        out[cid] = dataclasses.replace(
            cfg, optimizer=dataclasses.replace(opt, adaptive=new_adaptive)
        )
    return out


def _auto_tune_training(args, logger, estimator_kwargs, coordinates, data):
    """Iteration-0 A/B over the adaptive-RE knob space.

    Each candidate runs a 1-outer-iteration fit with its knob values and a
    FRESH MetricsRegistry fed by a trial-local emitter (trial A's solver
    counters cannot leak into trial B's judgment, and none of it pollutes
    the surrounding run's telemetry). Judged by ``--auto-tune-judge``
    (default: trial wall-clock). Returns (winner_knobs, ab_result_dict) —
    winner_knobs is {} when the incumbent wins."""
    spec = get_knob("adaptive.chunk_iters")
    incumbent = None
    for cfg in coordinates.values():
        adaptive = getattr(getattr(cfg, "optimizer", None), "adaptive", None)
        if adaptive is not None:
            incumbent = {
                "adaptive.chunk_iters": adaptive.chunk_iters,
                "adaptive.min_lanes": adaptive.min_lanes,
            }
            break
    if incumbent is None:
        logger.info("auto-tune: no adaptive-RE coordinate; nothing to tune")
        return {}, None

    candidates = [dict(incumbent)]
    if args.auto_tune_report:
        with open(args.auto_tune_report, "r", encoding="utf-8") as f:
            report = RunReport.from_dict(json.load(f))
        for cand in ab_candidates(propose(report), "train")[1:]:
            knobs = {
                k: v for k, v in cand.items() if k.startswith("adaptive.")
            }
            if knobs and knobs != incumbent:
                candidates.append({**incumbent, **knobs})
    else:
        ladder = list(spec.candidates)
        cur = incumbent["adaptive.chunk_iters"]
        for alt in sorted(ladder, key=lambda v: abs(v - cur)):
            if alt != cur:
                candidates.append(
                    {**incumbent, "adaptive.chunk_iters": alt}
                )
    candidates = candidates[: 1 + max(0, args.auto_tune_trials)]

    def _trial(knobs, registry):
        trial_emitter = EventEmitter()
        trial_emitter.register_listener(
            TelemetryEventListener(ledger=None, registry=registry)
        )
        try:
            trial = GameEstimator(
                coordinates=_apply_adaptive_knobs(coordinates, knobs),
                emitter=trial_emitter,
                **{**estimator_kwargs, "num_outer_iterations": 1},
            )
            trial.fit(data, validation_data=None)
        finally:
            trial_emitter.clear_listeners()

    logger.info(
        "auto-tune: %d candidate config(s) over 1-outer-iteration trials",
        len(candidates),
    )
    result = run_ab_trials(
        candidates,
        _trial,
        judge_metric=args.auto_tune_judge,
        minimize=True,
        logger=logger,
    )
    winner = result.winner
    logger.info(
        "auto-tune winner: trial %d %s=%s config=%s",
        winner.index,
        args.auto_tune_judge,
        f"{winner.score:.6g}" if winner.score is not None else "n/a",
        winner.config,
    )
    if winner.index == 0:
        return {}, result.to_dict()
    return dict(winner.config), result.to_dict()


def _weight_range(spec: str):
    parts = spec.split(",")
    if len(parts) != 2:
        raise ValueError(
            f"--regularization-weight-range expects lower,upper (e.g. 1e-4,1e4), got {spec!r}"
        )
    lo, hi = float(parts[0]), float(parts[1])
    if not (0 < lo < hi):
        raise ValueError(f"need 0 < lower < upper, got {lo}, {hi}")
    return (np.log10(lo), np.log10(hi))


def _config_with_overrides(raw_config: dict, overrides) -> dict:
    """The raw config with one sweep point's (or tuning trial's) λ folded
    in, so that each saved model's metadata names the configuration that
    trained it (reference Driver.scala:419-427). ``overrides`` values are
    optimizer configurations (a sweep) or coordinate configurations (a
    trial, with a factored coordinate's matrix λ)."""
    if not overrides:
        return raw_config
    cfg = json.loads(json.dumps(raw_config))
    for cid, o in overrides.items():
        opt = getattr(o, "optimizer", o)
        opt_cfg = cfg["coordinates"][cid].setdefault("optimizer", {})
        opt_cfg.pop("regularization_weights", None)
        opt_cfg["regularization_weight"] = opt.regularization_weight
        matrix = getattr(o, "matrix_optimizer", None)
        if matrix is not None:
            m_cfg = cfg["coordinates"][cid].setdefault("matrix_optimizer", {})
            m_cfg.pop("regularization_weights", None)
            m_cfg["regularization_weight"] = matrix.regularization_weight
    return cfg


@contextlib.contextmanager
def _profiled(profile_dir: Optional[str], device: torch.device):
    """A torch.profiler trace of the block, written to
    ``<profile_dir>/trace.json``, where the JAX CLI writes its
    jax.profiler trace."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


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
    """Train; returns the selected fit (of the sweep and the tuning trials,
    the best by the first evaluator)."""
    _refuse_unported(args)
    logger = setup_logger(args.log_file)
    device = resolve_device(args.device)
    timer = Timer()
    emitter = EventEmitter()
    for name in args.event_listeners:
        emitter.register_listener_class(name)
    telemetry = start_telemetry(args, "train_game", emitter=emitter)
    progress = None
    introspect = None
    try:
        if args.progress_out or args.introspect_port is not None:
            progress = ConvergenceTracker(
                ledger_path=args.progress_out, emitter=emitter, label="train_game"
            )
            # resilience failures land in the convergence ledger as they happen
            progress.attach_failure_sink()
        if args.introspect_port is not None:
            introspect = IntrospectionServer(
                varz=lambda: vars(args),
                health=progress.health,
                port=args.introspect_port,
                extra_json={"/progress": progress.progress_json},
            ).start()
            logger.info("introspection on http://%s:%d (/progress /metrics /healthz)",
                        introspect.host, introspect.port)
            if args.introspect_port_file:
                with open(args.introspect_port_file, "w") as f:
                    f.write(str(introspect.port))
        return _run(args, logger, device, emitter, timer, progress)
    finally:
        # the introspection hold runs first, so that /healthz (503 after a
        # divergence abort) and /progress stay readable before teardown
        if introspect is not None:
            if args.introspect_hold > 0:
                introspect.wait_quit(args.introspect_hold)
            introspect.stop()
        if progress is not None:
            progress.finish()
        # listeners flush and close even when the run fails; telemetry
        # finishes after them so that every bridged event is in the ledger
        emitter.clear_listeners()
        finish_telemetry(telemetry, phases=dict(timer.durations))


def _run(args: argparse.Namespace, logger, device, emitter: EventEmitter, timer: Timer,
         progress: Optional[ConvergenceTracker]) -> GameFit:
    t_start = time.perf_counter()
    emitter.send_event(PhotonSetupEvent(params=vars(args)))
    task = TaskType[args.task]
    shard_configs, coordinates, update_order, raw_config = load_game_config(
        args.coordinate_config
    )
    if args.updating_sequence:
        unknown = [c for c in args.updating_sequence if c not in coordinates]
        if unknown:
            raise ValueError(
                f"--updating-sequence names unknown coordinates {unknown}; "
                f"config has {sorted(coordinates)}"
            )
        update_order = list(args.updating_sequence)
    col_names = parse_input_columns(args.input_columns_names)
    if args.delete_output_dir_if_exists:
        delete_dirs_if_exist(args.output_dir)
    id_tags = sorted(id_tags_needed(coordinates))
    with timer.time("prepare feature maps"):
        index_maps = load_index_maps(args.offheap_indexmap_dir, shard_configs)
    train_dirs = expand_data_dirs(
        args.train_data_dirs, args.train_date_range, args.train_date_days_ago
    )
    source = data = None
    if args.streaming:
        _check_streaming_compatible(args)
        cache_dir = None
        if not args.no_block_cache:
            cache_dir = args.block_cache_dir or _default_block_cache_dir(train_dirs)
        with timer.time("open streaming source"):
            source = StreamingSource.open(
                train_dirs, shard_configs, index_maps=index_maps,
                block_rows=args.block_rows, id_tags=id_tags,
                decode_workers=None if args.decode_workers < 0 else args.decode_workers,
                cache_dir=cache_dir, **col_names,
            )
        source.on_block_error = args.on_block_error
        index_maps = source.index_maps
        logger.info(
            "training rows (streamed): %d in %d blocks of %d on %s "
            "(block cache: %s, decode workers: %d)",
            source.plan.total_rows, source.plan.num_blocks, args.block_rows, device,
            cache_dir or "off", source.decode_workers,
        )
    else:
        with timer.time("read training data"):
            data, index_maps, _ = read_game_data(
                train_dirs, shard_configs, index_maps, id_tags=id_tags, **col_names,
            )
        logger.info("training rows: %d on %s", data.num_rows, device)

    def check_shards(game_data, phase: str) -> None:
        """--check-data over every feature shard (reference CHECK_DATA wraps
        both the training and the validation read, Driver.scala:74-75)."""
        with timer.time(f"check data [{phase}]"):
            for sid in shard_configs:
                validate_labeled_data(LabeledData.create(
                    game_data.sparse_features(sid, engine="auto", device=device),
                    torch.from_numpy(game_data.labels).to(device),
                    offsets=torch.from_numpy(game_data.offsets).to(device),
                    weights=torch.from_numpy(game_data.weights).to(device),
                ), task)

    if args.check_data:
        check_shards(data, "train")

    # a grouped evaluator's tag must be read even when no coordinate uses it
    val_tags = list(id_tags)
    for spec in args.evaluator or []:
        tag = spec.partition(":")[2].strip()
        if tag and tag not in val_tags:
            val_tags.append(tag)
    validation_data = None
    if args.validation_data_dirs:
        validation_dirs = expand_data_dirs(
            args.validation_data_dirs, args.validation_date_range,
            args.validation_date_days_ago,
        )
        with timer.time("read validation data"):
            validation_data, _, _ = read_game_data(
                validation_dirs, shard_configs, index_maps, id_tags=val_tags, **col_names,
            )
        logger.info("validation rows: %d", validation_data.num_rows)
        if args.check_data:
            check_shards(validation_data, "validation")

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
            with timer.time(f"feature stats [{sid}]"):
                labeled = LabeledData.create(
                    data.sparse_features(sid, engine="auto", device=device),
                    torch.from_numpy(data.labels).to(device),
                    weights=torch.from_numpy(data.weights).to(device),
                )
                summary = summarize(labeled)
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

    estimator_kwargs = dict(
        task=task,
        update_order=update_order,
        num_outer_iterations=(
            args.num_outer_iterations
            if args.num_outer_iterations is not None
            else int(raw_config.get("num_outer_iterations", 1))
        ),
        normalization=normalization,
        intercept_indices=intercept_indices,
        device=device,
        compute_variance=False,  # trials skip variances; the real fit opts in
        schedule=args.schedule,
        staleness=args.staleness,
    )
    tuned_config: Dict[str, object] = {}
    if args.auto_tune:
        with timer.time("auto-tune"):
            tuned_config, ab_result = _auto_tune_training(
                args, logger, estimator_kwargs, coordinates, data
            )
        if tuned_config:
            coordinates = _apply_adaptive_knobs(coordinates, tuned_config)
        if ab_result is not None:
            os.makedirs(args.output_dir, exist_ok=True)
            with open(os.path.join(args.output_dir, "auto-tune.json"), "w") as f:
                json.dump(ab_result, f, indent=2, sort_keys=True)

    estimator = GameEstimator(
        coordinates=coordinates,
        evaluator=evaluator,
        extra_evaluators=extra,
        emitter=emitter,
        **{**estimator_kwargs, "compute_variance": args.compute_variance},
    )
    sweep_configs = _sweep_model_configs(coordinate_weight_sweeps(raw_config), coordinates)
    if args.streaming and len(sweep_configs) > 1:
        raise ValueError(
            "--streaming does not compose with regularization_weights "
            "sweeps (each swept fit would re-stream the dataset); pick "
            "one weight per coordinate or train in-memory"
        )
    if len(sweep_configs) > 1 and validation_data is None:
        raise ValueError(
            "regularization_weights sweeps need --validation-data-dirs: "
            "without a validation evaluator there is no way to select "
            "the best of the swept models"
        )
    if progress is not None and len(sweep_configs) > 1:
        raise ValueError(
            "--progress-out/--introspect-port track ONE fit's trajectory; "
            "they do not compose with regularization_weights sweeps"
        )
    emitter.send_event(TrainingStartEvent(task=args.task))
    fit_overrides: Dict[str, object] = {}
    with _profiled(args.profile_dir, device), timer.time("fit"):
        if args.streaming:
            fit = estimator.fit_streaming(
                source, validation_data=validation_data,
                checkpoint_dir=args.checkpoint_dir,
                prefetch_depth=args.prefetch_depth, mode=args.stream_mode,
                gap_schedule=args.gap_schedule,
                resident_blocks=args.resident_blocks,
                resident_bytes=args.resident_bytes, progress=progress,
            )
            all_fits, all_overrides = [fit], [{}]
        elif len(sweep_configs) > 1:
            # one fit per swept configuration over coordinates built once,
            # the best by the validation evaluator (reference
            # Driver.scala:112 selectBestModel over getAllModelConfigs)
            all_fits = estimator.fit_multiple(
                data, validation_data=validation_data, configs=sweep_configs,
                checkpoint_dir=args.checkpoint_dir,
            )
            for cfg_map, f in zip(sweep_configs, all_fits):
                logger.info(
                    "config %s -> metric %s",
                    {c: v.regularization_weight for c, v in cfg_map.items()},
                    "n/a" if f.validation_metric is None else "%.6f" % f.validation_metric,
                )
            best_i = estimator.select_best_fit(all_fits)
            if best_i is None:
                raise ValueError(
                    "no swept fit produced a validation metric; cannot select a best model"
                )
            fit, fit_overrides = all_fits[best_i], sweep_configs[best_i]
            all_overrides = list(sweep_configs)
        else:
            fit = estimator.fit(data, validation_data=validation_data,
                                checkpoint_dir=args.checkpoint_dir, progress=progress)
            all_fits, all_overrides = [fit], [{}]
    for cid, value in fit.objective_history:
        opt_cfg = fit_overrides.get(cid) or coordinates[cid].optimizer
        emitter.send_event(PhotonOptimizationLogEvent(
            coordinate_id=cid,
            regularization_weight=opt_cfg.regularization_weight,
            objective_value=value,
            iterations=-1,  # per-coordinate iteration counts live in the trackers
            convergence_reason="",
        ))
        logger.info("objective [%s]: %.6f", cid, value)
    if fit.validation_metric is not None:
        logger.info("validation metric: %.6f", fit.validation_metric)

    best, best_overrides = fit, fit_overrides
    if (args.hyperparameter_tuning != "NONE" and validation_data is not None
            and args.hyperparameter_tuning_iter > 0):
        tuning_kwargs = {}
        if args.regularization_weight_range:
            tuning_kwargs["log10_range"] = _weight_range(args.regularization_weight_range)
        with timer.time("hyperparameter tuning"):
            trials = run_hyperparameter_tuning(
                estimator, data, validation_data,
                mode=args.hyperparameter_tuning,
                num_iterations=args.hyperparameter_tuning_iter,
                prior_fits=[fit], warm_start=args.use_warm_start, **tuning_kwargs,
            )
        for t in trials:
            logger.info("trial lambda=%s metric=%.6f",
                        ["%.4g" % (10.0 ** v) for v in t.hyperparameters], t.value)
        # the winning trial's λ goes into the saved metadata too
        to_configs = GameEstimatorEvaluationFunction(estimator, None, None).vector_to_configuration
        better = estimator.evaluator.better_than
        for c, ovr in [(t.fit, to_configs(t.hyperparameters)) for t in trials]:
            if c.validation_metric is not None and (
                best.validation_metric is None
                or better(c.validation_metric, best.validation_metric)
            ):
                best, best_overrides = c, ovr

    def final_config(overrides) -> dict:
        """The configuration that trained a saved model, with the
        --auto-tune winner as ``tuned_config``."""
        cfg = _config_with_overrides(raw_config, overrides)
        if tuned_config:
            cfg = dict(cfg)
            cfg["tuned_config"] = dict(tuned_config)
        return cfg

    if args.model_output_mode != "NONE":
        with timer.time("save model"):
            save = dict(index_maps=index_maps, model_name=args.model_name,
                        num_output_files_per_random_effect=(
                            args.num_output_files_for_random_effect_model))
            save_game_model(best.model, os.path.join(args.output_dir, "best"),
                            configurations=final_config(best_overrides), **save)
            if args.model_output_mode == "ALL":
                # reference Driver.scala:416-433: every swept configuration's
                # model under <output>/all/<i>, each with its own
                # configuration
                for i, (f, ovr) in enumerate(zip(all_fits, all_overrides)):
                    save_game_model(f.model, os.path.join(args.output_dir, "all", str(i)),
                                    configurations=final_config(ovr), **save)
        logger.info("model saved to %s", os.path.join(args.output_dir, "best"))
    emitter.send_event(TrainingFinishEvent(
        task=args.task, wall_seconds=time.perf_counter() - t_start
    ))
    for name, seconds in timer.durations.items():
        logger.info("timing %-20s %.3fs", name, seconds)
    return best


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    try:
        run(args)
    except DivergenceError as e:
        # the watchdog already wrote the anomaly record and flipped
        # /healthz; abort without a model rather than save a diverged one
        print(f"training aborted by divergence watchdog: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())

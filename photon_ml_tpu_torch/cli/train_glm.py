"""Single-GLM training driver (the reference's "legacy" pipeline).

Port of ``photon_ml_tpu/cli/train_glm.py`` (reference Driver.scala:71,
run() :158-218): preprocess (read Avro or LibSVM, select features, validate,
feature statistics and normalization) → train (the λ sweep, warm-started,
ModelTraining.scala:106, by L-BFGS, TRON or OWL-QN, with box constraints) →
validate (the task's default metric per λ; the best λ, ModelSelection.scala:29)
→ output (``model-lambda-<λ>.txt`` per λ, ``best-model.avro``,
``selection.json``) → diagnose (``--diagnostic-mode TRAIN|VALIDATE|ALL``:
``model-diagnostic.html``; the learning curves' and the bootstrap's sub-fits
and every scoring run on the device, the statistics are host numpy).
Training runs on ``--device`` (default ``cuda``; ``cpu`` only when asked).

Usage:
    python -m photon_ml_tpu_torch.cli.train_glm \\
        --training-data-dirs data/train --validation-data-dirs data/test \\
        --task LOGISTIC_REGRESSION --regularization-weights 0.1 1 10 100 \\
        --output-dir out/ [--input-format LIBSVM] [--device cpu]

``--telemetry-out`` writes a JSONL run ledger (spans, events, metrics) and
``--trace-out`` a Chrome trace; the phases (``utils/timer.py``) are spans.

``--offheap-indexmap-dir`` reads AVRO input through the prebuilt off-heap
index stores of ``build_index`` (the ``features`` shard).

``--coordinator-address --num-processes --process-id`` join a
multi-process run on ``torch.distributed`` first.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.cli.common import (
    add_telemetry_args,
    delete_dirs_if_exist,
    finish_telemetry,
    load_index_maps,
    parse_box_constraints,
    parse_optimizer_config,
    setup_logger,
    start_telemetry,
)
from photon_ml_tpu_torch.cli.train_game import write_feature_stats
from photon_ml_tpu_torch.data.validators import DataValidationType, validate_labeled_data
from photon_ml_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from photon_ml_tpu_torch.estimators.model_training import train_glm
from photon_ml_tpu_torch.evaluation.evaluators import default_evaluator
from photon_ml_tpu_torch.event import (
    EventEmitter,
    PhotonOptimizationLogEvent,
    PhotonSetupEvent,
    TrainingFinishEvent,
    TrainingStartEvent,
)
from photon_ml_tpu_torch.indexmap import INTERCEPT_KEY, NAME_TERM_DELIMITER, feature_key
from photon_ml_tpu_torch.io import schemas
from photon_ml_tpu_torch.io.avro import read_avro_dir, write_avro_file
from photon_ml_tpu_torch.io.data_reader import FeatureShardConfiguration, read_game_data
from photon_ml_tpu_torch.io.libsvm import read_libsvm
from photon_ml_tpu_torch.normalization import build_normalization_context
from photon_ml_tpu_torch.ops.data import LabeledData
from photon_ml_tpu_torch.parallel.multihost import add_distributed_args, initialize_from_args
from photon_ml_tpu_torch.stat.summary import summarize
from photon_ml_tpu_torch.types import ConvergenceReason, NormalizationType, TaskType
from photon_ml_tpu_torch.utils.timer import Timer

def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="photon-ml-tpu-torch train-glm", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    add_distributed_args(p)
    p.add_argument("--training-data-dirs", nargs="+", required=True)
    p.add_argument("--validation-data-dirs", nargs="*", default=[])
    p.add_argument("--task", required=True, choices=[t.name for t in TaskType])
    p.add_argument("--output-dir", required=True)
    p.add_argument("--input-format", default="AVRO", choices=["AVRO", "LIBSVM"],
                   help="TRAINING_EXAMPLE avro or LibSVM text (reference "
                        "InputFormatFactory / LibSVMInputDataFormat)")
    p.add_argument("--feature-bags", nargs="+", default=["features"])
    p.add_argument("--add-intercept", dest="add_intercept", action="store_true", default=True)
    p.add_argument("--no-intercept", dest="add_intercept", action="store_false")
    p.add_argument("--regularization-weights", nargs="+", type=float, default=[0.0])
    p.add_argument("--optimizer", default="LBFGS", choices=["LBFGS", "TRON"])
    p.add_argument("--regularization", default="L2",
                   choices=["NONE", "L1", "L2", "ELASTIC_NET"])
    p.add_argument("--elastic-net-alpha", type=float, default=None)
    p.add_argument("--max-iterations", type=int, default=None)
    p.add_argument("--tolerance", type=float, default=None)
    p.add_argument("--normalization-type", default="NONE",
                   choices=[n.name for n in NormalizationType])
    p.add_argument("--coefficient-box-constraints", default=None,
                   help='JSON: global {"lower": -1.0, "upper": 1.0}, or the '
                        "reference's per-feature array "
                        '[{"name": "age", "term": "", "lowerBound": 0.0, '
                        '"upperBound": 1.0}, ...] with "*" wildcards '
                        "(GLMSuite constraint-map rules)")
    p.add_argument("--offheap-indexmap-dir", default=None,
                   help="read features through prebuilt off-heap index "
                        "stores (reference --offheap-indexmap-dir; AVRO "
                        "input only)")
    p.add_argument("--summarization-output-dir", default=None,
                   help="write per-feature summary stats as "
                        "FeatureSummarizationResultAvro")
    p.add_argument("--selected-features-file", default=None,
                   help="Avro file of name/term records; training uses only "
                        "these features (reference --selected-features-file)")
    p.add_argument("--data-validation", default="VALIDATE_FULL",
                   choices=[v.name for v in DataValidationType])
    p.add_argument("--compute-variances", action="store_true")
    p.add_argument("--delete-output-dirs-if-exist", action="store_true",
                   help="remove existing output (and summarization) dirs first")
    p.add_argument("--use-warm-start", dest="use_warm_start", action="store_true",
                   default=True,
                   help="warm-start each λ of the sweep from the previous "
                        "optimum (default on, reference USE_WARM_START)")
    p.add_argument("--no-warm-start", dest="use_warm_start", action="store_false")
    p.add_argument("--validate-per-iteration", action="store_true",
                   help="log the validation metric of every iteration's model "
                        "(reference VALIDATE_PER_ITERATION); needs "
                        "--validation-data-dirs")
    p.add_argument("--event-listeners", nargs="*", default=[], metavar="module.Class",
                   help="EventListener classes to register (reference "
                        "--event-listeners, Params.scala:186)")
    p.add_argument("--diagnostic-mode", default="NONE",
                   choices=["NONE", "TRAIN", "VALIDATE", "ALL"],
                   help="writes model-diagnostic.html (reference Driver "
                        "diagnose stage, DiagnosticMode.scala): TRAIN runs "
                        "the training-data diagnostics (learning curves + "
                        "bootstrap), VALIDATE the held-out diagnostics "
                        "(Hosmer-Lemeshow, error independence, feature "
                        "importance), ALL both")
    p.add_argument("--log-file", default=None)
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device to train on: 'cuda' (default) or 'cpu'")
    add_telemetry_args(p)
    return p.parse_args(argv)


def _filter_selected_features(data, imap, path: str, logger):
    """Keep only the features named in the Avro name/term file, and the
    intercept (reference GLMSuite.getSelectedFeatureSetFromFile:139-146):
    the other entries of the shard are dropped, the dimension unchanged."""
    selected = {
        feature_key(str(rec["name"]), str(rec.get("term") or "")) for rec in read_avro_dir(path)
    }
    if not selected:
        raise ValueError(
            f"--selected-features-file {path!r} yielded no name/term "
            "records; refusing to silently train on ALL features"
        )
    keep_idx = [i for i in map(imap.get_index, sorted(selected) + [INTERCEPT_KEY]) if i >= 0]
    keep_mask = np.zeros(len(imap), dtype=bool)
    keep_mask[keep_idx] = True
    shard = data.feature_shards["features"]
    m = keep_mask[shard.cols]
    logger.info(
        "selected-features filter: %d/%d features kept, %d/%d entries",
        len(keep_idx), len(imap), int(m.sum()), len(shard.cols),
    )
    return dataclasses.replace(
        data,
        feature_shards={"features": dataclasses.replace(
            shard, rows=shard.rows[m], cols=shard.cols[m], vals=shard.vals[m]
        )},
    )


def _labeled(data, device, norm=None) -> LabeledData:
    return LabeledData.create(
        data.sparse_features("features", engine="auto", device=device),
        torch.from_numpy(data.labels).to(device),
        offsets=torch.from_numpy(data.offsets).to(device),
        weights=torch.from_numpy(data.weights).to(device),
        norm=norm,
    )


def _split_key(imap, i: int):
    key = imap.get_feature_name(int(i)) or str(i)
    name, _, term = key.partition(NAME_TERM_DELIMITER)
    return name, term


def _write_model_text(path: str, w, variances, index_map) -> None:
    """Per-feature text 'name<TAB>term<TAB>value[<TAB>variance]' (reference
    IOUtils.writeModelsInText, Driver.scala:213)."""
    w = w.cpu().numpy()
    var = None if variances is None else variances.cpu().numpy()
    with open(path, "w") as f:
        for i in np.flatnonzero(w):
            name, term = _split_key(index_map, i)
            line = f"{name}\t{term}\t{w[i]:.17g}"
            if var is not None:
                line += f"\t{var[i]:.17g}"
            f.write(line + "\n")


def run(args: argparse.Namespace) -> dict:
    logger = setup_logger(args.log_file)
    device = resolve_device(args.device)
    emitter = EventEmitter()
    for name in args.event_listeners:
        emitter.register_listener_class(name)
    timer = Timer()
    telemetry = start_telemetry(args, "train_glm", emitter=emitter)
    try:
        return _run(args, logger, device, emitter, timer)
    finally:
        # listeners flush and close even when the run fails; telemetry
        # finishes after them so that every bridged event is in the ledger
        emitter.clear_listeners()
        finish_telemetry(telemetry, phases=dict(timer.durations))


def _read(args, task, paths, feature_dimension=None, index_maps=None):
    """(GameData, index maps) of Avro or LibSVM input."""
    if args.input_format == "LIBSVM":
        if len(paths) > 1:
            raise ValueError("LIBSVM input takes a single path")
        data, imap = read_libsvm(
            paths[0], feature_dimension=feature_dimension, use_intercept=args.add_intercept,
            binarize_labels=task.is_classification,
        )
        return data, {"features": imap}
    shard_cfg = {"features": FeatureShardConfiguration(
        feature_bags=args.feature_bags, add_intercept=args.add_intercept
    )}
    data, index_maps, _ = read_game_data(paths, shard_cfg, index_maps)
    return data, index_maps


def _run(args, logger, device, emitter: EventEmitter, timer: Timer) -> dict:
    task = TaskType[args.task]
    emitter.send_event(PhotonSetupEvent(params=vars(args)))
    t_start = time.perf_counter()
    if args.validate_per_iteration and not args.validation_data_dirs:
        raise ValueError("--validate-per-iteration requires --validation-data-dirs")
    if args.input_format == "LIBSVM":
        for flag in ("offheap_indexmap_dir", "selected_features_file"):
            if getattr(args, flag):
                raise ValueError(
                    f"--{flag.replace('_', '-')} applies to AVRO input "
                    "(LIBSVM features are positional)"
                )
    if args.delete_output_dirs_if_exist:
        delete_dirs_if_exist(args.output_dir, args.summarization_output_dir)

    with timer.time("preprocess"):
        data, index_maps = _read(args, task, args.training_data_dirs, index_maps=load_index_maps(
            args.offheap_indexmap_dir, ["features"]))
        imap = index_maps["features"]
        if args.selected_features_file:
            data = _filter_selected_features(data, imap, args.selected_features_file, logger)
        labeled = _labeled(data, device)
        validate_labeled_data(labeled, task, DataValidationType[args.data_validation])
        icpt = imap.get_index(INTERCEPT_KEY)
        intercept_index = icpt if icpt >= 0 else None
        norm_type = NormalizationType[args.normalization_type]
        if norm_type is not NormalizationType.NONE or args.summarization_output_dir:
            summary = summarize(labeled)
            if args.summarization_output_dir:
                write_feature_stats(args.summarization_output_dir, summary, imap)
        if norm_type is not NormalizationType.NONE:
            norm = build_normalization_context(
                norm_type, mean=summary.mean, variance=summary.variance,
                max_magnitude=summary.max_abs, intercept_index=intercept_index,
            )
            labeled = _labeled(data, device, norm=norm)
    logger.info("rows: %d features: %d on %s", data.num_rows, len(imap), device)

    opt_cfg = {"optimizer": args.optimizer, "regularization": args.regularization}
    if args.elastic_net_alpha is not None:
        opt_cfg["alpha"] = args.elastic_net_alpha
    if args.max_iterations is not None:
        opt_cfg["max_iterations"] = args.max_iterations
    if args.tolerance is not None:
        opt_cfg["tolerance"] = args.tolerance
    scalar_lo, scalar_hi, box_constraints = parse_box_constraints(
        args.coefficient_box_constraints, imap, len(imap), intercept_index=intercept_index,
    )
    if scalar_lo is not None:
        opt_cfg["constraint_lower"] = scalar_lo
    if scalar_hi is not None:
        opt_cfg["constraint_upper"] = scalar_hi
    configuration = parse_optimizer_config(opt_cfg)

    emitter.send_event(TrainingStartEvent(task=task.name))
    with timer.time("train"):
        fits = train_glm(
            labeled, task, configuration,
            regularization_weights=args.regularization_weights,
            warm_start=args.use_warm_start,
            compute_variances=args.compute_variances,
            track_models=args.validate_per_iteration,
            intercept_index=intercept_index,
            box_constraints=box_constraints,
        )
    for fit in fits:
        emitter.send_event(PhotonOptimizationLogEvent(
            coordinate_id=None,
            regularization_weight=fit.regularization_weight,
            objective_value=float(fit.result.value[0]),
            iterations=int(fit.result.iterations[0]),
            convergence_reason=ConvergenceReason(int(fit.result.reason[0])).name,
        ))

    # validate: the metric of each λ, the best by the task's default metric
    # (reference Driver.validate + ModelSelection.selectBestModel)
    evaluator = default_evaluator(task)
    metrics: Dict[float, float] = {}
    per_iter_metrics: Dict[float, List[float]] = {}
    best_lambda = fits[0].regularization_weight
    vdata = None
    if args.validation_data_dirs:
        with timer.time("validate"):
            vdata, _ = _read(
                args, task, args.validation_data_dirs,
                feature_dimension=len(imap) - 1 if args.add_intercept else len(imap),
                index_maps=index_maps,
            )
            vfeats = vdata.sparse_features("features", engine="auto", device=device)
            voffsets = torch.from_numpy(vdata.offsets).to(device)

            def metric(model) -> float:
                scores = model.compute_score(vfeats) + voffsets
                return evaluator.evaluate(scores, vdata.labels, vdata.weights)

            for fit in fits:
                metrics[fit.regularization_weight] = metric(fit.model)
                logger.info("lambda=%g %s=%.6f", fit.regularization_weight, evaluator.name,
                            metrics[fit.regularization_weight])
                curve = []
                for i, tm in enumerate(fit.tracked_models or ()):
                    # the metric-vs-iteration curve (reference validatePerIteration)
                    curve.append(metric(tm))
                    logger.info("lambda=%g iteration=%d %s=%.6f", fit.regularization_weight,
                                i, evaluator.name, curve[-1])
                if curve:
                    per_iter_metrics[fit.regularization_weight] = curve
        best_lambda = None
        for lam, m in metrics.items():
            # NaN never wins (reference Evaluator.betterThan)
            if best_lambda is None or evaluator.better_than(m, metrics[best_lambda]):
                best_lambda = lam
        logger.info("best lambda: %g", best_lambda)

    with timer.time("output"):
        os.makedirs(args.output_dir, exist_ok=True)
        for fit in fits:
            _write_model_text(
                os.path.join(args.output_dir, f"model-lambda-{fit.regularization_weight:g}.txt"),
                fit.model.coefficients.means, fit.model.coefficients.variances, imap,
            )
        best = next(f for f in fits if f.regularization_weight == best_lambda)
        means = best.model.coefficients.means.cpu().numpy()
        ntv = []
        for i in np.flatnonzero(means):
            name, term = _split_key(imap, i)
            ntv.append({"name": name, "term": term, "value": float(means[i])})
        write_avro_file(
            os.path.join(args.output_dir, "best-model.avro"),
            schemas.bayesian_linear_model_schema(),
            [{"modelId": "best", "modelClass": None, "means": ntv, "variances": None,
              "lossFunction": None}],
        )
        with open(os.path.join(args.output_dir, "selection.json"), "w") as f:
            json.dump({
                "best_lambda": best_lambda,
                "metrics": {str(k): v for k, v in metrics.items()},
                "evaluator": evaluator.name,
            }, f, indent=2)
    if args.diagnostic_mode != "NONE":
        with timer.time("diagnose"):
            _diagnose(
                args, task, data, labeled, fits, best_lambda, imap, intercept_index,
                configuration, logger, device, val_data=vdata,
                metric_vs_iteration=per_iter_metrics or None, metric_name=evaluator.name,
                box_constraints=box_constraints,
            )

    emitter.send_event(TrainingFinishEvent(
        task=task.name, wall_seconds=time.perf_counter() - t_start
    ))
    for name, seconds in timer.durations.items():
        logger.info("timing %-12s %.3fs", name, seconds)
    return {"best_lambda": best_lambda, "metrics": metrics, "fits": fits}


def _diagnose(
    args, task, data, labeled, fits, best_lambda, imap, intercept_index,
    configuration, logger, device, val_data=None, metric_vs_iteration=None,
    metric_name="metric", box_constraints=None,
) -> str:
    """Reference Driver diagnose() stage (Driver.scala:612-638), as the JAX
    CLI runs it: TRAIN|ALL the training-data diagnostics (FittingDiagnostic
    learning curves, BootstrapTrainingDiagnostic), VALIDATE|ALL the
    held-out ones (Hosmer-Lemeshow, prediction-error independence, mean and
    variance feature importance), on the validation set when one was given,
    else the training set. The sub-fits and the scoring run on ``device``.

    A row subset's data and device layout are built once while the caller
    holds its index array: the learning curves score the holdout after
    every portion and each portion's rows right after fitting them.
    Returns the report's path."""
    from photon_ml_tpu_torch.diagnostics import (
        bootstrap_training,
        evaluate_metrics,
        expected_magnitude_importance,
        fitting_diagnostic,
        hosmer_lemeshow_diagnostic,
        prediction_error_independence,
        variance_importance,
    )
    from photon_ml_tpu_torch.diagnostics.evaluation import _sigmoid
    from photon_ml_tpu_torch.diagnostics.report import (
        build_diagnostic_document,
        write_diagnostic_report,
    )

    do_train = args.diagnostic_mode in ("TRAIN", "ALL")
    do_validate = args.diagnostic_mode in ("VALIDATE", "ALL")
    lambdas = [f.regularization_weight for f in fits]
    best = next(f for f in fits if f.regularization_weight == best_lambda)

    def score(model, gdata) -> np.ndarray:
        # f32 margins plus f32 offsets, as the reference's scores
        feats = gdata.sparse_features("features", engine="auto", device=device)
        return model.compute_score(feats).cpu().numpy() + gdata.offsets

    ddata = val_data if val_data is not None else data
    scores = score(best.model, ddata)
    metrics = evaluate_metrics(scores, ddata.labels, task, ddata.weights)

    subs: Dict[int, tuple] = {}

    def rows_of(idx):
        hit = subs.get(id(idx))
        if hit is not None and hit[0]() is idx:
            return hit[1]
        sub = data.take_rows(idx)
        sub_labeled = _labeled(sub, device, norm=labeled.norm)
        key = id(idx)
        subs[key] = (weakref.ref(idx, lambda _: subs.pop(key, None)), (sub, sub_labeled))
        return sub, sub_labeled

    def sub_fits(idx, weights):
        sub, sub_labeled = rows_of(idx)
        # the diagnosed model's normalization: the regularizer acts in the
        # normalized space, so dropping it would bootstrap another estimator
        return sub, train_glm(
            sub_labeled, task, configuration, regularization_weights=weights,
            intercept_index=intercept_index, box_constraints=box_constraints,
        )

    fitting = None
    bootstrap = None
    if do_train:
        def fit_portion(idx, warm):
            # ignores ``warm`` (cold fits a portion), as the reference does
            _, sub_fit = sub_fits(idx, lambdas)
            return {f.regularization_weight: f.model for f in sub_fit}

        def eval_rows(model, idx):
            sub = rows_of(idx)[0]
            return evaluate_metrics(score(model, sub), sub.labels, task, sub.weights)

        fitting = fitting_diagnostic(fit_portion, eval_rows, data.num_rows, len(imap), seed=0)

        def boot_train(idx):
            sub, sub_fit = sub_fits(idx, [best_lambda])
            model = sub_fit[0].model
            return (
                model.coefficients.means.cpu().numpy(),
                evaluate_metrics(score(model, sub), sub.labels, task, sub.weights),
            )

        bootstrap = bootstrap_training(boot_train, data.num_rows, num_samples=6, seed=0)
    subs.clear()

    hl = None
    independence = None
    importance = None
    importance_var = None
    if do_validate:
        if task is TaskType.LOGISTIC_REGRESSION:
            hl = hosmer_lemeshow_diagnostic(_sigmoid(scores), ddata.labels, len(imap))
        independence = prediction_error_independence(scores, ddata.labels, max_items=2000)
        # the importance scales (E|x|, Var x) come from the training
        # summary, as the reference's preprocessing-stage summary
        summary = summarize(labeled)
        means = best.model.coefficients.means.cpu().numpy()
        importance = expected_magnitude_importance(
            means, mean_abs=summary.mean_abs.cpu().numpy(), index_map=imap)
        importance_var = variance_importance(
            means, variance=summary.variance.cpu().numpy(), index_map=imap)

    doc = build_diagnostic_document(
        f"Model diagnostics (lambda = {best_lambda:g})",
        metrics=metrics,
        fitting=fitting,
        bootstrap=bootstrap,
        hosmer_lemeshow=hl,
        independence=independence,
        importance=importance,
        importance_variance=importance_var,
        metric_vs_iteration=metric_vs_iteration,
        metric_name=metric_name,
    )
    out = write_diagnostic_report(args.output_dir, doc)
    logger.info("diagnostic report: %s", out)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    # the process group (or the single-process no-op) before any device use
    initialize_from_args(args)
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())

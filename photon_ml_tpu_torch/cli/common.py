"""Shared CLI plumbing: logger setup, output removal, input column names,
date-range expansion of the data dirs, the JSON coordinate config → typed
configs and its λ sweep lists, and coefficient box constraints.

Port of the parts of ``photon_ml_tpu/cli/common.py`` that ``score_game``,
``train_game`` and ``train_glm`` use, the telemetry flags
(``--telemetry-out``, ``--trace-out``) among them (reference
GameTrainingParams.scala:269-610; the config mini-languages replaced by
JSON, GLMOptimizationConfiguration.scala:64-67,
RandomEffectDataConfiguration.scala:78-143; the per-feature constraint map
of GLMSuite.createConstraintFeatureMap:206-282).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from photon_ml_tpu_torch.algorithm.factored_random_effect import MFOptimizationConfiguration
from photon_ml_tpu_torch.data.random_effect import RandomEffectDataConfiguration
from photon_ml_tpu_torch.estimators.game import (
    CoordinateConfiguration,
    FactoredRandomEffectCoordinateConfiguration,
    FixedEffectCoordinateConfiguration,
    RandomEffectCoordinateConfiguration,
)
from photon_ml_tpu_torch.indexmap import NAME_TERM_DELIMITER, IndexMap, feature_key
from photon_ml_tpu_torch.indexmap.offheap import OffHeapIndexMap
from photon_ml_tpu_torch.io.data_reader import FeatureShardConfiguration
from photon_ml_tpu_torch.opt.config import (
    AdaptiveSolveConfig,
    GlmOptimizationConfiguration,
    OptimizerConfig,
    OptimizerType,
    RegularizationContext,
)
from photon_ml_tpu_torch.projector import ProjectorType
from photon_ml_tpu_torch.types import RegularizationType
from photon_ml_tpu_torch.utils.date_range import paths_for_date_range

LOGGER_NAME = "photon_ml_tpu_torch"


def setup_logger(log_file: Optional[str] = None, level: str = "INFO") -> logging.Logger:
    """Driver logging to stderr, and to ``log_file`` when given (reference
    util/PhotonLogger.scala:36: a per-job log file); ``PHOTON_LOG_LEVEL``
    overrides ``level``. Idempotent: a second run in one process closes the
    first run's handlers instead of stacking them."""
    logger = logging.getLogger(LOGGER_NAME)
    level = os.environ.get("PHOTON_LOG_LEVEL", level)
    resolved = getattr(logging, str(level).upper(), None)
    if not isinstance(resolved, int):
        logger.warning("unknown log level %r, falling back to INFO", level)
        resolved = logging.INFO
    logger.setLevel(resolved)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(name)s %(message)s")
    handlers: List[logging.Handler] = [logging.StreamHandler(sys.stderr)]
    if log_file:
        parent = os.path.dirname(log_file)
        if parent:
            os.makedirs(parent, exist_ok=True)
        handlers.append(logging.FileHandler(log_file))
    for h in handlers:
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger


def add_telemetry_args(parser) -> None:
    """``--telemetry-out`` / ``--trace-out``: shared by the drivers."""
    parser.add_argument(
        "--telemetry-out",
        default=None,
        metavar="LEDGER.jsonl",
        help="write a JSONL run ledger (spans, events, metrics snapshot) "
        "to this path; enables span tracing for the run",
    )
    parser.add_argument(
        "--trace-out",
        default=None,
        metavar="TRACE.json",
        help="write a Chrome trace-event file (load in Perfetto or "
        "chrome://tracing) to this path; enables span tracing for the run",
    )


def start_telemetry(args, label: str, emitter=None):
    """Start a telemetry run when the driver asked for one (either flag);
    returns None otherwise. ``emitter`` gets the event->ledger bridge."""
    ledger_path = getattr(args, "telemetry_out", None)
    trace_path = getattr(args, "trace_out", None)
    if not ledger_path and not trace_path:
        return None
    from photon_ml_tpu_torch.telemetry import start_run

    run = start_run(label, ledger_path=ledger_path, trace_path=trace_path)
    if emitter is not None:
        run.attach(emitter)
    return run


def finish_telemetry(run, **extra):
    """Finish a run from ``start_telemetry`` (None-safe); disables the
    tracer again so later driver runs in-process start clean."""
    if run is None:
        return None
    from photon_ml_tpu_torch.telemetry import disable_tracing

    try:
        return run.finish(extra=extra or None)
    finally:
        disable_tracing()


def delete_dirs_if_exist(*dirs: Optional[str]) -> None:
    """Remove stale output dirs (reference DELETE_OUTPUT_DIR_IF_EXISTS);
    None entries skipped."""
    for d in dirs:
        if d and os.path.isdir(d):
            shutil.rmtree(d)


def parse_input_columns(spec: Optional[str]) -> Dict[str, str]:
    """``--input-columns-names`` JSON → ``read_game_data`` field kwargs
    (reference InputColumnsNames: response/offset/weight/uid)."""
    if not spec:
        return {}
    raw_cols = json.loads(spec)
    allowed = {"response", "offset", "weight", "uid"}
    bad = set(raw_cols) - allowed
    if bad:
        raise ValueError(
            f"--input-columns-names has unknown keys {sorted(bad)}; "
            f"allowed: {sorted(allowed)}"
        )
    return {f"{k}_field": v for k, v in raw_cols.items()}


def parse_optimizer_config(cfg: dict) -> GlmOptimizationConfiguration:
    """JSON dict → GlmOptimizationConfiguration. Keys mirror the reference
    mini-language fields: optimizer, max_iterations, tolerance,
    regularization, alpha, regularization_weight, down_sampling_rate, plus
    box constraints and the adaptive random-effect driver's knobs. The
    sweep list ``regularization_weights`` (plural) may stand in for the
    weight: its first entry is the single-configuration weight, and the
    ``train_game`` sweeps the list (``coordinate_weight_sweeps``)."""
    opt_type = OptimizerType[cfg.get("optimizer", "LBFGS").upper()]
    kw = {}
    if "max_iterations" in cfg:
        kw["max_iterations"] = int(cfg["max_iterations"])
    if "tolerance" in cfg:
        kw["tolerance"] = float(cfg["tolerance"])
    if "constraint_lower" in cfg:
        kw["constraint_lower"] = cfg["constraint_lower"]
    if "constraint_upper" in cfg:
        kw["constraint_upper"] = cfg["constraint_upper"]
    if opt_type is OptimizerType.TRON:
        for key in ("history_length", "history_dtype"):
            if key in cfg:
                raise ValueError(f"{key} applies to LBFGS/OWL-QN, not TRON")
        opt = OptimizerConfig.tron(**kw)
    else:
        if "history_length" in cfg:
            kw["history_length"] = int(cfg["history_length"])
        if "history_dtype" in cfg:
            kw["history_dtype"] = cfg["history_dtype"]
        opt = OptimizerConfig.lbfgs(**kw)
    reg_type = RegularizationType[cfg.get("regularization", "NONE").upper()]
    reg = RegularizationContext(reg_type, alpha=cfg.get("alpha"))
    weight = cfg.get("regularization_weight")
    if weight is not None and cfg.get("regularization_weights"):
        raise ValueError(
            "give either regularization_weight or the sweep list "
            "regularization_weights, not both"
        )
    if weight is None:
        ws = cfg.get("regularization_weights")
        weight = ws[0] if ws else 0.0
    adaptive = AdaptiveSolveConfig()
    adaptive_cfg = cfg.get("adaptive")
    if adaptive_cfg is not None:
        akw = {}
        if "enabled" in adaptive_cfg:
            akw["enabled"] = bool(adaptive_cfg["enabled"])
        if "chunk_iters" in adaptive_cfg:
            akw["chunk_iters"] = int(adaptive_cfg["chunk_iters"])
        if "min_lanes" in adaptive_cfg:
            akw["min_lanes"] = int(adaptive_cfg["min_lanes"])
        adaptive = AdaptiveSolveConfig(**akw)
    return GlmOptimizationConfiguration(
        optimizer_config=opt,
        regularization=reg,
        regularization_weight=float(weight),
        down_sampling_rate=float(cfg.get("down_sampling_rate", 1.0)),
        adaptive=adaptive,
    )


def coordinate_weight_sweeps(raw: dict) -> Dict[str, List[float]]:
    """Per-coordinate λ sweep lists from the raw config JSON: a
    coordinate's optimizer block may give ``"regularization_weights": [w1,
    w2, ...]`` instead of one weight; ``train_game`` fits the cross
    product of every sweeping coordinate's weights, one GAME model each,
    and selects the best by the validation evaluator (reference
    getAllModelConfigs, GameTrainingParams.scala:212-223)."""
    out: Dict[str, List[float]] = {}
    for cid, c in (raw.get("coordinates") or {}).items():
        ws = (c.get("optimizer") or {}).get("regularization_weights")
        if ws:
            out[cid] = [float(w) for w in ws]
    return out


def expand_data_dirs(
    dirs: List[str], date_range: Optional[str], days_ago: Optional[str]
) -> List[str]:
    """Date-range expansion shared by the CLIs (reference
    --train-date-range / --date-range): each dir expands to its daily
    yyyy/MM/dd subdirs; an empty result fails fast."""
    out = paths_for_date_range(dirs, date_range, days_ago)
    if not out:
        raise FileNotFoundError(f"no input dirs in date range under {dirs}")
    return out


def parse_re_data_config(cfg: dict, re_type: str) -> RandomEffectDataConfiguration:
    return RandomEffectDataConfiguration(
        random_effect_type=re_type,
        active_data_upper_bound=cfg.get("active_data_upper_bound"),
        passive_data_lower_bound=cfg.get("passive_data_lower_bound"),
        features_to_samples_ratio=cfg.get("features_to_samples_ratio"),
        max_local_features=cfg.get("max_local_features"),
        num_buckets=int(cfg.get("num_buckets", 1)),
        projector=ProjectorType[cfg.get("projector", "INDEX_MAP").upper()],
        projected_dim=cfg.get("projected_dim"),
    )


def parse_coordinate_config(cfg: dict) -> CoordinateConfiguration:
    ctype = cfg.get("type", "fixed").lower()
    shard = cfg["feature_shard"]
    optimizer = parse_optimizer_config(cfg.get("optimizer", {}))
    if ctype == "fixed":
        return FixedEffectCoordinateConfiguration(
            feature_shard=shard,
            optimizer=optimizer,
            sparse_engine=cfg.get("sparse_engine", "auto"),
        )
    if ctype not in ("random", "factored_random"):
        raise ValueError(f"unknown coordinate type: {ctype}")
    re_type = cfg["random_effect_type"]
    data = parse_re_data_config(cfg.get("data", {}), re_type)
    if ctype == "random":
        return RandomEffectCoordinateConfiguration(
            feature_shard=shard, data=data, optimizer=optimizer
        )
    mf = cfg.get("mf", {})
    return FactoredRandomEffectCoordinateConfiguration(
        feature_shard=shard,
        data=data,
        mf=MFOptimizationConfiguration(
            num_latent_factors=int(mf.get("num_latent_factors", 8)),
            num_iterations=int(mf.get("num_iterations", 2)),
        ),
        optimizer=optimizer,
        matrix_optimizer=(
            parse_optimizer_config(cfg["matrix_optimizer"])
            if "matrix_optimizer" in cfg else None
        ),
    )


def load_game_config(path: str) -> Tuple[
    Dict[str, FeatureShardConfiguration],
    Dict[str, CoordinateConfiguration],
    List[str],
    dict,
]:
    """Load the typed JSON coordinate-config file. Returns (shard configs,
    coordinate configs, update order, the raw dict for metadata)."""
    with open(path) as f:
        raw = json.load(f)
    shards = {
        sid: FeatureShardConfiguration(
            feature_bags=s["feature_bags"],
            add_intercept=bool(s.get("add_intercept", True)),
        )
        for sid, s in raw["feature_shards"].items()
    }
    coordinates = {
        cid: parse_coordinate_config(c) for cid, c in raw["coordinates"].items()
    }
    update_order = raw.get("update_order", list(coordinates))
    return shards, coordinates, update_order, raw


def parse_box_constraints(
    spec: Optional[str], index_map, dim: int, intercept_index: Optional[int] = None,
):
    """``--coefficient-box-constraints`` → (scalar_lower, scalar_upper,
    per_feature_box_or_None).

    Two payloads are accepted:
    - ``{"lower": s, "upper": s}``: global scalar bounds;
    - the reference's JSON array of ``{"name", "term", "lowerBound",
      "upperBound"}`` maps (GLMSuite.createConstraintFeatureMap:206-282):
      every map names both name and term; at least one bound is finite and
      lower < upper; ``name='*', term='*'`` bounds every feature but the
      intercept and combines with no other entry; ``term='*'`` alone bounds
      every feature whose name part equals ``name`` and combines with
      entries that do not overlap it; a wildcard name needs a wildcard
      term; a feature bounded twice is refused.
    """
    if not spec:
        return None, None, None
    payload = json.loads(spec)
    if isinstance(payload, dict):
        return payload.get("lower"), payload.get("upper"), None
    if not isinstance(payload, list):
        raise ValueError(
            "--coefficient-box-constraints expects a JSON object with "
            "lower/upper or the reference's JSON array of per-feature maps"
        )
    WILD = "*"
    lower = np.full(dim, -np.inf, dtype=np.float32)
    upper = np.full(dim, np.inf, dtype=np.float32)
    assigned = np.zeros(dim, dtype=bool)

    # one pass over the index map finds the features of every term-wildcard
    # entry at once
    wild_names = {
        str(e["name"]) for e in payload
        if isinstance(e, dict) and e.get("term") == WILD and e.get("name") not in (None, WILD)
    }
    by_name: Dict[str, List[int]] = {nm: [] for nm in wild_names}
    if wild_names:
        for key, idx in index_map.items():
            # empty-term features carry the bare name as their key
            name_part = key.split(NAME_TERM_DELIMITER, 1)[0]
            if name_part in by_name:
                by_name[name_part].append(idx)

    def _set(idx: int, lo: float, hi: float, what: str) -> None:
        if assigned[idx]:
            raise ValueError(
                f"overlapping constraints for {what} (reference GLMSuite "
                "conflict rule: a feature may be bounded at most once)"
            )
        lower[idx] = lo
        upper[idx] = hi
        assigned[idx] = True

    for entry in payload:
        if "name" not in entry or "term" not in entry:
            raise ValueError(f"constraint map {entry!r} must name both 'name' and 'term'")
        # JSON null == missing: unbounded on that side
        lo_raw, hi_raw = entry.get("lowerBound"), entry.get("upperBound")
        lo = float(lo_raw) if lo_raw is not None else -np.inf
        hi = float(hi_raw) if hi_raw is not None else np.inf
        name, term = str(entry["name"]), str(entry["term"])
        if np.isnan(lo) or np.isnan(hi):
            raise ValueError(f"constraint for {name!r}/{term!r} has a NaN bound")
        if not np.isfinite(lo) and not np.isfinite(hi):
            raise ValueError(
                f"constraint for {name!r}/{term!r} has -Inf and +Inf "
                "bounds: a no-op entry is an invalid specification "
                "(reference GLMSuite.scala:224)"
            )
        if lo >= hi:
            raise ValueError(
                f"constraint lower bound {lo} must be strictly below the "
                f"upper bound {hi} for {name!r}/{term!r} (reference "
                "GLMSuite.scala:228)"
            )
        if name == WILD and term != WILD:
            raise ValueError(
                "a wildcard name requires a wildcard term (reference GLMSuite.scala:245)"
            )
        if name == WILD:  # '*'/'*': every feature except the intercept
            if assigned.any():
                raise ValueError(
                    "potentially conflicting constraints: the all-wildcard "
                    "entry may not combine with any other constraint "
                    "(reference GLMSuite.scala:234)"
                )
            lower[:] = lo
            upper[:] = hi
            assigned[:] = True
            if intercept_index is not None:
                # wildcard bounds never pin the intercept; a later explicit
                # intercept entry may still bound it (the reference's
                # containsKey-then-put order)
                lower[intercept_index] = -np.inf
                upper[intercept_index] = np.inf
                assigned[intercept_index] = False
            continue
        if term == WILD:
            for idx in by_name.get(name, ()):
                _set(idx, lo, hi, f"{name!r} (term wildcard)")
            continue
        idx = index_map.get_index(feature_key(name, term))
        if idx < 0:
            continue  # feature absent from the training index
        _set(idx, lo, hi, f"{name!r}/{term!r}")
    if not assigned.any():
        return None, None, None
    return None, None, (lower, upper)


def load_index_maps(
    offheap_dir: Optional[str],
    shard_ids,
) -> Optional[Dict[str, IndexMap]]:
    """Off-heap (PHIX) maps when a directory is given — one subdir per
    feature shard, as ``build_index`` writes them — else None (callers
    build the maps by scanning the Avro input, reference
    GameDriver.prepareFeatureMaps)."""
    if not offheap_dir:
        return None
    out: Dict[str, IndexMap] = {}
    for sid in shard_ids:
        d = os.path.join(offheap_dir, sid)
        if not os.path.isdir(d):
            raise FileNotFoundError(f"no off-heap index map for shard {sid} at {d}")
        out[sid] = OffHeapIndexMap(d)
    return out


def id_tags_needed(coordinates: Dict[str, CoordinateConfiguration]) -> List[str]:
    """The random-effect id tags the coordinates read, in config order."""
    tags = []
    for cfg in coordinates.values():
        re_type = getattr(getattr(cfg, "data", None), "random_effect_type", None)
        if re_type and re_type not in tags:
            tags.append(re_type)
    return tags

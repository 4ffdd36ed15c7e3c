"""Shared CLI plumbing: logger setup, output removal, input column names,
and the JSON coordinate config → typed configs.

Port of the parts of ``photon_ml_tpu/cli/common.py`` that ``score_game``
and ``train_game`` use (reference GameTrainingParams.scala:269-610; the
config mini-languages replaced by JSON, GLMOptimizationConfiguration
.scala:64-67, RandomEffectDataConfiguration.scala:78-143).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import sys
from typing import Dict, List, Optional, Tuple

from photon_ml_tpu_torch.data.random_effect import RandomEffectDataConfiguration
from photon_ml_tpu_torch.estimators.game import (
    CoordinateConfiguration,
    FixedEffectCoordinateConfiguration,
    RandomEffectCoordinateConfiguration,
)
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

LOGGER_NAME = "photon_ml_tpu_torch"


def setup_logger(level: str = "INFO") -> logging.Logger:
    """Driver logging to stderr; ``PHOTON_LOG_LEVEL`` overrides ``level``.
    Idempotent: a second run in one process does not stack handlers."""
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
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(name)s %(message)s"))
    logger.addHandler(handler)
    return logger


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
    sweep list ``regularization_weights`` is not ported (ROADMAP.md,
    Queue A: fit_multiple/tuning)."""
    if cfg.get("regularization_weights"):
        raise NotImplementedError(
            "regularization_weights sweeps need fit_multiple, which is not "
            "ported yet (ROADMAP.md, Queue A); give one regularization_weight"
        )
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
        regularization_weight=float(cfg.get("regularization_weight", 0.0)),
        down_sampling_rate=float(cfg.get("down_sampling_rate", 1.0)),
        adaptive=adaptive,
    )


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
    if ctype == "random":
        re_type = cfg["random_effect_type"]
        return RandomEffectCoordinateConfiguration(
            feature_shard=shard,
            data=parse_re_data_config(cfg.get("data", {}), re_type),
            optimizer=optimizer,
        )
    if ctype == "factored_random":
        raise NotImplementedError(
            "factored random effects are not ported yet (ROADMAP.md, Queue A item 2)"
        )
    raise ValueError(f"unknown coordinate type: {ctype}")


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

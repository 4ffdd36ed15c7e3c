"""A GLMix fit through the program: set-up builds the fused fixed-effect
layouts and the random-effect coordinates (host bucket planning, the padded
blocks on the device); a job is ``estimators.game.GameEstimator.fit``:
coordinate descent over the fixed effect and the random effects, each
solved by L-BFGS (the random effects batched over entities), validated on
the held-out rows after every update, the best model kept.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark import datagen
from benchmark.spans import Spans


class _RandomEffectStats:
    """An event listener that keeps, after each random-effect update, the
    coordinate's per-bucket solver statistics (entity iterations)."""

    def __init__(self, coordinates: dict):
        self.coordinates = coordinates
        self.updates = []
        self._seen = set()

    def on_event(self, event) -> None:
        from photon_ml_tpu_torch.event import SolverStatsEvent

        if not isinstance(event, SolverStatsEvent):
            return
        stats = self.coordinates[event.coordinate_id].last_solver_stats
        if id(stats) not in self._seen:
            self._seen.add(id(stats))
            self.updates.append((event.coordinate_id, stats))

    def close(self) -> None:
        pass


class Job:
    def __init__(self, config: dict, data: datagen.CellData, device, spans: Spans):
        from photon_ml_tpu_torch.data.game_data import FeatureShard, GameData
        from photon_ml_tpu_torch.data.random_effect import RandomEffectDataConfiguration
        from photon_ml_tpu_torch.estimators.game import (
            FixedEffectCoordinateConfiguration, GameEstimator,
            RandomEffectCoordinateConfiguration,
        )
        from photon_ml_tpu_torch.opt.config import (
            GlmOptimizationConfiguration, OptimizerConfig, RegularizationContext,
        )
        from photon_ml_tpu_torch.types import RegularizationType, TaskType

        self.config, self.spans, self.device = config, spans, torch.device(device)
        o = config["optimizer"]
        opt = GlmOptimizationConfiguration(
            optimizer_config=OptimizerConfig.lbfgs(
                max_iterations=o["max_iterations"], tolerance=o["tolerance"],
                history_length=o["history_length"]),
            regularization=RegularizationContext(RegularizationType[config["regularization"]]),
            regularization_weight=config["lambda"],
        )
        coordinates = {"fixed": FixedEffectCoordinateConfiguration("global", opt)}
        for shard in config["random_effects"]:
            coordinates[shard] = RandomEffectCoordinateConfiguration(
                shard, RandomEffectDataConfiguration(
                    datagen.ENTITY_TAGS[shard][0],
                    num_buckets=config["random_effects"][shard]["buckets"]), opt)
        self.estimator = GameEstimator(
            TaskType[config["task"]], coordinates, update_order=config["update_order"],
            num_outer_iterations=config["outer_iterations"], device=self.device)
        self.train, self.heldout = (self._game_data(rows, FeatureShard, GameData)
                                    for rows in (data.train, data.heldout))
        fe = data.train.shards["global"]
        self.shape = {"rows": data.train.num_rows, "nnz": fe.vals.numel(), "dim": fe.dim}
        self.re_stats = None
        self.last = None

    def build(self) -> None:
        """The program's fixed-effect layouts, then its coordinates (the
        random effects' host bucket planning and device blocks)."""
        with self.spans.span("setup/layout_build"):
            self.train.sparse_features("global", engine="auto", device=self.device)
            self.heldout.sparse_features("global", engine="auto", device=self.device)
            self.spans.sync(self.device)
        with self.spans.span("setup/build_coordinates"):
            self.coordinates = self.estimator.build_coordinates(self.train)
            self.spans.sync(self.device)

    @staticmethod
    def _game_data(rows: datagen.Rows, FeatureShard, GameData):
        shards, tags = {}, {}
        for name, shard in rows.shards.items():
            shards[name] = FeatureShard(*datagen.coo(shard), shard.dim)
            if name in rows.entity:
                tags[datagen.ENTITY_TAGS[name][0]] = datagen.entity_names(
                    name, rows.entity[name].cpu().numpy(), rows.unseen[name].cpu().numpy())
        return GameData(labels=rows.labels.cpu().numpy(), feature_shards=shards, id_tags=tags)

    def trace_on(self) -> None:
        """Collect the random-effect solver statistics of every update (the
        estimator's event emitter; a traced run only)."""
        from photon_ml_tpu_torch.event import EventEmitter

        self.re_stats = _RandomEffectStats(self.coordinates)
        self.estimator.emitter = EventEmitter()
        self.estimator.emitter.register_listener(self.re_stats)

    def warm_up(self) -> None:
        """One outer iteration at two solver iterations a coordinate: every
        coordinate's path and the validation, on the same built data."""
        from photon_ml_tpu_torch.estimators.game import GameEstimator

        def short(cid):
            cfg = self.estimator.coordinate_configs[cid]
            opt = dataclasses.replace(cfg.optimizer, optimizer_config=dataclasses.replace(
                cfg.optimizer.optimizer_config, max_iterations=2))
            return GameEstimator.with_configuration(self.coordinates[cid],
                                                    dataclasses.replace(cfg, optimizer=opt))

        outer = self.estimator.num_outer_iterations
        self.estimator.num_outer_iterations = 1
        try:
            self.estimator.fit(self.train, self.heldout,
                               coordinates={c: short(c) for c in self.coordinates})
        finally:
            self.estimator.num_outer_iterations = outer

    def run(self) -> dict:
        from photon_ml_tpu_torch.telemetry.progress import ConvergenceTracker

        tracker = (ConvergenceTracker(abort_on_divergence=False)
                   if self.re_stats is not None else None)
        with self.spans.span("job/fit"):
            fit = self.estimator.fit(self.train, self.heldout, coordinates=self.coordinates,
                                     progress=tracker)
            self.spans.sync(self.device)
        self.last = fit
        # the update that produced the best model: the program keeps the
        # first strictly better validation once every coordinate trained
        start = len(self.config["update_order"]) - 1
        best = max(range(start, len(fit.validation_history)),
                   key=lambda i: (fit.validation_history[i][1], -i))
        record = {"objective": fit.objective_history[best][1], "auc": fit.validation_metric,
                  "coordinate": fit.objective_history[best][0], "update": best,
                  "update_seconds": fit.update_seconds}
        if tracker is not None:
            record["fe_iterations"] = sum(r.get("solver_iterations") or 0 for r in tracker.records
                                          if r.get("coordinate") == "fixed"
                                          and r.get("kind") == "coordinate")
            record["re_updates"] = [(cid, [(s.bucket, s.sum_entity_iterations) for s in stats])
                                    for cid, stats in self.re_stats.updates]
            self.re_stats.updates = []
        return record

    @staticmethod
    def answers(record: dict) -> dict:
        return {"objective": float(record["objective"]), "auc": float(record["auc"]),
                "coordinate": record["coordinate"], "update": record["update"]}

    def last_answers(self) -> dict:
        """The best model of the last job: the fixed effect's means and each
        random effect's coefficients keyed by entity * dim + feature."""
        models = self.last.model.models
        re = {}
        for shard in self.config["random_effects"]:
            m = models[shard]
            keys, coef = [], []
            for w, idx, valid, ids in zip(m.coefficients, m.proj_indices, m.proj_valid,
                                          m.entity_ids):
                ent = torch.as_tensor(np.char.lstrip(np.asarray(ids, dtype=str),
                                                     datagen.ENTITY_TAGS[shard][1]).astype(np.int64),
                                      device=w.device)
                e, j = torch.nonzero(valid, as_tuple=True)
                keys.append(ent[e] * m.global_dim + idx[e, j])
                coef.append(w[e, j])
            keys, coef = torch.cat(keys), torch.cat(coef)
            order = torch.argsort(keys)
            re[shard] = (keys[order], coef[order])
        return {"model": {"fe": models["fixed"].coefficients.means, "re": re}}

    @staticmethod
    def summary(record: dict) -> str:
        return "updates " + " ".join(f"{c}:{s:.3f}" for c, s in record["update_seconds"])

    def free(self) -> None:
        self.estimator = self.coordinates = self.last = None
        self.train = self.heldout = None

    def fe_iterations(self, record: dict) -> int:
        return int(record["fe_iterations"])

    def model_work(self, record: dict) -> tuple:
        s = self.shape
        re = []
        for cid, buckets in record["re_updates"]:
            blocks = self.coordinates[cid].dataset.buckets
            re.extend((its, blocks[b].max_samples, blocks[b].local_dim) for b, its in buckets)
        return [(self.fe_iterations(record), s["rows"], s["nnz"], s["dim"])], re

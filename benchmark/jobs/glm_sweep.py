"""The λ sweep of a single logistic GLM through the program: set-up builds
the fused fixed-effect layouts of the training and held-out rows; a job is
``estimators.model_training.train_glm`` over the configured λ grid (high to
low, warm-started, L-BFGS), then each λ's held-out scores and AUC by the
program's evaluator, as the ``train_glm`` driver validates a sweep.
"""

from __future__ import annotations

import torch

from benchmark import datagen
from benchmark.spans import Spans


class Job:
    def __init__(self, config: dict, data: datagen.CellData, device, spans: Spans):
        from photon_ml_tpu_torch.data.game_data import FeatureShard, GameData
        from photon_ml_tpu_torch.evaluation.evaluators import default_evaluator
        from photon_ml_tpu_torch.opt.config import (
            GlmOptimizationConfiguration, OptimizerConfig, RegularizationContext,
        )
        from photon_ml_tpu_torch.types import RegularizationType, TaskType

        self.config, self.spans, self.device = config, spans, torch.device(device)
        self.task = TaskType[config["task"]]
        o = config["optimizer"]
        self.configuration = GlmOptimizationConfiguration(
            optimizer_config=OptimizerConfig.lbfgs(
                max_iterations=o["max_iterations"], tolerance=o["tolerance"],
                history_length=o["history_length"]),
            regularization=RegularizationContext(RegularizationType[config["regularization"]]),
            regularization_weight=1.0,
        )
        self.evaluator = default_evaluator(self.task)
        self.lambdas = list(config["lambdas"])
        self.intercept = config["fixed_effect"]["features"]
        parts = {}
        for part, rows in (("train", data.train), ("heldout", data.heldout)):
            shard = rows.shards["global"]
            parts[part] = (GameData(
                labels=rows.labels.cpu().numpy(),
                feature_shards={"features": FeatureShard(*datagen.coo(shard), shard.dim)},
                id_tags={}), rows.labels.cpu())
        self.shape = {"rows": data.train.num_rows, "nnz": data.train.shards["global"].vals.numel(),
                      "dim": data.train.shards["global"].dim}
        self.parts = parts
        self.last = None

    def build(self) -> None:
        """The program's layouts of the training and held-out rows."""
        from photon_ml_tpu_torch.ops.data import LabeledData

        (train, labels), (heldout, heldout_labels) = self.parts["train"], self.parts["heldout"]
        with self.spans.span("setup/layout_build"):
            feats = train.sparse_features("features", engine="auto", device=self.device)
            self.heldout_feats = heldout.sparse_features("features", engine="auto",
                                                         device=self.device)
            self.spans.sync(self.device)
        self.data = LabeledData.create(feats, labels.to(self.device))
        self.heldout_labels = heldout_labels.to(self.device)
        self.parts = None

    def _sweep(self, configuration):
        from photon_ml_tpu_torch.estimators.model_training import train_glm

        with self.spans.span("job/train_glm"):
            fits = train_glm(self.data, self.task, configuration,
                             regularization_weights=self.lambdas,
                             intercept_index=self.intercept)
            self.spans.sync(self.device)
        with self.spans.span("job/validate"):
            scores = {f.regularization_weight: f.model.compute_score(self.heldout_feats)
                      for f in fits}
            auc = {lam: self.evaluator.evaluate(z, self.heldout_labels) for lam, z in scores.items()}
        return fits, scores, auc

    def trace_on(self) -> None:
        """A sweep's records carry what its readers count untraced."""

    def warm_up(self) -> None:
        """The job's path once at two iterations a λ: every launch shape of
        the window, the validation included."""
        import dataclasses

        cfg = dataclasses.replace(self.configuration, optimizer_config=dataclasses.replace(
            self.configuration.optimizer_config, max_iterations=2))
        self._sweep(cfg)

    def run(self) -> dict:
        """One job; returns its record: the small answers as tensors (read
        once the window has closed), its λ iterations and seconds."""
        fits, scores, auc = self._sweep(self.configuration)
        self.last = fits
        return {
            "value": {f.regularization_weight: f.result.value[0] for f in fits},
            "iterations": {f.regularization_weight: f.result.iterations[0] for f in fits},
            "auc": auc,
            "scores": scores,
        }

    @staticmethod
    def answers(record: dict) -> dict:
        """A record's answers: each λ's objective and AUC as plain numbers,
        and its held-out scores."""
        out = {k: {lam: float(v) for lam, v in record[k].items()} for k in ("value", "auc")}
        out["scores"] = record["scores"]
        return out

    def last_answers(self) -> dict:
        """The last job's coefficients, the means each fit returned."""
        return {"w": {f.regularization_weight: f.model.coefficients.means for f in self.last}}

    @staticmethod
    def summary(record: dict) -> str:
        return "iterations " + " ".join(f"{lam:g}:{int(v)}" for lam, v in record["iterations"].items())

    def free(self) -> None:
        self.data = self.heldout_feats = self.last = None

    def fe_iterations(self, record: dict) -> int:
        return int(sum(int(v) for v in record["iterations"].values()))

    def model_work(self, record: dict) -> tuple:
        """(fixed-effect passes, random-effect passes) of a job for
        ``roofline.model_work_s``."""
        s = self.shape
        return [(self.fe_iterations(record), s["rows"], s["nnz"], s["dim"])], []

"""Full model-diagnostic report assembly (model-diagnostic.html).

Port of ``photon_ml_tpu/diagnostics/report.py``, host numpy as there.

Reference parity: the legacy Driver's diagnose() stage (Driver.scala:472-)
which runs fitting / bootstrap / Hosmer-Lemeshow / error-independence /
feature-importance diagnostics per λ and renders one HTML document
(README.md:256-259).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from photon_ml_tpu_torch.diagnostics.bootstrap import BootstrapReport
from photon_ml_tpu_torch.diagnostics.evaluation import MetricsMap
from photon_ml_tpu_torch.diagnostics.feature_importance import FeatureImportanceReport
from photon_ml_tpu_torch.diagnostics.fitting import FittingReport
from photon_ml_tpu_torch.diagnostics.hl import HosmerLemeshowReport
from photon_ml_tpu_torch.diagnostics.independence import KendallTauReport
from photon_ml_tpu_torch.diagnostics.reporting import (
    BulletedList,
    Chapter,
    Document,
    Plot,
    Section,
    SimpleText,
    Table,
    render_html,
)


def build_diagnostic_document(
    title: str,
    metrics: Optional[MetricsMap] = None,
    fitting: Optional[Dict[float, FittingReport]] = None,
    bootstrap: Optional[BootstrapReport] = None,
    hosmer_lemeshow: Optional[HosmerLemeshowReport] = None,
    independence: Optional[KendallTauReport] = None,
    importance: Optional[FeatureImportanceReport] = None,
    importance_variance: Optional[FeatureImportanceReport] = None,
    metric_vs_iteration: Optional[Dict[float, List[float]]] = None,
    metric_name: str = "metric",
) -> Document:
    doc = Document(title=title)

    if metric_vs_iteration:
        # reference validatePerIteration: the per-iteration tracked models'
        # validation metric, one series per regularization weight
        doc.chapters.append(Chapter("Metric vs iteration", [Section(
            "Validation metric of each tracked iteration's model",
            [Plot(
                title=f"{metric_name} vs optimizer iteration",
                x_label="iteration", y_label=metric_name,
                series=[
                    (f"lambda={lam:g}",
                     list(range(len(curve))), list(curve))
                    for lam, curve in sorted(metric_vs_iteration.items())
                ],
            )],
        )]))

    if metrics:
        doc.chapters.append(Chapter("Model metrics", [Section("Summary", [
            Table(
                headers=["Metric", "Value"],
                rows=[(k, f"{v:.6g}") for k, v in sorted(metrics.items())],
            )
        ])]))

    if fitting:
        sections = []
        for lam, rep in sorted(fitting.items()):
            items = []
            for metric, (portions, train_vals, test_vals) in rep.metrics.items():
                items.append(Plot(
                    title=f"{metric} vs training data portion",
                    x_label="% of data", y_label=metric,
                    series=[
                        ("train", portions, train_vals),
                        ("holdout", portions, test_vals),
                    ],
                ))
            sections.append(Section(f"lambda = {lam:g}", items))
        doc.chapters.append(Chapter("Fitting analysis (learning curves)", sections))

    if bootstrap:
        rows = [
            (name, f"{s.mean:.4g}", f"{s.std:.4g}",
             f"[{s.q1:.4g}, {s.q3:.4g}]", f"[{s.min:.4g}, {s.max:.4g}]")
            for name, s in bootstrap.metric_summaries.items()
        ]
        items = [
            Table(
                headers=["Metric", "Mean", "Std", "IQR", "Range"],
                rows=rows, caption="Bootstrapped metric distributions",
            ),
            SimpleText(
                f"{len(bootstrap.zero_crossing_indices)} coefficients have "
                "bootstrap intervals containing zero."
            ),
        ]
        doc.chapters.append(Chapter("Bootstrap analysis", [Section("Metrics", items)]))

    if hosmer_lemeshow:
        hl = hosmer_lemeshow
        mids = [(b.lower + b.upper) / 2 for b in hl.bins]
        obs_rate = [
            b.observed_pos / b.count if b.count else float("nan") for b in hl.bins
        ]
        items = [
            SimpleText(
                f"chi^2 = {hl.chi_squared:.4g} with {hl.degrees_of_freedom} "
                f"d.o.f.; P[chi^2 >= observed | calibrated] = {hl.p_value:.4g}"
            ),
            Plot(
                title="Calibration: observed positive rate vs predicted probability",
                x_label="predicted probability (bin center)",
                y_label="observed positive rate",
                series=[
                    ("observed", mids, obs_rate),
                    ("ideal", [0.0, 1.0], [0.0, 1.0]),
                ],
            ),
        ]
        if hl.warnings:
            items.append(BulletedList(hl.warnings[:10]))
        doc.chapters.append(Chapter("Hosmer-Lemeshow calibration",
                                    [Section("Goodness of fit", items)]))

    if independence:
        kt = independence
        doc.chapters.append(Chapter("Prediction-error independence", [Section(
            "Kendall tau", [
                Table(
                    headers=["Statistic", "Value"],
                    rows=[
                        ("tau-alpha", f"{kt.tau_alpha:.4g}"),
                        ("tau-beta", f"{kt.tau_beta:.4g}"),
                        ("z", f"{kt.z_alpha:.4g}"),
                        ("P[dependent]", f"{kt.prob_dependent:.4g}"),
                        ("p-value (H0: independent)", f"{kt.p_value:.4g}"),
                        ("concordant", kt.num_concordant),
                        ("discordant", kt.num_discordant),
                    ],
                ),
            ] + ([SimpleText(kt.message)] if kt.message else []),
        )]))

    importance_sections = [
        Section(rep.importance_description, [
            Table(
                headers=["Rank", "Name", "Term", "Importance"],
                rows=[
                    (r + 1, name, term, f"{imp:.4g}")
                    for r, (name, term, _, imp)
                    in enumerate(rep.ranked_features)
                ],
            ),
        ])
        for rep in (importance, importance_variance)
        if rep is not None
    ]
    if importance_sections:
        doc.chapters.append(Chapter("Feature importance", importance_sections))

    return doc


def write_diagnostic_report(path: str, document: Document) -> str:
    """Render to ``model-diagnostic.html`` under ``path`` (a directory)."""
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, "model-diagnostic.html")
    with open(out, "w") as f:
        f.write(render_html(document))
    return out

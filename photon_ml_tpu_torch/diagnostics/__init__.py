"""Model diagnostics: metrics, bootstrap intervals, learning curves,
Hosmer-Lemeshow calibration, Kendall-τ independence, feature importance,
and the report engine (document → HTML / text).

Port of ``photon_ml_tpu/diagnostics`` (reference photon-diagnostics:
Evaluation.scala:31, BootstrapTraining.scala:29,
diagnostics/fitting/FittingDiagnostic.scala:33,
diagnostics/hl/HosmerLemeshowDiagnostic.scala:29,
diagnostics/independence/KendallTauAnalysis.scala:26,
diagnostics/featureimportance/*, diagnostics/reporting/*). The statistics
are host numpy and scipy, as in the JAX package; the device work of a
diagnosis (the sub-fits and the scoring) is the caller's
(``cli/train_glm.py``).
"""

from photon_ml_tpu_torch.diagnostics.evaluation import MetricsMap, evaluate_metrics
from photon_ml_tpu_torch.diagnostics.bootstrap import (
    BootstrapReport,
    CoefficientSummary,
    bootstrap_training,
)
from photon_ml_tpu_torch.diagnostics.fitting import FittingReport, fitting_diagnostic
from photon_ml_tpu_torch.diagnostics.hl import (
    HosmerLemeshowReport,
    hosmer_lemeshow_diagnostic,
)
from photon_ml_tpu_torch.diagnostics.independence import (
    KendallTauReport,
    kendall_tau_analysis,
    prediction_error_independence,
)
from photon_ml_tpu_torch.diagnostics.feature_importance import (
    FeatureImportanceReport,
    expected_magnitude_importance,
    variance_importance,
)

__all__ = [
    "MetricsMap",
    "evaluate_metrics",
    "BootstrapReport",
    "CoefficientSummary",
    "bootstrap_training",
    "FittingReport",
    "fitting_diagnostic",
    "HosmerLemeshowReport",
    "hosmer_lemeshow_diagnostic",
    "KendallTauReport",
    "kendall_tau_analysis",
    "prediction_error_independence",
    "FeatureImportanceReport",
    "expected_magnitude_importance",
    "variance_importance",
]

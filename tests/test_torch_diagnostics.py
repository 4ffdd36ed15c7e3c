"""The port's diagnostics, ``testing.py``, ``utils/math_utils.py``,
``utils/cachedir.py`` and ``GameData.take_rows`` against the JAX package.

- Every case of ``tests/test_diagnostics.py`` runs through both packages on
  the same seeded numpy inputs; the reports are exactly equal (every field,
  floats bit for bit, NaN included) and ``render_html`` / ``render_text``
  byte-equal for the same document. The JAX test's own assertions hold on
  the port's reports too.
- The column-wise bootstrap summaries are bitwise the per-column ones of
  JAX ``bootstrap_training`` at d = 5000 (a constant column, one of -0.0,
  one that straddles zero, one with NaN), for 6 and 16 samples.
- ``take_rows`` gives equal arrays for random indices with repeats, rows
  stored in order or not.
- ``testing.py``'s generators give the JAX module's arrays bit for bit;
  ``generate_game_model`` scores within 1e-6 of the JAX model's.
- ``math_utils`` against the JAX functions (rtol 1e-6, ±100 and ±1e-16
  included; results below the smallest normal float32 agree absolutely,
  as XLA flushes them to zero); ``per_uid_cache_dir`` (0700, a group-writable or foreign
  directory refused) and ``default_plan_cache`` on top of it.
"""

import dataclasses
import os
import stat
from collections.abc import Sequence

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_ml_tpu import diagnostics as J
from photon_ml_tpu.diagnostics import feature_importance as j_importance
from photon_ml_tpu.diagnostics import reporting as j_reporting
from photon_ml_tpu.diagnostics.evaluation import (
    area_under_pr_curve as j_pr_auc,
    peak_f1 as j_peak_f1,
)
from photon_ml_tpu.diagnostics.hl import default_bin_count as j_bins
from photon_ml_tpu.diagnostics.report import build_diagnostic_document as j_document
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch import diagnostics as T
from photon_ml_tpu_torch.diagnostics import feature_importance as t_importance
from photon_ml_tpu_torch.diagnostics import reporting as t_reporting
from photon_ml_tpu_torch.diagnostics.evaluation import (
    area_under_pr_curve as t_pr_auc,
    peak_f1 as t_peak_f1,
)
from photon_ml_tpu_torch.diagnostics.hl import default_bin_count as t_bins
from photon_ml_tpu_torch.diagnostics.report import build_diagnostic_document as t_document
from photon_ml_tpu_torch.types import TaskType


def plain(x):
    """A report as nested builtins for an exact comparison across the two
    packages: floats by their bits, arrays by dtype, shape and bytes."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, plain(getattr(x, f.name))) for f in dataclasses.fields(x))
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (float, np.floating)):
        return ("float", np.float64(x).tobytes())
    if isinstance(x, dict):
        return ("dict", tuple((plain(k), plain(v)) for k, v in x.items()))
    if isinstance(x, (str, bytes)):
        return x
    if isinstance(x, Sequence):
        return ("seq", tuple(plain(v) for v in x))
    return x


def same(t, j) -> None:
    assert plain(t) == plain(j)


# ---- evaluation ---------------------------------------------------------------

def _metric_inputs(task: str, seed: int, weighted: bool, scores: str = "ties"):
    rng = np.random.default_rng(seed)
    n = 300
    s = rng.normal(size=n) * 2.0
    s[::7] = s[3]  # tied scores
    if task in ("LOGISTIC_REGRESSION", "SMOOTHED_HINGE_LOSS_LINEAR_SVM"):
        y = (rng.random(n) < 1 / (1 + np.exp(-s))).astype(float)
    elif task == "POISSON_REGRESSION":
        y = rng.poisson(np.exp(np.clip(s, -3, 2))).astype(float)
    else:
        y = s + rng.normal(size=n)
    w = rng.uniform(0.0, 2.0, n) if weighted else None
    if scores == "signed_zeros":  # -0.0 and 0.0 tie
        s[::5] = np.where(np.arange(0, n, 5) % 2, -0.0, 0.0)
    elif scores == "nan":
        s[::11] = np.nan
    return s, y, w


@pytest.mark.parametrize("scores", ["ties", "signed_zeros", "nan"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("task", [t.name for t in TaskType])
def test_evaluate_metrics_equal_jax(task, weighted, scores):
    """Bit for bit, also where the port turns one sort around for the
    precision-recall sweep (ties, -0.0 against 0.0, NaN scores)."""
    s, y, w = _metric_inputs(task, 3, weighted, scores)
    with np.errstate(invalid="ignore"):
        same(T.evaluate_metrics(s, y, TaskType[task], w),
             J.evaluate_metrics(s, y, JTask[task], w))


@pytest.mark.parametrize("case", ["regression", "perfect_separation", "pr_auc_known",
                                  "peak_f1_known", "no_positives"])
def test_metric_cases_equal_jax(case):
    if case == "regression":
        s, y = np.array([1.0, 2.0, 3.0]), np.array([1.5, 2.0, 2.0])
        m = T.evaluate_metrics(s, y, TaskType.LINEAR_REGRESSION)
        same(m, J.evaluate_metrics(s, y, JTask.LINEAR_REGRESSION))
        assert m["MSE"] == pytest.approx((0.25 + 0 + 1) / 3)
        assert m["MAE"] == pytest.approx((0.5 + 0 + 1) / 3)
    elif case == "perfect_separation":
        s, y = np.array([-5.0, -3.0, 3.0, 5.0]), np.array([0.0, 0.0, 1.0, 1.0])
        m = T.evaluate_metrics(s, y, TaskType.LOGISTIC_REGRESSION)
        same(m, J.evaluate_metrics(s, y, JTask.LOGISTIC_REGRESSION))
        assert m["Area under ROC"] == m["Peak F1 score"] == pytest.approx(1.0)
    elif case == "pr_auc_known":
        s, y = np.array([4.0, 3.0, 2.0, 1.0]), np.array([1.0, 0.0, 1.0, 0.0])
        same(t_pr_auc(s, y), j_pr_auc(s, y))
        assert t_pr_auc(s, y) == pytest.approx(0.5 * 1.0 + 0.5 * (0.5 + 2 / 3) / 2)
    elif case == "peak_f1_known":
        s, y = np.array([4.0, 3.0, 2.0, 1.0]), np.array([0.0, 1.0, 1.0, 0.0])
        same(t_peak_f1(s, y), j_peak_f1(s, y))
        assert t_peak_f1(s, y) == pytest.approx(0.8)
    else:
        s, y = np.array([0.5, -0.5]), np.zeros(2)
        same(T.evaluate_metrics(s, y, TaskType.LOGISTIC_REGRESSION),
             J.evaluate_metrics(s, y, JTask.LOGISTIC_REGRESSION))


# ---- bootstrap ----------------------------------------------------------------

def test_bootstrap_cis_equal_jax(rng):
    n, d = 400, 4
    X = rng.normal(size=(n, d))
    w_true = np.array([2.0, -1.0, 0.0, 0.5])
    y = X @ w_true + 0.1 * rng.normal(size=n)

    def train(idx):
        Xi, yi = X[idx], y[idx]
        w = np.linalg.lstsq(Xi, yi, rcond=None)[0]
        return w, {"MSE": float(np.mean((Xi @ w - yi) ** 2))}

    rep = T.bootstrap_training(train, n, num_samples=20, seed=0)
    same(rep, J.bootstrap_training(train, n, num_samples=20, seed=0))
    assert len(rep.coefficient_summaries) == d
    for j, s in enumerate(rep.coefficient_summaries):
        assert s.min <= w_true[j] <= s.max
    assert 2 in rep.zero_crossing_indices and 0 not in rep.zero_crossing_indices
    assert rep.metric_summaries["MSE"].mean < 0.02


def test_quartiles_equal_jax():
    s = np.arange(101, dtype=float)
    t = T.CoefficientSummary.from_samples(s)
    same(t, J.CoefficientSummary.from_samples(s))
    assert t.q1 <= t.median <= t.q3 and t.median == pytest.approx(50.0)


@pytest.mark.parametrize("num_samples", [6, 16])
def test_columnwise_summaries_bitwise_jax(num_samples):
    """d = 5000 coefficients across fits, scales spread over 10^±6: every
    summary, the zero crossings and the metric summaries bit for bit."""
    d = 5000
    gen = np.random.default_rng(num_samples)
    stack = gen.normal(size=(num_samples, d)) * np.exp(3 * gen.normal(size=(num_samples, d)))
    stack[:, 0] = 1.25                                  # constant samples
    stack[:, 1] = -0.0
    stack[:, 2] = np.linspace(-1.0, 1.0, num_samples)   # straddles zero
    stack[:, 3] = np.abs(stack[:, 3]) + 1e-3            # never reaches zero
    stack[1, 4] = np.nan
    calls = iter(range(num_samples))

    def train(idx):
        k = next(calls)
        return stack[k].astype(np.float32) if k % 2 else stack[k], {"AUC": float(idx.mean())}

    t = T.bootstrap_training(train, 50, num_samples=num_samples, seed=4)
    calls = iter(range(num_samples))
    j = J.bootstrap_training(train, 50, num_samples=num_samples, seed=4)
    assert len(t.coefficient_summaries) == len(j.coefficient_summaries) == d
    same(t, j)
    # the lazy sequence equals the list of the port's own per-column summaries
    coefs = np.stack([stack[k].astype(np.float32) if k % 2 else stack[k]
                      for k in range(num_samples)]).astype(np.float64)
    per_column = [T.CoefficientSummary.from_samples(coefs[:, c]) for c in range(d)]
    same(list(t.coefficient_summaries), per_column)  # column 4 is NaN: bits, not ==
    assert t.coefficient_summaries[5:] == per_column[5:]
    assert t.coefficient_summaries[-1] == per_column[-1]
    assert t.coefficient_summaries[10:13] == per_column[10:13]
    assert 2 in t.zero_crossing_indices and 1 in t.zero_crossing_indices
    assert 0 not in t.zero_crossing_indices and 3 not in t.zero_crossing_indices
    with pytest.raises(IndexError):
        t.coefficient_summaries[d]


def test_bootstrap_refuses_one_sample():
    for pkg in (T, J):
        with pytest.raises(ValueError, match="at least 2"):
            pkg.bootstrap_training(lambda idx: (np.zeros(2), {}), 10, num_samples=1)


# ---- learning curves ------------------------------------------------------------

def test_learning_curves_equal_jax(rng):
    n, d = 2000, 5
    X = rng.normal(size=(n, d))
    w_true = rng.normal(size=d)
    y = X @ w_true + 0.5 * rng.normal(size=n)

    def train(idx, warm):
        A = X[idx].T @ X[idx] + np.eye(d)
        return {1.0: np.linalg.solve(A, X[idx].T @ y[idx])}

    def evaluate(w, idx):
        return {"MSE": float(np.mean((X[idx] @ w - y[idx]) ** 2))}

    t = T.fitting_diagnostic(train, evaluate, n, d, seed=1)
    same(t, J.fitting_diagnostic(train, evaluate, n, d, seed=1))
    portions, _, test_vals = t[1.0].metrics["MSE"]
    assert len(portions) == 9 and portions == sorted(portions)
    assert test_vals[-1] <= test_vals[0] + 0.05


@pytest.mark.parametrize("num_rows,dim", [(3, 10), (10, 10)])
def test_too_small_for_curves_both_empty(num_rows, dim):
    args = (lambda idx, warm: {}, lambda m, idx: {}, num_rows, dim)
    assert T.fitting_diagnostic(*args) == J.fitting_diagnostic(*args) == {}


# ---- Hosmer-Lemeshow ------------------------------------------------------------

@pytest.mark.parametrize("shift", [0.0, 0.25])
def test_hosmer_lemeshow_equal_jax(rng, shift):
    n = 5000
    p = rng.uniform(0.05, 0.95, size=n)
    y = (rng.random(n) < np.clip(p + shift, 0, 1)).astype(float)
    t = T.hosmer_lemeshow_diagnostic(p, y, num_dimensions=8)
    same(t, J.hosmer_lemeshow_diagnostic(p, y, num_dimensions=8))
    assert t.degrees_of_freedom == len(t.bins) - 2 and sum(b.count for b in t.bins) == n
    if shift:
        assert t.prob_at_chi_squared > 0.999 and t.p_value < 1e-3
    else:
        assert t.prob_at_chi_squared < 0.99


def test_hosmer_lemeshow_small_bins_warn_equal_jax():
    p = np.array([0.01, 0.02, 0.5, 0.51, 0.97, 0.99, 0.3])
    y = np.array([0, 0, 1, 0, 1, 1, 0.0])
    t = T.hosmer_lemeshow_diagnostic(p, y, num_dimensions=3, num_bins=4)
    same(t, J.hosmer_lemeshow_diagnostic(p, y, num_dimensions=3, num_bins=4))
    assert t.warnings


@pytest.mark.parametrize("items,dims", [(10_000, 8), (100, 100), (10, 1), (2 ** 20, 2 ** 24 + 1)])
def test_bin_count_equal_jax(items, dims):
    assert t_bins(items, dims) == j_bins(items, dims)


# ---- Kendall tau ----------------------------------------------------------------

def _tau_inputs(case, rng):
    if case == "dependent":
        a = rng.normal(size=200)
        return a, 0.5 * a + rng.normal(size=200), {}
    if case == "independent":
        return rng.normal(size=300), rng.normal(size=300), {}
    if case == "ties":
        return np.array([1.0, 1.0, 2.0, 3.0]), np.array([1.0, 2.0, 2.0, 3.0]), {}
    a = np.round(rng.normal(size=5000), 1)  # subsampled, with ties
    return a, np.round(a + rng.normal(size=5000), 1), {"max_items": 2000}


@pytest.mark.parametrize("case", ["dependent", "independent", "ties", "subsampled"])
def test_kendall_tau_equal_jax(rng, case):
    from scipy.stats import kendalltau

    a, b, kw = _tau_inputs(case, rng)
    t = T.kendall_tau_analysis(a, b, **kw)
    same(t, J.kendall_tau_analysis(a, b, **kw))
    if case == "dependent":
        assert t.tau_beta == pytest.approx(kendalltau(a, b)[0], abs=1e-9)
        assert t.prob_dependent > 0.99 and t.p_value < 0.01
    elif case == "independent":
        assert abs(t.tau_alpha) < 0.1 and t.prob_dependent < 0.95
    elif case == "ties":
        assert (t.num_concordant, t.num_discordant) == (4, 0) and "ties" in t.message
    else:
        assert t.num_items == 2000


def test_error_independence_equal_jax(rng):
    scores = rng.normal(size=150)
    labels = scores + rng.normal(size=150)
    t = T.prediction_error_independence(scores, labels, max_items=100, seed=3)
    same(t, J.prediction_error_independence(scores, labels, max_items=100, seed=3))
    with pytest.raises(ValueError, match="paired"):
        T.kendall_tau_analysis(np.zeros(3), np.zeros(4))


# ---- feature importance ---------------------------------------------------------

@pytest.mark.parametrize("values", ["distinct", "ties", "nan", "few"])
@pytest.mark.parametrize("kind", ["expected_magnitude", "variance"])
@pytest.mark.parametrize("scale", [False, True])
@pytest.mark.parametrize("index_map", ["none", "default", "empty"])
def test_importance_equal_jax(kind, scale, index_map, values):
    """The port ranks by partial sorts: the same top 25 (ties by index, NaN
    last) and the same importance at each rank as the JAX full sort."""
    from photon_ml_tpu.indexmap import DefaultIndexMap as JMap
    from photon_ml_tpu_torch.indexmap import DefaultIndexMap as TMap

    gen = np.random.default_rng(5)
    d = 60
    coefs = gen.normal(size=d)
    coefs[7] = 0.0
    if values == "ties":  # ties straddle the 25th place, zeros fill the tail
        coefs = np.round(coefs, 0) * (np.arange(d) % 3 > 0)
    elif values == "nan":
        coefs[[3, 40]] = np.nan
    elif values == "few":  # fewer values than ranked places that are not NaN
        coefs[10:] = np.nan
    scales = gen.uniform(0.0, 3.0, d) if scale else None
    keys = {f"f{i}" if i % 3 else f"f{i}\x01t{i}": i for i in range(d - 1)}  # last unmapped
    maps = {"none": (None, None), "default": (TMap(keys), JMap(keys)),
            "empty": (TMap({}), JMap({}))}[index_map]
    fn = {"expected_magnitude": "expected_magnitude_importance", "variance": "variance_importance"}
    t = getattr(t_importance, fn[kind])(coefs, scales, maps[0])
    same(t, getattr(j_importance, fn[kind])(coefs, scales, maps[1]))
    assert len(t.ranked_features) == 25 and sorted(t.rank_to_importance) == list(
        map(float, range(0, 101, 10)))
    if values == "ties" and not scale:
        importances = [r[3] for r in t.ranked_features]
        assert len(set(importances)) < 25  # ties inside the top 25


def test_importance_rankings():
    from photon_ml_tpu_torch.indexmap import DefaultIndexMap

    imap = DefaultIndexMap({f"f{i}": i for i in range(4)})
    coefs = np.array([0.1, -5.0, 2.0, 0.0])
    rep = T.expected_magnitude_importance(coefs, np.array([10.0, 0.1, 1.0, 1.0]), imap)
    assert rep.ranked_features[0][0] == "f2" and rep.ranked_features[0][3] == pytest.approx(2.0)
    assert T.variance_importance(coefs, np.ones(4), imap).ranked_features[0][0] == "f1"
    rep = T.expected_magnitude_importance(np.array([1.0, -3.0]))
    assert rep.ranked_features[0][2] == 1 and "Magnitude" in rep.importance_description


# ---- reporting ------------------------------------------------------------------

def _document(R):
    return R.Document(
        title="Model diagnostics",
        chapters=[
            R.Chapter("Metrics", [R.Section("Summary", [
                R.SimpleText("All good & well <tested>"),
                R.Table(headers=["Metric", "Value"], rows=[("AUC", 0.9)], caption="c & d"),
                R.BulletedList(["point one", "point two"]),
                R.NumberedList(["first", "second"]),
            ])]),
            R.Chapter("Curves", [R.Section("Learning", [
                R.Plot("MSE vs portion", "% data", "MSE",
                       series=[("train", [10, 50, 90], [1.0, 0.6, float("nan")]),
                               ("holdout", [10, 50, 90], [1.5, 0.8, 0.6])]),
                R.Plot("flat", "x", "y", series=[("one", [1.0], [2.0])]),
                R.Plot("empty", "x", "y", series=[]),
            ])]),
        ],
    )


@pytest.mark.parametrize("render", ["render_html", "render_text"])
def test_rendering_byte_equal_jax(render):
    t = getattr(t_reporting, render)(_document(t_reporting))
    assert t == getattr(j_reporting, render)(_document(j_reporting))
    if render == "render_html":
        assert "<h2>1. Metrics</h2>" in t and "<h3>2.1. Learning</h3>" in t
        assert "&amp; well &lt;tested&gt;" in t and "<svg" in t and "polyline" in t
    else:
        assert "1. Metrics" in t and "[plot: MSE vs portion]" in t


def test_full_report_equal_jax(tmp_path, rng):
    """Every diagnostic of a small logistic fit into one document: the
    documents equal, the written model-diagnostic.html byte-equal."""
    from scipy.optimize import minimize

    n, d = 600, 4
    X = rng.normal(size=(n, d))
    z = X @ rng.normal(size=d)
    y = (1 / (1 + np.exp(-z)) > rng.random(n)).astype(float)

    def train(idx):
        def nll(wv):
            zz = X[idx] @ wv
            return float(np.mean(np.logaddexp(0, zz) - y[idx] * zz))

        res = minimize(nll, np.zeros(d), method="L-BFGS-B")
        return res.x, J.evaluate_metrics(X[idx] @ res.x, y[idx], JTask.LOGISTIC_REGRESSION)

    what, metrics = train(np.arange(n))
    scores = X @ what
    probs = 1 / (1 + np.exp(-scores))
    fitting = J.fitting_diagnostic(
        lambda idx, warm: {0.5: train(idx)[0]},
        lambda w, idx: J.evaluate_metrics(X[idx] @ w, y[idx], JTask.LOGISTIC_REGRESSION),
        n, d, seed=2)
    docs = []
    for pkg, build, task in ((T, t_document, TaskType), (J, j_document, JTask)):
        docs.append(build(
            "diag",
            metrics=pkg.evaluate_metrics(scores, y, task.LOGISTIC_REGRESSION),
            fitting={lam: pkg.FittingReport(metrics=r.metrics) for lam, r in fitting.items()},
            bootstrap=pkg.bootstrap_training(train, n, num_samples=4, seed=2),
            hosmer_lemeshow=pkg.hosmer_lemeshow_diagnostic(probs, y, d),
            independence=pkg.prediction_error_independence(scores, y, max_items=150),
            importance=pkg.expected_magnitude_importance(what),
            importance_variance=pkg.variance_importance(what, np.ones(d)),
            metric_vs_iteration={0.5: [0.7, 0.75, 0.8], 2.0: [0.6, 0.7]},
            metric_name="AUC",
        ))
    same(docs[0], docs[1])
    from photon_ml_tpu.diagnostics.report import write_diagnostic_report as j_write
    from photon_ml_tpu_torch.diagnostics.report import write_diagnostic_report

    t_out = write_diagnostic_report(str(tmp_path / "t"), docs[0])
    j_out = j_write(str(tmp_path / "j"), docs[1])
    assert os.path.basename(t_out) == "model-diagnostic.html"
    html = open(t_out, "rb").read()
    assert html == open(j_out, "rb").read()
    for chapter in (b"Metric vs iteration", b"Fitting analysis", b"Bootstrap", b"Hosmer-Lemeshow",
                    b"Prediction-error independence", b"Feature importance"):
        assert chapter in html


def test_package_exports_match_jax():
    assert T.__all__ == J.__all__
    for name in T.__all__:
        assert getattr(T, name) is not None


# ---- take_rows ------------------------------------------------------------------

@pytest.mark.parametrize("in_order", [True, False])
def test_take_rows_equal_jax(in_order):
    from photon_ml_tpu.data.game_data import FeatureShard as JShard, GameData as JData
    from photon_ml_tpu_torch.data.game_data import FeatureShard, GameData

    gen = np.random.default_rng(11)
    n, d = 300, 40
    rows = np.repeat(np.arange(n), gen.integers(0, 5, n))  # rows without entries too
    cols = gen.integers(0, d, rows.size)
    vals = gen.normal(size=rows.size).astype(np.float32)
    if not in_order:
        perm = gen.permutation(rows.size)
        rows, cols, vals = rows[perm], cols[perm], vals[perm]
    labels = gen.random(n).astype(np.float32)
    offsets = gen.normal(size=n).astype(np.float32)
    ids = np.array([f"u{i % 17}" for i in range(n)])

    def both(shard_cls, data_cls):
        return data_cls(labels=labels, feature_shards={"g": shard_cls(rows, cols, vals, d)},
                        id_tags={"userId": ids}, offsets=offsets)

    t, j = both(FeatureShard, GameData), both(JShard, JData)
    for draw in (gen.integers(0, n, n), gen.integers(0, n, 40), np.array([5, 5, 5, 0]),
                 np.array([], dtype=np.int64)):
        ts, js = t.take_rows(draw), j.take_rows(draw)
        for f in ("rows", "cols", "vals"):
            a, b = getattr(ts.feature_shards["g"], f), getattr(js.feature_shards["g"], f)
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert ts.feature_shards["g"].dim == d
        for f in ("labels", "offsets", "weights"):
            assert np.array_equal(getattr(ts, f), getattr(js, f))
        assert np.array_equal(ts.id_tags["userId"], js.id_tags["userId"])
    # indices naming no stored row (past the last, negative) give no entries
    shard = t.feature_shards["g"]
    for draw in (np.array([n + 3, -1, 2, n - 1]), np.array([-5])):
        a, b = shard.take_rows(draw), j.feature_shards["g"].take_rows(draw)
        for f in ("rows", "cols", "vals"):
            assert np.array_equal(getattr(a, f), getattr(b, f))
    # the cached row order follows a replaced rows array
    shard = t.feature_shards["g"]
    shard.rows = shard.rows[::-1].copy()
    jshard = JShard(shard.rows, shard.cols, shard.vals, d)
    assert np.array_equal(shard.take_rows(np.arange(n)).cols, jshard.take_rows(np.arange(n)).cols)


# ---- testing.py ----------------------------------------------------------------

@pytest.mark.parametrize("regime", ["benign", "outlier", "invalid"])
@pytest.mark.parametrize("task", [t.name for t in TaskType])
def test_draw_sample_bitwise_jax(task, regime):
    from photon_ml_tpu import testing as jt
    from photon_ml_tpu_torch import testing as tt

    for a, b in zip(tt.draw_sample(TaskType[task], n=90, d=7, regime=regime, seed=2),
                    jt.draw_sample(JTask[task], n=90, d=7, regime=regime, seed=2)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    a = tt.draw_invalid_labels(TaskType[task], n=60, seed=4)
    assert a.tobytes() == jt.draw_invalid_labels(JTask[task], n=60, seed=4).tobytes()
    with pytest.raises(ValueError, match="unknown regime"):
        tt.draw_sample(TaskType[task], regime="nope")


def _same_game_data(t, j) -> None:
    assert np.array_equal(t.labels, j.labels) and np.array_equal(t.offsets, j.offsets)
    assert set(t.feature_shards) == set(j.feature_shards)
    for k, ts in t.feature_shards.items():
        js = j.feature_shards[k]
        assert ts.dim == js.dim
        for f in ("rows", "cols", "vals"):
            a, b = getattr(ts, f), getattr(js, f)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert {k: list(v) for k, v in t.id_tags.items()} == {k: list(v) for k, v in j.id_tags.items()}


@pytest.mark.parametrize("task", ["LOGISTIC_REGRESSION", "LINEAR_REGRESSION", "POISSON_REGRESSION"])
def test_generators_bitwise_jax(task):
    from photon_ml_tpu import testing as jt
    from photon_ml_tpu_torch import testing as tt

    (td, tw), (jd, jw) = (tt.generate_fixed_effect_data(TaskType[task], n=80, d=6, seed=5),
                          jt.generate_fixed_effect_data(JTask[task], n=80, d=6, seed=5))
    _same_game_data(td, jd)
    assert tw.tobytes() == jw.tobytes()
    (td, tt_), (jd, jt_) = (tt.generate_glmix_data(TaskType[task], n_entities=5, rows_per_entity=9,
                                                   seed=6),
                            jt.generate_glmix_data(JTask[task], n_entities=5, rows_per_entity=9,
                                                   seed=6))
    _same_game_data(td, jd)
    assert tt_.keys() == jt_.keys() and all(tt_[k].tobytes() == jt_[k].tobytes() for k in tt_)
    shard = np.array([[0.0, 1.5], [2.0, 0.0]], np.float32)
    a, b = tt.dense_to_shard(shard), jt.dense_to_shard(shard)
    assert [x.tolist() for x in (a.rows, a.cols, a.vals)] == [
        x.tolist() for x in (b.rows, b.cols, b.vals)]


def test_generate_game_model_scores_match_jax():
    from photon_ml_tpu import testing as jt
    from photon_ml_tpu_torch import testing as tt

    coords = {"fixed": {"feature_shard": "global"},
              "per_user": {"feature_shard": "per_entity", "random_effect_type": "userId"}}
    tdata, _ = tt.generate_glmix_data(n_entities=4, rows_per_entity=8, seed=7)
    jdata, _ = jt.generate_glmix_data(n_entities=4, rows_per_entity=8, seed=7)
    tmodel = tt.generate_game_model(tdata, TaskType.LINEAR_REGRESSION, coords, device="cpu")
    jmodel = jt.generate_game_model(jdata, JTask.LINEAR_REGRESSION, coords)
    assert tmodel.device.type == "cpu"
    t, j = tmodel.score(tdata).numpy(), np.asarray(jmodel.score(jdata))
    assert t.shape == (32,) and np.isfinite(t).all() and np.abs(t).sum() > 0
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tmodel.models["fixed"].coefficients.means.numpy(),
                                  np.asarray(jmodel.models["fixed"].coefficients.means))


# ---- math_utils and cachedir ---------------------------------------------------

@pytest.mark.parametrize("fn", ["log1p_exp", "is_almost_zero", "safe_div"])
def test_math_utils_match_jax(fn):
    from photon_ml_tpu.utils import math_utils as jm
    from photon_ml_tpu_torch.utils import math_utils as tm

    x = np.array([-100.0, -30.0, -1.0, -1e-16, 0.0, 1e-16, 1e-15, 0.5, 30.0, 100.0], np.float32)
    den = np.array([1e-16, -1e-16, 2.0, 0.0, 1e-15, 3.0, -4.0, 1e-20, 5.0, -1e-16], np.float32)
    if fn == "safe_div":
        t = tm.safe_div(torch.from_numpy(x), torch.from_numpy(den))
        j = jm.safe_div(jnp.asarray(x), jnp.asarray(den))
    else:
        t = getattr(tm, fn)(torch.from_numpy(x))
        j = getattr(jm, fn)(jnp.asarray(x))
    assert t.dtype == (torch.bool if fn == "is_almost_zero" else torch.float32)
    # XLA on the CPU flushes subnormal results to zero (log1p_exp(-100) is
    # 3.8e-44 in torch, 0 in JAX): below the smallest normal float32 the
    # two agree absolutely
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                               atol=float(np.finfo(np.float32).tiny))


def test_losses_go_through_log1p_exp():
    from photon_ml_tpu_torch.losses.pointwise import LogisticLoss
    from photon_ml_tpu_torch.utils.math_utils import log1p_exp

    z = torch.linspace(-120.0, 120.0, 1001)
    y = (torch.arange(1001) % 2).float()
    assert torch.equal(LogisticLoss.value(z, y), torch.nn.functional.softplus(z) - y * z)
    assert torch.equal(log1p_exp(z), torch.nn.functional.softplus(z))


def test_per_uid_cache_dir(tmp_path, monkeypatch):
    import tempfile

    from photon_ml_tpu.utils.cachedir import per_uid_cache_dir as j_dir
    from photon_ml_tpu_torch.ops.sparse_perm import default_plan_cache
    from photon_ml_tpu_torch.utils.cachedir import per_uid_cache_dir

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    path = per_uid_cache_dir("photon_cache_test")
    assert path == j_dir("photon_cache_test") == str(tmp_path / f"photon_cache_test_{os.getuid()}")
    assert stat.S_IMODE(os.stat(path).st_mode) == 0o700
    os.chmod(path, 0o770)  # group-writable: refused by both
    assert per_uid_cache_dir("photon_cache_test") is None is j_dir("photon_cache_test")
    (tmp_path / "blocked").write_text("")  # a file, not a directory
    monkeypatch.setattr(os, "makedirs", lambda *a, **k: (_ for _ in ()).throw(OSError("ro")))
    assert per_uid_cache_dir("anything") is None
    monkeypatch.undo()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(os, "getuid", lambda: 12345)  # another user's directory
    os.makedirs(tmp_path / "theirs_12345", mode=0o700)
    assert per_uid_cache_dir("theirs") is None
    monkeypatch.undo()
    # the plan cache: the same directory name and environment rule as before
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.delenv("PHOTON_ML_TPU_TORCH_PLAN_CACHE", raising=False)
    assert default_plan_cache() == str(tmp_path / f"photon_ml_tpu_torch_plan_cache_{os.getuid()}")
    monkeypatch.setenv("PHOTON_ML_TPU_TORCH_PLAN_CACHE", "")
    assert default_plan_cache() is None
    monkeypatch.setenv("PHOTON_ML_TPU_TORCH_PLAN_CACHE", str(tmp_path / "mine"))
    assert default_plan_cache() == str(tmp_path / "mine")

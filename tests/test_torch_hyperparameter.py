"""The port's hyperparameter search (its own copy of the numpy/scipy
modules) against the JAX package's: the kernels, the slice sampler, the
GP's fit and prediction, EI and CB, and both searchers' candidate sequences
on a numpy objective equal bit for bit under the same seeds; then the JAX
file's own cases (tests/test_hyperparameter.py) on the port."""

import numpy as np
import pytest

from photon_ml_tpu import hyperparameter as jhp
from photon_ml_tpu_torch.hyperparameter import (
    RBF,
    ConfidenceBound,
    ExpectedImprovement,
    GaussianProcessEstimator,
    GaussianProcessSearch,
    Matern52,
    RandomSearch,
    SliceSampler,
)


class QuadraticEvalFn:
    """Maximize -(x-target)^2 summed over dims; records trial points."""

    def __init__(self, target):
        self.target = np.asarray(target, dtype=float)
        self.calls = []

    def __call__(self, h):
        value = -float(np.sum((h - self.target) ** 2))
        self.calls.append(np.asarray(h))
        return value, (np.asarray(h, dtype=float), value)

    def vectorize_params(self, result):
        return result[0]

    def get_evaluation_value(self, result):
        return result[1]


# ------------------------------------------------------------ parity


@pytest.mark.parametrize("kernel", ["RBF", "Matern52"])
def test_kernels_equal_jax(kernel, rng):
    x1, x2 = rng.normal(size=(9, 3)), rng.normal(size=(5, 3))
    scale = np.array([0.7, 1.9, 3.1])
    for ls in (None, scale):
        kw = {} if ls is None else {"length_scale": ls}
        ours, theirs = getattr(jhp, kernel)(**kw), globals()[kernel](**kw)
        np.testing.assert_array_equal(theirs(x1), ours(x1))
        np.testing.assert_array_equal(theirs(x1, x2), ours(x1, x2))
        np.testing.assert_array_equal(theirs.get_params(), ours.get_params())


def test_slice_sampler_draws_equal_jax():
    logp = lambda x: -0.5 * float(np.sum((x - 1.5) ** 2) / 0.25)  # noqa: E731
    ours = SliceSampler(logp, range_=(-10, 10), rng=np.random.default_rng(7))
    theirs = jhp.SliceSampler(logp, range_=(-10, 10), rng=np.random.default_rng(7))
    x = y = np.zeros(2)
    for _ in range(50):
        x, y = ours.draw(x), theirs.draw(y)
        np.testing.assert_array_equal(x, y)


def test_gp_fit_and_predict_equal_jax(rng):
    x = rng.uniform(0, 2 * np.pi, size=(10, 2))
    y = np.sin(x[:, 0]) + 0.3 * np.cos(x[:, 1])
    xq = rng.uniform(0, 2 * np.pi, size=(7, 2))

    def fit(mod, crit):
        est = mod.GaussianProcessEstimator(
            kernel=mod.Matern52(), normalize_labels=True, num_burn_in_samples=10,
            num_samples=10, rng=np.random.default_rng(3), prediction_transformation=crit(mod),
        )
        return est.fit(x, y)

    import photon_ml_tpu_torch.hyperparameter as thp

    for crit in (lambda m: m.ExpectedImprovement(best_evaluation=0.5, larger_is_better=True),
                 lambda m: m.ConfidenceBound(larger_is_better=False)):
        ours, theirs = fit(thp, crit), fit(jhp, crit)
        for a, b in zip(ours.predict(xq), theirs.predict(xq)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ours.predict_transformed(xq),
                                      theirs.predict_transformed(xq))


def test_criteria_equal_jax(rng):
    means, variances = rng.normal(size=12), rng.uniform(0, 2, size=12)
    for larger in (True, False):
        np.testing.assert_array_equal(
            ExpectedImprovement(best_evaluation=0.2, larger_is_better=larger)(means, variances),
            jhp.ExpectedImprovement(best_evaluation=0.2, larger_is_better=larger)(
                means, variances))
        np.testing.assert_array_equal(
            ConfidenceBound(larger_is_better=larger, exploration_factor=1.5)(means, variances),
            jhp.ConfidenceBound(larger_is_better=larger, exploration_factor=1.5)(
                means, variances))


@pytest.mark.parametrize("searcher", ["random", "gp_cb", "gp_ei"])
def test_search_sequences_equal_jax(searcher):
    def run(mod):
        fn = QuadraticEvalFn([0.7, 0.3])
        if searcher == "random":
            search = mod.RandomSearch([(0, 1), (-1, 1)], fn, seed=4)
        else:
            search = mod.GaussianProcessSearch(
                [(0, 1), (-1, 1)], fn, larger_is_better=True, seed=4,
                candidate_pool_size=50, num_mcmc_samples=6,
                acquisition="EI" if searcher == "gp_ei" else "CB",
            )
        seed_obs = [(np.array([0.1, 0.2]), -0.37)]
        search.find(7, seed_obs)
        return np.array(fn.calls)

    import photon_ml_tpu_torch.hyperparameter as thp

    np.testing.assert_array_equal(run(thp), run(jhp))


# ------------------------------------------ the JAX file's own cases


class TestKernels:
    def test_rbf_closed_form(self):
        x = np.array([[0.0], [1.0], [3.0]])
        k = RBF()(x)
        assert k[0, 0] == pytest.approx(1.0)
        assert k[0, 1] == pytest.approx(np.exp(-0.5))
        assert k[0, 2] == pytest.approx(np.exp(-4.5))
        assert np.allclose(k, k.T)

    def test_matern52_closed_form(self):
        x = np.array([[0.0], [2.0]])
        r2 = 4.0
        f = np.sqrt(5 * r2)
        expected = (1 + f + 5 * r2 / 3) * np.exp(-f)
        k = Matern52()(x)
        assert k[0, 1] == pytest.approx(expected)
        assert k[0, 0] == pytest.approx(1.0)

    def test_length_scale_and_cross(self):
        x1 = np.array([[0.0, 0.0]])
        x2 = np.array([[2.0, 2.0]])
        wide = RBF(length_scale=np.array([10.0]))(x1, x2)[0, 0]
        narrow = RBF(length_scale=np.array([0.5]))(x1, x2)[0, 0]
        assert wide > narrow
        ard = RBF(length_scale=np.array([1.0, 1e6]))(x1, x2)[0, 0]
        assert ard == pytest.approx(np.exp(-0.5 * 4.0), rel=1e-3)

    def test_psd(self, rng):
        x = rng.normal(size=(12, 3))
        for kern in (RBF(), Matern52()):
            assert np.linalg.eigvalsh(kern(x)).min() > -1e-8

    def test_log_param_round_trip(self):
        k = Matern52(length_scale=np.array([2.5]))
        assert np.allclose(k.with_params(k.get_params()).length_scale, [2.5])


class TestSliceSampler:
    def test_recovers_gaussian(self):
        logp = lambda x: -0.5 * float(np.sum((x - 1.5) ** 2) / 0.25)  # noqa: E731
        sampler = SliceSampler(logp, range_=(-10, 10), rng=np.random.default_rng(7))
        x = np.zeros(1)
        draws = []
        for _ in range(600):
            x = sampler.draw(x)
            draws.append(x[0])
        draws = np.array(draws[100:])
        assert draws.mean() == pytest.approx(1.5, abs=0.1)
        assert draws.std() == pytest.approx(0.5, abs=0.12)

    def test_multidimensional(self):
        logp = lambda x: -0.5 * float(np.sum(x**2))  # noqa: E731
        sampler = SliceSampler(logp, rng=np.random.default_rng(3))
        x = sampler.draw(np.array([2.0, -2.0, 0.5]))
        assert x.shape == (3,)
        assert np.isfinite(logp(x))


class TestGaussianProcess:
    def test_regression_interpolates(self):
        x = np.linspace(0, 2 * np.pi, 12)[:, None]
        y = np.sin(x[:, 0])
        est = GaussianProcessEstimator(
            kernel=Matern52(), normalize_labels=True, num_burn_in_samples=15,
            num_samples=15, rng=np.random.default_rng(0),
        )
        model = est.fit(x, y)
        mean, _ = model.predict(np.array([[1.0], [4.0]]))
        assert mean[0] == pytest.approx(np.sin(1.0), abs=0.15)
        assert mean[1] == pytest.approx(np.sin(4.0), abs=0.15)
        _, var_train = model.predict(x[:1])
        _, var_far = model.predict(np.array([[20.0]]))
        assert var_train[0] < var_far[0]

    def test_log_likelihood_finite_and_peaked(self, rng):
        x = rng.normal(size=(8, 2))
        y = x[:, 0] * 0.5
        est = GaussianProcessEstimator(kernel=RBF())
        ll_good = est._log_likelihood(x, y, np.zeros(2))
        ll_bad = est._log_likelihood(x, y, np.full(2, -11.0))
        assert np.isfinite(ll_good)
        assert ll_good > ll_bad


class TestCriteria:
    def test_expected_improvement(self):
        means, variances = np.array([1.0, 2.0]), np.array([0.04, 0.04])
        vals = ExpectedImprovement(best_evaluation=1.5, larger_is_better=True)(means, variances)
        assert vals[1] > vals[0]
        assert (vals >= 0).all()
        vals_min = ExpectedImprovement(best_evaluation=1.5, larger_is_better=False)(
            means, variances)
        assert vals_min[0] > vals_min[1]

    def test_confidence_bound(self):
        means, variances = np.array([1.0, 1.0]), np.array([0.0, 1.0])
        ucb = ConfidenceBound(larger_is_better=True)(means, variances)
        lcb = ConfidenceBound(larger_is_better=False)(means, variances)
        assert ucb[1] == pytest.approx(3.0)
        assert lcb[1] == pytest.approx(-1.0)
        assert ucb[0] == pytest.approx(1.0)


class TestSearch:
    def test_random_search_explores(self):
        fn = QuadraticEvalFn([0.5, 0.5])
        results = RandomSearch([(0, 1), (0, 1)], fn, seed=1).find(16)
        pts = np.array([r[0] for r in results])
        assert pts.shape == (16, 2)
        assert (pts >= 0).all() and (pts <= 1).all()
        assert (pts[:, 0] < 0.5).any() and (pts[:, 0] > 0.5).any()

    def test_random_search_with_observations(self):
        fn = QuadraticEvalFn([0.0])
        results = RandomSearch([(-1, 1)], fn, seed=2).find(3, [(np.array([0.3]), -0.09)])
        assert len(results) == 3

    def test_gp_search_beats_random(self):
        search = GaussianProcessSearch(
            [(0, 1), (0, 1)], QuadraticEvalFn([0.7, 0.3]), larger_is_better=True,
            candidate_pool_size=60, seed=5, num_mcmc_samples=8,
        )
        results = search.find(12)
        assert max(r[1] for r in results) > -0.05
        assert search.last_model is not None

    def test_gp_search_expected_improvement(self):
        search = GaussianProcessSearch(
            [(0, 1)], QuadraticEvalFn([0.4]), larger_is_better=True, seed=9,
            candidate_pool_size=40, num_mcmc_samples=6, acquisition="EI",
        )
        assert max(r[1] for r in search.find(8)) > -0.05

    def test_gp_search_minimize(self):
        class NegFn(QuadraticEvalFn):
            def __call__(self, h):
                v, r = QuadraticEvalFn.__call__(self, h)
                return -v, (r[0], -v)

        search = GaussianProcessSearch(
            [(0, 1)], NegFn([0.5]), larger_is_better=False, seed=3,
            candidate_pool_size=40, num_mcmc_samples=6,
        )
        assert min(r[1] for r in search.find(8)) < 0.02


class TestGameTuning:
    def test_end_to_end_tuning_improves_bad_lambda(self, rng):
        """Random tuning from a terrible λ finds a better validation RMSE
        within a few trials (reference DriverTest hyperopt paths)."""
        from photon_ml_tpu_torch.data.game_data import FeatureShard, GameData
        from photon_ml_tpu_torch.estimators.game import (
            FixedEffectCoordinateConfiguration,
            GameEstimator,
        )
        from photon_ml_tpu_torch.estimators.tuning import run_hyperparameter_tuning
        from photon_ml_tpu_torch.opt.config import (
            GlmOptimizationConfiguration,
            RegularizationContext,
        )
        from photon_ml_tpu_torch.types import RegularizationType, TaskType

        n, d = 400, 10
        X = rng.normal(size=(n, d)).astype(np.float32)
        w = rng.normal(size=d).astype(np.float32)
        y = X @ w + 0.05 * rng.normal(size=n).astype(np.float32)

        def coo(X):
            rows, cols = np.nonzero(X)
            return FeatureShard(rows=rows, cols=cols, vals=X[rows, cols], dim=d)

        data = GameData(labels=y[:300], feature_shards={"g": coo(X[:300])}, id_tags={})
        vdata = GameData(labels=y[300:], feature_shards={"g": coo(X[300:])}, id_tags={})
        bad = GlmOptimizationConfiguration(
            regularization=RegularizationContext(RegularizationType.L2),
            regularization_weight=1e4,
        )
        est = GameEstimator(
            task=TaskType.LINEAR_REGRESSION,
            coordinates={"g": FixedEffectCoordinateConfiguration("g", bad)}, device="cpu",
        )
        base_fit = est.fit(data, validation_data=vdata)
        trials = run_hyperparameter_tuning(
            est, data, vdata, mode="RANDOM", num_iterations=4,
            log10_range=(-3.0, 1.0), prior_fits=[base_fit], seed=0,
        )
        assert len(trials) == 4
        assert min(t.value for t in trials) < base_fit.validation_metric

"""High-level API tests (reference surface: tsu/api.py)."""

import numpy as np
import pytest

from tsu_tpu import (
    Backend,
    BayesianSampler,
    BernoulliActivation,
    ConfigurationError,
    GaussianSampler,
    MaxCutProblem,
    MultimodalSampler,
    ProbabilisticModel,
    SamplingResult,
    StochasticLinear,
    TSUConfig,
    compare_samplers,
    optimize,
    sample_gaussian,
    sample_multimodal,
)


class TestGaussianSampler:
    def test_sampling_result(self):
        s = GaussianSampler(1.0, 0.5, seed=0,
                            config=TSUConfig(n_chains=16, n_burnin=200,
                                             n_steps=200, dt=0.1))
        res = s.sample(2000)
        assert isinstance(res, SamplingResult)
        assert res.samples.shape == (2000, 1)
        assert res.time_elapsed > 0
        assert "samples_per_second" in res.metadata
        assert abs(res.samples.mean() - 1.0) < 0.15
        assert abs(res.samples.std() - 0.5) < 0.12

    def test_invalid_sigma(self):
        with pytest.raises(ConfigurationError):
            GaussianSampler(0.0, -1.0)


class TestMultimodalSampler:
    def test_covers_both_modes(self):
        s = MultimodalSampler(modes=[-3.0, 3.0], sigmas=[0.5, 0.5], seed=0,
                              config=TSUConfig(n_chains=32, n_burnin=300,
                                               n_steps=300, dt=0.1,
                                               temperature=1.0))
        res = s.sample(2000)
        x = res.samples.ravel()
        frac_left = np.mean(x < 0)
        assert 0.2 < frac_left < 0.8  # both modes visited across chains

    def test_mismatched_lengths(self):
        with pytest.raises(ConfigurationError):
            MultimodalSampler(modes=[0.0, 1.0], sigmas=[0.5])


class TestBayesianSampler:
    def test_posterior_concentrates_on_truth(self):
        rng = np.random.default_rng(0)
        theta_true = np.array([1.5, -0.7])
        X = rng.normal(0, 1, (200, 2))
        y = X @ theta_true + 0.1 * rng.normal(size=200)
        s = BayesianSampler(X, y, noise_std=0.1, prior_std=5.0, seed=0,
                            config=TSUConfig(n_chains=16, n_burnin=500,
                                             n_steps=200, dt=0.01))
        res = s.sample(2000)
        post_mean = res.samples.mean(axis=0)
        assert np.all(np.abs(post_mean - theta_true) < 0.2)


class TestFunctionalAPI:
    def test_sample_gaussian(self):
        s = sample_gaussian(0.0, 1.0, 500, seed=0)
        assert s.shape == (500,)

    def test_sample_multimodal(self):
        s = sample_multimodal([-1.0, 1.0], [0.3, 0.3], 500, seed=0)
        assert s.shape == (500,)

    def test_compare_samplers(self):
        out = compare_samplers(500)
        assert set(out) == {"tsu", "direct", "mcmc"}
        for v in out.values():
            assert "time" in v and "mean" in v


class TestMaxCut:
    def test_bipartite_graph_solved_exactly(self):
        # Complete bipartite K_{3,3}: max cut = 9 (all edges cut).
        n = 6
        W = np.zeros((n, n))
        for i in range(3):
            for j in range(3, 6):
                W[i, j] = W[j, i] = 1.0
        prob = MaxCutProblem(W)
        result = optimize(prob, n_steps=400, n_chains=8, seed=0)
        assert prob.cut_value(result["best_solution"]) == pytest.approx(9.0)
        assert result["best_objective"] == pytest.approx(-9.0)

    def test_cut_value(self):
        W = np.array([[0.0, 1.0], [1.0, 0.0]])
        prob = MaxCutProblem(W)
        assert prob.cut_value(np.array([1.0, -1.0])) == pytest.approx(1.0)
        assert prob.cut_value(np.array([1.0, 1.0])) == pytest.approx(0.0)

    def test_dimension(self):
        assert MaxCutProblem(np.zeros((4, 4))).dimension == 4


class TestProbabilisticModel:
    def test_stack_and_forward(self):
        model = ProbabilisticModel()
        model.add(StochasticLinear(3, 8, seed=0)).add(BernoulliActivation(seed=0))
        model.add(StochasticLinear(8, 1, seed=1))
        out = model.forward(np.ones((5, 3)))
        assert out.shape == (5, 1)

    def test_bernoulli_activation_binary(self):
        act = BernoulliActivation(seed=0)
        out = act.forward(np.zeros((10, 10)))
        assert set(np.unique(out)) <= {0.0, 1.0}
        assert abs(out.mean() - 0.5) < 0.2

    def test_predict_proba(self):
        model = ProbabilisticModel()
        model.add(StochasticLinear(2, 1, weight_noise=0.5, seed=0))
        probs = model.predict_proba(np.ones((3, 2)), n_samples=20)
        assert probs.shape == (3, 1)

    def test_add_rejects_non_layer(self):
        with pytest.raises(ConfigurationError):
            ProbabilisticModel().add(lambda x: x)


class TestBackend:
    def test_enum_values(self):
        assert Backend.EMULATOR.value == "emulator"
        assert Backend.GPU.value == "gpu"

    def test_gpu_backend_rejected_on_cpu(self):
        import jax

        if jax.default_backend() != "gpu":
            with pytest.raises(ConfigurationError):
                GaussianSampler(backend=Backend.GPU)


class TestReferenceAliases:
    """Drop-in parity with the reference's parameter names
    (tsu/api.py:75-108,199-214: ``n``, ``return_metadata``, ``centers``)."""

    def test_sample_n_alias_and_bare_array(self):
        s = GaussianSampler(mu=0.0, sigma=1.0, seed=0)
        bare = s.sample(n=300, return_metadata=False)
        assert isinstance(bare, np.ndarray)
        assert bare.shape[0] == 300

    def test_functional_n_alias(self):
        from tsu_tpu.api import sample_gaussian

        out = sample_gaussian(mu=1.0, sigma=2.0, n=400, seed=3)
        assert out.shape == (400,)
        assert abs(float(np.mean(out)) - 1.0) < 0.5

    def test_multimodal_centers_alias(self):
        from tsu_tpu.api import sample_multimodal

        out = sample_multimodal(centers=[-3.0, 0.0, 3.0], n=300, seed=0)
        assert out.shape == (300,)

"""tsu_tpu — a JAX probabilistic inference engine for NVIDIA GPUs.

A from-scratch rebuild of the capabilities of the TSU (Thermodynamic Sampling
Unit) emulator (reference: Arsham-001/tsu-emulator) on JAX:

- Energy models are JAX-traceable functions compiled by XLA; gradients come
  from ``jax.grad`` (reference uses finite differences, tsu/core.py:82-98).
- Langevin/HMC samplers are fused ``lax.scan`` loops vmapped over chains
  (reference: per-sample Python loops, tsu/core.py:140-159).
- Ising/Boltzmann sampling uses vectorized checkerboard (red/black) Gibbs
  sweeps, with a Pallas GPU kernel where it is faster (reference: scalar
  per-bit Python loop, tsu/gibbs.py:128-162).
- Large lattices shard spatially over a ``jax.sharding.Mesh`` with halo
  exchange via collectives; chains/replicas shard over their own mesh axes
  (reference simulates parallelism with sequential loops, tsu/gibbs.py:450-487).
- The BNN path trains a true ELBO with ``jax.value_and_grad`` + optax
  (reference: hand-written backprop that never learns sigma, tsu/ml.py:458-539).

The flat public namespace mirrors the reference's ``tsu/__init__.py:80-131``
so users of the reference can switch with minimal friction.
"""

from tsu_tpu.config import (
    TSUError,
    ConfigurationError,
    SamplingError,
    TSUConfig,
    GibbsConfig,
    IsingConfig,
)
from tsu_tpu.core import (
    ThermalSamplingUnit,
    ProbabilisticNeuron,
    validate_distribution,
)
from tsu_tpu.samplers.gibbs import GibbsSampler
from tsu_tpu.samplers import (
    sample_langevin,
    sample_hmc,
    sample_hmc_adaptive,
    sample_mala,
    sample_nuts,
    annealed_smc,
    fit_meanfield_vi,
)
from tsu_tpu.hardware import (
    HardwareEmulator,
    TSUHardwareSpec,
    HardwarePerformanceEstimator,
    ConservativeEstimator,
)
from tsu_tpu.models.ising import (
    IsingModel,
    IsingChain,
    IsingGrid,
    demonstrate_phase_transition,
)
from tsu_tpu.models.ml import (
    AnchoredEnsembleRegressor,
    BayesianNetwork,
    BayesianRegressor,
    BayesianLinear,
    StochasticLayer,
    PosteriorSample,
    PredictionResult,
)
from tsu_tpu.api import (
    Backend,
    SamplingResult,
    Sampler,
    GaussianSampler,
    MultimodalSampler,
    BayesianSampler,
    OptimizationProblem,
    MaxCutProblem,
    ProbabilisticLayer,
    StochasticLinear,
    BernoulliActivation,
    ProbabilisticModel,
    sample_gaussian,
    sample_multimodal,
    compare_samplers,
    optimize,
)
# Plotting needs matplotlib (and plotly for the interactive landscape),
# which the sampling engine does not: the plot functions load on first use.
_PLOTS = (
    "plot_predictions_with_uncertainty",
    "plot_uncertainty_vs_error",
    "plot_energy_landscape_2d",
    "plot_ising_state",
    "plot_phase_transition",
    "plot_sampling_diagnostics",
    "plot_active_learning_curve",
    "plot_interactive_energy_landscape",
)


def __getattr__(name):
    if name in _PLOTS:
        from tsu_tpu import visualization

        return getattr(visualization, name)
    raise AttributeError(f"module 'tsu_tpu' has no attribute {name!r}")


# Alias mirroring the reference (`tsu/__init__.py:22`).
TSU = ThermalSamplingUnit

__version__ = "0.5.0"

__all__ = [
    # Core
    "ThermalSamplingUnit",
    "TSU",
    "TSUConfig",
    "ProbabilisticNeuron",
    "validate_distribution",
    "TSUError",
    "ConfigurationError",
    "SamplingError",
    # Gibbs
    "GibbsSampler",
    "GibbsConfig",
    "HardwareEmulator",
    # Hardware projection
    "TSUHardwareSpec",
    "HardwarePerformanceEstimator",
    "ConservativeEstimator",
    # Models
    "IsingModel",
    "IsingChain",
    "IsingGrid",
    "IsingConfig",
    "demonstrate_phase_transition",
    # ML
    "BayesianNetwork",
    "BayesianRegressor",
    "AnchoredEnsembleRegressor",
    "BayesianLinear",
    "StochasticLayer",
    "PosteriorSample",
    "PredictionResult",
    # Visualization
    "plot_predictions_with_uncertainty",
    "plot_uncertainty_vs_error",
    "plot_energy_landscape_2d",
    "plot_ising_state",
    "plot_phase_transition",
    "plot_sampling_diagnostics",
    "plot_active_learning_curve",
    "plot_interactive_energy_landscape",
    # API
    "Backend",
    "SamplingResult",
    "Sampler",
    "GaussianSampler",
    "MultimodalSampler",
    "BayesianSampler",
    "OptimizationProblem",
    "MaxCutProblem",
    "ProbabilisticLayer",
    "StochasticLinear",
    "BernoulliActivation",
    "ProbabilisticModel",
    "sample_gaussian",
    "sample_multimodal",
    "compare_samplers",
    "optimize",
    "quick_demo",
    # Sampler engines (beyond the reference surface)
    "sample_langevin",
    "sample_hmc",
    "sample_hmc_adaptive",
    "sample_mala",
    "sample_nuts",
    "annealed_smc",
    "fit_meanfield_vi",
]


def quick_demo():
    """Run a quick demonstration of core capabilities (cf. tsu/__init__.py:134-156)."""
    import numpy as np

    print("tsu_tpu quick demo")
    print("=" * 40)

    sampler = GaussianSampler(mu=0.0, sigma=1.0)
    result = sampler.sample(n_samples=1000)
    print(f"Gaussian sampling: mean={np.mean(result.samples):+.3f} "
          f"std={np.std(result.samples):.3f} "
          f"({result.metadata['samples_per_second']:.0f} samples/s)")

    grid = IsingGrid((16, 16), coupling_strength=1.0)
    samples = grid.sample(n_samples=64, temperature=1.5)
    print(f"Ising 16x16 @ T=1.5: |M|={abs(grid.magnetization(samples)):.3f}")
    print("Demo complete.")

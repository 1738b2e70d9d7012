"""Quickstart: the main entry points of tsu_tpu in one script."""

import numpy as np

import tsu_tpu as tsu


def main():
    # 1. Continuous sampling from an arbitrary traceable energy.
    unit = tsu.ThermalSamplingUnit(
        tsu.TSUConfig(n_chains=16, n_burnin=300, n_steps=200, dt=0.1), seed=0
    )
    samples = unit.sample_gaussian(mu=2.0, sigma=0.5, n_samples=5000)
    print(f"Gaussian: mean={samples.mean():.3f} std={samples.std():.3f}")

    # 2. Custom energy (anything jax.numpy-traceable).
    import jax.numpy as jnp

    def double_well(x):
        return jnp.sum((x**2 - 1.0) ** 2)

    s = unit.sample_from_energy(double_well, np.zeros(1), 3000)
    print(f"Double well: both wells visited -> mean |x| = "
          f"{np.abs(s).mean():.3f} (minima at +-1)")

    # 3. Boltzmann machine bits.
    gibbs = tsu.GibbsSampler(tsu.GibbsConfig(n_chains=16), seed=0)
    J = np.array([[0.0, 2.0], [2.0, 0.0]], np.float32)
    bits = gibbs.sample_boltzmann(J, n_samples=2000)
    print(f"2-bit ferromagnet: aligned fraction = "
          f"{np.mean(bits[:, 0] == bits[:, 1]):.2f}")

    # 4. 2-D Ising lattice (checkerboard engine; Pallas kernel on the GPU).
    grid = tsu.IsingGrid((32, 32), coupling_strength=1.0, periodic=True, seed=0)
    states = grid.sample(n_samples=50, temperature=1.8)
    print(f"32x32 Ising @ T=1.8: |M| = {abs(grid.magnetization(states)):.3f}")

    # 5. Bayesian regression with calibrated uncertainty.
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (100, 1)).astype(np.float32)
    y = np.sin(3 * x) + 0.1 * rng.normal(size=x.shape).astype(np.float32)
    reg = tsu.BayesianRegressor(1, [32, 32], temperature=0.2, seed=0)
    reg.fit(x, y, n_epochs=100, learning_rate=0.01, kl_weight=1e-4)
    mean, lo, hi = reg.predict_with_interval(x[:5])
    for xi, m, l, h in zip(x[:5].ravel(), mean.ravel(), lo.ravel(), hi.ravel()):
        print(f"  f({xi:+.2f}) = {m:+.3f}  95% CI [{l:+.3f}, {h:+.3f}]")


if __name__ == "__main__":
    main()

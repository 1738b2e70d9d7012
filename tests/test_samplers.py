"""Direct sampler-engine tests: Langevin integrators, HMC, annealed SMC."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tsu_tpu.energy import MixtureOfGaussians, Quadratic
from tsu_tpu.samplers.hmc import sample_hmc
from tsu_tpu.samplers.langevin import sample_langevin
from tsu_tpu.samplers.smc import annealed_smc, systematic_resample_indices


class TestLangevin:
    @pytest.mark.parametrize("underdamped", [True, False])
    def test_gaussian_moments(self, underdamped):
        key = jax.random.key(0)
        x0 = jnp.zeros((16, 2))
        s = sample_langevin(
            key, x0, energy_fn=Quadratic(0.0, 1.0), n_samples=300,
            dt=0.05 if underdamped else 0.01, n_burnin=300, n_steps=5,
            underdamped=underdamped,
        )
        assert s.shape == (16, 300, 2)
        flat = np.asarray(s).reshape(-1, 2)
        assert np.all(np.abs(flat.mean(axis=0)) < 0.1)
        assert np.all(np.abs(flat.std(axis=0) - 1.0) < 0.12)

    def test_temperature_scales_variance(self):
        key = jax.random.key(1)
        x0 = jnp.zeros((8, 1))
        kwargs = dict(energy_fn=Quadratic(0.0, 1.0), n_samples=400,
                      dt=0.05, n_burnin=300, n_steps=5)
        hot = sample_langevin(key, x0, temperature=4.0, **kwargs)
        cold = sample_langevin(key, x0, temperature=0.25, **kwargs)
        # Var scales linearly with T: std ratio ~ sqrt(16) = 4.
        ratio = np.asarray(hot).std() / np.asarray(cold).std()
        assert 2.5 < ratio < 6.0


class TestHMC:
    def test_gaussian_exact(self):
        key = jax.random.key(0)
        x0 = jnp.zeros((8, 3))
        s, acc = sample_hmc(
            key, x0, energy_fn=Quadratic(0.0, 1.0), n_samples=500,
            step_size=0.3, n_leapfrog=8, n_burnin=100,
        )
        assert s.shape == (8, 500, 3)
        assert float(acc) > 0.7
        flat = np.asarray(s).reshape(-1, 3)
        assert np.all(np.abs(flat.mean(axis=0)) < 0.08)
        assert np.all(np.abs(flat.std(axis=0) - 1.0) < 0.08)

    def test_anisotropic_gaussian(self):
        key = jax.random.key(2)

        def energy(x):
            return x[0] ** 2 / (2 * 4.0) + x[1] ** 2 / (2 * 0.25)

        s, acc = sample_hmc(key, jnp.zeros((8, 2)), energy_fn=energy,
                            n_samples=800, step_size=0.2, n_leapfrog=10,
                            n_burnin=200)
        flat = np.asarray(s).reshape(-1, 2)
        assert abs(flat[:, 0].std() - 2.0) < 0.25
        assert abs(flat[:, 1].std() - 0.5) < 0.08


class TestSMC:
    def test_systematic_resampling_unbiased(self):
        key = jax.random.key(0)
        log_w = jnp.log(jnp.array([0.1, 0.2, 0.3, 0.4]))
        counts = np.zeros(4)
        for i in range(200):
            idx = systematic_resample_indices(jax.random.fold_in(key, i), log_w)
            counts += np.bincount(np.asarray(idx), minlength=4)
        freqs = counts / counts.sum()
        np.testing.assert_allclose(freqs, [0.1, 0.2, 0.3, 0.4], atol=0.03)

    def test_multimodal_target(self):
        key = jax.random.key(1)
        energy = MixtureOfGaussians(((-3.0,), (3.0,)), (0.5, 0.5))
        particles = 3.0 * jax.random.normal(jax.random.fold_in(key, 0), (512, 1))
        out = annealed_smc(jax.random.fold_in(key, 1), particles,
                           energy_fn=energy, n_steps=40, n_moves=5, dt=0.05)
        x = np.asarray(out["particles"]).ravel()
        frac_left = np.mean(x < 0)
        assert 0.3 < frac_left < 0.7
        # Mode means near ±3.
        assert abs(np.mean(np.abs(x)) - 3.0) < 0.4

    def test_log_z_gaussian(self):
        # Target N(0,1) from base N(0, 3^2): log Z = log[(1/sqrt(2pi)) ... ]
        # With E_target = x^2/2, Z_target = sqrt(2 pi); base normalized
        # against exp(-x^2/(2*9)) with Z_base = sqrt(2 pi * 9).
        key = jax.random.key(3)
        particles = 3.0 * jax.random.normal(jax.random.fold_in(key, 0), (2048, 1))
        out = annealed_smc(jax.random.fold_in(key, 1), particles,
                           energy_fn=Quadratic(0.0, 1.0), n_steps=60,
                           n_moves=3, dt=0.1, base_sigma=3.0)
        expected = 0.5 * np.log(2 * np.pi) - 0.5 * np.log(2 * np.pi * 9.0)
        assert float(out["log_Z"]) == pytest.approx(expected, abs=0.15)


class TestLatticeAnnealing:
    """Per-sweep temperature schedules through the lattice engines (r4)."""

    def test_ferromagnet_reaches_ground_state(self):
        from tsu_tpu.samplers.annealing import anneal_lattice

        state, e = anneal_lattice(jax.random.key(0), (8, 8), n_steps=400,
                                  n_chains=2, use_pallas=False)
        assert e == -128.0  # periodic 8x8 ferromagnet: E = -2N
        assert abs(float(np.mean(state))) == 1.0

    def test_spin_glass_anneal_beats_quench(self):
        from tsu_tpu.ops.checkerboard_bonds import lattice_energy_bonds
        from tsu_tpu.samplers.annealing import anneal_spin_glass

        key = jax.random.key(1)
        Jh = jnp.where(jax.random.bernoulli(jax.random.fold_in(key, 0), 0.5,
                                            (8, 8)), 1.0, -1.0)
        Jv = jnp.where(jax.random.bernoulli(jax.random.fold_in(key, 1), 0.5,
                                            (8, 8)), 1.0, -1.0)
        st, e = anneal_spin_glass(jax.random.key(2), Jh, Jv, n_steps=400,
                                  n_restarts=2, use_pallas=False)
        n = 64
        # The EA +-J ground-state energy density is ~-1.4; a random state
        # sits at 0. Annealing must land deep.
        assert e / n < -1.2
        # Reported energy must match the returned state.
        assert abs(float(lattice_energy_bonds(jnp.asarray(st), Jh, Jv, 0.0,
                                              periodic=True)) - e) < 1e-4

    def test_discrete_table_gate(self):
        """The +-J threshold-table path is only exact for {-1,0,1} bonds
        with ZERO field (any field shifts the local field off the 9-entry
        table — r4 review finding)."""
        from tsu_tpu.samplers.annealing import discrete_table_applicable

        Jh = jnp.ones((8, 8))
        Jv = -jnp.ones((8, 8))
        assert discrete_table_applicable(Jh, Jv, 0.0)
        assert not discrete_table_applicable(Jh, Jv, 1.0)   # integer field
        assert not discrete_table_applicable(Jh, Jv, 0.5)
        assert not discrete_table_applicable(Jh * 0.7, Jv, 0.0)

    def test_spin_glass_chunked_tracking_cpu_pallas(self, kernel_interpret):
        """The kernel route's chunked best-state tracking must report an
        energy that matches the returned state (interpret mode)."""
        from tsu_tpu.ops.checkerboard_bonds import lattice_energy_bonds
        from tsu_tpu.samplers.annealing import anneal_spin_glass

        key = jax.random.key(3)
        Jh = jnp.where(jax.random.bernoulli(jax.random.fold_in(key, 0), 0.5,
                                            (8, 8)), 1.0, -1.0)
        Jv = jnp.where(jax.random.bernoulli(jax.random.fold_in(key, 1), 0.5,
                                            (8, 8)), 1.0, -1.0)
        st, e = anneal_spin_glass(jax.random.key(4), Jh, Jv,
                                  n_steps=60, use_pallas=True)
        e_check = float(lattice_energy_bonds(jnp.asarray(st), Jh, Jv, 0.0,
                                             periodic=True))
        assert abs(e_check - e) < 1e-4


class TestSpinGlassTempering:
    """Replica exchange over a disordered lattice (the spin-glass
    workhorse; r4 addition with no reference counterpart)."""

    def test_ladder_orders_energies_and_swaps(self):
        from tsu_tpu.samplers.tempering import parallel_tempering_bonds

        key = jax.random.key(0)
        Jh = jnp.where(jax.random.bernoulli(jax.random.fold_in(key, 0), 0.5,
                                            (8, 8)), 1.0, -1.0)
        Jv = jnp.where(jax.random.bernoulli(jax.random.fold_in(key, 1), 0.5,
                                            (8, 8)), 1.0, -1.0)
        cold, info = parallel_tempering_bonds(
            jax.random.key(1), Jh, Jv,
            temperatures=np.geomspace(0.5, 3.0, 6),
            n_samples=40, swap_interval=2, n_burnin=30, use_pallas=False,
        )
        assert cold.shape == (40, 8, 8)
        assert info["swap_acceptance_rate"] > 0.05
        e = info["energies"]
        # Rung energies must order with temperature (cold < hot).
        assert e[-20:, 0].mean() < e[-20:, -1].mean()
        # Cold rung should sit near the EA ground-state density.
        assert e[-20:, 0].mean() / 64 < -1.1

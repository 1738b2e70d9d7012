"""Ising model tests: exact energies, corrected spin<->bit mapping (quirk Q1),
observables, and phase behavior (reference pattern: tests/test_ising.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tsu_tpu import (
    ConfigurationError,
    IsingChain,
    IsingConfig,
    IsingGrid,
    IsingModel,
)
from tsu_tpu.energy import ising_to_boltzmann
from tsu_tpu.oracle import exact_ising_moments, exact_boltzmann_moments


class TestIsingModel:
    def test_energy_exact(self):
        # Two spins, J=1: E(++) = -1, E(+-) = +1 (cf. tests/test_ising.py:47-73).
        m = IsingModel(2, seed=0)
        m.set_coupling(0, 1, 1.0)
        assert m.energy(np.array([1.0, 1.0])) == pytest.approx(-1.0)
        assert m.energy(np.array([1.0, -1.0])) == pytest.approx(1.0)

    def test_energy_with_field(self):
        m = IsingModel(2, seed=0)
        m.set_external_field(np.array([0.5, -0.5]))
        assert m.energy(np.array([1.0, 1.0])) == pytest.approx(0.0)
        assert m.energy(np.array([1.0, -1.0])) == pytest.approx(-1.0)

    def test_set_coupling_symmetric(self):
        m = IsingModel(3, seed=0)
        m.set_coupling(0, 2, 1.5)
        assert m.J[0, 2] == m.J[2, 0] == 1.5

    def test_self_coupling_rejected(self):
        m = IsingModel(3, seed=0)
        with pytest.raises(ConfigurationError):
            m.set_coupling(1, 1, 1.0)

    def test_out_of_range_rejected(self):
        m = IsingModel(3, seed=0)
        with pytest.raises(ConfigurationError):
            m.set_coupling(0, 5, 1.0)

    def test_spin_bit_roundtrip(self):
        m = IsingModel(4, seed=0)
        s = np.array([1.0, -1.0, -1.0, 1.0])
        np.testing.assert_array_equal(m._bits_to_spins(m._spins_to_bits(s)), s)

    def test_bit_mapping_preserves_distribution(self):
        """The corrected spin->bit mapping (quirk Q1 fix) must give identical
        Boltzmann moments in both representations."""
        rng = np.random.default_rng(3)
        n = 6
        J = rng.normal(0, 0.8, (n, n))
        J = (J + J.T) / 2
        np.fill_diagonal(J, 0)
        h = rng.normal(0, 0.5, n)
        T = 1.3

        spin = exact_ising_moments(J, h, temperature=T)
        J_bit, h_bit = ising_to_boltzmann(J, h)
        bit = exact_boltzmann_moments(np.asarray(J_bit), np.asarray(h_bit),
                                      temperature=T)
        # <s_i> = 2<b_i> - 1 must hold exactly.
        np.testing.assert_allclose(spin["mean"], 2 * bit["mean"] - 1, atol=1e-5)

    def test_sample_moments_vs_exact(self):
        rng = np.random.default_rng(11)
        n = 5
        m = IsingModel(n, IsingConfig(n_burnin=100, n_sweeps=3, n_chains=8),
                       seed=5)
        for i in range(n):
            for j in range(i + 1, n):
                m.set_coupling(i, j, rng.normal(0, 0.6))
        m.set_external_field(rng.normal(0, 0.4, n))
        samples = m.sample(4000)
        exact = exact_ising_moments(m.J, m.h, temperature=1.0)
        assert np.all(np.abs(samples.mean(axis=0) - exact["mean"]) < 0.08)

    def test_sample_shape_and_spins(self):
        m = IsingModel(4, IsingConfig(n_burnin=10), seed=0)
        s = m.sample(20)
        assert s.shape == (20, 4)
        assert set(np.unique(s)) <= {-1.0, 1.0}

    def test_observables(self):
        m = IsingModel(3, seed=0)
        samples = np.array([[1.0, 1.0, 1.0], [-1.0, -1.0, -1.0]])
        assert m.magnetization(samples) == pytest.approx(0.0)
        assert m.susceptibility(np.ones((5, 3))) == pytest.approx(0.0)

    def test_find_ground_state_ferromagnet(self):
        m = IsingModel(6, seed=0)
        for i in range(5):
            m.set_coupling(i, i + 1, 2.0)
        state, energy = m.find_ground_state(n_steps=300)
        assert abs(state.sum()) == 6  # fully aligned
        assert energy == pytest.approx(-10.0)


class TestIsingChain:
    def test_construction(self):
        chain = IsingChain(5, J=1.5, seed=0)
        assert chain.J[0, 1] == 1.5
        assert chain.J[3, 4] == 1.5
        assert chain.J[0, 2] == 0.0

    def test_orders_at_low_temperature(self):
        chain = IsingChain(8, J=2.0,
                           config=IsingConfig(temperature=0.3, n_burnin=200,
                                              n_sweeps=2), seed=1)
        s = chain.sample(100)
        m = np.abs(s.mean(axis=1))
        assert m.mean() > 0.8

    def test_visualize_smoke(self):
        chain = IsingChain(5, seed=0)
        fig = chain.visualize(np.array([1, -1, 1, -1, 1.0]))
        assert fig is not None


class TestIsingGrid:
    def test_even_grid_uses_stencil(self):
        grid = IsingGrid((8, 8), seed=0)
        assert grid._fast
        assert grid.J is None

    def test_odd_grid_uses_dense(self):
        grid = IsingGrid((3, 3), seed=0)
        assert not grid._fast
        assert grid.J is not None
        # 3x3 open grid: 12 bonds.
        assert (np.count_nonzero(grid.J) // 2) == 12

    def test_energy_matches_between_paths(self, rng):
        state = np.where(rng.random(16) < 0.5, 1.0, -1.0)
        fast = IsingGrid((4, 4), coupling_strength=1.0, periodic=False, seed=0,
                         use_pallas=False)
        # Build dense twin via an odd-grid-style construction.
        dense = IsingGrid.__new__(IsingGrid)
        IsingModel.__init__(dense, 16, None, 0)
        dense.shape = (4, 4)
        dense.periodic = False
        dense.coupling_strength = 1.0
        dense._fast = False
        dense._build_dense()
        assert fast.energy(state) == pytest.approx(dense.energy(state))

    def test_sample_shape(self):
        grid = IsingGrid((6, 6), config=IsingConfig(n_burnin=20), seed=0,
                         use_pallas=False)
        s = grid.sample(10)
        assert s.shape == (10, 36)
        assert set(np.unique(s)) <= {-1.0, 1.0}

    def test_orders_below_tc(self):
        grid = IsingGrid((16, 16), periodic=True, seed=0, use_pallas=False,
                         config=IsingConfig(n_burnin=300, n_sweeps=2))
        s = grid.sample(50, temperature=1.5)  # below T_c ~ 2.269
        m = np.abs(s.mean(axis=1))
        assert m.mean() > 0.85

    def test_disorders_above_tc(self):
        grid = IsingGrid((16, 16), periodic=True, seed=0, use_pallas=False,
                         config=IsingConfig(n_burnin=100, n_sweeps=1))
        s = grid.sample(100, temperature=5.0)
        assert abs(s.mean()) < 0.1

    def test_ground_state(self):
        grid = IsingGrid((6, 6), periodic=True, seed=0, use_pallas=False)
        state, energy = grid.find_ground_state(n_steps=300)
        # Ferromagnetic periodic 6x6: E0 = -2 * 36 = -72.
        assert energy == pytest.approx(-72.0)

    def test_compute_domains(self):
        grid = IsingGrid((4, 4), seed=0)
        assert grid.compute_domains(np.ones(16)) == 1
        half = np.ones((4, 4))
        half[:, 2:] = -1
        assert grid.compute_domains(half.ravel()) == 2

    def test_visualize_smoke(self):
        grid = IsingGrid((4, 4), seed=0)
        fig = grid.visualize(np.ones(16))
        assert fig is not None


class TestPhaseTransition:
    @pytest.mark.slow
    def test_magnetization_drops_across_tc(self):
        from tsu_tpu.models.ising import demonstrate_phase_transition

        res = demonstrate_phase_transition(
            sizes=[12], temperatures=np.array([1.0, 1.5, 3.5, 4.0]),
            n_samples=40, seed=0,
        )
        m = res[12]["magnetization"]
        assert m[0] > 0.9      # deep ferromagnetic phase
        assert m[-1] < 0.35    # disordered phase


class TestPerBondCouplings:
    """Random-bond lattices on the checkerboard bond engine (r1 gap #4:
    set_coupling forced a dense fallback capped at 4,096 spins)."""

    def test_set_coupling_keeps_stencil_path(self):
        from tsu_tpu.models.ising import IsingGrid

        g = IsingGrid((8, 8), coupling_strength=1.0, periodic=True, seed=0,
                      use_pallas=False)
        g.set_coupling(0, 1, -0.5)       # horizontal neighbor bond
        g.set_coupling(0, 8, 2.0)        # vertical neighbor bond
        g.set_coupling(0, 7, 0.25)       # periodic horizontal wrap
        assert g._fast and g.J is None
        assert g._Jh[0, 0] == -0.5
        assert g._Jv[0, 0] == 2.0
        assert g._Jh[0, 7] == 0.25

    def test_nonlocal_coupling_falls_back_dense(self):
        from tsu_tpu.models.ising import IsingGrid

        g = IsingGrid((4, 4), seed=0, use_pallas=False)
        g.set_coupling(0, 5, 0.3)  # diagonal: not a lattice neighbor
        assert not g._fast and g.J is not None

    def test_nonlocal_on_large_grid_rejected(self):
        from tsu_tpu.config import ConfigurationError
        from tsu_tpu.models.ising import IsingGrid

        g = IsingGrid((128, 128), seed=0, use_pallas=False)
        with pytest.raises(ConfigurationError):
            g.set_coupling(0, 130, 0.3)

    def test_bond_energy_matches_dense(self, rng):
        from tsu_tpu.models.ising import IsingGrid, IsingModel
        from tsu_tpu.ops.checkerboard_bonds import dense_from_bonds

        Jh = rng.normal(0, 1, (4, 4)).astype(np.float32)
        Jv = rng.normal(0, 1, (4, 4)).astype(np.float32)
        g = IsingGrid((4, 4), periodic=True, seed=0, use_pallas=False,
                      bonds=(Jh, Jv))
        dense = IsingModel(16, seed=0)
        dense.J = dense_from_bonds(Jh, Jv, periodic=True).astype(np.float32)
        for _ in range(5):
            s = np.where(rng.random(16) < 0.5, 1.0, -1.0)
            assert g.energy(s) == pytest.approx(dense.energy(s), abs=1e-3)

    def test_bond_moments_vs_enumeration(self, rng):
        from tsu_tpu.models.ising import IsingGrid
        from tsu_tpu.ops.checkerboard_bonds import dense_from_bonds
        from tsu_tpu.oracle import exact_ising_moments

        Jh = rng.normal(0, 0.8, (4, 4)).astype(np.float32)
        Jv = rng.normal(0, 0.8, (4, 4)).astype(np.float32)
        from tsu_tpu.config import IsingConfig

        g = IsingGrid((4, 4), periodic=True, seed=0, use_pallas=False,
                      bonds=(Jh, Jv),
                      config=IsingConfig(temperature=2.0, n_burnin=300,
                                         n_sweeps=2))
        samples = g.sample(n_samples=4000)
        ex = exact_ising_moments(dense_from_bonds(Jh, Jv, True),
                                 np.zeros(16), 2.0)
        m_hat = samples.mean(axis=0)
        se = np.sqrt(samples.var(axis=0) / (4000 / 5.0))  # conservative ESS
        assert np.max(np.abs(m_hat - ex["mean"]) / se) < 5.0

    def test_spin_glass_ground_state_beats_random(self, rng):
        from tsu_tpu.models.ising import IsingGrid

        Jh = rng.choice([-1.0, 1.0], (8, 8)).astype(np.float32)
        Jv = rng.choice([-1.0, 1.0], (8, 8)).astype(np.float32)
        g = IsingGrid((8, 8), periodic=True, seed=0, use_pallas=False,
                      bonds=(Jh, Jv))
        state, e = g.find_ground_state(n_steps=400)
        random_e = np.mean([
            g.energy(np.where(rng.random(64) < 0.5, 1.0, -1.0))
            for _ in range(20)
        ])
        assert e < random_e - 10.0

    def test_large_random_bond_lattice_runs(self, rng):
        """256^2 random-bond observables on the stencil engine — far above
        the old 4,096-spin dense cap (1024^2 runs the same code path on
        the card; CI keeps it small for time)."""
        from tsu_tpu.config import IsingConfig
        from tsu_tpu.models.ising import IsingGrid

        R = 256
        Jh = rng.choice([-1.0, 1.0], (R, R)).astype(np.float32)
        Jv = rng.choice([-1.0, 1.0], (R, R)).astype(np.float32)
        g = IsingGrid((R, R), periodic=True, seed=0, use_pallas=False,
                      bonds=(Jh, Jv),
                      config=IsingConfig(n_burnin=20, n_sweeps=1))
        out = g.sample_observables(n_samples=5, temperature=2.0)
        assert out["magnetization"].shape == (5,)
        assert np.all(np.isfinite(out["energy"]))
        # spin glass: no ferromagnetic order
        assert np.all(np.abs(out["magnetization"]) < 0.2)


class TestEnsembleSampler:
    """Batched multi-temperature ensemble (models/lattice_sampler.py:
    sample_grid_ensemble) — one program, per-member temperatures."""

    def test_observable_shapes_and_physics(self):
        from tsu_tpu.models.lattice_sampler import sample_grid_ensemble

        Ts = jnp.array([1.0, 2.269, 4.0], jnp.float32)
        out = sample_grid_ensemble(
            jax.random.key(0), jnp.ones((3, 8, 8)), Ts,
            n_samples=30, n_burnin=50, use_pallas=False,
        )
        m = np.asarray(out["magnetization"])
        e = np.asarray(out["energy"])
        assert m.shape == (30, 3) and e.shape == (30, 3)
        # Cold member stays ordered; hot member disorders.
        assert abs(m[:, 0].mean()) > 0.9
        assert abs(m[:, 2].mean()) < 0.4
        # Energy ordering follows temperature (colder = lower energy).
        assert e[:, 0].mean() < e[:, 2].mean()

    def test_members_are_decorrelated(self):
        from tsu_tpu.models.lattice_sampler import sample_grid_ensemble

        # Two members at the SAME temperature: magnetization traces must
        # differ (member-indexed PRNG streams).
        out = sample_grid_ensemble(
            jax.random.key(1), jnp.ones((2, 8, 8)),
            jnp.array([2.8, 2.8], jnp.float32),
            n_samples=40, n_burnin=30, use_pallas=False,
        )
        m = np.asarray(out["magnetization"])
        assert not np.allclose(m[:, 0], m[:, 1])

    def test_phase_driver_ensemble_matches_loop(self):
        """The ensemble phase-transition path and the per-T loop must agree
        statistically (same physics, different batching)."""
        from tsu_tpu.models.ising import demonstrate_phase_transition

        Ts = np.array([1.2, 3.6])
        a = demonstrate_phase_transition(sizes=[8], temperatures=Ts,
                                         n_samples=40, seed=0, ensemble=True)
        b = demonstrate_phase_transition(sizes=[8], temperatures=Ts,
                                         n_samples=40, seed=3, ensemble=False)
        for r in (a[8], b[8]):
            assert r["magnetization"][0] > 0.9
            assert r["magnetization"][1] < 0.45

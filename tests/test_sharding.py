"""Multi-device tests on the CPU-simulated 8-device mesh (SURVEY.md §4):
halo-exchange correctness, sharded moments, replica/chain axes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tsu_tpu.ops.checkerboard import (
    lattice_energy_batch,
    merge_checkerboard,
    split_checkerboard,
)
from tsu_tpu.oracle import exact_ising_moments, lattice_energy_np
from tsu_tpu.parallel import make_mesh, sharded_checkerboard_sweeps, sharded_lattice_sample


@pytest.fixture(autouse=True)
def _four_devices():
    if len(jax.devices()) < 4:
        pytest.skip("needs >=4 (virtual) devices")


class TestMesh:
    def test_make_mesh(self):
        mesh = make_mesh(rows=4)
        assert mesh.shape["row"] == 4

    def test_too_many_devices_rejected(self):
        with pytest.raises(ValueError):
            make_mesh(rows=1024)


class TestShardedSweeps:
    def test_spins_stay_binary_and_sharded(self):
        mesh = make_mesh(rows=4)
        lat = jnp.ones((16, 16))
        red, black = split_checkerboard(lat)
        red2, black2 = sharded_checkerboard_sweeps(
            mesh, jax.random.key(0), red, black, 2.0, 3, periodic=True
        )
        out = np.asarray(merge_checkerboard(red2, black2))
        assert set(np.unique(out)) <= {-1.0, 1.0}

    def test_moments_vs_exact_enumeration_4x4(self):
        """Sharded checkerboard on 4 devices (1 row-pair per shard!) must
        reproduce exact 4x4 moments — exercises every halo path."""
        R = C = 4
        T = 3.0
        n = R * C
        J = np.zeros((n, n))
        for r in range(R):
            for c in range(C):
                i = r * C + c
                for rr, cc in ((r, (c + 1) % C), ((r + 1) % R, c)):
                    j = rr * C + cc
                    J[i, j] += 1.0
                    J[j, i] += 1.0
        exact = exact_ising_moments(J, np.zeros(n), temperature=T)

        mesh = make_mesh(rows=2)  # 2 shards x 2 rows each
        out = sharded_lattice_sample(
            mesh, jax.random.key(5), jnp.ones((R, C)),
            n_samples=4000, temperature=T, n_burnin=200, n_sweeps=2,
            periodic=True,
        )
        m_abs = np.abs(np.asarray(out["magnetization"]))
        e = np.asarray(out["energy"])
        assert m_abs.mean() == pytest.approx(exact["abs_magnetization"], abs=0.04)
        assert e.mean() == pytest.approx(exact["energy"], abs=0.6)

    @pytest.mark.parametrize("periodic", [True, False])
    def test_sharded_matches_single_device_statistics(self, periodic):
        """Same lattice, same T: sharded and unsharded sampling must agree on
        <|M|> and <E> within MC error (they target the same distribution)."""
        from tsu_tpu.ops.checkerboard import sample_lattice

        T = 2.5
        shape = (16, 16)
        mesh = make_mesh(rows=4)
        out_sh = sharded_lattice_sample(
            mesh, jax.random.key(1), jnp.ones(shape), n_samples=600,
            temperature=T, n_burnin=150, n_sweeps=2, periodic=periodic,
        )
        out_1d = sample_lattice(
            jax.random.key(2), jnp.ones(shape), n_samples=600, temperature=T,
            n_burnin=150, n_sweeps=2, periodic=periodic, collect="observables",
        )
        m_sh = np.abs(np.asarray(out_sh["magnetization"])).mean()
        m_1d = np.abs(np.asarray(out_1d["magnetization"])).mean()
        e_sh = np.asarray(out_sh["energy"]).mean()
        e_1d = np.asarray(out_1d["energy"]).mean()
        assert m_sh == pytest.approx(m_1d, abs=0.08)
        assert e_sh == pytest.approx(e_1d, rel=0.1, abs=8.0)

    def test_low_temperature_orders_when_sharded(self):
        mesh = make_mesh(rows=4)
        out = sharded_lattice_sample(
            mesh, jax.random.key(3), jnp.ones((16, 16)), n_samples=50,
            temperature=0.8, n_burnin=100, n_sweeps=1, periodic=True,
        )
        assert np.abs(np.asarray(out["magnetization"])).mean() > 0.9


class TestSharded2D:
    """Row x column sharding: four-sided halo exchange (col_axis path)."""

    def test_moments_vs_exact_enumeration_4x4_2d_mesh(self):
        """2x2 spatial mesh on a 4x4 torus: each shard holds 2 rows x 1
        compact column — every site update needs at least one halo."""
        R = C = 4
        T = 3.0
        n = R * C
        J = np.zeros((n, n))
        for r in range(R):
            for c in range(C):
                i = r * C + c
                for rr, cc in ((r, (c + 1) % C), ((r + 1) % R, c)):
                    j = rr * C + cc
                    J[i, j] += 1.0
                    J[j, i] += 1.0
        exact = exact_ising_moments(J, np.zeros(n), temperature=T)

        mesh = make_mesh(rows=2, cols=2)
        out = sharded_lattice_sample(
            mesh, jax.random.key(7), jnp.ones((R, C)),
            n_samples=4000, temperature=T, n_burnin=200, n_sweeps=2,
            periodic=True, col_axis="col",
        )
        m_abs = np.abs(np.asarray(out["magnetization"]))
        e = np.asarray(out["energy"])
        assert m_abs.mean() == pytest.approx(exact["abs_magnetization"], abs=0.04)
        assert e.mean() == pytest.approx(exact["energy"], abs=0.6)

    @pytest.mark.parametrize("periodic", [True, False])
    def test_2d_sharded_matches_single_device_statistics(self, periodic):
        from tsu_tpu.ops.checkerboard import sample_lattice

        T = 2.5
        shape = (16, 16)
        mesh = make_mesh(rows=2, cols=4)
        out_sh = sharded_lattice_sample(
            mesh, jax.random.key(11), jnp.ones(shape), n_samples=600,
            temperature=T, n_burnin=150, n_sweeps=2, periodic=periodic,
            col_axis="col",
        )
        out_1d = sample_lattice(
            jax.random.key(2), jnp.ones(shape), n_samples=600, temperature=T,
            n_burnin=150, n_sweeps=2, periodic=periodic, collect="observables",
        )
        m_sh = np.abs(np.asarray(out_sh["magnetization"])).mean()
        m_1d = np.abs(np.asarray(out_1d["magnetization"])).mean()
        e_sh = np.asarray(out_sh["energy"]).mean()
        e_1d = np.asarray(out_1d["energy"]).mean()
        assert m_sh == pytest.approx(m_1d, abs=0.08)
        assert e_sh == pytest.approx(e_1d, rel=0.1, abs=8.0)

    def test_2d_sweeps_spins_stay_binary(self):
        mesh = make_mesh(rows=2, cols=2)
        red, black = split_checkerboard(jnp.ones((8, 8)))
        red2, black2 = sharded_checkerboard_sweeps(
            mesh, jax.random.key(0), red, black, 2.0, 3, periodic=True,
            col_axis="col",
        )
        out = np.asarray(merge_checkerboard(red2, black2))
        assert set(np.unique(out)) <= {-1.0, 1.0}


class TestGridShardedAPI:
    def test_sample_observables_with_mesh(self):
        from tsu_tpu import IsingConfig, IsingGrid

        mesh = make_mesh(rows=4)
        grid = IsingGrid((16, 16), periodic=True, seed=0, use_pallas=False,
                         config=IsingConfig(n_burnin=100, n_sweeps=1))
        out = grid.sample_observables(50, temperature=1.2, mesh=mesh)
        assert out["magnetization"].shape == (50,)
        assert np.abs(out["magnetization"]).mean() > 0.9

    def test_sample_observables_single_device(self):
        from tsu_tpu import IsingConfig, IsingGrid

        grid = IsingGrid((16, 16), periodic=True, seed=0, use_pallas=False,
                         config=IsingConfig(n_burnin=50, n_sweeps=1))
        out = grid.sample_observables(20, temperature=5.0)
        assert out["energy"].shape == (20,)


class TestChainsAxis:
    def test_sharded_chains_langevin(self):
        """Chains sharded over all 8 devices via jit auto-partitioning."""
        from jax.sharding import NamedSharding, PartitionSpec as P
        from tsu_tpu.energy import Quadratic
        from tsu_tpu.samplers.langevin import sample_langevin

        mesh = make_mesh(chains=len(jax.devices()))
        n_chains = 8 * 4
        x0 = jnp.zeros((n_chains, 2))
        x0 = jax.device_put(x0, NamedSharding(mesh, P("chains", None)))
        s = sample_langevin(
            jax.random.key(0), x0, energy_fn=Quadratic(0.0, 1.0),
            n_samples=300, dt=0.05, n_burnin=300, n_steps=10,
        )
        flat = np.asarray(s).reshape(-1, 2)
        assert np.all(np.abs(flat.mean(axis=0)) < 0.12)
        assert np.all(np.abs(flat.std(axis=0) - 1.0) < 0.12)


class TestShardedSMC:
    """Distributed systematic resampling (SURVEY §8.3 item 4 / r1 gap #5)."""

    def test_log_z_matches_single_device_and_analytic(self):
        from tsu_tpu.energy import Quadratic
        from tsu_tpu.parallel.smc_sharded import annealed_smc_sharded
        from tsu_tpu.samplers.smc import annealed_smc

        key = jax.random.key(3)
        particles = 3.0 * jax.random.normal(jax.random.fold_in(key, 0),
                                            (2048, 1))
        kwargs = dict(energy_fn=Quadratic(0.0, 1.0), n_steps=60, n_moves=3,
                      dt=0.1, base_sigma=3.0)
        single = annealed_smc(jax.random.fold_in(key, 1), particles, **kwargs)

        mesh = make_mesh(chains=8)
        sharded = annealed_smc_sharded(mesh, jax.random.fold_in(key, 1),
                                       particles, **kwargs)
        # Analytic: log(Z_target / Z_base) = log sqrt(2pi / (2pi*9)).
        expected = 0.5 * np.log(2 * np.pi) - 0.5 * np.log(2 * np.pi * 9.0)
        assert sharded["log_Z"] == pytest.approx(expected, abs=0.15)
        assert sharded["log_Z"] == pytest.approx(float(single["log_Z"]),
                                                 abs=0.2)
        # Resampling fired at least once and produced target-like particles.
        assert np.std(sharded["particles"]) == pytest.approx(1.0, abs=0.2)

    def test_multimodal_target_sharded(self):
        from tsu_tpu.energy import MixtureOfGaussians
        from tsu_tpu.parallel.smc_sharded import annealed_smc_sharded

        key = jax.random.key(1)
        energy = MixtureOfGaussians(((-3.0,), (3.0,)), (0.5, 0.5))
        particles = 3.0 * jax.random.normal(jax.random.fold_in(key, 0),
                                            (512, 1))
        mesh = make_mesh(chains=8)
        out = annealed_smc_sharded(mesh, jax.random.fold_in(key, 1),
                                   particles, energy_fn=energy, n_steps=40,
                                   n_moves=5, dt=0.05)
        x = out["particles"].ravel()
        assert 0.3 < np.mean(x < 0) < 0.7
        assert abs(np.mean(np.abs(x)) - 3.0) < 0.4


class TestPlanLatticeMesh:
    """Row-first topology planning: the GPU kernel takes row halos only, so
    a column split (which runs XLA) must never be chosen silently."""

    def test_prefers_row_only_when_fused_constraint_fits(self):
        from tsu_tpu.parallel import plan_lattice_mesh

        mesh = plan_lattice_mesh(8, (4096, 4096))
        assert mesh.shape["row"] == 8 and mesh.shape["col"] == 1

    def test_falls_back_to_columns_with_warning(self):
        from tsu_tpu.parallel import plan_lattice_mesh

        # 12 rows over 4 or 8 row shards would leave an odd row count per
        # shard: only rows=2 keeps the parity contract, so cols must pick
        # up 4 — and that downgrade must be loud.
        with pytest.warns(RuntimeWarning, match="XLA"):
            mesh = plan_lattice_mesh(8, (12, 1024))
        assert mesh.shape["row"] * mesh.shape["col"] == 8
        assert mesh.shape["col"] > 1

    def test_replica_chains_budget(self):
        from tsu_tpu.parallel import plan_lattice_mesh

        mesh = plan_lattice_mesh(8, (64, 64), replica=2, chains=2)
        assert mesh.shape["replica"] == 2 and mesh.shape["chains"] == 2
        assert mesh.shape["row"] == 2 and mesh.shape["col"] == 1
        with pytest.raises(ValueError):
            plan_lattice_mesh(8, (64, 64), replica=3)

    def test_streaming_fallback_warns_in_sweeps(self):
        from tsu_tpu.parallel import sharded_checkerboard_sweeps

        mesh = make_mesh(rows=2, cols=2, devices=jax.devices()[:4])
        lat = jnp.ones((16, 16), jnp.float32)
        red, black = split_checkerboard(lat)
        # An explicit kernel request on a column mesh raises instead of
        # silently running another path.
        with pytest.raises(ValueError, match="row sharding"):
            sharded_checkerboard_sweeps(
                mesh, jax.random.key(0), red, black, 2.0, 1,
                use_pallas=True, col_axis="col")


class TestShardedCheckpointResume:
    """SURVEY §5.4 integration (r5 verdict #3): the sharded sampling loop
    snapshots periodically, and a killed-and-resumed run is BIT-IDENTICAL
    to an uninterrupted one (global-sample-index seed schedule)."""

    def _run(self, key, lat0, mesh, **kw):
        return sharded_lattice_sample(
            mesh, key, lat0, n_samples=9, temperature=2.5, n_burnin=5,
            n_sweeps=1, use_pallas=False, **kw)

    def test_killed_and_resumed_matches_uninterrupted(self, tmp_path,
                                                      monkeypatch):
        mesh = make_mesh(rows=4, devices=jax.devices()[:4])
        key = jax.random.key(42)
        lat0 = jnp.where(
            jax.random.bernoulli(jax.random.fold_in(key, 9), 0.5, (16, 16)),
            1.0, -1.0)
        full = self._run(key, lat0, mesh)

        import tsu_tpu.checkpoint as ckpt_mod

        real_save = ckpt_mod.save_state
        calls = {"n": 0}

        def dying_save(path, state, step=None):
            out = real_save(path, state, step)
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("simulated preemption")
            return out

        monkeypatch.setattr(ckpt_mod, "save_state", dying_save)
        p = str(tmp_path / "ck")
        with pytest.raises(RuntimeError, match="preemption"):
            self._run(key, lat0, mesh, checkpoint_path=p, checkpoint_every=3)
        monkeypatch.setattr(ckpt_mod, "save_state", real_save)

        resumed = self._run(key, lat0, mesh, checkpoint_path=p,
                            checkpoint_every=3, resume=True)
        assert np.array_equal(np.asarray(full["magnetization"]),
                              np.asarray(resumed["magnetization"]))
        assert np.array_equal(np.asarray(full["energy"]),
                              np.asarray(resumed["energy"]))
        for a, b in zip(full["final_planes"], resumed["final_planes"]):
            assert np.array_equal(np.asarray(a), np.asarray(b))

    def test_chunked_without_kill_matches(self, tmp_path):
        mesh = make_mesh(rows=4, devices=jax.devices()[:4])
        key = jax.random.key(7)
        lat0 = jnp.ones((16, 16), jnp.float32)
        full = self._run(key, lat0, mesh)
        chunked = self._run(key, lat0, mesh,
                            checkpoint_path=str(tmp_path / "ck2"),
                            checkpoint_every=4)
        assert np.array_equal(np.asarray(full["magnetization"]),
                              np.asarray(chunked["magnetization"]))

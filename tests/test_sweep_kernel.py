"""The GPU sweep kernel (ops/checkerboard_triton.py) on the CPU, in Pallas
interpret mode, against independent references; its chooser
(ops/select.py); and what surrounds it (compile cache, imports, the
measurement scripts' refusal to run without a GPU)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tsu_tpu.ops import checkerboard_triton as ct
from tsu_tpu.ops.checkerboard import merge_checkerboard, split_checkerboard
from tsu_tpu.ops.checkerboard_bonds import color_bond_weights, pack_bond_codes
from tsu_tpu.oracle import heat_bath_threshold_halfstep_np
from tsu_tpu.ops.select import choose_sweep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY2 = jnp.array([20260821, -12345], jnp.int32)


def _spins(seed, shape):
    return np.random.default_rng(seed).choice(np.array([-1, 1], np.int8),
                                              shape)


def _pm_j(seed, R, C):
    rng = np.random.default_rng(seed)
    return (rng.choice(np.array([-1.0, 1.0], np.float32), (R, C)),
            rng.choice(np.array([-1.0, 1.0], np.float32), (R, C)))


# -- the generator ------------------------------------------------------------


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    """Philox-4x32-10 known-answer vectors (Random123's kat_vectors)."""
    as_i32 = lambda v: jnp.asarray(np.uint32(v).view(np.int32))
    out = ct.philox4x32(*map(as_i32, ctr), *map(as_i32, key))
    assert tuple(int(np.asarray(x).view(np.uint32)) for x in out) == want


def _philox_py(c, k):
    """Philox-4x32-10 on Python ints: a third, independent implementation."""
    M0, M1, W0, W1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85
    c, k = list(c), list(k)
    for rnd in range(10):
        if rnd:
            k = [(k[0] + W0) & 0xFFFFFFFF, (k[1] + W1) & 0xFFFFFFFF]
        p0, p1 = M0 * c[0], M1 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & 0xFFFFFFFF,
             (p0 >> 32) ^ c[3] ^ k[1], p0 & 0xFFFFFFFF]
    return c


def test_site_uniforms_match_python_philox():
    shape = (2, 4, 6)
    key = [int(np.int32(v).view(np.uint32)) for v in np.asarray(KEY2)]
    for red in (True, False):
        u = np.asarray(ct.site_uniforms(KEY2, 9, red, shape, row_offset=10,
                                        lattice_offset=5))
        for b, r, c in ((0, 0, 0), (1, 3, 5), (0, 2, 4), (1, 0, 3)):
            words = _philox_py([c, 10 + r, 9, 5 + b], key)
            assert u[b, r, c] == words[0 if red else 1] >> 8


@pytest.mark.parametrize("row_offset,lattice_offset", [(0, 0), (6, 2)])
def test_generator_kernel_matches_twin(row_offset, lattice_offset):
    """The kernel's own generator code writes exactly the twin's bits."""
    shape = (2, 6, 8)
    bits = ct.generator_uniforms(KEY2, 3, shape, row_offset=row_offset,
                                 lattice_offset=lattice_offset,
                                 interpret=True)
    for color in (0, 1):
        want = ct.site_uniforms(KEY2, 3, color == 0, shape,
                                row_offset=row_offset,
                                lattice_offset=lattice_offset)
        np.testing.assert_array_equal(np.asarray(bits[color]),
                                      np.asarray(want))


# -- one half-sweep against the NumPy oracle -----------------------------------


@pytest.mark.parametrize("contract", ["uniform", "pm_j"])
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("update_red", [True, False])
def test_halfsweep_matches_numpy_oracle(contract, periodic, update_red):
    """Kernel with injected uniforms == the site-by-site NumPy heat-bath
    threshold update on the full lattice (independent of the compact
    layout), for a batch of two lattices at two temperatures."""
    B, R, C = 2, 6, 8
    lat = _spins(1, (B, R, C))
    rng = np.random.default_rng(2)
    u24 = rng.integers(0, 1 << 24, (B, R, C // 2)).astype(np.int32)
    Ts = np.array([1.7, 3.1], np.float32)
    tables = np.asarray(ct.sigmoid_table(1.0, 0.0, Ts))
    Jh = Jv = codes = None
    if contract == "pm_j":
        Jh, Jv = _pm_j(3, R, C)
        codes = pack_bond_codes(color_bond_weights(Jh, Jv, 0.0, periodic))
        codes = codes["red" if update_red else "black"]
    red, black = split_checkerboard(jnp.asarray(lat))
    other = black if update_red else red
    up, down = ct.wrap_rows(other, periodic)
    new = ct.halfsweep(KEY2, 0, tables, other, up, down,
                       update_red=update_red, periodic=periodic, codes=codes,
                       u24=u24, interpret=True)
    got = np.asarray(merge_checkerboard(new, black) if update_red
                     else merge_checkerboard(red, new))
    # The uniform of compact (r, j) belongs to that color's site in row r.
    u_full = np.asarray(merge_checkerboard(jnp.asarray(u24), jnp.asarray(u24)))
    for b in range(B):
        want = heat_bath_threshold_halfstep_np(
            lat[b], u_full[b], tables[b], 0 if update_red else 1, periodic,
            Jh, Jv)
        np.testing.assert_array_equal(got[b], want)


# -- full sweeps with the kernel's generator ----------------------------------


@pytest.mark.parametrize("contract", ["uniform", "pm_j"])
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("B", [1, 2])
def test_sweeps_match_jnp_twin(contract, periodic, B):
    """Kernel sweeps (in-kernel Philox, per-lattice temperatures) equal the
    plain-jnp twin exactly."""
    R, C = 8, 16
    reds, blacks = split_checkerboard(jnp.asarray(_spins(4, (B, R, C))))
    codes = None
    if contract == "pm_j":
        codes = pack_bond_codes(color_bond_weights(*_pm_j(5, R, C), 0.0,
                                                   periodic))
    Ts = jnp.linspace(1.5, 3.0, B)
    got = ct.sweeps(KEY2, reds, blacks, Ts, 2, periodic=periodic,
                    codes=codes, sweep_offset=7, interpret=True)
    want = ct.sweeps_reference(KEY2, reds, blacks, Ts, 2, periodic=periodic,
                               codes=codes, sweep_offset=7)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# -- row sharding -------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("periodic", [True, False])
def test_row_sharded_kernel_matches_unsharded(kernel_interpret, n_shards,
                                              periodic):
    """The generator is keyed by global site, so the row-sharded kernel
    route gives the same spins as the unsharded kernel under one key."""
    from tsu_tpu.parallel import make_mesh, sharded_checkerboard_sweeps

    if len(jax.devices()) < n_shards:
        pytest.skip(f"needs {n_shards} (virtual) devices")
    R, C = 8, 8
    red, black = split_checkerboard(jnp.asarray(_spins(6, (R, C)),
                                                jnp.float32))
    mesh = make_mesh(rows=n_shards, devices=jax.devices()[:n_shards])
    key = jax.random.key(8)
    r_sh, b_sh = sharded_checkerboard_sweeps(mesh, key, red, black, 2.3, 2,
                                             periodic=periodic,
                                             use_pallas=True)
    r_1, b_1 = ct.sweeps(ct.key_words(key), red[None], black[None], 2.3, 2,
                         periodic=periodic, interpret=True)
    np.testing.assert_array_equal(np.asarray(r_sh), np.asarray(r_1[0]))
    np.testing.assert_array_equal(np.asarray(b_sh), np.asarray(b_1[0]))


@pytest.mark.parametrize("periodic", [True, False])
def test_row_sharded_injected_uniforms(kernel_interpret, periodic):
    """Kernel + halo exchange with injected uniforms == the unsharded
    kernel with the same uniforms."""
    from tsu_tpu.parallel import make_mesh, sharded_checkerboard_sweeps

    if len(jax.devices()) < 2:
        pytest.skip("needs 2 (virtual) devices")
    R, C, n = 8, 8, 2
    red, black = split_checkerboard(jnp.asarray(_spins(7, (R, C)),
                                                jnp.float32))
    U = np.random.default_rng(9).integers(0, 1 << 24, (n, 2, R, C // 2))
    mesh = make_mesh(rows=2, devices=jax.devices()[:2])
    r_sh, b_sh = sharded_checkerboard_sweeps(
        mesh, jax.random.key(0), red, black, 2.0, n, periodic=periodic,
        use_pallas=True, uniforms=U)
    r_1, b_1 = ct.sweeps(KEY2, red[None], black[None], 2.0, n,
                         periodic=periodic, interpret=True,
                         uniforms=jnp.asarray(U[:, :, None], jnp.int32))
    np.testing.assert_array_equal(np.asarray(r_sh), np.asarray(r_1[0]))
    np.testing.assert_array_equal(np.asarray(b_sh), np.asarray(b_1[0]))


# -- the chooser --------------------------------------------------------------


@pytest.mark.parametrize("platform,contract,shape,use_pallas,want", [
    ("gpu", "uniform", (4096, 4096), None, "triton"),
    ("gpu", "pm_j", (256, 256), None, "triton"),
    ("gpu", "bonds", (256, 256), None, "xla"),
    ("gpu", "uniform", (6, 10), None, "triton"),
    ("gpu", "uniform", (5, 10), None, "xla"),
    ("gpu", "uniform", (64, 64), False, "xla"),
    ("gpu", "pm_j", (64, 64), True, "triton"),
    ("cpu", "uniform", (64, 64), None, "xla"),
    ("cpu", "pm_j", (64, 64), False, "xla"),
    ("rocm", "uniform", (64, 64), None, "xla"),
])
def test_choose_sweep(platform, contract, shape, use_pallas, want):
    assert choose_sweep(shape, contract, use_pallas=use_pallas,
                        platform=platform) == want


@pytest.mark.parametrize("platform,contract,shape", [
    ("cpu", "uniform", (64, 64)),
    ("gpu", "bonds", (64, 64)),
    ("gpu", "uniform", (5, 10)),
])
def test_choose_sweep_explicit_kernel_raises(platform, contract, shape):
    with pytest.raises(ValueError, match="use_pallas=True"):
        choose_sweep(shape, contract, use_pallas=True, platform=platform)


def test_choose_sweep_rejects_unknown_contract():
    with pytest.raises(ValueError, match="contract"):
        choose_sweep((8, 8), "dense")


@pytest.mark.parametrize("entry", ["grid", "ensemble", "tempering",
                                   "spin_glass"])
def test_explicit_kernel_raises_on_cpu(entry):
    """use_pallas=True on a machine without the GPU kernel raises; it never
    falls back to interpret mode or XLA."""
    with pytest.raises(ValueError, match="use_pallas=True"):
        if entry == "grid":
            from tsu_tpu import IsingGrid

            IsingGrid((8, 8), seed=0, use_pallas=True).sample(2)
        elif entry == "ensemble":
            from tsu_tpu.models.lattice_sampler import sample_grid_ensemble

            sample_grid_ensemble(jax.random.key(0), jnp.ones((2, 8, 8)),
                                 jnp.array([1.0, 2.0]), n_samples=1,
                                 use_pallas=True)
        elif entry == "tempering":
            from tsu_tpu.samplers.tempering import parallel_tempering_lattice

            parallel_tempering_lattice(jax.random.key(0), (8, 8),
                                       temperatures=[1.0, 2.0], n_samples=1,
                                       use_pallas=True)
        else:
            from tsu_tpu.samplers.annealing import anneal_spin_glass

            anneal_spin_glass(jax.random.key(0), *_pm_j(0, 8, 8),
                              n_steps=2, use_pallas=True)


@pytest.mark.parametrize("R,C2,want", [
    (4096, 2048, (8, 256)), (6, 10, (2, 2)), (16384, 8192, (8, 256)),
    (8, 4, (8, 4))])
def test_pick_block_tiles_the_plane(R, C2, want):
    BR, BC = ct.pick_block(R, C2)
    assert (BR, BC) == want
    assert R % BR == 0 and C2 % BC == 0


def test_bond_codes_roundtrip():
    Jh, Jv = _pm_j(11, 6, 8)
    Jh[0, 0] = 0.0  # a missing bond is part of the +-J contract
    weights = color_bond_weights(Jh, Jv, 0.0, periodic=False)
    codes = pack_bond_codes(weights)
    for color in ("red", "black"):
        assert codes[color].dtype == jnp.uint8
        for w, d in zip(weights[color][:4], ct.decode_codes(codes[color])):
            np.testing.assert_array_equal(np.asarray(w), np.asarray(d))


def test_sigmoid_table_thresholds():
    t = np.asarray(ct.sigmoid_table(1.0, 0.0, jnp.array([2.0, 1e-3])))
    assert t.shape == (2, 9)
    assert np.all(np.diff(t[0]) > 0) and t[0, 4] == 1 << 23
    assert t[1, 0] == 0 and t[1, 8] == (1 << 24) - 1


# -- entry points on the kernel route (interpret mode) ------------------------


def test_ising_grid_kernel_route(kernel_interpret):
    from tsu_tpu import IsingConfig, IsingGrid

    grid = IsingGrid((8, 8), periodic=True, seed=0,
                     config=IsingConfig(n_burnin=20, n_sweeps=1))
    s = grid.sample(10, initial_state=np.ones(64), temperature=1.2)
    assert grid.last_route == "triton"
    assert set(np.unique(s)) <= {-1.0, 1.0}
    assert np.abs(s.mean(axis=1)).mean() > 0.9


def test_ensemble_kernel_route_orders_by_temperature(kernel_interpret):
    from tsu_tpu.models.lattice_sampler import sample_grid_ensemble

    out = sample_grid_ensemble(jax.random.key(1), jnp.ones((2, 8, 8)),
                               jnp.array([1.0, 6.0]), n_samples=6,
                               n_burnin=20)
    m = np.abs(np.asarray(out["magnetization"])).mean(axis=0)
    assert m[0] > 0.9 and m[1] < m[0]


def test_spin_glass_tempering_kernel_route(kernel_interpret):
    from tsu_tpu.samplers.tempering import parallel_tempering_bonds

    cold, info = parallel_tempering_bonds(
        jax.random.key(2), *_pm_j(12, 8, 8), temperatures=[0.8, 1.6, 3.0],
        n_samples=4, n_burnin=4, swap_interval=1)
    assert info["discrete_table_path"]
    assert cold.shape == (4, 8, 8)
    assert set(np.unique(np.asarray(cold))) <= {-1.0, 1.0}


def test_anneal_lattice_kernel_route(kernel_interpret):
    from tsu_tpu.oracle import lattice_energy_np
    from tsu_tpu.samplers.annealing import anneal_lattice

    best, e = anneal_lattice(jax.random.key(3), (8, 8), n_steps=25,
                             n_chains=2, track_every=10)
    assert e == lattice_energy_np(np.asarray(best))
    assert e / 64 < -1.0


# -- around the kernel ---------------------------------------------------------


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    from tsu_tpu import profiling

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert profiling.enable_compilation_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    from tsu_tpu import profiling

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = profiling.compilation_cache_dir()
    assert path == os.path.join(REPO, ".jax_cache")
    assert path == profiling.compilation_cache_dir()
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_import_without_plotting_libraries():
    code = (
        "import importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in ('matplotlib', 'plotly'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import tsu_tpu\n"
        "assert callable(tsu_tpu.GibbsSampler)\n"
        "print('ok')\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_refuses_cpu(capsys):
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    assert chip_smoke.main([]) != 0
    captured = capsys.readouterr()
    assert '"ok"' not in captured.out
    assert "no GPU" in captured.err


def test_bench_requires_gpu():
    from tsu_tpu.benchmarks.device import require_gpu

    with pytest.raises(RuntimeError, match="no GPU"):
        require_gpu()


@pytest.mark.gpu
def test_kernel_statistics_on_card(gpu):
    """On the card: the compiled kernel (not interpret mode) samples the
    2-D Ising model at T=2.0 at Onsager's energy and magnetization."""
    from tsu_tpu import IsingConfig, IsingGrid
    from tsu_tpu.oracle import onsager_energy, onsager_magnetization

    L = 1024
    grid = IsingGrid((L, L), periodic=True, seed=1,
                     config=IsingConfig(n_burnin=200, n_sweeps=5))
    s = grid.sample(20, initial_state=np.ones(L * L), temperature=2.0)
    assert grid.last_route == "triton"
    m = np.abs(s.mean(axis=1)).mean()
    lat = s.reshape(-1, L, L)
    e = -(lat * np.roll(lat, -1, 1) + lat * np.roll(lat, -1, 2)).sum(
        axis=(1, 2)).mean() / (L * L)
    assert abs(m - onsager_magnetization(2.0)) < 3e-3
    assert abs(e - onsager_energy(2.0)) < 3e-3

"""Smoke test of the sampling engine on NVIDIA GPUs, through its entry points.

    python chip_smoke.py               # one card: phases 1-6 below
    python chip_smoke.py --four-cards  # four cards: the sharded paths only

One process drives the engine's five deployments (BASELINE.json configs) at
their real sizes and compares each with a plain reference:

1. kernel_exact — every GPU sweep kernel at 4096^2, periodic and open,
   uniform and +-J: with injected uniforms it equals the XLA twin, with its
   own Philox generator it equals the jnp twin, and the generator's bits
   equal the twin's. Tolerance 0 (spins are +-1, thresholds integers).
2. ising_onsager — IsingGrid.sample at 4096^2, T=2.0, ordered start:
   |m| and e/site against Onsager within 5 batch-means standard errors.
3. spin_glass_anneal — anneal_spin_glass on a 4096^2 +-J glass, 2000
   sweeps, 3 seeds, on the kernel and on the XLA bond engine: reported
   energies equal the NumPy energy of the returned state exactly; the two
   routes' mean e/site agree within 5 standard errors of the seed spread.
4. tempering — parallel_tempering_lattice with 32 rungs of 4096^2, and PT +
   Houdayer on a 256^2 +-J glass (the spin_glass_ea suite row, shortened).
5. bnn_and_dense_gibbs — BayesianRegressor 1->[50,50]->1 on the sinusoid
   task against the same seed on the CPU; the dense 20-spin random-J
   GibbsSampler against exact enumeration.
6. timing — flips/s of kernel and XLA at 4096^2 and 16384^2, uniform and
   +-J, as bare sweeps and end to end (IsingGrid.sample, anneal_spin_glass).

Any failed check raises, so the exit code is non-zero unless every phase
passed. Without a GPU it exits at once. The last line of standard output is
one JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


class CheckFailed(RuntimeError):
    pass


def check(ok, what: str):
    if not ok:
        raise CheckFailed(what)


def report(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}, default=float), flush=True)


def batch_se(x, n_batches: int = 5) -> float:
    """Standard error of the mean of a correlated series by batch means."""
    x = np.asarray(x, np.float64)
    b = len(x) // n_batches
    means = x[: b * n_batches].reshape(n_batches, b).mean(axis=1)
    return float(means.std(ddof=1) / np.sqrt(n_batches))


class Sizes:
    """Problem sizes of each phase (the deployments' real sizes)."""

    lattice = 4096
    big = 16384
    ising_burnin, ising_samples, ising_thin = 200, 25, 5
    anneal_sweeps, anneal_seeds = 2000, 3
    pt_rungs, pt_burnin, pt_samples, pt_thin = 32, 40, 41, 10
    glass = 256
    glass_iters = 1000
    bnn_epochs = 200
    gibbs_samples = 8000
    timing_sweeps = 100
    e2e_burnin = 300
    shard_lattice = 16384
    shard_samples = 10


# -- phase 1 ------------------------------------------------------------------


def phase_kernel_exact(sz: Sizes, interpret: bool = False):
    import jax
    import jax.numpy as jnp

    from tsu_tpu.ops import checkerboard_triton as ct
    from tsu_tpu.ops.checkerboard_bonds import (
        color_bond_weights,
        pack_bond_codes,
    )

    L = sz.lattice
    key = jax.random.key(11)
    key2 = ct.key_words(key)
    rows = []
    for contract in ("uniform", "pm_j"):
        for periodic in (True, False):
            t0 = time.perf_counter()
            k = jax.random.fold_in(key, len(rows))
            reds, blacks = (
                jnp.where(jax.random.bernoulli(jax.random.fold_in(k, i), 0.5,
                                              (2, L, L // 2)), 1, -1
                          ).astype(jnp.int8) for i in (0, 1))
            codes = None
            if contract == "pm_j":
                Jh, Jv = (jnp.where(jax.random.bernoulli(
                    jax.random.fold_in(k, i), 0.5, (L, L)), 1.0, -1.0)
                    for i in (2, 3))
                codes = pack_bond_codes(color_bond_weights(Jh, Jv, 0.0,
                                                           periodic))
            Ts = jnp.array([2.0, 2.6])
            tables = ct.sigmoid_table(1.0, 0.0, Ts)
            up, down = ct.wrap_rows(blacks, periodic)
            u24 = jax.random.randint(jax.random.fold_in(k, 4), reds.shape, 0,
                                     1 << 24, jnp.int32)
            red_codes = None if codes is None else codes["red"]
            got = ct.halfsweep(key2, 0, tables, blacks, up, down,
                               update_red=True, periodic=periodic,
                               codes=red_codes, u24=u24, interpret=interpret)
            want = ct.halfsweep_reference(tables, blacks, up, down, u24,
                                          update_red=True, periodic=periodic,
                                          codes=red_codes)
            injected_diff = int(jnp.sum(got != want))
            got = ct.sweeps(key2, reds, blacks, Ts, 2, periodic=periodic,
                            codes=codes, interpret=interpret)
            want = jax.jit(lambda r, b: ct.sweeps_reference(
                key2, r, b, Ts, 2, periodic=periodic, codes=codes))(reds,
                                                                    blacks)
            philox_diff = sum(int(jnp.sum(a != b)) for a, b in zip(got, want))
            row = {"contract": contract, "periodic": periodic,
                   "injected_mismatches": injected_diff,
                   "philox_mismatches": philox_diff, "tolerance": 0,
                   "reference": "XLA twin (injected) / jnp Philox twin",
                   "wall_s": time.perf_counter() - t0}
            rows.append(row)
            report("kernel_exact", **row)
            check(injected_diff == 0 and philox_diff == 0,
                  f"kernel differs from its twin: {row}")
    t0 = time.perf_counter()
    shape = (2, L, L // 2)
    bits = ct.generator_uniforms(key2, 5, shape, row_offset=L,
                                 lattice_offset=3, interpret=interpret)
    bit_diff = sum(
        int(jnp.sum(bits[c] != ct.site_uniforms(
            key2, 5, c == 0, shape, row_offset=L, lattice_offset=3)))
        for c in (0, 1))
    report("kernel_exact", generator_bit_mismatches=bit_diff, tolerance=0,
           reference="jnp Philox-4x32-10 twin",
           wall_s=time.perf_counter() - t0)
    check(bit_diff == 0, "in-kernel generator differs from its twin")


# -- phase 2 ------------------------------------------------------------------


def phase_ising_onsager(sz: Sizes):
    from tsu_tpu import IsingConfig, IsingGrid
    from tsu_tpu.oracle import (
        lattice_energy_np,
        onsager_energy,
        onsager_magnetization,
    )

    L, T = sz.lattice, 2.0
    grid = IsingGrid((L, L), periodic=True, seed=3,
                     config=IsingConfig(n_burnin=sz.ising_burnin,
                                        n_sweeps=sz.ising_thin))
    t0 = time.perf_counter()
    states = grid.sample(sz.ising_samples, initial_state=np.ones(L * L),
                         temperature=T)
    wall = time.perf_counter() - t0
    states = states.reshape(-1, L, L)
    m = np.abs(states.mean(axis=(1, 2), dtype=np.float64))
    e = np.array([lattice_energy_np(s) for s in states]) / (L * L)
    out = {}
    for name, x, ref in (("abs_m", m, onsager_magnetization(T)),
                         ("e_per_site", e, onsager_energy(T))):
        se = batch_se(x)
        out[name] = {"value": float(x.mean()), "reference": ref,
                     "tolerance": 5 * se, "batch_se": se}
    report("ising_onsager", L=L, T=T, route=grid.last_route, wall_s=wall,
           reference="Onsager (oracle.numpy_ref)", **out)
    check(grid.last_route == "triton", f"route {grid.last_route}")
    for name, o in out.items():
        check(abs(o["value"] - o["reference"]) <= o["tolerance"],
              f"{name} off Onsager: {o}")
    return out


# -- phase 3 ------------------------------------------------------------------


def pm_j_bonds(L: int, seed: int):
    rng = np.random.default_rng(seed)
    return (rng.choice(np.array([-1.0, 1.0], np.float32), (L, L))
            for _ in range(2))


def phase_spin_glass_anneal(sz: Sizes):
    import jax

    from tsu_tpu.oracle import lattice_energy_bonds_np
    from tsu_tpu.ops.select import choose_sweep
    from tsu_tpu.samplers.annealing import anneal_spin_glass

    L = sz.lattice
    Jh, Jv = pm_j_bonds(L, 7)
    dens = {}
    for use_pallas in (None, False):
        route = choose_sweep((L, L), "pm_j", use_pallas=use_pallas)
        es = []
        for seed in range(sz.anneal_seeds):
            t0 = time.perf_counter()
            state, e = anneal_spin_glass(jax.random.key(100 + seed), Jh, Jv,
                                         n_steps=sz.anneal_sweeps,
                                         use_pallas=use_pallas)
            wall = time.perf_counter() - t0
            e_ref = lattice_energy_bonds_np(state, Jh, Jv)
            report("spin_glass_anneal", route=route, seed=seed, energy=e,
                   reference_energy=e_ref, tolerance=0, wall_s=wall,
                   reference="NumPy energy of the returned state")
            check(e == e_ref, f"reported {e} != recomputed {e_ref}")
            es.append(e / (L * L))
        dens[route] = np.array(es)
    a, b = dens["triton"], dens["xla"]
    se = float(np.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b)))
    report("spin_glass_anneal", kernel_e_per_site=a.mean(),
           xla_e_per_site=b.mean(), tolerance=5 * se, seed_se=se,
           reference="XLA bond engine, same bonds, other seeds")
    check(abs(a.mean() - b.mean()) <= 5 * se, "routes disagree")


# -- phase 4 ------------------------------------------------------------------


def phase_tempering(sz: Sizes, onsager_T: float = 2.5):
    import jax

    from tsu_tpu.oracle import lattice_energy_bonds_np, lattice_energy_np
    from tsu_tpu.oracle import onsager_energy
    from tsu_tpu.samplers.tempering import parallel_tempering_lattice
    from tsu_tpu.samplers.tempering_ladder import (
        build_tempering_ladder,
        pt_ground_state_search,
    )

    # Uniform ladder above T_c, where a random start equilibrates within the
    # burn-in; rungs ~6e-4 apart in T give healthy swaps at 4096^2.
    L = sz.lattice
    temps = np.geomspace(onsager_T, onsager_T * 1.01, sz.pt_rungs)
    swap_interval = 2
    total = sz.pt_burnin + sz.pt_samples
    t0 = time.perf_counter()
    _, info = parallel_tempering_lattice(
        jax.random.key(5), (L, L), temperatures=temps,
        n_samples=sz.pt_samples, n_burnin=sz.pt_burnin,
        n_sweeps=sz.pt_thin, swap_interval=swap_interval)
    wall = time.perf_counter() - t0
    e_cold = np.asarray(info["energies"])[sz.pt_burnin:, 0] / (L * L)
    se = batch_se(e_cold)
    # The last iteration swaps only when total is a multiple of the swap
    # interval; otherwise its energies belong to the final states' slots.
    finals = np.asarray(info["final_states"])
    e_last = np.asarray(info["energies"])[-1]
    recomputed = np.array([lattice_energy_np(s) for s in finals[[0, -1]]])
    f32_ulp = 2.0 ** -23 * np.abs(recomputed)
    rate = info["swap_acceptance_rate"]
    report("tempering_lattice", rungs=len(temps), L=L, wall_s=wall,
           swap_acceptance=rate, acceptance_range=[0.05, 0.95],
           cold_e_per_site=e_cold.mean(), reference=onsager_energy(temps[0]),
           tolerance=5 * se, energy_recomputed=recomputed.tolist(),
           energy_reported=e_last[[0, -1]].tolist(),
           energy_tolerance="1 float32 ulp (device sums in float32)")
    check(total % swap_interval != 0, "last iteration must not swap")
    check(0.05 <= rate <= 0.95, f"swap acceptance {rate}")
    check(abs(e_cold.mean() - onsager_energy(temps[0])) <= 5 * se,
          "cold rung off Onsager")
    check(np.all(np.abs(recomputed - e_last[[0, -1]]) <= f32_ulp),
          "PT energies differ from the recomputed ones")

    # PT + Houdayer on the spin_glass_ea row's 256^2 glass, shortened.
    n = sz.glass
    key = jax.random.key(7)
    Jh, Jv = pm_j_bonds(n, 8)
    t0 = time.perf_counter()
    ladder, linfo = build_tempering_ladder(
        jax.random.fold_in(key, 2), Jh, Jv, T_min=0.3, T_max=2.0,
        target_acceptance=0.3, accept_floor=0.2, feedback_iters=128,
        feedback_burnin=32)
    out = pt_ground_state_search(
        jax.random.fold_in(key, 3), Jh, Jv, temperatures=ladder,
        n_iters=sz.glass_iters, n_sweeps=1, n_copies=2, houdayer_every=10,
        quench_sweeps=64, chunk_iters=sz.glass_iters)
    wall = time.perf_counter() - t0
    e_ref = lattice_energy_bonds_np(out["best_state"], Jh, Jv)
    rate = out["swap_acceptance_rate"]
    report("pt_houdayer", L=n, rungs=out["n_rungs"], wall_s=wall,
           swap_acceptance=rate, acceptance_range=[0.1, 0.9],
           min_pair_acceptance=float(out["pair_acceptance"].min()),
           best_energy=out["best_energy"], reference_energy=e_ref,
           tolerance=0, e_per_site=out["energy_per_site"],
           kernel_route=out["discrete_table_path"],
           reference="NumPy energy of the best state")
    check(out["discrete_table_path"], "PT + Houdayer did not run the kernel")
    check(0.1 <= rate <= 0.9, f"swap acceptance {rate}")
    check(out["best_energy"] == e_ref, "best energy != recomputed")
    check(out["energy_per_site"] < -1.3, "ground-state search did not descend")


# -- phase 5 ------------------------------------------------------------------


def _bnn_fit(sz: Sizes):
    from tsu_tpu.benchmarks.ml import MLBenchmark
    from tsu_tpu.models.ml import BayesianRegressor

    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (100, 1)).astype(np.float32)
    y = (np.sin(3 * x) + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
    x_test = np.linspace(-1, 1, 200)[:, None].astype(np.float32)
    y_test = (np.sin(3 * x_test)
              + 0.1 * rng.normal(size=x_test.shape)).astype(np.float32)
    reg = BayesianRegressor(1, [50, 50], seed=0)
    reg.fit(x, y, n_epochs=sz.bnn_epochs, batch_size=100,
            learning_rate=0.01, kl_weight=0.1)
    return MLBenchmark(seed=0)._evaluate("sinusoid", reg, x_test, y_test, 0.0)


def phase_bnn_and_dense_gibbs(sz: Sizes):
    import jax

    from tsu_tpu import GibbsConfig, GibbsSampler
    from tsu_tpu.oracle import exact_boltzmann_moments

    t0 = time.perf_counter()
    gpu = _bnn_fit(sz)
    wall = time.perf_counter() - t0
    with jax.default_device(jax.devices("cpu")[0]), \
            jax.default_matmul_precision("highest"):
        cpu = _bnn_fit(sz)
    tol_mse = 0.5 * cpu.mse + 2e-3
    report("bnn", gpu_mse=gpu.mse, cpu_mse=cpu.mse, mse_tolerance=tol_mse,
           gpu_coverage_95=gpu.coverage_95, cpu_coverage_95=cpu.coverage_95,
           coverage_tolerance=0.1, wall_s=wall,
           reference="same seed on the CPU at highest matmul precision",
           tolerance_reason="float32 matmuls run in TF32 on the card, which "
           "moves the 200-epoch optimisation path")
    check(abs(gpu.mse - cpu.mse) <= tol_mse, "BNN MSE differs from the CPU")
    check(abs(gpu.coverage_95 - cpu.coverage_95) <= 0.1,
          "BNN coverage differs from the CPU")

    rng = np.random.default_rng(20)
    n = 20
    J = rng.normal(0, 0.3, (n, n))
    J = (J + J.T) / 2
    np.fill_diagonal(J, 0.0)
    h = rng.normal(0, 0.3, n)
    sampler = GibbsSampler(GibbsConfig(n_burnin=200, n_sweeps=3, n_chains=32,
                                       update_order="checkerboard"), seed=4)
    t0 = time.perf_counter()
    s = sampler.sample_boltzmann(J, bias=h, n_samples=sz.gibbs_samples)
    wall = time.perf_counter() - t0
    exact = exact_boltzmann_moments(J, h, temperature=1.0)["mean"]
    err = float(np.abs(s.mean(axis=0) - exact).max())
    report("dense_gibbs_20", route=sampler.last_route,
           platform=jax.default_backend(), max_mean_error=err,
           tolerance=0.05, wall_s=wall,
           reference="exact enumeration (oracle.exact_boltzmann_moments)",
           tolerance_reason="MC error of 8000 correlated samples; TF32 "
           "local fields")
    check(sampler.last_route == "xla" and jax.default_backend() == "gpu",
          f"dense Gibbs ran on {sampler.last_route}")
    check(err <= 0.05, "dense Gibbs marginals off exact enumeration")


# -- phase 6 ------------------------------------------------------------------


def phase_timing(sz: Sizes, card: str):
    import jax

    from tsu_tpu import IsingConfig, IsingGrid
    from tsu_tpu.benchmarks.device import sweep_program, timed
    from tsu_tpu.samplers.annealing import anneal_spin_glass

    rows = []
    for L in (sz.lattice, sz.big):
        for contract in ("uniform", "pm_j"):
            for route in ("triton", "xla"):
                fn, args = sweep_program(route, contract, L, sz.timing_sweeps)
                t = timed(fn, *args, reps=3)
                rows.append(dict(kind="bare_sweep", L=L, contract=contract,
                                 route=route, compile_s=t["first_call_s"],
                                 median_s=t["median_s"],
                                 flips_per_s=L * L * sz.timing_sweeps
                                 / t["median_s"], card=card))
                report("timing", **rows[-1])
                del fn, args
        # End to end through the entry points: one warm-up call compiles.
        for route, use_pallas in (("triton", None), ("xla", False)):
            grid = IsingGrid((L, L), periodic=True, seed=1,
                             use_pallas=use_pallas,
                             config=IsingConfig(n_burnin=sz.e2e_burnin,
                                                n_sweeps=1))
            ones = np.ones(L * L, np.float32)
            grid.sample(1, initial_state=ones, temperature=2.269)
            t0 = time.perf_counter()
            grid.sample(1, initial_state=ones, temperature=2.269)
            wall = time.perf_counter() - t0
            rows.append(dict(kind="IsingGrid.sample", L=L, route=route,
                             sweeps=sz.e2e_burnin + 1, wall_s=wall,
                             flips_per_s=L * L * (sz.e2e_burnin + 1) / wall,
                             card=card))
            report("timing", **rows[-1])
            check(grid.last_route == route, "IsingGrid took another route")
            Jh, Jv = pm_j_bonds(L, 9)
            anneal_spin_glass(jax.random.key(0), Jh, Jv,
                              n_steps=sz.anneal_sweeps, use_pallas=use_pallas)
            t0 = time.perf_counter()
            anneal_spin_glass(jax.random.key(1), Jh, Jv,
                              n_steps=sz.anneal_sweeps, use_pallas=use_pallas)
            wall = time.perf_counter() - t0
            rows.append(dict(kind="anneal_spin_glass", L=L, route=route,
                             sweeps=sz.anneal_sweeps, wall_s=wall,
                             flips_per_s=L * L * sz.anneal_sweeps / wall,
                             card=card))
            report("timing", **rows[-1])
    return rows


# -- four cards ---------------------------------------------------------------


def phase_sharded_lattice(sz: Sizes):
    import jax
    import jax.numpy as jnp

    from tsu_tpu.parallel import make_mesh, sharded_lattice_sample

    L = sz.shard_lattice
    lat0 = jnp.where(jax.random.bernoulli(jax.random.key(2), 0.5, (L, L)),
                     1.0, -1.0)
    outs = {}
    for n in (4, 1):
        mesh = make_mesh(rows=n, devices=jax.devices()[:n])
        t0 = time.perf_counter()
        out = sharded_lattice_sample(
            mesh, jax.random.key(4), lat0, n_samples=sz.shard_samples,
            temperature=2.269, n_burnin=50, n_sweeps=2, periodic=True)
        jax.block_until_ready(out)
        outs[n] = out
        placed = {str(s.device)
                  for s in out["final_planes"][0].addressable_shards}
        report("sharded_lattice", devices=n, L=L, shard_devices=sorted(placed),
               wall_s=time.perf_counter() - t0)
        check(len(placed) == n, f"{n} shards sit on {len(placed)} devices")
    same = all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(
        outs[4]["final_planes"], outs[1]["final_planes"]))
    e4, e1 = (np.asarray(outs[n]["energy"], np.float64) for n in (4, 1))
    rel = float(np.max(np.abs(e4 - e1) / np.abs(e1)))
    report("sharded_lattice", identical_spins=same, spin_tolerance=0,
           energy_max_rel_diff=rel, energy_tolerance=1e-5,
           energy_tolerance_reason="float32 sums in another order: psum of 4 "
           "shard partials vs one tree over 2.7e8 sites (~log2(N) ulps)",
           reference="the same key on one card (generator keyed by global "
           "site)")
    check(same, "4-card lattice spins differ from the 1-card ones")
    check(rel <= 1e-5, "4-card energies differ beyond float32 rounding")


def phase_replica_sharded_pt(sz: Sizes):
    import jax

    from tsu_tpu.parallel import make_mesh
    from tsu_tpu.parallel.tempering_sharded import (
        parallel_tempering_replica_sharded,
    )
    from tsu_tpu.samplers.tempering import parallel_tempering_lattice

    L = sz.lattice
    temps = np.geomspace(2.5, 2.5 * 1.01, sz.pt_rungs)
    mesh = make_mesh(replica=4, devices=jax.devices()[:4])
    t0 = time.perf_counter()
    out = parallel_tempering_replica_sharded(
        mesh, jax.random.key(6), (L, L), temps, n_samples=sz.pt_samples,
        n_burnin=sz.pt_burnin, n_sweeps=sz.pt_thin, swap_interval=2)
    wall4 = time.perf_counter() - t0
    e4 = np.asarray(out["cold_energy"]) / (L * L)
    t0 = time.perf_counter()
    _, info = parallel_tempering_lattice(
        jax.random.key(5), (L, L), temperatures=temps,
        n_samples=sz.pt_samples, n_burnin=sz.pt_burnin, n_sweeps=sz.pt_thin,
        swap_interval=2)
    wall1 = time.perf_counter() - t0
    e1 = np.asarray(info["energies"])[sz.pt_burnin:, 0] / (L * L)
    se = float(np.hypot(batch_se(e4), batch_se(e1)))
    report("replica_sharded_pt", rungs=len(temps), L=L,
           cold_e_per_site_4cards=e4.mean(), cold_e_per_site_1card=e1.mean(),
           tolerance=5 * se, swap_acceptance_4cards=out[
               "swap_acceptance_rate"], wall_s_4cards=wall4,
           wall_s_1card=wall1, reference="single-card ladder, other seed")
    check(abs(e4.mean() - e1.mean()) <= 5 * se,
          "replica-sharded ladder disagrees with the single-card one")


# -----------------------------------------------------------------------------


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the sharded paths, on four cards")
    args = parser.parse_args(argv)

    from tsu_tpu.profiling import enable_compilation_cache

    cache = enable_compilation_cache()
    import jax

    from tsu_tpu.benchmarks.device import card_name_and_power, require_gpu

    n_cards = 4 if args.four_cards else 1
    try:
        device = require_gpu(n_cards)
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    card = card_name_and_power()
    print(f"devices: {jax.devices()[0].platform} {device['kind']} "
          f"x{len(jax.devices())}", flush=True)
    print(f"card: {card}", flush=True)
    print(f"compile cache: {cache}", flush=True)

    sz = Sizes()
    if args.four_cards:
        phases = [("sharded_lattice", lambda: phase_sharded_lattice(sz)),
                  ("replica_sharded_pt", lambda: phase_replica_sharded_pt(sz))]
    else:
        phases = [("kernel_exact", lambda: phase_kernel_exact(sz)),
                  ("ising_onsager", lambda: phase_ising_onsager(sz)),
                  ("spin_glass_anneal", lambda: phase_spin_glass_anneal(sz)),
                  ("tempering", lambda: phase_tempering(sz)),
                  ("bnn_and_dense_gibbs",
                   lambda: phase_bnn_and_dense_gibbs(sz)),
                  ("timing", lambda: phase_timing(sz, card))]
    for name, run in phases:
        t0 = time.perf_counter()
        run()
        report(name, passed=True, phase_wall_s=time.perf_counter() - t0)
    peak = jax.devices()[0].memory_stats().get("peak_bytes_in_use")
    print(f"peak_bytes_in_use: {peak}", flush=True)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

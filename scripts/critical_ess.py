"""Statistical efficiency of the lattice path at and away from criticality.

The headline is flips/s, but near T_c single-spin-flip dynamics pay critical
slowing down (tau_int ~ L^z, z ~= 2.2 for heat-bath/Metropolis), so raw
flip throughput overstates usable sampling power exactly where the physics
is interesting (r5 verdict #2). This script measures the integrated
autocorrelation time of |M| and E with the Geyer estimator
(tsu_tpu/ops/stats.py) on the sweep the chooser picks (the GPU kernel on
the card, tsu_tpu/ops/select.py):

* at T_c = 2.269 for L = 64..512 (direct measurement), fitting
  tau = A * L^z,
* away from T_c (T = 3.0) for L = 256 and 4096 (direct, fast mixing),
* projecting tau and ESS/s for the 4096^2 headline at T_c from the fit —
  a direct measurement there would need ~tau * 300 ~ 1e10 sweeps (weeks).

ESS/s uses the MEASURED wall rate of the same loop that produced the
series (sweeps + observable evaluations), not the headline kernel rate.
Output: visual_output/critical_ess.json. Reference contrast: the reference
reports ESS for its generic sampling rows (tsu/benchmarks/sampling.py:
314-351) but has no lattice-scale statistical-efficiency number at all.

Run: python scripts/critical_ess.py [--quick]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from datetime import date

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from functools import partial

import jax
import jax.numpy as jnp

import numpy as np

T_C = 2.269


def measure_series(key, L, T, *, thin, n_meas, burnin, use_pallas=None):
    """Time series of (|m|, e/site) every ``thin`` sweeps after burn-in.

    Ordered start (all +1): at/below T_c a random start would have to
    coarsen O(L)-sized domains first, which takes longer than relaxing the
    ordered state. Returns (m_abs, e_site, sweeps_per_s_measured).
    """
    from tsu_tpu.ops.checkerboard import (
        lattice_energy_batch,
        merge_checkerboard,
        split_checkerboard,
    )

    from tsu_tpu.ops.select import choose_sweep

    route = choose_sweep((L, L), "uniform", use_pallas=use_pallas)
    lat0 = jnp.ones((L, L), jnp.float32)
    n_sites = L * L
    seed0 = jax.random.randint(key, (), 0, 2**30, dtype=jnp.int32)

    if route == "triton":
        from tsu_tpu.ops import checkerboard_triton as ct

        dtype = jnp.int8
        key2 = ct.key_words(key)

        def sweeps(planes, t, n):
            # Measurement t draws sweep counters t*n .. t*n + n - 1.
            reds, blacks = ct.sweeps(key2, planes[0][None], planes[1][None],
                                     T, n, periodic=True, sweep_offset=t * n)
            return reds[0], blacks[0]
    else:
        from tsu_tpu.ops.checkerboard import checkerboard_sweeps_planes

        dtype = jnp.float32

        def sweeps(planes, t, n):
            red, black = planes
            k = jax.random.fold_in(jax.random.key(12345), seed0 + t)
            return checkerboard_sweeps_planes(
                k, red, black, T, n, J=1.0, field=0.0, periodic=True)

    def meas(carry, t):
        planes = sweeps(carry, t, thin)
        red, black = planes
        m = (jnp.sum(red.astype(jnp.float32))
             + jnp.sum(black.astype(jnp.float32))) / n_sites
        lat = merge_checkerboard(red.astype(jnp.float32),
                                 black.astype(jnp.float32))
        e = lattice_energy_batch(lat, J=1.0, field=0.0,
                                 periodic=True) / n_sites
        return planes, (jnp.abs(m), e)

    @partial(jax.jit, static_argnames=("n",))
    def run_chunk(planes, t0c, n):
        return jax.lax.scan(meas, planes, t0c + jnp.arange(n))

    # Chunked host loop: the series is produced in launches budgeted by
    # FLIPS (~1e12 per launch, iteration-capped for small lattices where
    # per-iteration overhead dominates), which keeps every device
    # execution short and the progress visible. Burn-in and
    # measurement chunks are padded UP to one uniform chunk size — extra
    # burn-in/measurements are harmless, and a single static shape means
    # the one warm-up call compiles the ONLY program the timed loop runs
    # (review r5: mixed chunk sizes put a fresh compile inside the timed
    # region, and the full-size warm-up discarded ~1e12 flips).
    chunk_iters = max(1, min(20_000, int(1e12 // (thin * n_sites))))
    n_burn_chunks = -(-max(burnin // thin, 1) // chunk_iters) * chunk_iters
    n_meas = -(-n_meas // chunk_iters) * chunk_iters
    planes = split_checkerboard(lat0.astype(dtype))
    # Warm-up/compile: one real (small fraction of burn-in) chunk.
    planes, _ = run_chunk(planes, jnp.int32(0), n=chunk_iters)
    np.asarray(planes[0][:2, :2])

    t0 = time.perf_counter()
    done = chunk_iters  # the warm-up chunk counts toward burn-in
    while done < n_burn_chunks:
        planes, _ = run_chunk(planes, jnp.int32(done), n=chunk_iters)
        done += chunk_iters
    ms, es = [], []
    total = n_burn_chunks + n_meas
    while done < total:
        planes, (m, e) = run_chunk(planes, jnp.int32(done), n=chunk_iters)
        ms.append(np.asarray(m))
        es.append(np.asarray(e))
        done += chunk_iters
    dt = time.perf_counter() - t0
    m_abs = np.concatenate(ms)
    e = np.concatenate(es)
    total_sweeps = (total - chunk_iters) * thin
    return m_abs, e, total_sweeps / dt


def tau_and_ess(series, thin):
    """(tau_int in sweeps, ESS) via the Geyer estimator on a thinned chain.

    tau_int = N / (2 ESS) in measurement units, times the thinning stride.
    This is a lower bound when thin >~ tau (thinning hides correlation);
    the configs keep thin << expected tau so the bias is small.
    """
    from tsu_tpu.ops.stats import effective_sample_size

    n = len(series)
    ess = effective_sample_size(series)
    tau_meas_units = n / (2.0 * ess)
    return tau_meas_units * thin, ess


def run_row(key, L, T, *, thin, n_meas, burnin, label):
    m_abs, e, sweeps_per_s = measure_series(
        key, L, T, thin=thin, n_meas=n_meas, burnin=burnin)
    n_meas = len(m_abs)  # measure_series pads up to uniform chunks
    tau_m, ess_m = tau_and_ess(m_abs, thin)
    tau_e, ess_e = tau_and_ess(e, thin)
    meas_seconds = n_meas * thin / sweeps_per_s
    row = {
        "label": label,
        "L": L,
        "T": T,
        "thin_sweeps": thin,
        "n_meas": n_meas,
        "burnin_sweeps": burnin,
        "mean_abs_m": round(float(m_abs.mean()), 5),
        "mean_e_site": round(float(e.mean()), 5),
        "tau_int_M_sweeps": round(tau_m, 2),
        "tau_int_E_sweeps": round(tau_e, 2),
        "ess_M": round(ess_m, 1),
        "ess_M_per_s": round(ess_m / meas_seconds, 4),
        "sweeps_per_s_measured": round(sweeps_per_s, 1),
        "flips_per_s_measured": round(sweeps_per_s * L * L, 1),
        "run_over_tau": round(n_meas * thin / max(tau_m, 1e-9), 1),
    }
    print(json.dumps(row), flush=True)
    return row


def main():
    quick = "--quick" in sys.argv[1:]
    from tsu_tpu.profiling import enable_compilation_cache

    enable_compilation_cache()
    key = jax.random.key(20260821)

    # tau guess ~ 0.3 * L^2.17 sweeps sizes burn-in (10x) and thinning
    # (<< tau); the artifact records run_over_tau so an undersized run is
    # visible rather than silently trusted.
    def tau_guess(L):
        return 0.3 * L ** 2.17

    rows = []
    tc_sizes = [16, 32] if quick else [64, 128, 256, 512]
    for i, L in enumerate(tc_sizes):
        tg = tau_guess(L)
        thin = max(1, int(tg / 400))
        n_meas = 20_000 if quick else min(120_000, max(
            60_000, int(250 * tg / thin)))
        burnin = int(10 * tg)
        rows.append(run_row(jax.random.fold_in(key, i), L, T_C,
                            thin=thin, n_meas=n_meas, burnin=burnin,
                            label=f"Tc_L{L}"))

    away_sizes = [16] if quick else [256, 4096]
    for i, L in enumerate(away_sizes):
        rows.append(run_row(jax.random.fold_in(key, 100 + i), L, 3.0,
                            thin=1, n_meas=2_000 if quick else 20_000,
                            burnin=100 if quick else 2_000,
                            label=f"T3.0_L{L}"))

    # Fit tau = A * L^z at T_c and project the 4096^2 headline.
    Ls = np.array([r["L"] for r in rows if r["label"].startswith("Tc")],
                  float)
    taus = np.array([r["tau_int_M_sweeps"] for r in rows
                     if r["label"].startswith("Tc")], float)
    z, logA = np.polyfit(np.log(Ls), np.log(taus), 1)
    A = float(np.exp(logA))
    fit = {"z": round(float(z), 3), "A": round(A, 4),
           "Ls": Ls.astype(int).tolist(), "taus_sweeps": taus.tolist()}
    print(json.dumps({"fit": fit}), flush=True)

    # Wolff cluster yardstick (host oracle): what cluster updates would buy
    # at T_c, in MEASURED sweep-equivalents (cluster_size / N per step) —
    # the quantitative basis for the build/don't-build decision on a
    # device cluster-update kernel (ROADMAP.md, Reach item 2).
    from tsu_tpu.oracle.wolff import wolff_chain
    from tsu_tpu.ops.stats import effective_sample_size

    wolff_rows = []
    for L in ([16] if quick else [64, 128]):
        w = wolff_chain(20260821, L, T_C,
                        n_steps=1500 if quick else 4000)
        n = len(w["m_abs"])
        ess = effective_sample_size(w["m_abs"])
        tau_steps = n / (2.0 * ess)
        tau_sweq = tau_steps * w["sweep_equiv_per_step"]
        row = {
            "L": L, "T": T_C,
            "tau_int_M_wolff_steps": round(tau_steps, 2),
            "sweep_equiv_per_step": round(w["sweep_equiv_per_step"], 4),
            "tau_int_M_sweep_equivalents": round(tau_sweq, 3),
            "mean_abs_m": round(float(w["m_abs"].mean()), 5),
            "mean_cluster_size": round(w["mean_cluster_size"], 1),
        }
        hb = next((r for r in rows
                   if r["L"] == L and r["label"].startswith("Tc")), None)
        if hb is not None:
            row["heatbath_tau_over_wolff_tau_sweeps"] = round(
                hb["tau_int_M_sweeps"] / max(tau_sweq, 1e-9), 1)
        wolff_rows.append(row)
        print(json.dumps({"wolff": row}), flush=True)

    out = {
        "date": date.today().isoformat(),
        "git_sha": subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True,
            text=True, cwd=os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))).stdout.strip(),
        "backend": jax.default_backend(),
        "rows": rows,
        "fit_Tc": fit,
        "wolff_Tc": wolff_rows,
    }

    if not quick:
        # 4096^2 projection at T_c from the fit + the measured production
        # sweep rate at T=3.0 (same loop structure; at tau-scale thinning
        # the observable overhead vanishes, so the headline kernel rate is
        # the honest denominator — use the measured-with-observables rate
        # anyway, which is the conservative choice).
        r4096 = next(r for r in rows if r["L"] == 4096)
        tau_proj = A * 4096 ** z
        # The measured fit gives an EFFECTIVE z over L=64..512; the
        # asymptotic literature exponent is ~2.17, so project both and
        # report the spread as the honest uncertainty band.
        tau_256 = next(r["tau_int_M_sweeps"] for r in rows
                       if r["L"] == 256 and r["label"].startswith("Tc"))
        tau_proj_lit = tau_256 * (4096 / 256) ** 2.17
        sweeps_per_s = r4096["sweeps_per_s_measured"]
        # Production sampling thins at ~tau scale, where per-measurement
        # overhead vanishes — the headline kernel rate is then the honest
        # denominator; the measured-with-observables rate is the
        # conservative one.
        kernel_sweeps_per_s = 1.30e11 / 4096 ** 2
        out["projection_4096_Tc"] = {
            "tau_int_M_sweeps_projected_fit": round(tau_proj, 0),
            "tau_int_M_sweeps_projected_z2.17": round(tau_proj_lit, 0),
            "sweeps_per_s_measured_T3": sweeps_per_s,
            "sweeps_per_s_headline_kernel": round(kernel_sweeps_per_s, 1),
            # Both lists ordered [fit-z, literature-z=2.17] so index i of
            # one pairs with index i of the other.
            "ess_M_per_s_at_kernel_rate": [
                round(kernel_sweeps_per_s / (2 * tau_proj), 6),
                round(kernel_sweeps_per_s / (2 * tau_proj_lit), 6)],
            "seconds_per_independent_M_sample_at_kernel_rate": [
                round(2 * tau_proj / kernel_sweeps_per_s, 1),
                round(2 * tau_proj_lit / kernel_sweeps_per_s, 1)],
            "note": ("direct tau measurement at T_c would need ~300*tau "
                     "~ 1e10+ sweeps; projected from the measured "
                     "L=64..512 fit (effective z) and the literature "
                     "z=2.17 from the L=256 anchor"),
        }
        print(json.dumps({"projection_4096_Tc": out["projection_4096_Tc"]}),
              flush=True)

    if quick:
        # Smoke-run output stays out of the committed artifact tree.
        import tempfile

        path = os.path.join(tempfile.gettempdir(), "critical_ess_quick.json")
    else:
        os.makedirs("visual_output", exist_ok=True)
        path = os.path.join("visual_output", "critical_ess.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {path}", flush=True)


if __name__ == "__main__":
    main()

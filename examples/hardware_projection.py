"""Hardware performance analysis: GPU roofline vs TSU-chip projections.

The reference's examples/tsu_hardware_timing.py projects a fictional
thermodynamic chip. Here the roles invert (SURVEY.md §2 rows 15-16): the
roofline model analyses the REAL card this framework runs on, and the
TSU-chip projection models are kept for API parity so reference users can
still run their what-if studies.

Run: python examples/hardware_projection.py
"""

from tsu_tpu.hardware import (
    ConservativeEstimator,
    HardwarePerformanceEstimator,
    TSUHardwareSpec,
    checkerboard_roofline,
    device_peaks,
)


def main():
    # --- Real card: where is the speed of light? --------------------------
    spec = device_peaks("NVIDIA H100 80GB HBM3")
    print(f"[1] Memory roofline of a checkerboard sweep on {spec.name}")
    for size in (1024, 4096, 16384):
        r = checkerboard_roofline(spec, size, size, bytes_per_site=2.0)
        print(f"    {size}x{size} int8: {r['flips_per_s_ceiling']:.2e} "
              "flips/s ceiling")
    print("    measured rates: PERF.md (taken on the card by chip_smoke.py)")

    # --- Fictional TSU chip: the reference's projection, kept honest -------
    print("\n[2] TSU-chip projections (reference parity, tsu/hardware.py)")
    tsu_spec = TSUHardwareSpec()
    est = HardwarePerformanceEstimator(tsu_spec)
    r = est.estimate_sampling_time(n_samples=10_000, dimension=10,
                                   emulator_time=2.4)
    cons = ConservativeEstimator().estimate_sampling_time(
        n_samples=10_000, dimension=10, emulator_time=2.4)
    t, t_c = r["hardware_parallel_s"], cons["hardware_parallel_s"]
    print(f"    optimistic: 10k 10-D samples in {t * 1e3:.3f} ms "
          f"({r['realistic_speedup']:.1e}x vs emulator, "
          f"{r['energy_joules']:.1e} J)")
    print(f"    conservative: {t_c * 1e3:.3f} ms "
          f"({t_c / t:.0f}x slower than the optimistic model)")
    print("    (projections describe a hypothetical chip; the roofline above "
          "describes the real card)")


if __name__ == "__main__":
    main()

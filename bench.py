"""Headline benchmark: spin-flips/s of the checkerboard sweep on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...} with
the device it ran on (platform, device_kind, count, card name and power
limit). Runs the sweep the chooser picks (tsu_tpu/ops/select.py) on a
4096^2 periodic lattice, for the uniform coupling (the headline) and the
+-J spin glass. Each row: one compiling warm-up call, then 5 timed calls
of 200 sweeps each, every call waited for with block_until_ready; the
value is the median. Fails when no GPU is present.

Baseline: the reference emulator's implied bit-update throughput, ~4.4e5
flips/s (4,377 samples/s x 10 sweeps x 10 bits — BASELINE.md / SURVEY.md §6).

Run: python bench.py
"""

import json

REFERENCE_FLIPS_PER_S = 4.4e5  # BASELINE.md: reference software throughput
L = 4096
N_SWEEPS = 200


def main():
    from tsu_tpu.benchmarks.device import (
        card_name_and_power,
        require_gpu,
        sweep_program,
        timed,
    )
    from tsu_tpu.ops.select import choose_sweep
    from tsu_tpu.profiling import enable_compilation_cache

    enable_compilation_cache()
    device = require_gpu()
    card = card_name_and_power()
    rows = {}
    for contract in ("uniform", "pm_j"):
        route = choose_sweep((L, L), contract)
        fn, args = sweep_program(route, contract, L, N_SWEEPS)
        t = timed(fn, *args)
        rows[contract] = {"route": route,
                          "flips_per_s": L * L * N_SWEEPS / t["median_s"],
                          "median_s": t["median_s"]}
    flips = rows["uniform"]["flips_per_s"]
    print(json.dumps({
        "metric": f"ising_spin_flips_per_s_{L}x{L}",
        "value": flips,
        "unit": "flips/s",
        "vs_baseline": flips / REFERENCE_FLIPS_PER_S,
        "route": rows["uniform"]["route"],
        "ea_pm_j_flips_per_s": rows["pm_j"]["flips_per_s"],
        "ea_pm_j_route": rows["pm_j"]["route"],
        "sweeps_per_call": N_SWEEPS,
        "device": device,
        "card": card,
    }))


if __name__ == "__main__":
    main()

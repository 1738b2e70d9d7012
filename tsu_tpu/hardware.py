"""Hardware performance models: GPU peaks + fictional-TSU projections.

The reference projects performance of a fictional thermodynamic chip
(tsu/hardware.py:16-199, tsu/gibbs.py:396-487). This build runs on *real*
parallel hardware, so the roles invert (SURVEY.md §2 rows 15-16):

* ``device_peaks`` / ``checkerboard_roofline`` — published peaks of the
  card the program runs on, keyed by ``device_kind``, and the memory
  speed-of-light of a checkerboard sweep against them.
* ``TSUHardwareSpec`` / ``HardwarePerformanceEstimator`` / ``HardwareEmulator``
  — API-parity projection models so reference users keep their workflows;
  `HardwareEmulator.sample_parallel` now runs chains genuinely in parallel
  (vmapped) instead of a sequential Python loop (tsu/gibbs.py:475-479).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


# -- the card's published peaks -----------------------------------------------


@dataclass(frozen=True)
class DevicePeaks:
    """Published peak rates of one accelerator (dense, no sparsity)."""

    name: str
    hbm_bytes_per_s: float
    bf16_flops: float
    f32_flops: float
    source: str


_H100_SXM = DevicePeaks(
    name="NVIDIA H100 SXM",
    hbm_bytes_per_s=3.35e12,
    bf16_flops=989e12,
    f32_flops=67e12,
    source="NVIDIA H100 Tensor Core GPU data sheet (SXM, 700 W)",
)

# Keyed by jax.Device.device_kind.
PEAKS = {"NVIDIA H100 80GB HBM3": _H100_SXM}


def device_peaks(device_kind: str) -> DevicePeaks:
    """Peaks of the device JAX reports as ``device_kind``; a device that is
    not in the table is an error, never a default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device {device_kind!r}; add it to "
            "tsu_tpu.hardware.PEAKS with its source") from None


def checkerboard_roofline(peaks: DevicePeaks, rows: int, cols: int,
                          bytes_per_site: float = 2.0) -> dict:
    """Memory speed-of-light of a checkerboard sweep of a (rows, cols)
    lattice.

    ``bytes_per_site``: device-memory bytes one full sweep moves per site —
    2 for int8 spins on the GPU kernel (each half-sweep reads the other
    colour and writes its own), 3 with +-J bond codes, 8 for the float32
    XLA engine before its random-number traffic.
    """
    n_sites = rows * cols
    bytes_per_sweep = bytes_per_site * n_sites
    t_mem = bytes_per_sweep / peaks.hbm_bytes_per_s
    return {
        "sites": n_sites,
        "bytes_per_sweep": bytes_per_sweep,
        "t_mem_s": t_mem,
        "flips_per_s_ceiling": n_sites / t_mem,
        "sweeps_per_s_ceiling": 1.0 / t_mem,
    }


# -- parity: fictional-TSU projections (tsu/hardware.py) ---------------------


@dataclass
class TSUHardwareSpec:
    """Projected thermodynamic-chip specs (cf. tsu/hardware.py:16-36)."""

    thermal_relaxation_time: float = 1e-9
    circuit_response_time: float = 1e-10
    parallel_units: int = 1000
    dimensions_per_unit: int = 1
    equilibration_steps: int = 100
    samples_per_equilibration: int = 10
    energy_per_sample: float = 1e-15


class HardwarePerformanceEstimator:
    """Physics-based timing projections (cf. tsu/hardware.py:39-147)."""

    def __init__(self, spec: Optional[TSUHardwareSpec] = None):
        self.spec = spec or TSUHardwareSpec()

    def estimate_sampling_time(
        self, n_samples: int, dimension: int, emulator_time: float
    ) -> dict:
        s = self.spec
        time_per_sample = (
            s.equilibration_steps * s.thermal_relaxation_time + s.circuit_response_time
        )
        sequential_time = n_samples * time_per_sample
        effective_parallel = min(s.parallel_units, max(n_samples, 1))
        parallel_batches = int(np.ceil(n_samples / effective_parallel))
        parallel_time = parallel_batches * time_per_sample
        return {
            "emulator_time_s": emulator_time,
            "hardware_sequential_s": sequential_time,
            "hardware_parallel_s": parallel_time,
            "naive_speedup": emulator_time / sequential_time if sequential_time else 0.0,
            "realistic_speedup": emulator_time / parallel_time if parallel_time else 0.0,
            "parallel_units_used": effective_parallel,
            "energy_joules": n_samples * s.energy_per_sample,
            "energy_comparison": self._compare_energy_to_gpu(n_samples, dimension),
        }

    def _compare_energy_to_gpu(self, n_samples: int, dimension: int) -> dict:
        # ~300 W accelerator drawing for the emulator-equivalent run time.
        gpu_power_w = 300.0
        gpu_time_estimate = n_samples * dimension * 1e-7
        gpu_energy = gpu_power_w * gpu_time_estimate
        tsu_energy = n_samples * self.spec.energy_per_sample
        return {
            "gpu_energy_joules": gpu_energy,
            "tsu_energy_joules": tsu_energy,
            "energy_advantage": gpu_energy / tsu_energy if tsu_energy else float("inf"),
        }


class ConservativeEstimator(HardwarePerformanceEstimator):
    """10x-derated projection (cf. tsu/hardware.py:149-174)."""

    def __init__(self):
        super().__init__(
            TSUHardwareSpec(
                thermal_relaxation_time=1e-8,
                parallel_units=100,
                equilibration_steps=1000,
                energy_per_sample=1e-13,
            )
        )


class HardwareEmulator:
    """Chip-level emulator interface (cf. tsu/gibbs.py:396-487).

    ``sample_parallel`` runs its chains as a real vmapped batch on the
    accelerator — the thing the reference's sequential loop simulates.
    """

    def __init__(
        self, n_bits: int = 100, clock_speed_ghz: float = 1.0,
        parallel_chains: int = 1000,
    ):
        self.n_bits = n_bits
        self.clock_speed_ghz = clock_speed_ghz
        self.parallel_chains = parallel_chains
        self.ns_per_cycle = 1.0 / clock_speed_ghz

    def estimate_hardware_time(self, n_samples: int, n_sweeps_per_sample: int) -> dict:
        time_per_sweep_ns = self.n_bits * self.ns_per_cycle
        time_per_sample_ns = n_sweeps_per_sample * time_per_sweep_ns
        batches_needed = int(np.ceil(n_samples / self.parallel_chains))
        total_time_ns = batches_needed * time_per_sample_ns
        return {
            "time_per_sweep_ns": time_per_sweep_ns,
            "time_per_sample_ns": time_per_sample_ns,
            "batches_needed": batches_needed,
            "total_time_ns": total_time_ns,
            "total_time_us": total_time_ns / 1e3,
            "total_time_ms": total_time_ns / 1e6,
            "total_time_s": total_time_ns / 1e9,
            "speedup_vs_classical": None,
        }

    def sample_parallel(
        self, coupling: np.ndarray, n_samples: int, temperature: float = 1.0
    ) -> Tuple[np.ndarray, dict]:
        """Sample with genuinely parallel chains; returns (samples, timing)."""
        from tsu_tpu.config import GibbsConfig
        from tsu_tpu.samplers.gibbs import GibbsSampler

        n_chains = min(self.parallel_chains, n_samples, 1024)
        config = GibbsConfig(temperature=temperature, n_chains=n_chains,
                             update_order="checkerboard")
        sampler = GibbsSampler(config)
        samples = sampler.sample_boltzmann(coupling, n_samples=n_samples)
        timing = self.estimate_hardware_time(n_samples, config.n_sweeps)
        return samples, timing

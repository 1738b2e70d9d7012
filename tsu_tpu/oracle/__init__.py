"""NumPy oracle: slow, obviously-correct reference implementations.

Every kernel in tsu_tpu lands only with a moment test against this module
(SURVEY.md §8.3 item 5). These are independent NumPy implementations of the
*intended semantics* (with the reference's sign bug Q1 fixed), plus exact
enumeration and the Onsager solution for absolute ground truth.
"""

from tsu_tpu.oracle.numpy_ref import (
    ising_energy,
    boltzmann_energy,
    sequential_gibbs_bits,
    sequential_gibbs_spins,
    exact_boltzmann_moments,
    exact_ising_moments,
    onsager_magnetization,
    onsager_energy,
    lattice_energy_np,
    lattice_energy_bonds_np,
    heat_bath_threshold_halfstep_np,
)

__all__ = [
    "ising_energy",
    "boltzmann_energy",
    "sequential_gibbs_bits",
    "sequential_gibbs_spins",
    "exact_boltzmann_moments",
    "exact_ising_moments",
    "onsager_magnetization",
    "onsager_energy",
    "lattice_energy_np",
    "lattice_energy_bonds_np",
    "heat_bath_threshold_halfstep_np",
]

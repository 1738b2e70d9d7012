"""The one place that chooses a checkerboard sweep implementation.

Two implementations exist for each lattice coupling contract:

* ``"triton"`` — the Pallas/Triton half-sweep kernel
  (ops/checkerboard_triton.py): int8 spins, in-kernel Philox, threshold
  table. It compiles only for NVIDIA GPUs.
* ``"xla"`` — the plain engines (ops/checkerboard.py for a uniform
  coupling, ops/checkerboard_bonds.py for per-bond couplings), which run on
  any backend and are the references the kernel is tested against.

Contracts: ``"uniform"`` (one J and field for every bond), ``"pm_j"``
(every bond in {-1, 0, +1}, zero field: the kernel reads one bond-code
byte per site) and ``"bonds"`` (continuous couplings: XLA only).
"""

from __future__ import annotations

import jax

CONTRACTS = ("uniform", "pm_j", "bonds")
# Contracts the kernel implements. On an H100 it beat the XLA engines end
# to end for both (PERF.md, bring-up finding).
KERNEL_CONTRACTS = ("uniform", "pm_j")


def choose_sweep(shape, contract: str = "uniform", *, use_pallas=None,
                 platform: str | None = None) -> str:
    """Return ``"triton"`` or ``"xla"`` for a lattice of ``shape`` (rows,
    cols) under ``contract``.

    ``use_pallas``: None chooses by platform, shape and contract; False
    forces XLA; True demands the kernel and raises where it cannot run
    (another platform, a contract it does not implement). Nothing ever
    falls back to interpret mode. ``platform`` defaults to
    ``jax.default_backend()``.
    """
    if contract not in CONTRACTS:
        raise ValueError(f"unknown coupling contract {contract!r}")
    if use_pallas is not None and not use_pallas:
        return "xla"
    platform = platform or jax.default_backend()
    rows, cols = shape[-2:]
    reasons = []
    if platform != "gpu":
        reasons.append(f"platform {platform!r} has no GPU kernel")
    if contract not in KERNEL_CONTRACTS:
        reasons.append(f"contract {contract!r} runs on XLA only")
    if rows % 2 or cols % 2:
        reasons.append(f"lattice {rows}x{cols} is not even")
    if not reasons:
        return "triton"
    if use_pallas:
        raise ValueError("use_pallas=True but " + "; ".join(reasons))
    return "xla"


def bond_contract(Jh, Jv, field=0.0) -> str:
    """``"pm_j"`` when every bond is -1, 0 or +1 and the field is zero
    (the local field then stays on the 9 integers the threshold table
    covers), else ``"bonds"``. Reads the bond planes on the host."""
    from tsu_tpu.samplers.annealing import discrete_table_applicable

    return "pm_j" if discrete_table_applicable(Jh, Jv, field) else "bonds"

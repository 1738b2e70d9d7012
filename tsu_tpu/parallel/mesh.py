"""Mesh construction helpers.

Canonical axes (SURVEY.md §5.8): ``("replica", "chains", "row")`` —
temperature replicas, independent chains, and spatial lattice rows. Any axis
may be 1; the helpers below build meshes from whatever devices exist (the
GPUs of a host, or the CPU-simulated mesh used in tests via
``XLA_FLAGS=--xla_force_host_platform_device_count=N``). Every GPU of a host
reaches every other at the same NVLink rate, so a mesh follows the
algorithm alone.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(
    replica: int = 1,
    chains: int = 1,
    rows: int = 1,
    cols: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a Mesh with axes ("replica", "chains", "row", "col").

    The product must equal the device count used. Pass explicit sizes for the
    axes you shard; leave the rest at 1.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = replica * chains * rows * cols
    if n > len(devices):
        raise ValueError(
            f"mesh {replica}x{chains}x{rows}x{cols} needs {n} devices, "
            f"have {len(devices)}"
        )
    devs = np.array(devices[:n]).reshape(replica, chains, rows, cols)
    return Mesh(devs, ("replica", "chains", "row", "col"))


def plan_lattice_mesh(
    n_devices: int,
    shape,
    *,
    replica: int = 1,
    chains: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Spatial mesh for one (R, C) lattice, preferring ROW-ONLY sharding.

    Row-only sharding is the only layout the GPU sweep kernel takes (its
    halos are rows); column sharding runs the XLA engine. Picks the largest
    row count dividing the spatial device budget that keeps rows-per-shard
    even (the checkerboard parity contract), pushing any remainder onto the
    column axis with a RuntimeWarning. Devices are laid out in
    ``jax.devices()`` order, one shard per device.
    """
    import warnings

    spatial = n_devices // (replica * chains)
    if spatial * replica * chains != n_devices:
        raise ValueError(
            f"replica*chains={replica * chains} must divide {n_devices}")
    R, C = shape
    rows = max(
        (r for r in range(1, spatial + 1)
         if spatial % r == 0 and R % r == 0 and (R // r) % 2 == 0),
        default=1,
    )
    cols = spatial // rows
    if cols > 1:
        warnings.warn(
            f"lattice {R}x{C} over {spatial} spatial devices needs column "
            f"sharding ({rows}x{cols}): the GPU sweep kernel is row-only, "
            "so sweeps run the XLA engine (docs/DISTRIBUTED.md)",
            RuntimeWarning, stacklevel=2)
        if (C // 2) % cols != 0:
            raise ValueError(
                f"compact columns C/2={C // 2} not divisible by {cols}")
    return make_mesh(replica, chains, rows, cols, devices)


def mesh_info(mesh: Mesh) -> dict:
    """Topology summary for logging / benchmark metadata."""
    return {
        "axes": dict(zip(mesh.axis_names, mesh.devices.shape)),
        "n_devices": int(mesh.devices.size),
        "platform": mesh.devices.flat[0].platform,
    }


def multihost_initialize(**kwargs):
    """Initialize the JAX distributed runtime for multi-host execution.

    Thin wrapper over ``jax.distributed.initialize``: pass
    ``coordinator_address``, ``num_processes`` and ``process_id`` (nothing
    in a plain GPU host's environment supplies them). Call once per process
    before building meshes that span hosts.
    """
    jax.distributed.initialize(**kwargs)

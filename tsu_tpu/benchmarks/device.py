"""What a measurement on the card needs: the device it ran on, the card's
name and power limit, and timings that wait for the device.

A measurement path that finds no GPU fails; it never falls back to the CPU
(a CPU time is not a device metric).
"""

from __future__ import annotations

import statistics
import subprocess
import time

import jax
import jax.numpy as jnp


def require_gpu(count: int = 1) -> dict:
    """The devices JAX reports, as ``{"platform", "kind", "count"}``;
    raises unless they are GPUs, at least ``count`` of them."""
    devices = jax.devices()
    d = devices[0]
    if d.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {d.platform!r} ({d.device_kind})")
    if len(devices) < count:
        raise RuntimeError(f"needs {count} GPUs, JAX sees {len(devices)}")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devices)}


def card_name_and_power() -> str:
    """``name, power.limit`` of every card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def timed(fn, *args, reps: int = 5) -> dict:
    """Run ``fn(*args)`` once to compile and warm up, then ``reps`` times,
    each waited for with ``block_until_ready``. Returns the first call's
    seconds (compile included) and the steady-state median and minimum."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return {"first_call_s": first, "median_s": statistics.median(times),
            "min_s": min(times), "reps": reps}


def sweep_program(route: str, contract: str, L: int, n_sweeps: int, *,
                  temperature: float = 2.269, seed: int = 0):
    """(jitted fn, args) running ``n_sweeps`` sweeps of an L x L periodic
    lattice on ``route`` ("triton" or "xla") under ``contract`` ("uniform"
    or "pm_j"). The bare sweep, without the entry points around it."""
    from tsu_tpu.ops import checkerboard_triton as ct
    from tsu_tpu.ops.checkerboard import checkerboard_sweeps_planes
    from tsu_tpu.ops.checkerboard_bonds import (
        checkerboard_sweeps_bonds,
        color_bond_weights,
        pack_bond_codes,
    )

    key = jax.random.key(seed)
    plane = jnp.where(jax.random.bernoulli(key, 0.5, (L, L // 2)), 1, -1)
    if contract == "pm_j":
        Jh, Jv = (jnp.where(jax.random.bernoulli(jax.random.fold_in(key, i),
                                                 0.5, (L, L)), 1.0, -1.0)
                  for i in (1, 2))
        weights = color_bond_weights(Jh, Jv, 0.0, periodic=True)
    if route == "triton":
        planes = plane.astype(jnp.int8)[None]
        codes = pack_bond_codes(weights) if contract == "pm_j" else None
        fn = jax.jit(lambda k, r, b, codes: ct.sweeps(
            k, r, b, temperature, n_sweeps, codes=codes))
        return fn, (ct.key_words(key), planes, planes, codes)
    planes = plane.astype(jnp.float32)
    if contract == "pm_j":
        fn = jax.jit(lambda k, r, b, w: checkerboard_sweeps_bonds(
            k, r, b, w, temperature, n_sweeps))
        return fn, (key, planes, planes, weights)
    fn = jax.jit(lambda k, r, b: checkerboard_sweeps_planes(
        k, r, b, temperature, n_sweeps))
    return fn, (key, planes, planes)

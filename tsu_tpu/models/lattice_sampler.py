"""Single-device lattice sampling entry: runs the sweep the chooser picks.

Thin glue between IsingGrid (tsu_tpu/models/ising.py) and the checkerboard
engines (tsu_tpu/ops/). Both routes implement identical heat-bath
semantics; tests cross-validate them statistically. ``route`` comes from
:func:`tsu_tpu.ops.select.choose_sweep`.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from tsu_tpu.ops.checkerboard import (
    checkerboard_sweeps_planes,
    merge_checkerboard,
    split_checkerboard,
)


@partial(
    jax.jit,
    static_argnames=("n_samples", "n_burnin", "n_sweeps", "J", "field",
                     "periodic", "route"),
)
def sample_grid(
    key,
    lattice0,
    *,
    n_samples: int,
    temperature,
    J: float = 1.0,
    field: float = 0.0,
    n_burnin: int = 100,
    n_sweeps: int = 1,
    periodic: bool = False,
    route: str = "xla",
):
    """Checkerboard-Gibbs sample a (R, C) lattice; returns (n_samples, R, C)."""
    red, black = split_checkerboard(lattice0)

    if route == "triton":
        from tsu_tpu.ops import checkerboard_triton as ct

        # int8 planes in a (1, R, C/2) batch; every sweep of the run draws
        # with its own counter under one key.
        red, black = red.astype(jnp.int8)[None], black.astype(jnp.int8)[None]
        key2 = ct.key_words(key)

        def sweeps(i, red, black, n):
            return ct.sweeps(key2, red, black, temperature, n, J=J,
                             field=field, periodic=periodic, sweep_offset=i)

        offset = lambda i: n_burnin + i * n_sweeps
        state = lambda red, black: merge_checkerboard(red, black)[0].astype(
            lattice0.dtype)
    else:

        def sweeps(i, red, black, n):
            return checkerboard_sweeps_planes(
                jax.random.fold_in(key, i), red, black, temperature, n,
                J=J, field=field, periodic=periodic,
            )

        offset = lambda i: 1 + i
        state = merge_checkerboard

    red, black = sweeps(0, red, black, n_burnin)

    def collect(carry, i):
        red, black = carry
        red, black = sweeps(offset(i), red, black, n_sweeps)
        return (red, black), state(red, black)

    _, states = jax.lax.scan(collect, (red, black), jnp.arange(n_samples))
    return states


def sample_grid_ensemble(
    key,
    lattices0,
    temperatures,
    *,
    n_samples: int,
    J: float = 1.0,
    field: float = 0.0,
    n_burnin: int = 100,
    n_sweeps: int = 1,
    periodic: bool = True,
    use_pallas: bool | None = None,
):
    """Sample an ENSEMBLE of lattices, each at its own temperature, in one
    compiled program — on the GPU kernel every half-sweep of every member
    is one batched launch (ops/checkerboard_triton.sweeps).

    A whole phase-transition scan (B temperature points x one lattice each)
    or an independent-replica error-bar ensemble runs as one program
    instead of a Python loop over temperatures. Members draw from disjoint
    generator streams (the lattice index is part of the counter).

    Args:
        lattices0: (B, R, C) initial spin configurations (+-1).
        temperatures: scalar or (B,) — per-member temperatures.
        use_pallas: None lets :func:`tsu_tpu.ops.select.choose_sweep`
            decide; True demands the GPU kernel; False forces XLA.
    Returns:
        dict with per-sample per-member observables, shapes (n_samples, B):
        ``magnetization`` (per spin) and ``energy`` (total), matching
        ops/checkerboard.sample_lattice conventions.
    """
    from tsu_tpu.ops.select import choose_sweep

    route = choose_sweep(lattices0.shape, "uniform", use_pallas=use_pallas)
    return _sample_grid_ensemble(
        key, lattices0, temperatures, n_samples=n_samples, J=J, field=field,
        n_burnin=n_burnin, n_sweeps=n_sweeps, periodic=periodic, route=route)


@partial(
    jax.jit,
    static_argnames=("n_samples", "n_burnin", "n_sweeps", "J", "field",
                     "periodic", "route"),
)
def _sample_grid_ensemble(key, lattices0, temperatures, *, n_samples, J,
                          field, n_burnin, n_sweeps, periodic, route):
    from tsu_tpu.ops.checkerboard import lattice_energy_batch

    B, R, C = lattices0.shape
    n_sites = R * C
    Ts = jnp.broadcast_to(
        jnp.asarray(temperatures, jnp.float32).reshape(-1), (B,))
    if route == "triton":
        from tsu_tpu.ops import checkerboard_triton as ct

        reds, blacks = split_checkerboard(lattices0.astype(jnp.int8))
        key2 = ct.key_words(key)

        def sweeps(i, reds, blacks, n):
            return ct.sweeps(key2, reds, blacks, Ts, n, J=J, field=field,
                             periodic=periodic, sweep_offset=i)

        offset = lambda i: n_burnin + i * n_sweeps
    else:
        reds, blacks = split_checkerboard(lattices0.astype(jnp.float32))

        def sweeps(i, reds, blacks, n):
            ks = jax.random.split(jax.random.fold_in(key, i), B)
            return jax.vmap(
                lambda k, r, b, T: checkerboard_sweeps_planes(
                    k, r, b, T, n, J=J, field=field, periodic=periodic)
            )(ks, reds, blacks, Ts)

        offset = lambda i: 1 + i

    reds, blacks = sweeps(0, reds, blacks, n_burnin)

    def collect(carry, i):
        reds, blacks = carry
        reds, blacks = sweeps(offset(i), reds, blacks, n_sweeps)
        lat = merge_checkerboard(reds.astype(jnp.float32),
                                 blacks.astype(jnp.float32))
        m = jnp.sum(lat, axis=(-2, -1)) / n_sites
        e = lattice_energy_batch(lat, J=J, field=field, periodic=periodic)
        return (reds, blacks), (m, e)

    _, (ms, es) = jax.lax.scan(collect, (reds, blacks),
                               jnp.arange(n_samples))
    return {"magnetization": ms, "energy": es}

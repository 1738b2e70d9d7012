"""Parallel tempering with replicas sharded over the ``replica`` mesh axis.

Each device (or mesh slot) owns one lattice replica and a *rung* of the
temperature ladder. Swap rounds exchange **rungs, not lattices**
(SURVEY.md §2.2: "exchange temperatures (not states) to avoid data motion"):

  1. every replica computes its energy (local reduction);
  2. energies + rung assignments are all_gathered — a few floats per replica;
  3. every device deterministically evaluates the same even/odd Metropolis
     pair decisions (shared PRNG key), permutes the rung assignment, and
     continues sweeping at its (possibly new) temperature.

Nothing large ever crosses the interconnect; it carries only O(n_replicas)
scalars per swap round. Per-sweep (magnetization, energy, rung) traces come
back so cold-chain (rung 0) observables can be selected on the host.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from tsu_tpu.ops.checkerboard import (
    merge_checkerboard,
    split_checkerboard,
    halfstep_with_halo,
    wrap_halos,
)


def _local_sweeps(key, red, black, temperature, n_sweeps, J, field, periodic):
    """n_sweeps single-device checkerboard sweeps (XLA halfsteps)."""

    def body(carry, k):
        red, black = carry
        k_r, k_b = jax.random.split(k)
        up, down = wrap_halos(black, periodic)
        red = halfstep_with_halo(k_r, black, up, down, True, temperature, J,
                                 field, periodic)
        up, down = wrap_halos(red, periodic)
        black = halfstep_with_halo(k_b, red, up, down, False, temperature, J,
                                   field, periodic)
        return (red, black), None

    (red, black), _ = jax.lax.scan(body, (red, black),
                                   jax.random.split(key, n_sweeps))
    return red, black


def _local_sweeps_kernel(key, reds, blacks, temperatures, n_sweeps, J, field,
                         periodic):
    """Per-device replica batch through the GPU sweep kernel: all local
    rungs advance in one launch per half-sweep at their own temperatures
    (the same program single-device ladders run — samplers/tempering.py).
    ``key`` is already folded with the device index."""
    from tsu_tpu.ops import checkerboard_triton as ct

    return ct.sweeps(ct.key_words(key), reds, blacks, temperatures, n_sweeps,
                     J=J, field=field, periodic=periodic)


def _rung_swap(key, energies, rungs, betas_ladder, offset):
    """Deterministic even/odd rung exchange; identical on every device.

    energies, rungs: (n_replicas,) gathered arrays. Returns new rungs.
    """
    R = energies.shape[0]
    # replica_of_rung[k] = which replica currently holds rung k.
    replica_of_rung = jnp.argsort(rungs)
    e_by_rung = energies[replica_of_rung]
    idx = jnp.arange(R)
    is_left = ((idx - offset) % 2 == 0) & (idx >= offset) & (idx + 1 < R)
    partner = jnp.where(
        is_left, idx + 1,
        jnp.where(((idx - offset) % 2 == 1) & (idx >= 1), idx - 1, idx),
    )
    has_partner = partner != idx
    delta = (betas_ladder - betas_ladder[partner]) * (e_by_rung - e_by_rung[partner])
    u = jax.random.uniform(key, (R,))
    u_shared = jnp.where(is_left, u, u[partner])
    accept = has_partner & (u_shared < jnp.exp(jnp.minimum(delta, 0.0)))
    new_rung_by_rung = jnp.where(accept, partner, idx)  # rung k -> new rung
    # Replica r held rung[r]; its new rung is new_rung_by_rung[rung[r]].
    new_rungs = new_rung_by_rung[rungs]
    n_acc = jnp.sum(accept & is_left)
    return new_rungs, n_acc


def parallel_tempering_replica_sharded(
    mesh: Mesh,
    key: jax.Array,
    shape,
    temperatures,
    *,
    n_samples: int = 100,
    swap_interval: int = 5,
    n_sweeps: int = 1,
    n_burnin: int = 50,
    J: float = 1.0,
    field: float = 0.0,
    periodic: bool = True,
    axis_name: str = "replica",
    use_pallas: bool | None = None,
):
    """Replica-exchange over the ``replica`` mesh axis.

    n_replicas must be divisible by the mesh axis size (several replicas per
    device are folded into a local batch). Returns dict with per-sample
    (n_samples, n_replicas) magnetization, energy, rung traces, swap stats.

    On the GPU kernel (``use_pallas``: None lets
    :func:`tsu_tpu.ops.select.choose_sweep` decide) each device sweeps its
    local replica batch in one launch per half-sweep, each rung at its own
    temperature.
    """
    from tsu_tpu.ops.select import choose_sweep

    temperatures = jnp.asarray(temperatures, dtype=jnp.float32)
    n_rep = temperatures.shape[0]
    n_dev = mesh.shape[axis_name]
    assert n_rep % n_dev == 0, f"{n_rep} replicas on {n_dev} devices"
    per_dev = n_rep // n_dev
    rows, cols = shape
    route = choose_sweep(shape, "uniform", use_pallas=use_pallas)
    n_sites = rows * cols
    betas_ladder = 1.0 / jnp.sort(temperatures)
    ladder_sorted = jnp.sort(temperatures)

    k_init, k_run = jax.random.split(key)
    lat0 = jnp.where(
        jax.random.bernoulli(k_init, 0.5, (n_rep, rows, cols)), 1.0, -1.0
    ).astype(jnp.float32)
    red0, black0 = split_checkerboard(lat0)
    sharding = NamedSharding(mesh, P(axis_name, None, None))
    red0 = jax.device_put(red0, sharding)
    black0 = jax.device_put(black0, sharding)
    rungs0 = jnp.arange(n_rep)  # replica r starts on rung r (replicated)

    total = n_burnin + n_samples

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis_name, None, None), P(axis_name, None, None), P()),
        out_specs=(P(), P(), P(), P(), P()),
        check_vma=False,
    )
    def run(key, red_l, black_l, rungs):
        dev = jax.lax.axis_index(axis_name)
        my_slots = dev * per_dev + jnp.arange(per_dev)

        def energies_of(red_l, black_l):
            from tsu_tpu.ops.checkerboard import lattice_energy_batch

            lat = merge_checkerboard(red_l, black_l)  # (per_dev, rows, cols)
            return lattice_energy_batch(lat, J=J, field=field, periodic=periodic)

        def body(carry, inp):
            red_l, black_l, rungs, n_acc = carry
            t, k = inp
            my_T = ladder_sorted[rungs[my_slots]]  # (per_dev,)
            k_sweep = jax.random.fold_in(k, dev)
            if route == "triton":
                red_l, black_l = _local_sweeps_kernel(
                    k_sweep, red_l, black_l, my_T, n_sweeps, J, field,
                    periodic)
            else:
                red_l, black_l = jax.vmap(
                    lambda kk, r, b, T: _local_sweeps(kk, r, b, T, n_sweeps,
                                                      J, field, periodic)
                )(jax.random.split(k_sweep, per_dev), red_l, black_l, my_T)

            e_local = energies_of(red_l, black_l)  # (per_dev,)
            # Gather all replica energies (tiny) for the swap decision.
            e_all = jax.lax.all_gather(e_local, axis_name).reshape(n_rep)

            def do_swap(args):
                rungs, n_acc = args
                offset = (t // swap_interval) % 2
                new_rungs, acc = _rung_swap(
                    jax.random.fold_in(k, 10_007), e_all, rungs,
                    betas_ladder, offset,
                )
                return new_rungs, n_acc + acc

            rungs, n_acc = jax.lax.cond(
                (t + 1) % swap_interval == 0, do_swap, lambda a: a,
                (rungs, n_acc),
            )
            m_local = jnp.sum(merge_checkerboard(red_l, black_l),
                              axis=(-2, -1)) / n_sites
            m_all = jax.lax.all_gather(m_local, axis_name).reshape(n_rep)
            return (red_l, black_l, rungs, n_acc), (m_all, e_all, rungs)

        keys = jax.random.split(key, total)
        (red_l, black_l, rungs, n_acc), (ms, es, rung_hist) = jax.lax.scan(
            body, (red_l, black_l, rungs, jnp.int32(0)),
            (jnp.arange(total), keys),
        )
        return ms, es, rung_hist, n_acc, rungs

    ms, es, rung_hist, n_acc, rungs = jax.jit(run)(
        k_run, red0, black0, rungs0
    )
    ms = np.asarray(ms)[n_burnin:]
    es = np.asarray(es)[n_burnin:]
    rung_hist = np.asarray(rung_hist)[n_burnin:]
    # Cold-chain trace: observable of whichever replica holds rung 0.
    cold_idx = rung_hist.argmin(axis=1)
    cold_m = ms[np.arange(len(ms)), cold_idx]
    cold_e = es[np.arange(len(es)), cold_idx]
    n_swap_rounds = max(total // swap_interval, 1)
    return {
        "magnetization": ms,
        "energy": es,
        "rungs": rung_hist,
        "cold_magnetization": cold_m,
        "cold_energy": cold_e,
        "swap_accepts": int(n_acc),
        "swap_acceptance_rate": float(n_acc) / (n_swap_rounds * max(n_rep - 1, 1) / 2),
        "final_rungs": np.asarray(rungs),
    }

"""Parallel tempering (replica exchange), fully on-device.

The reference updates replicas one-by-one in Python and swaps with host-side
Metropolis tests (tsu/gibbs.py:270-323). Here all replicas advance
simultaneously (vmapped; shardable over a ``replica`` mesh axis —
tsu_tpu/parallel/), and swap decisions run inside the compiled scan using
deterministic even/odd adjacent pairing, so the chain never leaves the device.

Swap rule: replicas i (colder) and j=i+1 exchange states with probability
min(1, exp((beta_i - beta_j)(E_i - E_j))).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

import numpy as np

from tsu_tpu.samplers.gibbs import (
    blocked_sweeps,
    boltzmann_energy_batch,
    color_groups,
)


def _swap_permutation(key, energies, betas, offset):
    """Even/odd adjacent-pair Metropolis swap as a permutation of replica slots.

    Returns (perm, acc_pairs, att_pairs) where the pair vectors have shape
    (R-1,) int32 and index p refers to the adjacent pair (p, p+1) — per-pair
    statistics are what ladder construction feeds on (a single aggregate rate
    hides the one frozen link that cuts the ladder in two). Vectorized: every
    pair decides with one shared uniform; unpaired slots map to themselves.
    """
    R = energies.shape[0]
    idx = jnp.arange(R)
    is_left = ((idx - offset) % 2 == 0) & (idx >= offset) & (idx + 1 < R)
    partner = jnp.where(
        is_left,
        idx + 1,
        jnp.where(((idx - offset) % 2 == 1) & (idx >= 1), idx - 1, idx),
    )
    has_partner = partner != idx
    delta = (betas - betas[partner]) * (energies - energies[partner])
    u = jax.random.uniform(key, (R,))
    u_shared = jnp.where(is_left, u, u[partner])  # one draw per pair
    accept = has_partner & (u_shared < jnp.exp(jnp.minimum(delta, 0.0)))
    perm = jnp.where(accept, partner, idx)
    att_pairs = is_left[:-1].astype(jnp.int32)
    acc_pairs = (accept & is_left)[:-1].astype(jnp.int32)
    return perm, acc_pairs, att_pairs


def _state_exchange_run(key, states0, sweep_all, energy_of, betas, *,
                        total: int, swap_interval: int, n_burnin: int):
    """Shared replica-exchange driver for lattice-carrying PT variants.

    ``sweep_all(k, states, t)`` advances every replica one round;
    ``energy_of(states)`` returns per-replica energies. Returns
    (cold_samples_after_burnin, energy_hist, final_states, acc_pairs,
    att_pairs) with per-adjacent-pair swap counts as (R-1,) NumPy vectors
    — the scan/swap scaffolding lived in three near-identical copies
    before r4's review consolidated it.
    """
    R = betas.shape[0]

    @partial(jax.jit, static_argnames=())
    def run(states, keys, ts):
        def body(carry, inp):
            states, acc_p, att_p = carry
            t, k = inp
            k_sweep, k_swap = jax.random.split(k)
            states = sweep_all(k_sweep, states, t)
            energies = energy_of(states)

            def do_swap(args):
                states, acc_p, att_p = args
                offset = (t // swap_interval) % 2
                perm, acc, att = _swap_permutation(k_swap, energies, betas,
                                                   offset)
                return states[perm], acc_p + acc, att_p + att

            states, acc_p, att_p = jax.lax.cond(
                (t + 1) % swap_interval == 0, do_swap, lambda a: a,
                (states, acc_p, att_p),
            )
            return (states, acc_p, att_p), (states[0], energies)

        zeros = jnp.zeros((R - 1,), jnp.int32)
        return jax.lax.scan(body, (states, zeros, zeros), (ts, keys))

    ts = jnp.arange(total)
    keys = jax.random.split(key, total)
    (states, acc_p, att_p), (cold, energy_hist) = run(states0, keys, ts)
    return (cold[n_burnin:], energy_hist, states,
            np.asarray(acc_p), np.asarray(att_p))


def _pt_info(acc_p, att_p, energy_hist, finals) -> dict:
    """info dict shared by every PT variant: aggregate + per-pair swap
    statistics (pair p = adjacent rungs (p, p+1), coldest first)."""
    acc_p = np.asarray(acc_p)
    att_p = np.asarray(att_p)
    n_acc, n_att = int(acc_p.sum()), int(att_p.sum())
    return {
        "swap_acceptance_rate": n_acc / n_att if n_att > 0 else 0.0,
        "swap_attempts": n_att,
        "swap_accepts": n_acc,
        "pair_acceptance": acc_p / np.maximum(att_p, 1),
        "pair_attempts": att_p,
        "energies": jax.device_get(energy_hist),
        "final_states": jax.device_get(finals),
    }


@partial(
    jax.jit,
    static_argnames=("n_samples", "swap_interval", "n_sweeps", "n_burnin"),
)
def _pt_dense_scan(key, J, h, temperatures, colors, n_samples, swap_interval,
                   n_sweeps, n_burnin):
    R = temperatures.shape[0]
    n = J.shape[0]
    betas = 1.0 / temperatures

    k_init, k_run = jax.random.split(key)
    states = jax.random.bernoulli(k_init, 0.5, (R, n)).astype(jnp.float32)
    total = n_burnin + n_samples

    def body(carry, inp):
        states, acc_p, att_p = carry
        t, k = inp
        k_sweep, k_swap = jax.random.split(k)
        # All replicas advance together: one colored block sweep with a
        # per-replica temperature vector (replicas = the batch axis).
        states = blocked_sweeps(k_sweep, states, J, h, temperatures, colors,
                                n_sweeps)
        energies = boltzmann_energy_batch(states, J, h)

        def do_swap(args):
            states, acc_p, att_p = args
            offset = (t // swap_interval) % 2
            perm, acc, att = _swap_permutation(k_swap, energies, betas, offset)
            return states[perm], acc_p + acc, att_p + att

        states, acc_p, att_p = jax.lax.cond(
            (t + 1) % swap_interval == 0,
            do_swap,
            lambda args: args,
            (states, acc_p, att_p),
        )
        return (states, acc_p, att_p), (states[0], energies)

    ts = jnp.arange(total)
    keys = jax.random.split(k_run, total)
    zeros = jnp.zeros((R - 1,), jnp.int32)
    (states, acc_p, att_p), (cold_states, energy_hist) = jax.lax.scan(
        body, (states, zeros, zeros), (ts, keys)
    )
    return cold_states[n_burnin:], energy_hist, states, acc_p, att_p


def parallel_tempering_dense(
    key,
    J,
    h,
    *,
    temperatures,
    n_samples: int = 1000,
    swap_interval: int = 10,
    n_sweeps: int = 1,
    n_burnin: int = 100,
) -> Tuple[jax.Array, dict]:
    """Replica-exchange Gibbs on dense J. Returns (cold samples, info).

    info mirrors the reference dict (tsu/gibbs.py:330-336): swap acceptance
    statistics, per-sweep replica energies, final replica states.
    """
    colors = jnp.asarray(color_groups(np.asarray(J)))
    cold, energy_hist, finals, acc_p, att_p = _pt_dense_scan(
        key, J, h, temperatures, colors, n_samples, swap_interval, n_sweeps,
        n_burnin
    )
    return cold, _pt_info(acc_p, att_p, energy_hist, finals)


def parallel_tempering_lattice(
    key,
    shape,
    *,
    temperatures,
    J: float = 1.0,
    field: float = 0.0,
    n_samples: int = 100,
    swap_interval: int = 10,
    n_sweeps: int = 1,
    n_burnin: int = 100,
    periodic: bool = True,
    use_pallas: bool | None = None,
):
    """Replica-exchange over checkerboard lattice sweeps.

    Replicas carry whole 2-D lattices; swaps exchange lattices between
    adjacent temperature slots (equivalently, temperatures between replicas —
    the data stays put under jit since XLA fuses the gather). Returns
    (cold_samples (n_samples, R, C), info).

    On the GPU kernel (``use_pallas``: None lets
    :func:`tsu_tpu.ops.select.choose_sweep` decide) ALL replicas sweep in
    one batched launch per half-sweep, each at its own rung temperature
    (ops/checkerboard_triton.sweeps).
    """
    from tsu_tpu.ops.checkerboard import (
        checkerboard_sweeps,
        lattice_energy_batch,
        merge_checkerboard,
        split_checkerboard,
    )

    from tsu_tpu.ops.select import choose_sweep

    temperatures = jnp.asarray(temperatures, dtype=jnp.float32)
    R = temperatures.shape[0]
    betas = 1.0 / temperatures
    route = choose_sweep(shape, "uniform", use_pallas=use_pallas)

    k_init, k_run = jax.random.split(key)
    states = jnp.where(
        jax.random.bernoulli(k_init, 0.5, (R,) + tuple(shape)), 1.0, -1.0
    ).astype(jnp.float32)
    total = n_burnin + n_samples

    if route == "triton":
        from tsu_tpu.ops import checkerboard_triton as ct

        def sweep_all(k, states, i):
            reds, blacks = split_checkerboard(states.astype(jnp.int8))
            reds, blacks = ct.sweeps(
                ct.key_words(k), reds, blacks, temperatures, n_sweeps,
                J=J, field=field, periodic=periodic,
            )
            return merge_checkerboard(reds, blacks).astype(jnp.float32)
    else:

        def sweep_all(k, states, i):
            return jax.vmap(
                lambda kk, s, T: checkerboard_sweeps(
                    kk, s, T, n_sweeps, J=J, field=field, periodic=periodic
                )
            )(jax.random.split(k, R), states, temperatures)

    cold, energy_hist, finals, acc_p, att_p = _state_exchange_run(
        k_run, states, sweep_all,
        lambda st: lattice_energy_batch(st, J=J, field=field,
                                        periodic=periodic),
        betas, total=total, swap_interval=swap_interval, n_burnin=n_burnin,
    )
    return cold, _pt_info(acc_p, att_p, energy_hist, finals)


class _BondPlaneOps:
    """Plane-level primitives for a batch of replicas over one bond
    realization (Jh, Jv): sweep, energy, and the split/merge pair — all in
    the compact (B, R, C/2) checkerboard layout the kernels consume.

    The hot PT loops carry PLANES in the sweep dtype rather than full
    lattices, so each iteration is kernel half-sweeps + a plane-space
    energy (lattice_energy_bonds_planes): no split/merge and no dtype
    round-trip per iteration.
    """

    def __init__(self, Jh, Jv, *, field=0.0, periodic=True, use_pallas=None):
        from tsu_tpu.ops.checkerboard_bonds import (
            color_bond_weights,
            pack_bond_codes,
        )
        from tsu_tpu.ops.select import bond_contract, choose_sweep

        Jh = jnp.asarray(Jh, jnp.float32)
        Jv = jnp.asarray(Jv, jnp.float32)
        self.discrete = bond_contract(Jh, Jv, field) == "pm_j"
        self.route = choose_sweep(Jh.shape,
                                  "pm_j" if self.discrete else "bonds",
                                  use_pallas=use_pallas)
        self.periodic = periodic
        self.Jh, self.Jv, self.field = Jh, Jv, field
        # energy_planes consumes the plain weight planes whichever way the
        # sweep stores its couplings.
        self.weights = color_bond_weights(Jh, Jv, field, periodic=periodic)
        self.energy_weights = self.weights
        if self.route == "triton":
            # +-J kernel: one uint8 bond code per site and int8 spins.
            self.codes = pack_bond_codes(self.weights)
            self.dtype = jnp.int8
        else:
            self.dtype = jnp.float32

    def init_planes(self, key, batch, rows, cols):
        from tsu_tpu.ops.checkerboard import split_checkerboard

        states = jnp.where(
            jax.random.bernoulli(key, 0.5, (batch, rows, cols)), 1.0, -1.0)
        # split/merge broadcast over leading batch axes natively.
        return split_checkerboard(states.astype(self.dtype))

    def sweep_planes(self, k, reds, blacks, temperatures, n_sweeps):
        if self.route == "triton":
            from tsu_tpu.ops import checkerboard_triton as ct

            return ct.sweeps(ct.key_words(k), reds, blacks, temperatures,
                             n_sweeps, periodic=self.periodic,
                             codes=self.codes)
        # XLA fallback: the bond halfstep broadcasts over the replica
        # batch directly, temperatures ride (B, 1, 1).
        from tsu_tpu.ops.checkerboard_bonds import checkerboard_sweeps_bonds

        return checkerboard_sweeps_bonds(
            k, reds, blacks, self.weights, temperatures[:, None, None],
            n_sweeps, periodic=self.periodic,
        )

    def energy_planes(self, reds, blacks):
        from tsu_tpu.ops.checkerboard_bonds import (
            lattice_energy_bonds_planes,
        )

        return lattice_energy_bonds_planes(reds, blacks,
                                           self.energy_weights,
                                           periodic=self.periodic)

    def merge(self, reds, blacks):
        from tsu_tpu.ops.checkerboard import merge_checkerboard

        merged = merge_checkerboard(reds.astype(jnp.float32),
                                    blacks.astype(jnp.float32))
        return merged


def _make_bond_sweeper(Jh, Jv, *, field=0.0, periodic=True,
                       use_pallas=None):
    """Batched full-lattice replica sweeper over one bond realization.

    Returns (sweep_all, energy_of, discrete, kernel) where
    ``sweep_all(key, states, t, temperatures, n_sweeps)`` advances a batch
    of full lattices (B, R, C) one round — every replica at its own
    temperature — and ``energy_of(states)`` gives per-replica energies.
    Thin lattice-level wrapper over _BondPlaneOps (which the hot
    ladder/ground-state loops use directly to avoid per-iteration
    split/merge); kept for parallel_tempering_bonds, whose contract hands
    full lattices to _state_exchange_run.
    """
    from tsu_tpu.ops.checkerboard import split_checkerboard
    from tsu_tpu.ops.checkerboard_bonds import lattice_energy_bonds

    ops = _BondPlaneOps(Jh, Jv, field=field, periodic=periodic,
                        use_pallas=use_pallas)

    def sweep_all(k, states, t, temperatures, n_sweeps):
        reds, blacks = split_checkerboard(states.astype(ops.dtype))
        reds, blacks = ops.sweep_planes(k, reds, blacks, temperatures,
                                        n_sweeps)
        return ops.merge(reds, blacks)

    def energy_of(states):
        return lattice_energy_bonds(states, ops.Jh, ops.Jv, ops.field,
                                    periodic=periodic)

    return sweep_all, energy_of, ops.discrete, ops.route == "triton"


def parallel_tempering_bonds(
    key,
    Jh,
    Jv,
    *,
    temperatures,
    field: float = 0.0,
    n_samples: int = 100,
    swap_interval: int = 10,
    n_sweeps: int = 1,
    n_burnin: int = 100,
    periodic: bool = True,
    use_pallas: bool | None = None,
):
    """Replica exchange over a DISORDERED lattice (per-bond couplings).

    The workhorse algorithm for spin glasses: every rung of the ladder
    sweeps the SAME bond realization (Jh, Jv) at its own temperature, and
    adjacent rungs exchange states by the Metropolis rule. On the GPU
    kernel all replicas advance through ONE batched launch per half-sweep
    (ops/checkerboard_triton.sweeps on packed codes; it applies when the
    bonds are +-1/0 and field == 0); otherwise the XLA bond halfstep
    broadcasts over replicas.

    Returns (cold_samples (n_samples, R, C) — the coldest rung's states —
    and an info dict with swap statistics and per-replica energy traces),
    mirroring :func:`parallel_tempering_lattice`.

    LADDER SPACING: swap acceptance scales like exp(-dBeta * dE) with dE
    EXTENSIVE in the lattice size, so adjacent-rung spacing must shrink
    roughly like 1/sqrt(n_sites) for a constant acceptance rate. A
    16-rung geometric ladder that swaps healthily at 8x8 accepts nothing
    at 256^2 (measured) — large lattices need hundreds of rungs, or
    acceptance-targeted/feedback-optimized ladders: use
    :func:`tsu_tpu.samplers.tempering_ladder.build_tempering_ladder` to
    construct one, and check ``info["pair_acceptance"]`` before trusting
    the cold chain.
    """
    Jh = jnp.asarray(Jh, jnp.float32)
    Jv = jnp.asarray(Jv, jnp.float32)
    rows, cols = Jh.shape
    temperatures = jnp.sort(jnp.asarray(temperatures, dtype=jnp.float32))
    R = temperatures.shape[0]
    betas = 1.0 / temperatures
    sweep_batch, energy_of, discrete, kernel = _make_bond_sweeper(
        Jh, Jv, field=field, periodic=periodic, use_pallas=use_pallas)

    k_init, k_run = jax.random.split(key)
    states = jnp.where(
        jax.random.bernoulli(k_init, 0.5, (R, rows, cols)), 1.0, -1.0
    ).astype(jnp.float32)
    total = n_burnin + n_samples

    def sweep_all(k, states, t):
        return sweep_batch(k, states, t, temperatures, n_sweeps)

    cold, energy_hist, finals, acc_p, att_p = _state_exchange_run(
        k_run, states, sweep_all, energy_of,
        betas, total=total, swap_interval=swap_interval, n_burnin=n_burnin,
    )
    info = _pt_info(acc_p, att_p, energy_hist, finals)
    info["discrete_table_path"] = bool(kernel and discrete)
    return cold, info

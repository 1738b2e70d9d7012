"""Simulated annealing as a compiled temperature-schedule scan.

The reference anneals by mutating its config each step and re-entering the
Python sweep loop (tsu/gibbs.py:340-393, quirk Q8). Here the schedule is a
traced array consumed by one ``lax.scan``; multiple chains anneal in parallel
(vmapped / shardable on the ``chains`` mesh axis) and the best state is a
running on-device reduction.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

import numpy as np

from tsu_tpu.samplers.gibbs import (
    blocked_sweeps,
    boltzmann_energy_batch,
    color_groups,
)


def make_schedule(T_initial: float, T_final: float, n_steps: int, kind: str = "exponential"):
    """Temperature schedule array (n_steps,) (cf. tsu/gibbs.py:370-379).

    Built host-side (NumPy): schedules feed both the compiled scan and the
    native host SA loop, and must not cost a device round-trip."""
    t = np.arange(n_steps, dtype=np.float32) / max(n_steps - 1, 1)
    if kind == "exponential":
        return np.float32(T_initial) * np.float32(T_final / T_initial) ** t
    if kind == "linear":
        return np.float32(T_initial) + np.float32(T_final - T_initial) * t
    raise ValueError(f"unknown cooling schedule {kind!r}")


@partial(jax.jit, static_argnames=("n_steps", "n_chains"))
def _sa_dense_scan(key, J, h, colors, schedule, *, n_steps: int, n_chains: int):
    n = J.shape[0]
    k_init, k_run = jax.random.split(key)
    states = jax.random.bernoulli(k_init, 0.5, (n_chains, n)).astype(jnp.float32)

    def body(carry, inp):
        states, best_states, best_e = carry
        T, k = inp
        states = blocked_sweeps(k, states, J, h, T, colors, 1)
        e = boltzmann_energy_batch(states, J, h)  # (chains,)
        better = e < best_e
        best_states = jnp.where(better[:, None], states, best_states)
        best_e = jnp.minimum(e, best_e)
        return (states, best_states, best_e), None

    e0 = boltzmann_energy_batch(states, J, h)
    (_, best_states, best_e), _ = jax.lax.scan(
        body, (states, states, e0), (schedule, jax.random.split(k_run, n_steps))
    )
    i = jnp.argmin(best_e)
    return best_states[i], best_e[i]


def simulated_annealing_dense(
    key,
    J,
    h,
    *,
    T_initial: float = 10.0,
    T_final: float = 0.1,
    n_steps: int = 1000,
    cooling_schedule: str = "exponential",
    n_chains: int = 1,
):
    """Anneal bit states on dense J; returns (best_state, best_energy) over
    all chains and steps (cf. tsu/gibbs.py:340-393).

    All chains advance together through colored block sweeps — one compiled
    scan over the temperature schedule, batched matmul local fields.

    ``key`` may be a jax PRNG key or a plain integer seed. Small problems
    (n_vars <= 256 and modest total work) with an integer seed route to the
    native C++ host loop, where a device dispatch would cost more than the
    whole anneal. Where that crossover sits on a GPU is not measured yet.
    """
    J_np = np.asarray(J, np.float32)
    n = J_np.shape[0]
    small = (n <= 256
             and n * n * n_steps * max(n_chains, 1) <= (1 << 31))
    if small and isinstance(key, (int, np.integer)):
        from tsu_tpu.native import sa_dense_native

        schedule_np = np.asarray(
            make_schedule(T_initial, T_final, n_steps, cooling_schedule)
        )
        out = sa_dense_native(J_np, np.asarray(h, np.float32), schedule_np,
                              n_chains, int(key))
        if out is not None:
            # Host arrays out: wrapping in jnp.asarray would ship the result
            # to the accelerator only for the caller to fetch it back.
            return out[0], np.float32(out[1])
    if isinstance(key, (int, np.integer)):
        from tsu_tpu.rng import as_key

        key = as_key(int(key))
    schedule = make_schedule(T_initial, T_final, n_steps, cooling_schedule)
    colors = jnp.asarray(color_groups(J_np))
    return _sa_dense_scan(
        key, jnp.asarray(J, jnp.float32), jnp.asarray(h, jnp.float32),
        colors, schedule, n_steps=n_steps, n_chains=n_chains,
    )


def _tracked_anneal(sweeps, energy, reds, blacks, e0, schedule,
                    track_every: int):
    """Run ``schedule`` (one temperature per sweep) through
    ``sweeps(reds, blacks, first_sweep, temps)`` in chunks of
    ``track_every`` sweeps, keeping each lattice's lowest-``energy`` planes
    seen at chunk ends. Exactly len(schedule) sweeps run: full chunks plus
    one remainder chunk. Returns (best_reds, best_blacks, best_e)."""
    n_full, rem = divmod(schedule.shape[0], track_every)

    def track(reds, blacks, best_r, best_b, best_e):
        e = energy(reds, blacks)
        better = (e < best_e)[:, None, None]
        return (jnp.where(better, reds, best_r),
                jnp.where(better, blacks, best_b), jnp.minimum(e, best_e))

    def chunk(carry, inp):
        reds, blacks, best_r, best_b, best_e = carry
        ci, temps = inp
        reds, blacks = sweeps(reds, blacks, ci * track_every, temps)
        return (reds, blacks, *track(reds, blacks, best_r, best_b,
                                     best_e)), None

    carry = (reds, blacks, reds, blacks, e0)
    if n_full > 0:
        sched = schedule[: n_full * track_every].reshape(n_full, track_every)
        carry, _ = jax.lax.scan(chunk, carry, (jnp.arange(n_full), sched))
    reds, blacks, best_r, best_b, best_e = carry
    if rem > 0:
        reds, blacks = sweeps(reds, blacks, n_full * track_every,
                              schedule[-rem:])
        best_r, best_b, best_e = track(reds, blacks, best_r, best_b, best_e)
    return best_r, best_b, best_e


@partial(jax.jit, static_argnames=("J", "field", "periodic", "track_every"))
def _anneal_lattice_kernel(key2, states, schedule, *, J, field, periodic,
                           track_every):
    """All chains of :func:`anneal_lattice` on the GPU kernel, one schedule
    shared by every chain. Returns (best (B, R, C), best_E (B,))."""
    from tsu_tpu.ops import checkerboard_triton as ct
    from tsu_tpu.ops.checkerboard import (
        lattice_energy_batch,
        merge_checkerboard,
        split_checkerboard,
    )

    def sweeps(reds, blacks, start, temps):
        return ct.sweeps(key2, reds, blacks, temps[:, None], temps.shape[0],
                         J=J, field=field, periodic=periodic,
                         sweep_offset=start)

    def energy(reds, blacks):
        lat = merge_checkerboard(reds, blacks).astype(jnp.float32)
        return lattice_energy_batch(lat, J=J, field=field, periodic=periodic)

    reds, blacks = split_checkerboard(states.astype(jnp.int8))
    e0 = lattice_energy_batch(states, J=J, field=field, periodic=periodic)
    best_r, best_b, best_e = _tracked_anneal(sweeps, energy, reds, blacks, e0,
                                             schedule, track_every)
    return merge_checkerboard(best_r, best_b).astype(jnp.float32), best_e


@partial(jax.jit, static_argnames=("periodic", "track_every"))
def _anneal_bonds_kernel(key2, lat0, Jh, Jv, codes, schedule, field, *,
                         periodic, track_every):
    """One +-J anneal of :func:`anneal_spin_glass` on the GPU kernel.
    Returns (best (R, C), best_E). Bonds and codes are arguments, so one
    compiled program serves every restart and every call."""
    from tsu_tpu.ops import checkerboard_triton as ct
    from tsu_tpu.ops.checkerboard import merge_checkerboard, split_checkerboard
    from tsu_tpu.ops.checkerboard_bonds import lattice_energy_bonds

    def sweeps(red, black, start, temps):
        return ct.sweeps(key2, red, black, temps[:, None], temps.shape[0],
                         periodic=periodic, codes=codes, sweep_offset=start)

    def energy(red, black):
        lat = merge_checkerboard(red, black).astype(jnp.float32)
        return lattice_energy_bonds(lat, Jh, Jv, field, periodic=periodic)

    red, black = split_checkerboard(lat0.astype(jnp.int8)[None])
    e0 = lattice_energy_bonds(lat0[None], Jh, Jv, field, periodic=periodic)
    br, bb, be = _tracked_anneal(sweeps, energy, red, black, e0, schedule,
                                 track_every)
    return merge_checkerboard(br, bb)[0].astype(jnp.float32), be[0]


def anneal_lattice(
    key,
    shape,
    *,
    J: float = 1.0,
    field: float = 0.0,
    T_initial: float = 5.0,
    T_final: float = 0.05,
    n_steps: int = 1000,
    cooling_schedule: str = "exponential",
    n_chains: int = 1,
    periodic: bool = True,
    use_pallas: bool | None = None,
    track_every: int = 10,
):
    """Anneal 2-D lattices with checkerboard sweeps; returns
    (best_state (R, C), best_energy).

    On the GPU kernel (``use_pallas``: None lets
    :func:`tsu_tpu.ops.select.choose_sweep` decide) ALL chains anneal as
    one batch — one launch per half-sweep of the whole ensemble, per-sweep
    schedule temperatures via the threshold table — with best-energy
    tracking every ``track_every`` sweeps (an energy evaluation costs about
    one sweep, so per-sweep tracking would halve throughput; heat-bath at
    the low end of the schedule is monotone-greedy, so chunked tracking
    loses nothing in practice).
    """
    from tsu_tpu.ops.checkerboard import checkerboard_sweeps, lattice_energy_batch
    from tsu_tpu.ops.select import choose_sweep

    route = choose_sweep(shape, "uniform", use_pallas=use_pallas)

    schedule = make_schedule(T_initial, T_final, n_steps, cooling_schedule)
    k_init, k_run = jax.random.split(key)
    states = jnp.where(
        jax.random.bernoulli(k_init, 0.5, (n_chains,) + tuple(shape)), 1.0, -1.0
    ).astype(jnp.float32)

    if route == "triton":
        from tsu_tpu.ops.checkerboard_triton import key_words

        best_states, best_es = _anneal_lattice_kernel(
            key_words(k_run), states, jnp.asarray(schedule), J=J, field=field,
            periodic=periodic, track_every=track_every)
        i = int(jnp.argmin(best_es))
        return best_states[i], float(best_es[i])

    @jax.jit
    def run(states, keys):
        def chain(key, state):
            def body(carry, inp):
                state, best_state, best_e = carry
                T, k = inp
                state = checkerboard_sweeps(k, state, T, 1, J=J, field=field, periodic=periodic)
                e = lattice_energy_batch(state, J=J, field=field, periodic=periodic)
                better = e < best_e
                best_state = jnp.where(better, state, best_state)
                best_e = jnp.minimum(e, best_e)
                return (state, best_state, best_e), None

            e0 = lattice_energy_batch(state, J=J, field=field, periodic=periodic)
            (_, best_state, best_e), _ = jax.lax.scan(
                body, (state, state, e0), (schedule, jax.random.split(key, n_steps))
            )
            return best_state, best_e

        return jax.vmap(chain)(keys, states)

    best_states, best_es = run(states, jax.random.split(k_run, n_chains))
    i = int(jnp.argmin(best_es))
    return best_states[i], float(best_es[i])


def discrete_table_applicable(Jh, Jv, field) -> bool:
    """True when the +-J threshold-table kernel path is EXACT: the per-site
    local field must stay on the 9 integers -4..4 the table covers, i.e.
    every bond in {-1, 0, +1} AND zero field. A nonzero field — even an
    integer one — pushes the local field to +-5, which would silently fall
    through to the wrong table entry (r4 review finding #1).
    """
    Jh = jnp.asarray(Jh)
    Jv = jnp.asarray(Jv)
    return bool(
        jnp.all(jnp.isin(Jh, jnp.array([-1.0, 0.0, 1.0])))
        and jnp.all(jnp.isin(Jv, jnp.array([-1.0, 0.0, 1.0])))
        and float(field) == 0.0
    )


def anneal_spin_glass(
    key,
    Jh,
    Jv,
    *,
    field: float = 0.0,
    T_initial: float = 3.0,
    T_final: float = 0.05,
    n_steps: int = 2000,
    cooling_schedule: str = "exponential",
    n_restarts: int = 1,
    periodic: bool = True,
    use_pallas: bool | None = None,
    checkpoint_path: str | None = None,
    resume: bool = False,
):
    """Ground-state search on a DISORDERED lattice (per-bond couplings, e.g.
    the +-J Edwards-Anderson spin glass): annealed checkerboard sweeps with
    a per-sweep temperature schedule, best state over ``n_restarts``
    independent anneals. Returns (best_state (R, C), best_energy).

    ``checkpoint_path`` snapshots (best state, best energy, restarts done)
    after every completed restart; ``resume=True`` skips finished restarts.
    Each restart's stream is fold_in(key, restart), so the resumed search
    returns exactly what the uninterrupted one would (SURVEY §5.4).

    +-1 bonds with zero field (the +-J contract) run on the GPU kernel with
    one bond-code byte per site (``use_pallas``: None lets
    :func:`tsu_tpu.ops.select.choose_sweep` decide). Continuous bonds, and
    other platforms, run the XLA engine's on-device best-tracking anneal
    (ops/checkerboard_bonds.anneal_lattice_bonds).
    """
    from tsu_tpu.ops.checkerboard_bonds import (
        anneal_lattice_bonds,
        color_bond_weights,
        pack_bond_codes,
    )
    from tsu_tpu.ops.select import bond_contract, choose_sweep

    Jh = jnp.asarray(Jh, jnp.float32)
    Jv = jnp.asarray(Jv, jnp.float32)
    R, C = Jh.shape
    route = choose_sweep((R, C), bond_contract(Jh, Jv, field),
                         use_pallas=use_pallas)
    schedule = jnp.asarray(
        make_schedule(T_initial, T_final, n_steps, cooling_schedule))

    if route == "triton":
        from tsu_tpu.ops.checkerboard_triton import key_words

        codes = pack_bond_codes(
            color_bond_weights(Jh, Jv, field, periodic=periodic))
        # An energy evaluation costs about one sweep, so the kernel route
        # tracks the best state every ~n_steps/20 sweeps (the XLA anneal
        # tracks every sweep). With n_steps=0 the initial lattice and its
        # energy return.
        track_every = max(1, n_steps // 20)

    best_state, best_e = None, float("inf")
    r_start = 0
    if resume and checkpoint_path is not None:
        import os

        from tsu_tpu.checkpoint import restore_state

        ckpt_file = checkpoint_path if checkpoint_path.endswith(".npz") \
            else checkpoint_path + ".npz"
        if os.path.exists(ckpt_file) or os.path.exists(checkpoint_path):
            st = restore_state(checkpoint_path, {
                "best_state": jnp.zeros((R, C), jnp.float32),
                "best_e": jnp.float32(0.0),
                "restarts_done": jnp.int32(0)})
            r_start = int(st["restarts_done"])
            if r_start > 0:
                best_state = np.asarray(st["best_state"])
                best_e = float(st["best_e"])
    for r in range(r_start, n_restarts):
        k_init, k_run = jax.random.split(jax.random.fold_in(key, r))
        lat0 = jnp.where(jax.random.bernoulli(k_init, 0.5, (R, C)), 1.0, -1.0)
        if route == "triton":
            lat, e = _anneal_bonds_kernel(
                key_words(k_run), lat0, Jh, Jv, codes, schedule,
                jnp.float32(field), periodic=periodic,
                track_every=track_every)
            lat, e = jnp.asarray(lat), float(e)
        else:
            lat, e = anneal_lattice_bonds(
                k_run, lat0, Jh, Jv, T_initial=T_initial, T_final=T_final,
                n_steps=n_steps, field=field, periodic=periodic,
            )
            lat, e = jnp.asarray(lat), float(e)
        if e < best_e:
            best_state, best_e = np.asarray(lat), e
        if checkpoint_path is not None:
            from tsu_tpu.checkpoint import save_state

            save_state(checkpoint_path, {
                "best_state": jnp.asarray(best_state, jnp.float32),
                "best_e": jnp.float32(best_e),
                "restarts_done": jnp.int32(r + 1)})
    return best_state, best_e

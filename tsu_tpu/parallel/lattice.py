"""Spatially-sharded 2-D Ising lattice: checkerboard Gibbs with halo exchange.

The structural analog of sequence parallelism for this workload (SURVEY.md
§5.7): one big lattice state sharded over the ``row`` mesh axis, with
1-row-wide boundary strips exchanged between neighboring shards via
``jax.lax.ppermute`` before each half-sweep — the same neighbor-to-neighbor
shift communication pattern as ring attention.

The whole run (burn-in, thinning, observable collection) is ONE jitted
``shard_map``: sweeps scan on-device, observables reduce with ``psum``, and
nothing returns to the host until the per-sample scalars.

Correctness notes (SURVEY.md §8.3 item 2):
* Each shard must hold an even number of rows so checkerboard parity is
  identical on every shard (global row = shard_idx * R_local + r with
  R_local even ⇒ parity(global row) == parity(local row)).
* Periodic vertical boundaries map to the mesh-wrap permute (last shard sends
  to shard 0); open boundaries zero the outermost halos, which contributes
  nothing to the local field.
* XLA route: per-shard PRNG streams are decorrelated by folding the shard
  index into the key. GPU-kernel route: every shard shares one Philox key
  and passes its global row offset, so the sharded lattice draws exactly
  the bits of the unsharded one and gives identical spins.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp

import numpy as np

from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P
from jax import shard_map

from tsu_tpu.ops.checkerboard import (
    halfstep_with_halo,
    halfstep_with_halo2d,
    merge_checkerboard,
    split_checkerboard,
)
from tsu_tpu.ops import checkerboard_triton as ct


def _halo_exchange(plane, axis_name: str, periodic: bool):
    """Exchange boundary rows with the two neighbor shards along ``axis_name``.

    Returns (up_row, down_row): the vertical neighbors of local rows 0 and
    R_local-1. One ppermute per direction; zeroed at the global boundary for
    open lattices.
    """
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    fwd = [(i, (i + 1) % n) for i in range(n)]   # my last row -> next shard's up halo
    bwd = [(i, (i - 1) % n) for i in range(n)]   # my first row -> prev shard's down halo
    up_row = jax.lax.ppermute(plane[-1:, :], axis_name, fwd)
    down_row = jax.lax.ppermute(plane[:1, :], axis_name, bwd)
    if not periodic:
        up_row = jnp.where(idx == 0, 0.0, up_row)
        down_row = jnp.where(idx == n - 1, 0.0, down_row)
    return up_row, down_row


def _halo_exchange_cols(plane, axis_name: str, periodic: bool):
    """Column analog of :func:`_halo_exchange` on compact color planes.

    Returns (left_col, right_col) of shape (R_local, 1): the compact columns
    j2-1 / j2+1 adjacent to this column shard's block. Compact-column
    adjacency is offset-independent (the red/black horizontal-neighbor rule
    only depends on row parity), so the wrap permute realises periodic
    horizontal boundaries exactly as jnp.roll does on an unsharded plane.
    """
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    fwd = [(i, (i + 1) % n) for i in range(n)]
    bwd = [(i, (i - 1) % n) for i in range(n)]
    left_col = jax.lax.ppermute(plane[:, -1:], axis_name, fwd)
    right_col = jax.lax.ppermute(plane[:, :1], axis_name, bwd)
    if not periodic:
        left_col = jnp.where(idx == 0, 0.0, left_col)
        right_col = jnp.where(idx == n - 1, 0.0, right_col)
    return left_col, right_col


def _make_local_halfstep(axis_name, periodic, route, J, field, col_axis=None):
    """Build the per-shard half-sweep: halo exchange + color update.

    The returned function takes temperature as an ARGUMENT (not a closure
    capture) so one compiled program serves every temperature — and so the
    whole sharded program can be built once per static configuration and
    cached (see :func:`_sharded_sweeps_fn`). ``k`` feeds the XLA route;
    ``key2`` and ``sweep`` the kernel route.
    """

    if col_axis is not None:
        def one_halfstep2d(k, key2, sweep, other, update_red, T, u24=None):
            up, down = _halo_exchange(other, axis_name, periodic)
            left, right = _halo_exchange_cols(other, col_axis, periodic)
            return halfstep_with_halo2d(
                k, other, up, down, left, right, update_red, T, J, field,
            )

        return one_halfstep2d

    def one_halfstep(k, key2, sweep, other, update_red, T, u24=None):
        up, down = _halo_exchange(other, axis_name, periodic)
        if route == "triton":
            # Horizontal wrap stays in-shard under row sharding; the
            # vertical boundary is the exchanged (or zeroed) halo rows.
            row0 = jax.lax.axis_index(axis_name) * other.shape[0]
            return ct.halfsweep(
                key2, sweep, ct.sigmoid_table(J, field, T)[None],
                other[None], up[None], down[None], update_red=update_red,
                periodic=periodic, row_offset=row0,
                u24=None if u24 is None else u24[None],
            )[0]
        return halfstep_with_halo(
            k, other, up, down, update_red, T, J, field, periodic
        )

    return one_halfstep


def _local_observables(red, black, axis_name, periodic, J, field, col_axis=None):
    """Per-shard (M, E) partial sums reduced with psum over the mesh axes.

    Bonds crossing a shard boundary are attributed to the shard that owns the
    upper row / left column (its "down"/"right" bond), delivered by halo
    exchange of the merged local lattice's first row / column.
    """
    # f32 accumulation: the kernel route stores int8 planes.
    lat = merge_checkerboard(red, black).astype(jnp.float32)
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    fwd = [(i, (i - 1) % n) for i in range(n)]
    down_halo = jax.lax.ppermute(lat[:1, :], axis_name, fwd)  # next shard's row 0
    if not periodic:
        down_halo = jnp.where(idx == n - 1, 0.0, down_halo)

    horiz = jnp.sum(lat[:, :-1] * lat[:, 1:])
    if col_axis is None:
        if periodic:
            horiz = horiz + jnp.sum(lat[:, -1] * lat[:, 0])
    else:
        nc = jax.lax.axis_size(col_axis)
        cidx = jax.lax.axis_index(col_axis)
        cfwd = [(i, (i - 1) % nc) for i in range(nc)]
        right_halo = jax.lax.ppermute(lat[:, :1], col_axis, cfwd)
        if not periodic:
            right_halo = jnp.where(cidx == nc - 1, 0.0, right_halo)
        horiz = horiz + jnp.sum(lat[:, -1:] * right_halo)
    vert = jnp.sum(lat[:-1, :] * lat[1:, :]) + jnp.sum(lat[-1:, :] * down_halo)
    e_local = -J * (horiz + vert) - field * jnp.sum(lat)
    m_local = jnp.sum(lat)
    axes = (axis_name,) if col_axis is None else (axis_name, col_axis)
    return (
        jax.lax.psum(m_local, axes),
        jax.lax.psum(e_local, axes),
    )


@lru_cache(maxsize=64)
def _sharded_sweeps_fn(mesh, n_sweeps, J, field, periodic, route, axis_name,
                       col_axis):
    """Build + jit the sharded sweeps program ONCE per static configuration
    (keyed on mesh + statics; temperature is an argument), so repeat calls
    are pure dispatch instead of a re-trace."""
    spec = P(axis_name, col_axis)
    uspec = P(None, None, axis_name, col_axis)
    local_halfstep = _make_local_halfstep(
        axis_name, periodic, route, J, field, col_axis
    )

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), spec, spec, P(), uspec),
        out_specs=(spec, spec),
        check_vma=False,
    )
    def run(key, red_l, black_l, T, uniforms_l):
        shard = jax.lax.axis_index(axis_name)
        if col_axis is not None:
            shard = shard * jax.lax.axis_size(col_axis) + jax.lax.axis_index(col_axis)
        # Kernel route: one key on every shard (streams are keyed by global
        # site). XLA route: a per-shard key.
        key2 = ct.key_words(key)
        key = jax.random.fold_in(key, shard)

        def body(carry, inp):
            red_l, black_l = carry
            sweep_idx, k, u = inp
            k_r, k_b = jax.random.split(k)
            red_l = local_halfstep(k_r, key2, sweep_idx, black_l, True, T,
                                   None if u is None else u[0])
            black_l = local_halfstep(k_b, key2, sweep_idx, red_l, False, T,
                                     None if u is None else u[1])
            return (red_l, black_l), None

        keys = jax.random.split(key, n_sweeps)
        (red_l, black_l), _ = jax.lax.scan(
            body, (red_l, black_l), (jnp.arange(n_sweeps), keys, uniforms_l)
        )
        return red_l, black_l

    return jax.jit(run)


def _route(shape, use_pallas, col_axis):
    """The chooser's decision for a sharded uniform lattice. The GPU kernel
    takes row halos only, so column sharding runs XLA."""
    from tsu_tpu.ops.select import choose_sweep

    if col_axis is not None:
        if use_pallas:
            raise ValueError("the GPU sweep kernel supports row sharding "
                             "only; use a row-only mesh (plan_lattice_mesh)")
        return "xla"
    return choose_sweep(shape, "uniform", use_pallas=use_pallas)


def sharded_checkerboard_sweeps(
    mesh: Mesh,
    key: jax.Array,
    red: jax.Array,
    black: jax.Array,
    temperature,
    n_sweeps: int,
    *,
    J: float = 1.0,
    field: float = 0.0,
    periodic: bool = True,
    use_pallas: bool | None = None,
    axis_name: str = "row",
    col_axis: str | None = None,
    uniforms: jax.Array | None = None,
):
    """n_sweeps full sweeps on compact color planes sharded over ``axis_name``
    (rows) and optionally ``col_axis`` (compact columns — 2-D sharding).

    ``red``/``black`` have global shape (R, C/2), sharded
    (axis_name, col_axis). Returns updated (red, black), same sharding.
    ``use_pallas``: None lets :func:`tsu_tpu.ops.select.choose_sweep`
    decide (row sharding only); on the kernel route the result equals the
    single-device ``checkerboard_triton.sweeps`` with ``key_words(key)``.
    ``uniforms``: optional (n_sweeps, 2, R, C2) int32 in [0, 2^24), sharded
    like the planes — deterministic mode of the kernel route (exact tests
    of kernel + halo exchange together).
    """
    n_shards = mesh.shape[axis_name]
    R, C2 = red.shape
    if R % n_shards or (R // n_shards) % 2:
        raise ValueError(f"rows per shard must be even: R={R}, "
                         f"shards={n_shards}")
    if col_axis is not None and C2 % mesh.shape[col_axis]:
        raise ValueError(f"compact columns must divide evenly: C/2={C2}, "
                         f"shards={mesh.shape[col_axis]}")
    route = _route((R, 2 * C2), use_pallas, col_axis)
    # Injected uniforms are consumed only by the kernel; the XLA routes
    # would silently ignore them, so reject that combination loudly.
    if uniforms is not None and route != "triton":
        raise ValueError("uniforms require the GPU kernel route")
    fn = _sharded_sweeps_fn(mesh, n_sweeps, float(J), float(field), periodic,
                            route, axis_name, col_axis)
    if uniforms is not None:
        uniforms = jax.device_put(
            jnp.asarray(uniforms, jnp.int32),
            NamedSharding(mesh, P(None, None, axis_name, col_axis)),
        )
    return fn(key, red, black, jnp.asarray(temperature, jnp.float32),
              uniforms)


def sharded_lattice_sample(
    mesh: Mesh,
    key: jax.Array,
    lattice0: jax.Array,
    *,
    n_samples: int,
    temperature,
    J: float = 1.0,
    field: float = 0.0,
    n_burnin: int = 100,
    n_sweeps: int = 1,
    periodic: bool = True,
    use_pallas: bool | None = None,
    axis_name: str = "row",
    col_axis: str | None = None,
    dtype=None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 0,
    resume: bool = False,
):
    """Sample observables from a spatially-sharded lattice in ONE compiled
    program (row sharding, or 2-D row×column sharding when ``col_axis`` is
    given).

    Returns dict of per-sample global magnetization (per spin) and energy plus
    the final sharded planes. Full states stay sharded on device; only
    (n_samples,) scalars come back.

    ``use_pallas``: None lets :func:`tsu_tpu.ops.select.choose_sweep`
    decide (row sharding only). On the kernel route every shard shares one
    Philox key, so any row split gives the same spins and observables.
    ``dtype`` sets the plane storage dtype: default int8 on the kernel
    route (observables accumulate in f32), float32 otherwise.

    ``checkpoint_path`` + ``checkpoint_every`` (in samples) run the program
    in chunks and snapshot the sharded planes + collected observables after
    each chunk (SURVEY.md §5.4: the 4096^2 multi-host runs are exactly the
    runs that must survive preemption); ``resume=True`` continues a killed
    run. The seed/counter schedule is keyed by GLOBAL sample index, so the
    resumed run is bit-identical to the uninterrupted one.
    """
    n_shards = mesh.shape[axis_name]
    R, C = lattice0.shape
    if R % n_shards or (R // n_shards) % 2:
        raise ValueError(f"rows per shard must be even: R={R}, "
                         f"shards={n_shards}")
    if col_axis is not None and (C // 2) % mesh.shape[col_axis]:
        raise ValueError(f"compact columns must divide evenly: C/2={C // 2}, "
                         f"shards={mesh.shape[col_axis]}")
    route = _route((R, C), use_pallas, col_axis)
    if dtype is None:
        dtype = jnp.int8 if route == "triton" else jnp.float32
    red, black = split_checkerboard(jnp.asarray(lattice0, dtype=dtype))
    sharding = NamedSharding(mesh, P(axis_name, col_axis))
    red = jax.device_put(red, sharding)
    black = jax.device_put(black, sharding)
    T = jnp.asarray(temperature, jnp.float32)
    burn_offset = jnp.int32(n_burnin)

    if checkpoint_path is None or checkpoint_every <= 0:
        fn = _sharded_sample_fn(mesh, n_samples, n_burnin, n_sweeps,
                                float(J), float(field), periodic, route,
                                axis_name, col_axis)
        ms, es, red, black = fn(key, red, black, T, jnp.int32(0),
                                burn_offset)
        return {
            "magnetization": ms,
            "energy": es,
            "final_planes": (red, black),
        }

    # Chunked + checkpointed: identical seed/counter schedule (global
    # sample indices), sharded planes snapshotted after every chunk.
    from tsu_tpu.checkpoint import restore_state, save_state

    import os as _os

    obs_path = checkpoint_path + "_obs.npz"
    done = 0
    ms_parts: list = []
    es_parts: list = []
    if resume and _os.path.exists(obs_path):
        # Planes + the authoritative ``done`` ride the (sharded-aware)
        # checkpointer; the growing observable arrays live in a plain npz
        # side file so their shape never has to match a restore example.
        # The obs file is written BEFORE the planes snapshot, so on a
        # crash between the two writes the planes' ``done`` is the older
        # one and the obs arrays are simply sliced back to it.
        st = restore_state(checkpoint_path,
                           {"red": red, "black": black, "done": jnp.int32(0)})
        done = int(st["done"])
        red = jax.device_put(jnp.asarray(st["red"], dtype), sharding)
        black = jax.device_put(jnp.asarray(st["black"], dtype), sharding)
        if done > 0:
            obs = np.load(obs_path)
            ms_parts = [np.asarray(obs["ms"])[:done]]
            es_parts = [np.asarray(obs["es"])[:done]]

    while done < n_samples:
        n = min(checkpoint_every, n_samples - done)
        fn = _sharded_sample_fn(mesh, n, n_burnin if done == 0 else 0,
                                n_sweeps, float(J), float(field), periodic,
                                route, axis_name, col_axis)
        ms, es, red, black = fn(key, red, black, T, jnp.int32(done),
                                burn_offset)
        ms_parts.append(np.asarray(ms))
        es_parts.append(np.asarray(es))
        done += n
        np.savez(obs_path, ms=np.concatenate(ms_parts),
                 es=np.concatenate(es_parts))
        save_state(checkpoint_path,
                   {"red": red, "black": black, "done": jnp.int32(done)})
    return {
        "magnetization": jnp.asarray(np.concatenate(ms_parts)),
        "energy": jnp.asarray(np.concatenate(es_parts)),
        "final_planes": (red, black),
    }


@lru_cache(maxsize=64)
def _sharded_sample_fn(mesh, n_samples, n_burnin, n_sweeps, J, field,
                       periodic, route, axis_name, col_axis):
    """Cached jitted builder for :func:`sharded_lattice_sample` (one trace
    per static configuration; temperature is an argument)."""
    spec = P(axis_name, col_axis)
    local_halfstep = _make_local_halfstep(
        axis_name, periodic, route, J, field, col_axis
    )

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), spec, spec, P(), P(), P()),
        out_specs=(P(), P(), spec, spec),
        check_vma=False,
    )
    def run(key, red_l, black_l, T, start, burn_offset):
        # ``start``: global index of the first sample this call produces;
        # ``burn_offset``: the run's total burn-in sweeps. Both traced so a
        # checkpointed continuation replays the exact key/counter schedule
        # of the uninterrupted program (sample i always folds 1 + i and
        # sweeps from burn_offset + i * n_sweeps, no matter which chunk
        # executes it).
        shard = jax.lax.axis_index(axis_name)
        n_sites = 2 * red_l.shape[0] * red_l.shape[1] * jax.lax.axis_size(axis_name)
        if col_axis is not None:
            shard = shard * jax.lax.axis_size(col_axis) + jax.lax.axis_index(col_axis)
            n_sites = n_sites * jax.lax.axis_size(col_axis)
        # Kernel route: one key on every shard, counter = global sweep.
        # XLA route: a per-shard key.
        key2 = ct.key_words(key)
        key = jax.random.fold_in(key, shard)

        def sweeps(carry, step_base, k, n):
            def body(c, inp):
                red_l, black_l = c
                i, kk = inp
                k_r, k_b = jax.random.split(kk)
                red_l = local_halfstep(k_r, key2, i, black_l, True, T)
                black_l = local_halfstep(k_b, key2, i, red_l, False, T)
                return (red_l, black_l), None

            idxs = step_base + jnp.arange(n)
            (red_l, black_l), _ = jax.lax.scan(
                body, carry, (idxs, jax.random.split(k, n))
            )
            return red_l, black_l

        if n_burnin > 0:  # continuation chunks build with n_burnin == 0
            red_l, black_l = sweeps(
                (red_l, black_l), jnp.int32(0), jax.random.fold_in(key, 0),
                n_burnin
            )

        def collect(carry, i):
            red_l, black_l = carry
            red_l, black_l = sweeps(
                (red_l, black_l),
                burn_offset + i * n_sweeps,
                jax.random.fold_in(key, 1 + i),
                n_sweeps,
            )
            m, e = _local_observables(
                red_l, black_l, axis_name, periodic, J, field, col_axis
            )
            return (red_l, black_l), (m / n_sites, e)

        (red_l, black_l), (ms, es) = jax.lax.scan(
            collect, (red_l, black_l), start + jnp.arange(n_samples)
        )
        return ms, es, red_l, black_l

    return jax.jit(run)

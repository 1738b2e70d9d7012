"""Checkerboard (red/black) Gibbs sweeps for 2-D Ising lattices — XLA path.

This replaces the reference's scalar per-bit Python loop over a dense N^2
coupling matrix (tsu/gibbs.py:128-162 driven through tsu/models/ising.py:150-181)
with a vectorized formulation:

* The lattice is a (R, C) array of spins in {-1,+1}; couplings are an implicit
  nearest-neighbor stencil (uniform J, optional field h) — O(N) memory instead
  of the reference's O(N^2) dense J (tsu/models/ising.py:64).
* A sweep is two vectorized half-updates: all "red" sites ((i+j) even) update
  simultaneously given black neighbors, then all black sites. Red sites are
  conditionally independent given black ones, so this is exact heat-bath
  Gibbs — validated against the sequential NumPy oracle in tests.
* Heat-bath rule: P(s_ij = +1 | neighbors) = sigmoid(2 (J * nbr_sum + h) / T).

The half-lattice ("compact") layout used here stores each color as a
(R, C/2) plane so no lane is wasted on masked-out sites; this is also the
memory layout of the GPU kernel (tsu_tpu/ops/checkerboard_triton.py) and
of the spatially-sharded path (tsu_tpu/parallel/lattice.py).

Layout: for row i, red plane column j2 holds lattice column 2*j2 + (i % 2);
black plane column j2 holds 2*j2 + 1 - (i % 2). Horizontal neighbors of a
red site are black-plane columns {j2 - 1 + (i % 2), j2 + (i % 2)}; vertical
neighbors are the black plane at rows i±1, same column j2.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from tsu_tpu.energy import lattice_ising_energy


def split_checkerboard(lattice: jax.Array):
    """(R, C) lattice -> (red, black) planes of shape (R, C/2). C must be even."""
    R, C = lattice.shape[-2:]
    assert C % 2 == 0, "lattice width must be even for checkerboard layout"
    # Row-wise compaction: even rows take even cols as red; odd rows odd cols.
    even_cols = lattice[..., :, 0::2]
    odd_cols = lattice[..., :, 1::2]
    row_is_even = (jnp.arange(R) % 2 == 0)[:, None]
    red = jnp.where(row_is_even, even_cols, odd_cols)
    black = jnp.where(row_is_even, odd_cols, even_cols)
    return red, black


def merge_checkerboard(red: jax.Array, black: jax.Array):
    """Inverse of split_checkerboard: (R, C/2) x2 -> (R, C)."""
    R, C2 = red.shape[-2:]
    row_is_even = (jnp.arange(R) % 2 == 0)[:, None]
    even_cols = jnp.where(row_is_even, red, black)
    odd_cols = jnp.where(row_is_even, black, red)
    out = jnp.stack([even_cols, odd_cols], axis=-1)  # (..., R, C/2, 2)
    return out.reshape(*red.shape[:-1], 2 * C2)


def neighbor_sum_half_halo(
    other: jax.Array,
    up_row: jax.Array,
    down_row: jax.Array,
    update_red: bool,
    periodic_cols: bool,
):
    """4-neighbor sum for every site of one color, given the other color plane
    and explicit vertical halo rows.

    ``other`` has shape (..., R, C/2); ``up_row``/``down_row`` have shape
    (..., 1, C/2) — the vertical neighbors of local rows 0 and R-1 (wrap rows
    on a single device, ppermute'd shard boundaries when spatially sharded,
    zeros for an open boundary). For the red update, horizontal neighbors in
    row i sit at black columns j2-1,j2 (even i) or j2,j2+1 (odd i); for the
    black update the shifts swap. Vertical neighbors are rows i±1 same column.
    Requires an even local row count so local parity equals global parity.
    """
    R, C2 = other.shape[-2:]
    row_is_even = (jnp.arange(R) % 2 == 0)[:, None]

    up = jnp.concatenate([up_row, other[..., :-1, :]], axis=-2)
    down = jnp.concatenate([other[..., 1:, :], down_row], axis=-2)
    left_shift = jnp.roll(other, 1, axis=-1)   # brings column j2-1 to j2
    right_shift = jnp.roll(other, -1, axis=-1)  # brings column j2+1 to j2

    if update_red:
        horiz = jnp.where(row_is_even, left_shift + other, other + right_shift)
    else:
        horiz = jnp.where(row_is_even, other + right_shift, left_shift + other)

    if not periodic_cols:
        # Zero out wrapped horizontal contributions at the lattice edge
        # columns (the wrapped term is the shifted operand; replacing the sum
        # with `other` keeps only the in-bounds neighbor).
        col = jnp.arange(C2)[None, :]
        if update_red:
            wrap_left = row_is_even & (col == 0)
            wrap_right = (~row_is_even) & (col == C2 - 1)
        else:
            wrap_left = (~row_is_even) & (col == 0)
            wrap_right = row_is_even & (col == C2 - 1)
        horiz = jnp.where(wrap_left | wrap_right, other, horiz)

    return up + down + horiz


def neighbor_sum_half_halo2d(
    other: jax.Array,
    up_row: jax.Array,
    down_row: jax.Array,
    left_col: jax.Array,
    right_col: jax.Array,
    update_red: bool,
):
    """4-neighbor sum with explicit halos on ALL four sides (2-D sharding).

    ``left_col``/``right_col`` have shape (..., R, 1): the compact columns
    j2-1 / j2+1 adjacent to this shard (ppermute'd neighbors, wrap columns,
    or zeros at open boundaries — a zero halo contributes nothing, so no
    in-kernel edge masking is needed). Row parity logic is column-offset
    independent, so any even column split of the lattice works.
    """
    R = other.shape[-2]
    row_is_even = (jnp.arange(R) % 2 == 0)[:, None]

    up = jnp.concatenate([up_row, other[..., :-1, :]], axis=-2)
    down = jnp.concatenate([other[..., 1:, :], down_row], axis=-2)
    left_shift = jnp.concatenate([left_col, other[..., :, :-1]], axis=-1)
    right_shift = jnp.concatenate([other[..., :, 1:], right_col], axis=-1)

    if update_red:
        horiz = jnp.where(row_is_even, left_shift + other, other + right_shift)
    else:
        horiz = jnp.where(row_is_even, other + right_shift, left_shift + other)
    return up + down + horiz


def halfstep_with_halo2d(
    key, other, up_row, down_row, left_col, right_col, update_red,
    temperature, J, field,
):
    """Heat-bath resample with four-sided halos (2-D sharded shards)."""
    nbr = neighbor_sum_half_halo2d(
        other, up_row, down_row, left_col, right_col, update_red
    )
    p_up = jax.nn.sigmoid(2.0 * (J * nbr + field) / temperature)
    u = jax.random.uniform(key, other.shape)
    return jnp.where(u < p_up, 1.0, -1.0).astype(other.dtype)


def wrap_halos(plane: jax.Array, periodic: bool):
    """Single-device vertical halo rows: periodic wrap or zeros (open)."""
    if periodic:
        return plane[..., -1:, :], plane[..., :1, :]
    z = jnp.zeros_like(plane[..., :1, :])
    return z, z


def neighbor_sum_half(other: jax.Array, update_red: bool, periodic: bool):
    """Single-device neighbor sum (wrapped or open boundaries)."""
    up_row, down_row = wrap_halos(other, periodic)
    return neighbor_sum_half_halo(other, up_row, down_row, update_red, periodic)


def halfstep_with_halo(
    key, other, up_row, down_row, update_red, temperature, J, field, periodic_cols
):
    """Heat-bath resample of one color plane given the other + halo rows."""
    nbr = neighbor_sum_half_halo(other, up_row, down_row, update_red, periodic_cols)
    local = J * nbr + field
    p_up = jax.nn.sigmoid(2.0 * local / temperature)
    u = jax.random.uniform(key, other.shape)
    return jnp.where(u < p_up, 1.0, -1.0).astype(other.dtype)


def _halfstep(key, mine, other, update_red, temperature, J, field, periodic):
    """Heat-bath resample of one color plane given the other (single device)."""
    up_row, down_row = wrap_halos(other, periodic)
    return halfstep_with_halo(
        key, other, up_row, down_row, update_red, temperature, J, field, periodic
    )


@partial(jax.jit, static_argnames=("n_sweeps", "periodic"))
def checkerboard_sweeps_planes(
    key, red, black, temperature, n_sweeps: int, *, J=1.0, field=0.0, periodic=True
):
    """n_sweeps full red/black sweeps on compact planes; returns (red, black).

    ``temperature``: a scalar, or an (n_sweeps,) per-sweep SCHEDULE
    (annealing)."""
    temps = jnp.broadcast_to(
        jnp.asarray(temperature, jnp.float32).reshape(-1), (n_sweeps,)
    )

    def body(carry, inp):
        red, black = carry
        k, T = inp
        k_r, k_b = jax.random.split(k)
        red = _halfstep(k_r, red, black, True, T, J, field, periodic)
        black = _halfstep(k_b, black, red, False, T, J, field, periodic)
        return (red, black), None

    (red, black), _ = jax.lax.scan(
        body, (red, black), (jax.random.split(key, n_sweeps), temps)
    )
    return red, black


@partial(jax.jit, static_argnames=("n_sweeps", "periodic"))
def checkerboard_sweeps(
    key, lattice, temperature, n_sweeps: int, *, J=1.0, field=0.0, periodic=True
):
    """n_sweeps full checkerboard sweeps on a (R, C) spin lattice."""
    red, black = split_checkerboard(lattice)
    red, black = checkerboard_sweeps_planes(
        key, red, black, temperature, n_sweeps, J=J, field=field, periodic=periodic
    )
    return merge_checkerboard(red, black)


@partial(jax.jit, static_argnames=("periodic",))
def lattice_energy_batch(lattice, *, J=1.0, field=0.0, periodic=True):
    """Stencil Ising energy over (..., R, C); reduces the trailing 2 axes."""
    s = lattice
    if periodic:
        bond = jnp.sum(s * jnp.roll(s, -1, -1), axis=(-2, -1)) + jnp.sum(
            s * jnp.roll(s, -1, -2), axis=(-2, -1)
        )
    else:
        bond = jnp.sum(s[..., :, :-1] * s[..., :, 1:], axis=(-2, -1)) + jnp.sum(
            s[..., :-1, :] * s[..., 1:, :], axis=(-2, -1)
        )
    return -J * bond - field * jnp.sum(s, axis=(-2, -1))


@partial(
    jax.jit,
    static_argnames=("n_samples", "n_burnin", "n_sweeps", "periodic", "collect"),
)
def sample_lattice(
    key,
    lattice0,
    *,
    n_samples: int,
    temperature,
    J=1.0,
    field=0.0,
    n_burnin: int = 100,
    n_sweeps: int = 1,
    periodic: bool = True,
    collect: str = "states",
):
    """Boltzmann-sample a 2-D lattice with checkerboard Gibbs.

    collect="states": returns (n_samples, R, C) spin configurations.
    collect="observables": returns dict of per-sample M and E only (for large
        lattices where materializing samples would blow HBM).
    """
    red, black = split_checkerboard(lattice0)
    k_burn, k_main = jax.random.split(key)
    red, black = checkerboard_sweeps_planes(
        k_burn, red, black, temperature, n_burnin, J=J, field=field, periodic=periodic
    )

    R, C = lattice0.shape
    n_sites = R * C

    def step(carry, k):
        red, black = carry
        red, black = checkerboard_sweeps_planes(
            k, red, black, temperature, n_sweeps, J=J, field=field, periodic=periodic
        )
        if collect == "states":
            return (red, black), merge_checkerboard(red, black)
        lat = merge_checkerboard(red, black)
        m = jnp.sum(lat) / n_sites
        e = lattice_energy_batch(lat, J=J, field=field, periodic=periodic)
        return (red, black), (m, e)

    (red, black), out = jax.lax.scan(
        step, (red, black), jax.random.split(k_main, n_samples)
    )
    if collect == "states":
        return out
    m, e = out
    return {"magnetization": m, "energy": e}

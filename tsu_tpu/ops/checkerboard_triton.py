"""Checkerboard heat-bath half-sweep kernel for NVIDIA GPUs (Pallas, Triton route).

One launch resamples one colour of a batch of lattices in the compact
(B, R, C/2) layout of tsu_tpu/ops/checkerboard.py. Each Triton block owns a
(BR, BC) tile of the plane being written and, per site:

    4 neighbour loads of the other plane (halo rows come from the caller's
    ``up_rows``/``down_rows``, the column wrap is index arithmetic)
    -> integer local field (uniform stencil, or +-J from a 1-byte bond code)
    -> Philox-4x32-10 keyed by (seed, sweep, global row, column, lattice)
    -> integer compare against a 9-entry threshold table -> spin store.

Nothing but the spins (and the codes) crosses device memory: no uniform
plane and no per-site transcendental. Spins may be stored as int8, so a
full sweep moves ~2 B/site (uniform) or ~3 B/site (+-J codes).

The generator is keyed by the GLOBAL site, so a row-sharded lattice
(``row_offset``) draws the same bits as the unsharded one, and the
plain-jnp twin :func:`philox4x32` / :func:`halfsweep_reference` reproduces
the kernel bit for bit. ``u24=`` injects uniforms instead, so the kernel's
arithmetic can be compared exactly with the XLA engine's.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from tsu_tpu.ops.checkerboard import neighbor_sum_half_halo

# Philox-4x32 multipliers and Weyl key increments (Salmon et al., SC'11).
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
PHILOX_ROUNDS = 10

# Largest tile of one Triton block, rows x compact columns, and its warps:
# on an H100 the (8, 256) tile was as fast as any of six shapes tried
# (PERF.md).
BLOCK = (8, 256)
NUM_WARPS = 4


def _i32(v: int):
    """A uint32 bit pattern as an int32 constant. The generator runs on
    int32 words (wrapping products, logical shifts): the Triton lowering
    does not mix unsigned constants with converted tensors."""
    return jnp.int32(v - (1 << 32) if v >= 1 << 31 else v)


def _shr(x, n: int):
    return jax.lax.shift_right_logical(x, jnp.int32(n))


def _mulhi_split(a, m: int):
    """High 32 bits of the 64-bit unsigned product a * m from 16-bit
    halves (JAX without x64 has no 64-bit product)."""
    a_lo, a_hi = a & jnp.int32(0xFFFF), _shr(a, 16)
    m_lo, m_hi = jnp.int32(m & 0xFFFF), jnp.int32(m >> 16)
    t = a_lo * m_lo
    u = a_hi * m_lo + _shr(t, 16)
    w = a_lo * m_hi + (u & jnp.int32(0xFFFF))
    return a_hi * m_hi + _shr(u, 16) + _shr(w, 16)


def _mulhi_ptx(a, m: int):
    """The same high word as :func:`_mulhi_split` in one PTX instruction."""
    (hi,) = plgpu.elementwise_inline_asm(
        f"mul.hi.u32 $0, $1, {m};",
        args=[a], constraints="=r,r", pack=1,
        result_shape_dtypes=[jax.ShapeDtypeStruct(a.shape, jnp.int32)],
    )
    return hi


def philox4x32(c0, c1, c2, c3, k0, k1, *, mulhi=_mulhi_split):
    """Philox-4x32-10 on int32 words holding uint32 bit patterns: counters
    (c0..c3) and key (k0, k1).

    The plain-jnp twin of the kernel's generator (``mulhi`` is swapped for
    one PTX instruction inside the kernel on the card). Returns the four
    output words as int32 bit patterns."""
    k0 = jnp.asarray(k0, jnp.int32)
    k1 = jnp.asarray(k1, jnp.int32)
    for rnd in range(PHILOX_ROUNDS):
        if rnd:
            k0 = k0 + _i32(_W0)
            k1 = k1 + _i32(_W1)
        hi0, lo0 = mulhi(c0, _M0), c0 * _i32(_M0)
        hi1, lo1 = mulhi(c2, _M1), c2 * _i32(_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def key_words(key) -> jax.Array:
    """(2,) int32 Philox key drawn from a JAX PRNG key."""
    return jax.lax.bitcast_convert_type(
        jax.random.bits(key, (2,), jnp.uint32), jnp.int32)


def sigmoid_table(J, field, temperature) -> jax.Array:
    """(..., 9) int32 heat-bath thresholds for neighbour sums -4..4.

    Entry k is round-down(sigmoid(2 (J (k-4) + field) / T) * 2^24): a site
    turns up when its 24-bit uniform is below it. ``temperature`` may carry
    leading batch axes."""
    T = jnp.asarray(temperature, jnp.float32)[..., None]
    k = jnp.arange(-4, 5, dtype=jnp.float32)
    p = jax.nn.sigmoid(2.0 * (J * k + field) / T)
    return jnp.clip(p * 16777216.0, 0, 16777215).astype(jnp.int32)


def site_uniforms(key2, sweep, update_red: bool, shape, *, row_offset=0,
                  lattice_offset=0) -> jax.Array:
    """(B, R, C2) int32 uniforms in [0, 2^24) that the kernel draws for one
    half-sweep, from the jnp twin of its generator."""
    B, R, C2 = shape
    k = jnp.asarray(key2, jnp.int32)
    b = (jnp.arange(B, dtype=jnp.int32) + lattice_offset)[:, None, None]
    r = (jnp.arange(R, dtype=jnp.int32) + row_offset)[None, :, None]
    c = jnp.arange(C2, dtype=jnp.int32)[None, None, :]
    full = lambda v: jnp.broadcast_to(jnp.asarray(v, jnp.int32), shape)
    x0, x1, _, _ = philox4x32(full(c), full(r), full(sweep), full(b), k[0],
                              k[1])
    return _shr(x0 if update_red else x1, 8)


def decode_codes(codes):
    """(w_up, w_down, w_left, w_right) int32 planes from packed bond codes
    (ops/checkerboard_bonds.pack_bond_codes); also the kernel's decode."""
    c = codes.astype(jnp.int32)
    return tuple(((c >> s) & 3) - 1 for s in (0, 2, 4, 6))


def _scalars(key2, sweep, row_offset, lattice_offset):
    """The kernels' (5,) int32 scalar operand: key, sweep, row and lattice
    offsets."""
    key2 = jnp.asarray(key2, jnp.int32)
    return jnp.stack([key2[0], key2[1], jnp.asarray(sweep, jnp.int32),
                      jnp.asarray(row_offset, jnp.int32),
                      jnp.asarray(lattice_offset, jnp.int32)])


def pick_block(R: int, C2: int):
    """(BR, BC) tile dividing the (R, C2) plane: powers of two up to
    :data:`BLOCK` (Triton blocks are powers of two; dividing tiles keep
    every lane in range, so no store is masked)."""
    pow2 = lambda n, cap: min(cap, n & -n)
    return pow2(R, BLOCK[0]), pow2(C2, BLOCK[1])


def _halfsweep_kernel(scal_ref, table_ref, other_ref, up_ref, down_ref, *rest,
                      update_red, periodic, packed, injected, block, asm):
    rest = list(rest)
    code_ref = rest.pop(0) if packed else None
    u_ref = rest.pop(0) if injected else None
    (out_ref,) = rest
    BR, BC = block
    _, R, C2 = other_ref.shape
    b = pl.program_id(2)
    r = pl.program_id(0) * BR + jax.lax.broadcasted_iota(jnp.int32, block, 0)
    c = pl.program_id(1) * BC + jax.lax.broadcasted_iota(jnp.int32, block, 1)
    grow = scal_ref[3] + r
    row_even = grow % 2 == 0

    def load(ref, rows, cols, mask=None):
        return plgpu.load(ref.at[b, rows, cols], mask=mask,
                          other=None if mask is None else 0
                          ).astype(jnp.int32)

    zero = jnp.zeros(block, jnp.int32)
    center = load(other_ref, r, c)
    # Rows 0 and R-1 take their vertical neighbour from the halo rows;
    # masked-off lanes still form (unused, clamped) addresses.
    up = (load(other_ref, jnp.maximum(r - 1, 0), c, r > 0)
          + load(up_ref, zero, c, r == 0))
    down = (load(other_ref, jnp.minimum(r + 1, R - 1), c, r < R - 1)
            + load(down_ref, zero, c, r == R - 1))
    # Compact layout: the horizontal neighbours are this column and one
    # to its left or right, by row parity and colour.
    shift_left = row_even if update_red else jnp.logical_not(row_even)
    side_c = jnp.where(shift_left, c - 1, c + 1)
    if periodic:
        side = load(other_ref, r, jnp.where(
            side_c < 0, C2 - 1, jnp.where(side_c >= C2, 0, side_c)))
    else:
        side = load(other_ref, r, jnp.clip(side_c, 0, C2 - 1),
                    (side_c >= 0) & (side_c < C2))

    if packed:
        wu, wd, wl, wr = decode_codes(plgpu.load(code_ref.at[r, c]))
        left = jnp.where(shift_left, side, center)
        right = jnp.where(shift_left, center, side)
        local = wu * up + wd * down + wl * left + wr * right
    else:
        local = up + down + center + side
    thresh = table_ref[b, local + 4]

    if injected:
        u24 = plgpu.load(u_ref.at[b, r, c])
    else:
        u24 = _site_uniforms(scal_ref, b, grow, c, update_red, asm)
    spin = jnp.where(u24 < thresh, 1, -1).astype(out_ref.dtype)
    plgpu.store(out_ref.at[b, r, c], spin)


def _site_uniforms(scal_ref, b, grow, c, update_red: bool, asm: bool):
    """In-kernel twin of :func:`site_uniforms` for one tile: counter
    (column, global row, sweep, lattice), key (scal[0], scal[1])."""
    full = lambda v: jnp.full(c.shape, v, jnp.int32)
    x0, x1, _, _ = philox4x32(
        c, grow, full(scal_ref[2]), full(scal_ref[4] + b),
        scal_ref[0], scal_ref[1],
        mulhi=_mulhi_ptx if asm else _mulhi_split)
    return _shr(x0 if update_red else x1, 8)


def _generator_kernel(scal_ref, out_ref, *, block, asm):
    BR, BC = block
    b = pl.program_id(2)
    r = pl.program_id(0) * BR + jax.lax.broadcasted_iota(jnp.int32, block, 0)
    c = pl.program_id(1) * BC + jax.lax.broadcasted_iota(jnp.int32, block, 1)
    for color in (0, 1):
        plgpu.store(out_ref.at[color, b, r, c],
                    _site_uniforms(scal_ref, b, scal_ref[3] + r, c,
                                   color == 0, asm))


@partial(jax.jit, static_argnames=("shape", "interpret"))
def generator_uniforms(key2, sweep, shape, *, row_offset=0, lattice_offset=0,
                       interpret: bool = False):
    """(2, B, R, C2) uniforms the half-sweep kernel draws ([0] red, [1]
    black), written by the kernel's own generator code: on the card they
    must equal :func:`site_uniforms` bit for bit."""
    B, R, C2 = shape
    block = pick_block(R, C2)
    scal = _scalars(key2, sweep, row_offset, lattice_offset)
    return pl.pallas_call(
        partial(_generator_kernel, block=block, asm=not interpret),
        out_shape=jax.ShapeDtypeStruct((2, B, R, C2), jnp.int32),
        grid=(R // block[0], C2 // block[1], B),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="checkerboard_generator",
    )(scal)


@partial(jax.jit, static_argnames=("update_red", "periodic", "interpret"))
def halfsweep(key2, sweep, tables, other, up_rows, down_rows, *,
              update_red: bool, periodic: bool, codes=None, u24=None,
              row_offset=0, lattice_offset=0, interpret: bool = False):
    """Resample one colour of a batch of lattices given the other colour.

    Args:
        key2: (2,) int32 Philox key.
        sweep: int32 sweep counter (part of the generator's counter).
        tables: (B, 9) int32 thresholds (:func:`sigmoid_table`), one row per
            lattice.
        other: (B, R, C2) opposite-colour plane (int8, bf16 or f32 spins).
        up_rows / down_rows: (B, 1, C2) vertical neighbours of rows 0 and
            R-1: the wrap rows, a neighbour shard's rows, or zeros (open).
        periodic: horizontal wrap (open lattices mask the edge columns).
        codes: optional (R, C2) uint8 bond codes shared by the batch (the
            +-J contract); None is the uniform stencil.
        u24: optional (B, R, C2) int32 uniforms replacing the generator.
        row_offset / lattice_offset: global index of row 0 / lattice 0.
    Returns the new (B, R, C2) plane in ``other``'s dtype.
    """
    B, R, C2 = other.shape
    BR, BC = block = pick_block(R, C2)
    inputs = [_scalars(key2, sweep, row_offset, lattice_offset),
              jnp.asarray(tables, jnp.int32), other,
              up_rows.astype(other.dtype), down_rows.astype(other.dtype)]
    if codes is not None:
        inputs.append(jnp.asarray(codes, jnp.uint8))
    if u24 is not None:
        inputs.append(jnp.asarray(u24, jnp.int32))
    kernel = partial(_halfsweep_kernel, update_red=update_red,
                     periodic=periodic, packed=codes is not None,
                     injected=u24 is not None, block=block,
                     asm=not interpret)
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(other.shape, other.dtype),
        grid=(R // BR, C2 // BC, B),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="checkerboard_halfsweep",
    )(*inputs)


def wrap_rows(plane, periodic: bool):
    """Single-device halo rows of (B, R, C2) planes: wrap rows or zeros."""
    if periodic:
        return plane[:, -1:, :], plane[:, :1, :]
    z = jnp.zeros_like(plane[:, :1, :])
    return z, z


def _temperature_rows(temperature, n_sweeps: int, B: int):
    """(n_sweeps, B) temperatures from a scalar, a (B,) per-lattice vector
    or an (n_sweeps, B) / (n_sweeps, 1) schedule."""
    T = jnp.asarray(temperature, jnp.float32)
    if T.ndim <= 1:
        T = T.reshape(1, -1)
    return jnp.broadcast_to(T, (n_sweeps, B))


@partial(jax.jit, static_argnames=("n_sweeps", "J", "field", "periodic",
                                   "interpret"))
def sweeps(key2, reds, blacks, temperature, n_sweeps: int, *, J: float = 1.0,
           field: float = 0.0, periodic: bool = True, codes=None,
           sweep_offset=0, uniforms=None, interpret: bool = False):
    """``n_sweeps`` red-then-black sweeps of (B, R, C2) planes.

    ``temperature``: scalar, (B,), or an (n_sweeps, B) / (n_sweeps, 1)
    schedule. ``codes``: None (uniform J, field) or the pair
    ``{"red": (R, C2), "black": (R, C2)}`` of uint8 +-J codes (J=1, zero
    field by contract). Sweep s draws with counter ``sweep_offset + s``.
    ``uniforms``: optional (n_sweeps, 2, B, R, C2) int32 injected uniforms.
    """
    B = reds.shape[0]
    temps = _temperature_rows(temperature, n_sweeps, B)
    if codes is not None:
        J, field = 1.0, 0.0

    def body(carry, inp):
        reds, blacks = carry
        s, T, u = inp
        tables = sigmoid_table(J, field, T)
        common = dict(periodic=periodic, interpret=interpret)
        up, down = wrap_rows(blacks, periodic)
        reds = halfsweep(key2, sweep_offset + s, tables, blacks, up, down,
                         update_red=True,
                         codes=None if codes is None else codes["red"],
                         u24=None if u is None else u[0], **common)
        up, down = wrap_rows(reds, periodic)
        blacks = halfsweep(key2, sweep_offset + s, tables, reds, up, down,
                           update_red=False,
                           codes=None if codes is None else codes["black"],
                           u24=None if u is None else u[1], **common)
        return (reds, blacks), None

    xs = (jnp.arange(n_sweeps, dtype=jnp.int32), temps, uniforms)
    (reds, blacks), _ = jax.lax.scan(body, (reds, blacks), xs)
    return reds, blacks


def halfsweep_reference(tables, other, up_rows, down_rows, u24, *,
                        update_red: bool, periodic: bool, codes=None):
    """Plain-jnp twin of :func:`halfsweep` (same arguments, uniforms given):
    the XLA engine's neighbour sums with the kernel's threshold rule."""
    other = other.astype(jnp.int32)
    up_rows = up_rows.astype(jnp.int32)
    down_rows = down_rows.astype(jnp.int32)
    if codes is None:
        local = neighbor_sum_half_halo(other, up_rows, down_rows, update_red,
                                       periodic)
    else:
        from tsu_tpu.ops.checkerboard_bonds import _neighbor_values

        up, down, left, right = _neighbor_values(other, up_rows, down_rows,
                                                 update_red)
        wu, wd, wl, wr = decode_codes(codes)
        local = wu * up + wd * down + wl * left + wr * right
    thresh = jnp.take_along_axis(
        tables[:, None, :], (local + 4).reshape(local.shape[0], 1, -1),
        axis=2).reshape(local.shape)
    return jnp.where(u24 < thresh, 1, -1)


def sweeps_reference(key2, reds, blacks, temperature, n_sweeps: int, *,
                     J: float = 1.0, field: float = 0.0,
                     periodic: bool = True, codes=None, sweep_offset=0):
    """Plain-jnp twin of :func:`sweeps` with the generator's own bits: the
    kernel must reproduce it exactly."""
    B, R, C2 = reds.shape
    temps = _temperature_rows(temperature, n_sweeps, B)
    if codes is not None:
        J, field = 1.0, 0.0
    for s in range(n_sweeps):
        tables = sigmoid_table(J, field, temps[s])
        for update_red in (True, False):
            other = blacks if update_red else reds
            up, down = wrap_rows(other, periodic)
            u = site_uniforms(key2, sweep_offset + s, update_red, (B, R, C2))
            new = halfsweep_reference(
                tables, other, up, down, u, update_red=update_red,
                periodic=periodic,
                codes=None if codes is None else
                codes["red" if update_red else "black"],
            ).astype(reds.dtype)
            if update_red:
                reds = new
            else:
                blacks = new
    return reds, blacks

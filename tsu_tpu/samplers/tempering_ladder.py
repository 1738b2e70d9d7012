"""Temperature-ladder engineering for parallel tempering at lattice scale.

The swap acceptance between adjacent rungs scales like
exp(-dbeta * dE) with dE EXTENSIVE in the number of sites, so a ladder
that exchanges healthily at 8x8 accepts nothing at 256^2 (measured,
r4): production PT needs the rung spacing engineered to the system, not
guessed. The reference has no ladder construction at all — its PT takes a
user temperature list and runs (tsu/gibbs.py:238-338); at its <=50-spin
dense scale any ladder works, which is exactly why the gap only shows up
at the lattice sizes this framework targets.

Two mechanisms, composed by :func:`build_tempering_ladder`:

1. **Variance-matched initialization** (Kofke-style): a short pilot run
   measures the energy mean U(beta) and variance sigma^2(beta) on a coarse
   beta grid; assuming locally Gaussian energy distributions, the expected
   swap acceptance of a pair (beta, beta + dbeta) has the closed form

       E[min(1, e^D)] = Phi(mu/sig) + exp(mu + sig^2/2) Phi(-mu/sig - sig),
       D ~ N(mu, sig^2),  mu = dbeta (U(beta') - U(beta)),
       sig^2 = dbeta^2 (sigma^2(beta) + sigma^2(beta')),

   and rung spacing is chosen by root-finding that expression against the
   target acceptance — this is what makes spacing shrink like
   1/sqrt(n_sites) automatically (sigma_E ~ sqrt(N)).
2. **Feedback refinement**: short PT runs measure the *actual* per-pair
   acceptance (tempering._swap_permutation reports pairwise counts) and
   split any pair below the floor. This corrects where the pilot lies —
   chiefly at low temperature, where a quenched pilot under-measures the
   equilibrium energy variance of a glassy phase.

:func:`pt_ground_state_search` then drives the engineered ladder for
spin-glass ground-state search: every rung advances through ONE batched
sweep launch per half-sweep (ops/checkerboard_triton on the +-J contract),
the best energy per replica slot is tracked on device, and a final batched
low-temperature quench descends every slot's best state into its local
minimum. The hot loops carry compact checkerboard PLANES (int8 on the
kernel route) and evaluate energies in plane space
(ops/checkerboard_bonds.lattice_energy_bonds_planes) — no per-iteration
split/merge or dtype round-trips. Checkpoint/resume via tsu_tpu.checkpoint
hooks into the chunked scan (SURVEY.md §5.4).
"""

from __future__ import annotations

import math
import os
from functools import partial
from typing import Callable, Dict, Tuple

import jax
import jax.numpy as jnp

import numpy as np

from scipy.special import erfcinv, log_ndtr, ndtr

from tsu_tpu.samplers.tempering import _BondPlaneOps, _swap_permutation


def predict_swap_acceptance(beta1: float, beta2: float,
                            U: Callable[[float], float],
                            var: Callable[[float], float]) -> float:
    """Expected Metropolis swap acceptance for rungs at beta1 < beta2 under
    the Gaussian energy approximation (module docstring, mechanism 1)."""
    db = float(beta2 - beta1)
    if db <= 0.0:
        return 1.0
    mu = db * (U(beta2) - U(beta1))  # <= 0: colder rung has lower mean E
    sig = db * math.sqrt(max(var(beta1) + var(beta2), 0.0))
    if sig < 1e-12:
        return min(1.0, math.exp(min(mu, 0.0)))
    z = mu / sig
    # Second term fully in log space: mu + sig^2/2 overflows exp() long
    # before the product with Phi(-z - sig) stops being finite.
    log_term2 = mu + 0.5 * sig * sig + float(log_ndtr(-z - sig))
    return float(min(1.0, ndtr(z) + math.exp(min(log_term2, 50.0))))


def measure_energy_stats(
    key,
    Jh,
    Jv,
    betas,
    *,
    field: float = 0.0,
    periodic: bool = True,
    use_pallas: bool | None = None,
    n_burnin: int = 128,
    n_measure: int = 128,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pilot (mean, variance) of the energy at each inverse temperature.

    One batched run: replica i anneals from the hottest pilot temperature
    down to its own target over ``n_burnin`` sweeps (a cold replica quenched
    straight from a random start would freeze into an atypical state), then
    ``n_measure`` single-sweep measurements accumulate the moments.
    """
    betas = np.asarray(betas, np.float64)
    temps = (1.0 / betas).astype(np.float32)
    B = betas.shape[0]
    rows, cols = np.asarray(Jh).shape
    ops = _BondPlaneOps(Jh, Jv, field=field, periodic=periodic,
                        use_pallas=use_pallas)

    T_max = float(temps.max())
    frac = (np.arange(1, n_burnin + 1, dtype=np.float64) / n_burnin)
    # (n_burnin, B): geometric path T_max -> T_i for every replica.
    burn_temps = jnp.asarray(
        (T_max ** (1.0 - frac[:, None])) * (betas[None, :] ** -frac[:, None]),
        jnp.float32,
    )
    temps_j = jnp.asarray(temps)

    k_init, k_burn, k_meas = jax.random.split(key, 3)

    @jax.jit
    def run(planes, kb, km):
        def burn(carry, inp):
            t_row, k = inp
            reds, blacks = carry
            return ops.sweep_planes(k, reds, blacks, t_row, 1), None

        planes, _ = jax.lax.scan(
            burn, planes, (burn_temps, jax.random.split(kb, n_burnin)))

        def meas(carry, k):
            reds, blacks = ops.sweep_planes(k, *carry, temps_j, 1)
            return (reds, blacks), ops.energy_planes(reds, blacks)

        planes, es = jax.lax.scan(
            meas, planes, jax.random.split(km, n_measure))
        return es  # (n_measure, B)

    planes0 = ops.init_planes(k_init, B, rows, cols)
    es = np.asarray(run(planes0, k_burn, k_meas), np.float64)
    return es.mean(axis=0), es.var(axis=0)


def _ladder_from_stats(betas_pilot, U_pilot, var_pilot, *,
                       beta_min: float, beta_max: float, target: float,
                       max_rungs: int, dbeta_cap: float,
                       var_floor_frac: float = 1e-3):
    """Hot-to-cold rung placement by root-finding the Gaussian acceptance.

    Returns (betas ascending hot->cold, the (U, V) interpolants — so the
    caller can re-predict acceptance for a refined ladder — and the capped
    flag). The variance floor keeps a frozen pilot point (measured var ~ 0
    at low T) from licensing an absurd spacing; the cap bounds any single
    step to a fraction of the whole range for the same reason.
    """
    x = np.asarray(betas_pilot, np.float64)
    var_floor = max(1e-12, var_floor_frac * float(np.max(var_pilot)))
    Uv = np.asarray(U_pilot, np.float64)
    Vv = np.maximum(np.asarray(var_pilot, np.float64), var_floor)

    def U(b):
        return float(np.interp(b, x, Uv))

    def V(b):
        return float(np.interp(b, x, Vv))

    ladder = [float(beta_min)]
    capped = False
    while ladder[-1] < beta_max - 1e-12:
        # Reserve one slot for the forced beta_max endpoint so the cap is
        # a true maximum (review r5: the old check allowed max_rungs + 1).
        if len(ladder) >= max_rungs - 1:
            capped = True
            break
        b = ladder[-1]
        hi = min(dbeta_cap, beta_max - b)
        if predict_swap_acceptance(b, b + hi, U, V) >= target:
            ladder.append(b + hi)
            continue
        lo = 0.0
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            if predict_swap_acceptance(b, b + mid, U, V) >= target:
                lo = mid
            else:
                hi = mid
        ladder.append(b + max(lo, 1e-9))
    if ladder[-1] < beta_max:
        ladder.append(float(beta_max))  # forced final rung when capped
    betas = np.asarray(ladder, np.float64)
    return betas, (U, V), capped


def _measure_pair_acceptance(key, ops: _BondPlaneOps, betas_build, *,
                             shape, n_iters, n_burnin, n_sweeps,
                             swap_interval, pad_multiple):
    """Short PT run -> measured acceptance per builder pair (hot->cold).

    The trial ladder is padded (duplicating the coldest rung) to a multiple
    of ``pad_multiple`` replicas so successive feedback rounds reuse
    compiled programs instead of paying a fresh compile per rung-count;
    pad pairs have dbeta = 0 (acceptance 1) and are sliced off.
    """
    R_real = len(betas_build)
    R = R_real if pad_multiple <= 1 else (
        -(-R_real // pad_multiple) * pad_multiple)
    betas_d = np.concatenate([
        betas_build[::-1], np.full(R - R_real, betas_build[-1])])
    # Driver convention: coldest first. The pads equal the coldest beta, so
    # sorting descending keeps them adjacent at the cold end.
    betas_d = np.sort(betas_d)[::-1].copy()
    temps = jnp.asarray(1.0 / betas_d, jnp.float32)
    betas_j = jnp.asarray(betas_d, jnp.float32)
    rows, cols = shape

    k_init, k_run = jax.random.split(key)
    total = n_burnin + n_iters

    @partial(jax.jit, static_argnames=("n",))
    def run(planes, k, n):
        def body(carry, t):
            reds, blacks, acc_p, att_p = carry
            k_sweep, k_swap = jax.random.split(jax.random.fold_in(k, t))
            reds, blacks = ops.sweep_planes(k_sweep, reds, blacks, temps,
                                            n_sweeps)
            e = ops.energy_planes(reds, blacks)

            def do_swap(args):
                reds, blacks, acc_p, att_p = args
                offset = (t // swap_interval) % 2
                perm, acc, att = _swap_permutation(k_swap, e, betas_j, offset)
                # Burn-in iterations advance and swap but do not count.
                w = jnp.int32(t >= n_burnin)
                return (reds[perm], blacks[perm],
                        acc_p + w * acc, att_p + w * att)

            carry = jax.lax.cond(
                (t + 1) % swap_interval == 0, do_swap, lambda a: a,
                (reds, blacks, acc_p, att_p))
            return carry, None

        zeros = jnp.zeros((R - 1,), jnp.int32)
        (reds, blacks, acc_p, att_p), _ = jax.lax.scan(
            body, (*planes, zeros, zeros), jnp.arange(n))
        return acc_p, att_p

    planes0 = ops.init_planes(k_init, R, rows, cols)
    acc_p, att_p = map(np.asarray, run(planes0, k_run, total))
    # Driver pair p (cold-first, pads at the cold end occupying slots
    # 0..R-R_real-1 with acceptance-1 pairs) -> builder pair q (hot-first):
    # real pairs sit at driver indices (R - R_real)..(R - 2).
    pad = R - R_real
    acc_real = acc_p[pad:]
    att_real = att_p[pad:]
    meas = acc_real / np.maximum(att_real, 1)
    return meas[::-1].copy(), att_real[::-1].copy()  # builder order


def build_tempering_ladder(
    key,
    Jh,
    Jv,
    *,
    T_min: float,
    T_max: float,
    target_acceptance: float = 0.3,
    accept_floor: float = 0.2,
    n_pilot: int = 16,
    pilot_burnin: int = 128,
    pilot_measure: int = 128,
    feedback_rounds: int = 3,
    feedback_iters: int = 96,
    feedback_burnin: int = 32,
    n_sweeps: int = 2,
    swap_interval: int = 1,
    max_rungs: int = 512,
    max_insert: int = 3,
    pad_multiple: int = 32,
    field: float = 0.0,
    periodic: bool = True,
    use_pallas: bool | None = None,
) -> Tuple[np.ndarray, Dict]:
    """Construct a PT temperature ladder hitting a target swap acceptance.

    Returns (temperatures ascending — ready for parallel_tempering_bonds /
    pt_ground_state_search — and a diagnostics dict). See the module
    docstring for the two mechanisms; ``accept_floor`` is the measured
    per-pair rate below which feedback splits a pair. The reference never
    had to solve this problem (its PT runs <=50-spin dense systems,
    tsu/gibbs.py:238-338); at 256^2+ it is the difference between a working
    replica exchange and a decorative one.
    """
    if not (0.0 < T_min < T_max):
        raise ValueError(f"need 0 < T_min < T_max, got {T_min}, {T_max}")
    from tsu_tpu.rng import as_key

    key = as_key(key)
    beta_min, beta_max = 1.0 / T_max, 1.0 / T_min
    rows, cols = np.asarray(Jh).shape
    ops = _BondPlaneOps(Jh, Jv, field=field, periodic=periodic,
                        use_pallas=use_pallas)

    k_pilot, key = jax.random.split(key)
    betas_pilot = np.geomspace(beta_min, beta_max, n_pilot)
    U_pilot, var_pilot = measure_energy_stats(
        k_pilot, Jh, Jv, betas_pilot, field=field, periodic=periodic,
        use_pallas=use_pallas, n_burnin=pilot_burnin,
        n_measure=pilot_measure)

    dbeta_cap = (beta_max - beta_min) / 8.0
    betas, (U_itp, V_itp), capped = _ladder_from_stats(
        betas_pilot, U_pilot, var_pilot, beta_min=beta_min,
        beta_max=beta_max, target=target_acceptance, max_rungs=max_rungs,
        dbeta_cap=dbeta_cap)

    measured = None
    attempts = None
    rounds_run = 0
    for r in range(feedback_rounds):
        k_fb, key = jax.random.split(key)
        measured, attempts = _measure_pair_acceptance(
            k_fb, ops, betas, shape=(rows, cols),
            n_iters=feedback_iters, n_burnin=feedback_burnin,
            n_sweeps=n_sweeps, swap_interval=swap_interval,
            pad_multiple=pad_multiple)
        rounds_run += 1
        bad = measured < accept_floor
        # The diagnostics must describe the RETURNED ladder, so the last
        # allowed round measures without splitting.
        if not bad.any() or r == feedback_rounds - 1:
            break
        if len(betas) >= max_rungs:
            capped = True
            break
        # Split each failing pair: the local model acceptance ~ erfc(c dbeta)
        # gives the refinement ratio from the measured value; zero-accept
        # pairs clamp at the resolution of the attempt count.
        new = [betas[0]]
        for q in range(len(betas) - 1):
            if bad[q]:
                a_meas = max(float(measured[q]),
                             0.5 / max(int(attempts[q]), 1))
                ratio = float(erfcinv(min(a_meas, 0.999))
                              / erfcinv(min(max(target_acceptance, 1e-3),
                                            0.999)))
                k_ins = min(max_insert, max(1, math.ceil(ratio) - 1))
                # Never let the rung budget drop an endpoint: clamp at 0
                # extra points, keeping betas[q + 1] itself.
                k_ins = max(0, min(
                    k_ins,
                    max_rungs - len(new) - (len(betas) - 1 - q)))
                pts = np.linspace(betas[q], betas[q + 1], k_ins + 2)[1:]
            else:
                pts = [betas[q + 1]]
            new.extend(pts)
        betas = np.asarray(new, np.float64)

    temperatures = np.sort(1.0 / betas).astype(np.float32)
    # Diagnostics all describe the RETURNED ladder in ONE convention:
    # cold-first (matching ``temperatures`` ascending), with the Gaussian
    # prediction recomputed for the final post-feedback rungs so lengths
    # always line up (review r5: the pre-feedback prediction misaligned
    # with the refined ladder, and betas was hot-first while the measured
    # rates were cold-first).
    betas_cold_first = np.sort(betas)[::-1].copy()
    pred_final = np.asarray([
        predict_swap_acceptance(b2, b1, U_itp, V_itp)
        for b1, b2 in zip(betas_cold_first[:-1], betas_cold_first[1:])
    ])
    info = {
        "n_rungs": len(temperatures),
        "betas": betas_cold_first,
        "pilot_betas": betas_pilot,
        "pilot_energy_mean": U_pilot,
        "pilot_energy_var": var_pilot,
        "predicted_acceptance": pred_final,
        "measured_pair_acceptance": (
            None if measured is None else measured[::-1].copy()),
        "measured_pair_attempts": (
            None if attempts is None else attempts[::-1].copy()),
        "feedback_rounds_run": rounds_run,
        "capped": capped,
        "target_acceptance": target_acceptance,
        "accept_floor": accept_floor,
    }
    return temperatures, info


def _neighbor_or(other_mask, update_red: bool, periodic: bool):
    """4-neighbor OR across the checkerboard bipartition: the neighbors of
    one color's sites all live on the other color's plane, so cluster
    growth alternates colors using the same shift pattern as the sweep.
    Unlike the sweep (where zeroed WEIGHT planes realize open boundaries),
    a boolean mask has no weights, so the horizontal roll-wraps must be
    masked out here explicitly when the lattice is open."""
    R, C2 = other_mask.shape[-2:]
    row_is_even = (jnp.arange(R) % 2 == 0)[:, None]
    pick = row_is_even if update_red else ~row_is_even
    if periodic:
        up_row, down_row = other_mask[..., -1:, :], other_mask[..., :1, :]
    else:
        z = jnp.zeros_like(other_mask[..., :1, :])
        up_row, down_row = z, z
    up = jnp.concatenate([up_row, other_mask[..., :-1, :]], axis=-2)
    down = jnp.concatenate([other_mask[..., 1:, :], down_row], axis=-2)
    left_shift = jnp.roll(other_mask, 1, -1)
    right_shift = jnp.roll(other_mask, -1, -1)
    if not periodic:
        j = jnp.arange(C2)[None, :]
        # left_shift feeds only "picked" rows (global column even — their
        # left neighbor wraps at j == 0); right_shift only the others.
        left_shift = left_shift & (j != 0)
        right_shift = right_shift & (j != C2 - 1)
    left = jnp.where(pick, left_shift, other_mask)
    right = jnp.where(pick, other_mask, right_shift)
    return up | down | left | right


def houdayer_move(key, r1, b1, r2, b2, *, periodic: bool = True):
    """Houdayer isoenergetic cluster move on a batch of replica PAIRS.

    For each pair (same temperature, same bonds): compute the site overlap
    q_i = s^(1)_i s^(2)_i, pick a uniform random site with q_i = -1, grow
    the connected q = -1 cluster containing it (4-neighbor, via alternating
    red/black frontier propagation in compact plane space), and flip that
    cluster in BOTH replicas. Every boundary bond's two-replica energy
    contribution is J s1_j (s1_i + s2_i) = 0 both before and after the
    flip (q_i = -1 means s2_i = -s1_i), so E1 + E2 is conserved EXACTLY
    and the move is rejection-free — it teleports both replicas across
    energy barriers that single-spin flips cross in ~exp(dE/T) time. The
    classic accelerator for +-J spin glasses; the reference has nothing
    comparable (its PT is sequential dense-matrix Gibbs,
    tsu/gibbs.py:238-338). Pairs whose replicas agree everywhere are
    left unchanged.

    Inputs are compact color planes of shape (B, rows, cols/2) per
    replica; returns the four updated planes.
    """
    qr = (r1.astype(jnp.float32) * r2.astype(jnp.float32)) < 0
    qb = (b1.astype(jnp.float32) * b2.astype(jnp.float32)) < 0
    B = qr.shape[0]
    nred = qr.shape[-2] * qr.shape[-1]
    flat = jnp.concatenate(
        [qr.reshape(B, -1), qb.reshape(B, -1)], axis=1)
    any_neg = flat.any(axis=1)
    logits = jnp.where(flat, 0.0, -jnp.inf)
    # Fully-agreeing pairs get a dummy uniform seed; their flip is masked.
    logits = jnp.where(any_neg[:, None], logits, 0.0)
    idx = jax.random.categorical(key, logits, axis=1)  # (B,)
    iota = jnp.arange(nred)
    seed_red = ((idx[:, None] == iota[None, :])
                & (idx < nred)[:, None]).reshape(qr.shape)
    seed_black = (((idx - nred)[:, None] == iota[None, :])
                  & (idx >= nred)[:, None]).reshape(qb.shape)

    def body(state):
        m_red, m_black, _ = state
        new_red = m_red | (qr & _neighbor_or(m_black, True, periodic))
        new_black = m_black | (qb & _neighbor_or(new_red, False, periodic))
        changed = jnp.any(new_red != m_red) | jnp.any(new_black != m_black)
        return new_red, new_black, changed

    def cond(state):
        return state[2]

    m_red, m_black, _ = jax.lax.while_loop(
        cond, body, (seed_red & qr, seed_black & qb, jnp.bool_(True)))

    flip_ok = any_neg[:, None, None]
    fr = m_red & flip_ok
    fb = m_black & flip_ok
    return (jnp.where(fr, -r1, r1), jnp.where(fb, -b1, b1),
            jnp.where(fr, -r2, r2), jnp.where(fb, -b2, b2))


def pt_ground_state_search(
    key,
    Jh,
    Jv,
    *,
    temperatures,
    n_iters: int = 2000,
    n_sweeps: int = 1,
    swap_interval: int = 1,
    n_copies: int = 1,
    houdayer_every: int = 0,
    houdayer_frac: float = 0.5,
    field: float = 0.0,
    periodic: bool = True,
    use_pallas: bool | None = None,
    quench_sweeps: int = 64,
    quench_T_final: float = 0.02,
    chunk_iters: int | None = None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 1,
    resume: bool = False,
) -> Dict:
    """Parallel-tempering ground-state search over a bond realization.

    ``n_copies`` independent ladders run side by side in the same kernel
    batch (batch = n_copies * n_rungs replicas): independent restarts for
    ~the cost of better device utilization, each copy swapping only within
    its own ladder. With >= 2 copies, ``houdayer_every > 0`` additionally
    applies Houdayer isoenergetic cluster moves (:func:`houdayer_move`)
    every that many iterations to the coldest ``houdayer_frac`` of each
    rung's copy-pair — rejection-free barrier crossing that single-spin
    dynamics cannot reach (measured at 256^2: closes the last ~0.1% of
    the gap to the literature GS density that plain PT plateaus above).
    Every iteration advances all replicas ``n_sweeps``
    sweeps through the batched bond kernel, tracks the best energy seen per
    replica slot on device, and attempts adjacent swaps; afterwards every
    slot's best state descends through a batched low-temperature quench
    (heat-bath at T -> 0 is greedy alignment with the local field) and the
    global minimum is returned. Compare tsu/gibbs.py:238-338, which neither
    tracks a best state nor survives beyond toy sizes.

    ``checkpoint_path`` + ``checkpoint_every`` snapshot the full search
    state every N chunks (``chunk_iters`` iterations each);
    ``resume=True`` continues a killed run bit-identically (per-iteration
    keys are fold_in(key, t), so the stream is independent of chunking and
    the continuation replays exactly what the uninterrupted run would
    have done).
    """
    from tsu_tpu.rng import as_key

    key = as_key(key)
    temps_np = np.sort(np.asarray(temperatures, np.float32))
    R = len(temps_np)
    C = int(n_copies)
    B = C * R
    temps = jnp.asarray(np.tile(temps_np, C))
    betas = jnp.asarray(1.0 / temps_np, jnp.float32)
    rows, cols = np.asarray(Jh).shape
    ops = _BondPlaneOps(Jh, Jv, field=field, periodic=periodic,
                        use_pallas=use_pallas)

    if chunk_iters is None:
        # Always bounded: checkpointing needs chunk boundaries, and a
        # bounded program keeps each device execution short. The stream
        # is chunking-invariant, so this only affects launch granularity.
        chunk_iters = max(1, min(n_iters,
                                 500 if checkpoint_path else 3000))

    k_init, key = jax.random.split(key)
    reds, blacks = ops.init_planes(k_init, B, rows, cols)
    best_r, best_b = reds, blacks
    best_e = ops.energy_planes(reds, blacks)
    acc_p = jnp.zeros((max(R - 1, 0),), jnp.int32)
    att_p = jnp.zeros((max(R - 1, 0),), jnp.int32)
    done = 0

    if resume and checkpoint_path is not None:
        from tsu_tpu.checkpoint import restore_state

        ckpt_file = checkpoint_path if checkpoint_path.endswith(".npz") \
            else checkpoint_path + ".npz"
        if os.path.exists(ckpt_file) or os.path.exists(checkpoint_path):
            example = {"reds": reds, "blacks": blacks, "best_r": best_r,
                       "best_b": best_b, "best_e": best_e,
                       "acc_p": acc_p, "att_p": att_p, "done": jnp.int32(0)}
            st = restore_state(checkpoint_path, example)
            reds, blacks = jnp.asarray(st["reds"]), jnp.asarray(st["blacks"])
            best_r, best_b = (jnp.asarray(st["best_r"]),
                              jnp.asarray(st["best_b"]))
            best_e = jnp.asarray(st["best_e"])
            acc_p = jnp.asarray(st["acc_p"])
            att_p = jnp.asarray(st["att_p"])
            done = int(st["done"])

    def swap_all(k_swap, e, t):
        """Even/odd adjacent swaps within each copy's ladder: vmapped over
        copies, then lifted to a permutation of the flat batch."""
        offset = (t // swap_interval) % 2
        perm, acc, att = jax.vmap(
            lambda kk, ee: _swap_permutation(kk, ee, betas, offset)
        )(jax.random.split(k_swap, C), e.reshape(C, R))
        base = (jnp.arange(C) * R)[:, None]
        perm_flat = (perm + base).reshape(-1)
        return perm_flat, acc.sum(axis=0), att.sum(axis=0)

    n_pairs = C // 2
    hd_rungs = max(1, int(round(R * houdayer_frac)))
    use_houdayer = houdayer_every > 0 and n_pairs > 0

    def houdayer_all(k, reds, blacks):
        """Cluster moves for the coldest hd_rungs of every copy pair
        (copies 2k and 2k+1 at identical temperatures share a ladder
        layout, so rung j of both sits at the same T)."""
        rs = reds.reshape(C, R, *reds.shape[1:])
        bs = blacks.reshape(C, R, *blacks.shape[1:])
        sl = (slice(0, 2 * n_pairs, 2), slice(0, hd_rungs))
        sl2 = (slice(1, 2 * n_pairs, 2), slice(0, hd_rungs))
        shape_flat = (n_pairs * hd_rungs,) + reds.shape[1:]
        r1, b1, r2, b2 = houdayer_move(
            k,
            rs[sl].reshape(shape_flat), bs[sl].reshape(shape_flat),
            rs[sl2].reshape(shape_flat), bs[sl2].reshape(shape_flat),
            periodic=periodic)
        unflat = (n_pairs, hd_rungs) + reds.shape[1:]
        rs = rs.at[sl].set(r1.reshape(unflat)).at[sl2].set(r2.reshape(unflat))
        bs = bs.at[sl].set(b1.reshape(unflat)).at[sl2].set(b2.reshape(unflat))
        return (rs.reshape(B, *reds.shape[1:]),
                bs.reshape(B, *blacks.shape[1:]))

    @partial(jax.jit, static_argnames=("n",))
    def run_chunk(k, t0, reds, blacks, best_r, best_b, best_e, acc_p, att_p,
                  *, n):
        def body(carry, t):
            reds, blacks, best_r, best_b, best_e, acc_p, att_p = carry
            # Per-iteration key from the global iteration index: the random
            # stream is independent of how the run is chunked, so a resumed
            # run is bit-identical to an uninterrupted one at any chunk
            # size.
            k_sweep, k_swap, k_hd = jax.random.split(
                jax.random.fold_in(k, t), 3)
            reds, blacks = ops.sweep_planes(k_sweep, reds, blacks, temps,
                                            n_sweeps)
            e = ops.energy_planes(reds, blacks)
            better = e < best_e
            best_r = jnp.where(better[:, None, None], reds, best_r)
            best_b = jnp.where(better[:, None, None], blacks, best_b)
            best_e = jnp.minimum(e, best_e)

            def do_swap(args):
                reds, blacks, acc_p, att_p = args
                perm, acc, att = swap_all(k_swap, e, t)
                return reds[perm], blacks[perm], acc_p + acc, att_p + att

            reds, blacks, acc_p, att_p = jax.lax.cond(
                (t + 1) % swap_interval == 0, do_swap, lambda a: a,
                (reds, blacks, acc_p, att_p))
            if use_houdayer:
                reds, blacks = jax.lax.cond(
                    (t + 1) % houdayer_every == 0,
                    lambda rb: houdayer_all(k_hd, *rb), lambda rb: rb,
                    (reds, blacks))
            return (reds, blacks, best_r, best_b, best_e, acc_p, att_p), None

        carry = (reds, blacks, best_r, best_b, best_e, acc_p, att_p)
        carry, _ = jax.lax.scan(body, carry, t0 + jnp.arange(n))
        return carry

    chunks_done = 0
    while done < n_iters:
        n = min(chunk_iters, n_iters - done)
        reds, blacks, best_r, best_b, best_e, acc_p, att_p = run_chunk(
            key, jnp.int32(done), reds, blacks, best_r, best_b, best_e,
            acc_p, att_p, n=n)
        done += n
        chunks_done += 1
        if (checkpoint_path is not None and checkpoint_every > 0
                and (chunks_done % checkpoint_every == 0 or done >= n_iters)):
            from tsu_tpu.checkpoint import save_state

            save_state(checkpoint_path, {
                "reds": reds, "blacks": blacks, "best_r": best_r,
                "best_b": best_b, "best_e": best_e,
                "acc_p": acc_p, "att_p": att_p, "done": jnp.int32(done)})

    # Batched quench: every slot's best state descends to its local
    # minimum; B restarts for the price of one batched schedule.
    qsched = jnp.asarray(
        np.geomspace(float(temps_np[0]), quench_T_final,
                     max(quench_sweeps, 1)), jnp.float32)

    @jax.jit
    def quench(k, qr, qb, best_e):
        def body(carry, inp):
            qr, qb, br, bb, be = carry
            T, kk = inp
            qr, qb = ops.sweep_planes(kk, qr, qb, jnp.full((B,), T), 1)
            e = ops.energy_planes(qr, qb)
            better = e < be
            br = jnp.where(better[:, None, None], qr, br)
            bb = jnp.where(better[:, None, None], qb, bb)
            return (qr, qb, br, bb, jnp.minimum(e, be)), None

        e0 = ops.energy_planes(qr, qb)
        (qr, qb, br, bb, be), _ = jax.lax.scan(
            body, (qr, qb, qr, qb, e0),
            (qsched, jax.random.split(k, qsched.shape[0])))
        # Quench can only improve a slot; keep whichever is lower.
        better = be < best_e
        return (jnp.where(better[:, None, None], br, best_r),
                jnp.where(better[:, None, None], bb, best_b),
                jnp.minimum(be, best_e))

    if quench_sweeps > 0:
        # Chunk keys fold in start-of-chunk iteration counts (< n_iters),
        # so n_iters itself is a collision-free quench stream id.
        k_q = jax.random.fold_in(key, n_iters)
        best_r, best_b, best_e = quench(k_q, best_r, best_b, best_e)

    best_e_np = np.asarray(best_e)
    acc_np, att_np = np.asarray(acc_p), np.asarray(att_p)
    i = int(best_e_np.argmin())
    n_att = int(att_np.sum())
    return {
        "best_state": np.asarray(ops.merge(best_r[i], best_b[i])),
        "best_energy": float(best_e_np[i]),
        "energy_per_site": float(best_e_np[i]) / (rows * cols),
        "pair_acceptance": acc_np / np.maximum(att_np, 1),
        "pair_attempts": att_np,
        "swap_acceptance_rate": (
            float(acc_np.sum()) / n_att if n_att else 0.0),
        "n_rungs": R,
        "n_copies": C,
        "houdayer_every": houdayer_every if use_houdayer else 0,
        "temperatures": temps_np,
        "iters_run": int(done),
        "discrete_table_path": ops.route == "triton",
    }

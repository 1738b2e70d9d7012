"""NumPy reference implementations used as correctness oracles in tests.

Semantics follow the reference implementation (Arsham-001/tsu-emulator) —
E(b) = -1/2 b^T J b - h^T b with heat-bath conditionals
P(b_i=1|rest) = sigmoid(((J b)_i + h_i)/T) (tsu/gibbs.py:79-126) — but written
independently and extended with exact enumeration, which the reference lacks.
"""

from __future__ import annotations

import itertools

import numpy as np


def boltzmann_energy(b: np.ndarray, J: np.ndarray, h: np.ndarray) -> float:
    """E(b) = -1/2 b^T J b - h^T b for bits b in {0,1}^n."""
    b = np.asarray(b, dtype=np.float64)
    return float(-0.5 * b @ J @ b - h @ b)


def ising_energy(s: np.ndarray, J: np.ndarray, h: np.ndarray) -> float:
    """E(s) = -1/2 s^T J s - h^T s for spins s in {-1,+1}^n."""
    s = np.asarray(s, dtype=np.float64)
    return float(-0.5 * s @ J @ s - h @ s)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-np.clip(x, -500, 500)))


def sequential_gibbs_bits(
    rng: np.random.Generator,
    J: np.ndarray,
    h: np.ndarray,
    n_samples: int,
    temperature: float = 1.0,
    n_burnin: int = 100,
    n_sweeps: int = 10,
) -> np.ndarray:
    """Sequential-scan heat-bath Gibbs over bits {0,1}^n. Oracle for the
    dense Gibbs engine (semantics of tsu/gibbs.py:164-213)."""
    n = J.shape[0]
    state = (rng.random(n) < 0.5).astype(np.float64)

    def sweep(state):
        for i in range(n):
            field = J[i] @ state + h[i]
            # Note J[i,i]*b_i term: reference includes the diagonal in the
            # local field (tsu/gibbs.py:79-100 uses the full row dot). For
            # J with zero diagonal (the standard case) this is identical.
            field -= J[i, i] * state[i]
            state[i] = 1.0 if rng.random() < _sigmoid(field / temperature) else 0.0
        return state

    for _ in range(n_burnin):
        state = sweep(state)
    out = np.empty((n_samples, n), dtype=np.float64)
    for k in range(n_samples):
        for _ in range(n_sweeps):
            state = sweep(state)
        out[k] = state
    return out


def sequential_gibbs_spins(
    rng: np.random.Generator,
    J: np.ndarray,
    h: np.ndarray,
    n_samples: int,
    temperature: float = 1.0,
    n_burnin: int = 100,
    n_sweeps: int = 10,
) -> np.ndarray:
    """Sequential heat-bath Gibbs over spins {-1,+1}^n.
    P(s_i=+1|rest) = sigmoid(2 ((J s)_i + h_i)/T) with diagonal excluded."""
    n = J.shape[0]
    state = np.where(rng.random(n) < 0.5, 1.0, -1.0)

    def sweep(state):
        for i in range(n):
            field = J[i] @ state + h[i] - J[i, i] * state[i]
            p_up = _sigmoid(2.0 * field / temperature)
            state[i] = 1.0 if rng.random() < p_up else -1.0
        return state

    for _ in range(n_burnin):
        state = sweep(state)
    out = np.empty((n_samples, n), dtype=np.float64)
    for k in range(n_samples):
        for _ in range(n_sweeps):
            state = sweep(state)
        out[k] = state
    return out


def _enumerate_moments(states: np.ndarray, J, h, temperature):
    """Boltzmann-weighted moments over an explicit state enumeration."""
    J = np.asarray(J, dtype=np.float64)
    h = np.asarray(h, dtype=np.float64)
    E = -0.5 * np.einsum("ki,ij,kj->k", states, J, states) - states @ h
    logw = -E / temperature
    logw -= logw.max()
    w = np.exp(logw)
    w /= w.sum()
    mean = w @ states
    m_per = states.mean(axis=1)
    return {
        "mean": mean,
        "energy": float(w @ E),
        "energy2": float(w @ (E**2)),
        "magnetization": float(w @ m_per),
        "abs_magnetization": float(w @ np.abs(m_per)),
        "m2": float(w @ (m_per**2)),
    }


def exact_boltzmann_moments(J, h, temperature=1.0):
    """Exact moments of the bit-Boltzmann distribution by enumeration (n <= 20)."""
    n = np.asarray(J).shape[0]
    assert n <= 20, "enumeration limited to n<=20"
    states = np.array(list(itertools.product([0.0, 1.0], repeat=n)))
    return _enumerate_moments(states, J, h, temperature)


def exact_ising_moments(J, h, temperature=1.0):
    """Exact moments of the spin-Ising distribution by enumeration (n <= 20)."""
    n = np.asarray(J).shape[0]
    assert n <= 20, "enumeration limited to n<=20"
    states = np.array(list(itertools.product([-1.0, 1.0], repeat=n)))
    return _enumerate_moments(states, J, h, temperature)


def onsager_magnetization(T: float, J: float = 1.0) -> float:
    """Exact spontaneous magnetization of the infinite 2-D Ising lattice.

    M = (1 - sinh(2J/T)^-4)^(1/8) below T_c = 2J/ln(1+sqrt(2)) ≈ 2.269J, else 0.
    Ground truth for the phase-transition sweep (BASELINE config 3).
    """
    Tc = 2.0 * J / np.log(1.0 + np.sqrt(2.0))
    if T >= Tc:
        return 0.0
    return float((1.0 - np.sinh(2.0 * J / T) ** -4) ** 0.125)


def lattice_energy_np(s: np.ndarray, J: float = 1.0, h: float = 0.0,
                      periodic: bool = True) -> float:
    """NumPy stencil 2-D Ising energy (right+down bonds)."""
    s = np.asarray(s, dtype=np.float64)
    if periodic:
        bond = np.sum(s * np.roll(s, -1, axis=-1)) + np.sum(s * np.roll(s, -1, axis=-2))
    else:
        bond = np.sum(s[:, :-1] * s[:, 1:]) + np.sum(s[:-1, :] * s[1:, :])
    return float(-J * bond - h * np.sum(s))


def onsager_energy(T: float, J: float = 1.0) -> float:
    """Exact energy per site of the infinite 2-D Ising lattice (Onsager):
    u = -J coth(2K) [1 + (2/pi) (2 tanh^2(2K) - 1) K1(k)], K = J/T,
    k = 2 sinh(2K) / cosh^2(2K), K1 the complete elliptic integral of the
    first kind (scipy's ellipk takes the parameter m = k^2)."""
    from scipy.special import ellipk

    K = J / T
    k = 2.0 * np.sinh(2 * K) / np.cosh(2 * K) ** 2
    return float(-J / np.tanh(2 * K) * (
        1.0 + 2.0 / np.pi * (2.0 * np.tanh(2 * K) ** 2 - 1.0) * ellipk(k * k)))


def lattice_energy_bonds_np(s: np.ndarray, Jh: np.ndarray, Jv: np.ndarray,
                            periodic: bool = True) -> float:
    """NumPy per-bond 2-D energy E = -sum_b J_b s_i s_j (float64): Jh[r, c]
    couples (r, c)-(r, c+1), Jv[r, c] couples (r, c)-(r+1, c)."""
    s = np.asarray(s, dtype=np.float64)
    Jh = np.asarray(Jh, dtype=np.float64)
    Jv = np.asarray(Jv, dtype=np.float64)
    eh = Jh * s * np.roll(s, -1, axis=-1)
    ev = Jv * s * np.roll(s, -1, axis=-2)
    if not periodic:
        eh, ev = eh[..., :, :-1], ev[..., :-1, :]
    return float(-(eh.sum() + ev.sum()))


def heat_bath_threshold_halfstep_np(s: np.ndarray, u24: np.ndarray,
                                    table: np.ndarray, color: int,
                                    periodic: bool = True, Jh=None,
                                    Jv=None) -> np.ndarray:
    """One colour of a threshold-table heat-bath sweep on a full (R, C) spin
    lattice, site by site: every site with (r + c) % 2 == color gets
    +1 when u24[r, c] < table[local + 4] (local = integer neighbour field,
    bonds from Jh/Jv or all 1), else -1. Independent of the compact layout
    and of JAX: the oracle of the GPU sweep kernel's arithmetic."""
    s = np.array(s, dtype=np.int64)
    R, C = s.shape
    Jh = np.ones((R, C), np.int64) if Jh is None else np.asarray(Jh, np.int64)
    Jv = np.ones((R, C), np.int64) if Jv is None else np.asarray(Jv, np.int64)
    out = s.copy()
    for r in range(R):
        for c in range(C):
            if (r + c) % 2 != color:
                continue
            local = 0
            for rr, cc, w in ((r - 1, c, Jv[(r - 1) % R, c]),
                              (r + 1, c, Jv[r, c]),
                              (r, c - 1, Jh[r, (c - 1) % C]),
                              (r, c + 1, Jh[r, c])):
                if periodic or (0 <= rr < R and 0 <= cc < C):
                    local += w * s[rr % R, cc % C]
            out[r, c] = 1 if u24[r, c] < table[local + 4] else -1
    return out

"""ctypes bindings for the native graph tools, with a pure-Python fallback.

The shared library is built from graph_tools.cpp at first use with g++ (see
build.sh, or `make native`) into a git-ignored file; if no
toolchain is available the NumPy fallbacks keep everything functional
(just slower on very large graphs).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_HERE, "libgraph_tools.so")
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(
                ["sh", os.path.join(_HERE, "build.sh")],
                check=True, capture_output=True, timeout=120,
            )
        except Exception:
            _build_failed = True
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        _build_failed = True
        return None

    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")

    lib.greedy_maxcut.restype = ctypes.c_double
    lib.greedy_maxcut.argtypes = [i64p, i32p, f64p, ctypes.c_int64,
                                  ctypes.c_int32, ctypes.c_uint64, i8p]
    lib.cut_value.restype = ctypes.c_double
    lib.cut_value.argtypes = [i64p, i32p, f64p, ctypes.c_int64, i8p]
    lib.coloring_conflicts.restype = ctypes.c_int64
    lib.coloring_conflicts.argtypes = [i64p, i32p, ctypes.c_int64, i32p]
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.sa_dense.restype = ctypes.c_double
    lib.sa_dense.argtypes = [f32p, f32p, ctypes.c_int32, f32p,
                             ctypes.c_int32, ctypes.c_int32,
                             ctypes.c_uint64, f32p]
    lib.gibbs_dense.restype = ctypes.c_int32
    lib.gibbs_dense.argtypes = [f32p, f32p, ctypes.c_int32, ctypes.c_double,
                                ctypes.c_int32, ctypes.c_int32,
                                ctypes.c_int32, ctypes.c_int32,
                                ctypes.c_int32, ctypes.c_uint64, f32p]
    _lib = lib
    return lib


def csr_from_dense(W: np.ndarray):
    """Dense symmetric weight matrix -> CSR (indptr, indices, weights)."""
    from scipy import sparse

    csr = sparse.csr_matrix(np.asarray(W, dtype=np.float64))
    return (csr.indptr.astype(np.int64), csr.indices.astype(np.int32),
            csr.data.astype(np.float64))


def csr_from_edges(n: int, edges: np.ndarray, weights: np.ndarray):
    """Undirected edge list -> symmetric CSR."""
    from scipy import sparse

    e = np.asarray(edges)
    w = np.asarray(weights, dtype=np.float64)
    m = sparse.coo_matrix((np.concatenate([w, w]),
                           (np.concatenate([e[:, 0], e[:, 1]]),
                            np.concatenate([e[:, 1], e[:, 0]]))),
                          shape=(n, n)).tocsr()
    return (m.indptr.astype(np.int64), m.indices.astype(np.int32),
            m.data.astype(np.float64))


def greedy_maxcut_csr(indptr, indices, weights, n_restarts: int = 10,
                      seed: int = 0) -> Tuple[float, np.ndarray]:
    """Greedy local-search cut lower bound; native when available."""
    n = len(indptr) - 1
    lib = _load()
    if lib is not None:
        spins = np.zeros(n, dtype=np.int8)
        cut = lib.greedy_maxcut(
            np.ascontiguousarray(indptr, np.int64),
            np.ascontiguousarray(indices, np.int32),
            np.ascontiguousarray(weights, np.float64),
            n, n_restarts, seed, spins,
        )
        if cut >= 0:
            return float(cut), spins.astype(np.float64)

    # NumPy fallback (vectorized gains; fine to ~10^4 nodes).
    from scipy import sparse

    W = sparse.csr_matrix((weights, indices, indptr), shape=(n, n))
    rng = np.random.default_rng(seed)
    best_cut, best_s = -1.0, None
    for _ in range(n_restarts):
        s = rng.choice([-1.0, 1.0], n)
        for _ in range(200):
            gain = s * (W @ s)
            i = int(np.argmax(gain))
            if gain[i] <= 1e-12:
                break
            s[i] = -s[i]
        # cut = 1/4 (sum_sym W - s^T W s); CSR holds both edge directions.
        cut = 0.25 * (float(np.sum(weights)) - float(s @ (W @ s)))
        if cut > best_cut:
            best_cut, best_s = cut, s.copy()
    return best_cut, best_s


def cut_value_csr(indptr, indices, weights, spins) -> float:
    n = len(indptr) - 1
    lib = _load()
    s8 = np.where(np.asarray(spins) > 0, 1, -1).astype(np.int8)
    if lib is not None:
        return float(lib.cut_value(
            np.ascontiguousarray(indptr, np.int64),
            np.ascontiguousarray(indices, np.int32),
            np.ascontiguousarray(weights, np.float64),
            n, s8,
        ))
    from scipy import sparse

    W = sparse.csr_matrix((weights, indices, indptr), shape=(n, n))
    s = s8.astype(np.float64)
    return 0.25 * (float(weights.sum()) - float(s @ (W @ s)))


def coloring_conflicts_csr(indptr, indices, colors) -> int:
    n = len(indptr) - 1
    lib = _load()
    if lib is not None:
        return int(lib.coloring_conflicts(
            np.ascontiguousarray(indptr, np.int64),
            np.ascontiguousarray(indices, np.int32),
            n, np.ascontiguousarray(colors, np.int32),
        ))
    c = np.asarray(colors)
    conflicts = 0
    for i in range(n):
        for k in range(indptr[i], indptr[i + 1]):
            j = indices[k]
            if j > i and c[i] == c[j]:
                conflicts += 1
    return conflicts


def sa_dense_native(J, h, schedule, n_chains: int, seed: int):
    """Native simulated annealing on dense (J, h); returns
    (best_state (n,), best_energy) or None when the library is unavailable.

    The latency path for small problems: one accelerator dispatch costs more
    round-trip time than the entire anneal, so the host C++ loop wins below
    a few hundred variables (tsu_tpu/samplers/annealing.py does the routing;
    the TPU scan owns everything larger).
    """
    lib = _load()
    if lib is None:
        return None
    J = np.ascontiguousarray(J, np.float32)
    h = np.ascontiguousarray(h, np.float32)
    schedule = np.ascontiguousarray(schedule, np.float32)
    n = J.shape[0]
    best_state = np.zeros(n, dtype=np.float32)
    e = lib.sa_dense(J, h, n, schedule, len(schedule), int(n_chains),
                     int(seed) & (2**64 - 1), best_state)
    if e >= 1e299:
        return None
    return best_state, float(e)


def gibbs_dense_native(J, h, *, temperature: float, n_chains: int,
                       n_samples: int, n_burnin: int, n_sweeps: int,
                       random_order: bool, seed: int):
    """Native heat-bath Gibbs on dense (J, h); returns (n_samples, n) float32
    bit samples, or None when the library is unavailable.

    Latency path for tiny models (see sa_dense_native): site-ordered sweeps
    (the engine's "sequential" chain) or per-sweep random permutations,
    n_chains round-robin-interleaved — the same output layout as the
    compiled engine (tsu_tpu/samplers/gibbs.py sample_boltzmann).
    """
    lib = _load()
    if lib is None:
        return None
    J = np.ascontiguousarray(J, np.float32)
    h = np.ascontiguousarray(h, np.float32)
    n = J.shape[0]
    out = np.zeros((n_samples, n), dtype=np.float32)
    rc = lib.gibbs_dense(J, h, n, float(temperature), int(n_chains),
                         int(n_samples), int(n_burnin), int(n_sweeps),
                         1 if random_order else 0,
                         int(seed) & (2**64 - 1), out)
    return out if rc == 0 else None


def native_available() -> bool:
    return _load() is not None

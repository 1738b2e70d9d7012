"""100k-node MAX-CUT: sparse ELL annealing on the device vs the native greedy bound.

BASELINE config 5 scale. The dense-J path caps out at tens of spins; the
sparse path is O(N * max_degree) memory and anneals entirely on device.
"""

import time

import jax
import numpy as np

from tsu_tpu.native import csr_from_edges, greedy_maxcut_csr
from tsu_tpu.ops.sparse_ising import maxcut_sparse


def main(n=100_000, m=500_000, n_steps=2000, seed=0):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, (m, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    weights = np.ones(len(edges))
    print(f"random graph: {n} nodes, {len(edges)} edges")

    t0 = time.perf_counter()
    indptr, idx, w = csr_from_edges(n, edges, weights)
    greedy_cut, _ = greedy_maxcut_csr(indptr, idx, w, n_restarts=5, seed=seed)
    t_greedy = time.perf_counter() - t0
    print(f"greedy local search (native): cut={greedy_cut:.0f} "
          f"({greedy_cut / len(edges):.1%}) in {t_greedy:.2f}s")

    t0 = time.perf_counter()
    out = maxcut_sparse(jax.random.key(seed), n, edges, weights,
                        n_steps=n_steps, n_chains=8)
    t_anneal = time.perf_counter() - t0
    print(f"device annealing ({n_steps} steps x 8 chains): "
          f"cut={out['cut_value']:.0f} ({out['cut_value'] / len(edges):.1%}) "
          f"in {t_anneal:.2f}s")


if __name__ == "__main__":
    main()

"""Edwards-Anderson +-J spin-glass ground-state search at lattice scale.

The flagship disordered-lattice workflow: random +-1 bonds on a periodic
2-D lattice, annealed through the GPU sweep kernel on packed bond codes
(its rate on the card: PERF.md), best state over
independent restarts. The known ground-state energy density of the 2-D
+-J EA model is ~-1.40 J/site; a few thousand annealing sweeps with
restarts should land within a couple percent.

Run: python examples/spin_glass_ground_state.py [--size 1024] [--steps 3000]
"""

import argparse
import time

import jax
import jax.numpy as jnp

from tsu_tpu.samplers.annealing import anneal_spin_glass


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--restarts", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    key = jax.random.key(args.seed)
    shape = (args.size, args.size)
    Jh = jnp.where(jax.random.bernoulli(jax.random.fold_in(key, 0), 0.5,
                                        shape), 1.0, -1.0)
    Jv = jnp.where(jax.random.bernoulli(jax.random.fold_in(key, 1), 0.5,
                                        shape), 1.0, -1.0)

    t0 = time.perf_counter()
    state, energy = anneal_spin_glass(
        jax.random.fold_in(key, 2), Jh, Jv,
        T_initial=3.0, T_final=0.05, n_steps=args.steps,
        n_restarts=args.restarts,
    )
    dt = time.perf_counter() - t0

    n = args.size * args.size
    print(f"{args.size}x{args.size} +-J EA glass, {args.steps} sweeps "
          f"x {args.restarts} restarts: E = {energy:.0f} "
          f"({energy / n:.4f} J/site, GS density ~ -1.40) in {dt:.1f}s")


if __name__ == "__main__":
    main()

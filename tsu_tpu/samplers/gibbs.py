"""Dense-coupling Gibbs sampler for binary Boltzmann machines.

API parity with the reference ``GibbsSampler`` (tsu/gibbs.py:39-393), rebuilt
TPU-first as **graph-colored block sweeps**: the coupling graph is greedily
colored on the host (sites sharing a color have J_ij = 0, so their
conditionals are mutually independent), and one sweep updates whole color
groups at a time with a single batched matmul local-field computation across
all chains. Updating a color group simultaneously is *exactly equivalent* to
visiting its sites one-by-one (no site in the group reads another's new
value), so a colored sweep is a systematic-order Gibbs sweep — the
reference's per-bit scalar loop (tsu/gibbs.py:128-162) reordered by color.
A chain graph needs 2 colors, a 2-D lattice 2 (the checkerboard), a dense
clique n; in every case the chains axis rides the MXU instead of a scalar
Python loop.

Dense J is the small-system path (Boltzmann machines, random-J instances,
BNN posteriors); large lattices use the checkerboard kernel
(tsu_tpu/ops/checkerboard.py) via IsingGrid.

Conventions (matching tsu/gibbs.py:79-126):
    E(b) = -1/2 b^T J b - h^T b over bits b in {0,1}^n
    P(b_i = 1 | rest) = sigmoid(((J b)_i - J_ii b_i + h_i) / T)
"""

from __future__ import annotations

import time
from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tsu_tpu.config import GibbsConfig, SamplingError


def _host_device_ctx(want_host: bool):
    """``jax.default_device(cpu)`` context when ``want_host`` and a CPU
    backend exists beside the accelerator; null context otherwise."""
    import contextlib

    if want_host and jax.default_backend() != "cpu":
        try:
            return jax.default_device(jax.local_devices(backend="cpu")[0])
        except RuntimeError:
            pass
    return contextlib.nullcontext()


def _site_update(i, state, J, h, temperature, u):
    """Heat-bath update of one site given a uniform draw u."""
    field = J[i] @ state + h[i] - J[i, i] * state[i]
    p = jax.nn.sigmoid(field / temperature)
    return state.at[i].set(jnp.where(u < p, 1.0, 0.0))


def _sweep_ordered(key, state, J, h, temperature, order):
    """One Gibbs sweep visiting sites in the given order (shape (n,))."""
    n = state.shape[0]
    us = jax.random.uniform(key, (n,))

    def body(state, iu):
        i, u = iu
        return _site_update(i, state, J, h, temperature, u), None

    state, _ = jax.lax.scan(body, state, (order, us))
    return state


@partial(jax.jit, static_argnames=("n_sweeps", "random_order"))
def gibbs_sweeps(key, state, J, h, temperature, n_sweeps: int, random_order: bool = False):
    """Run ``n_sweeps`` sequential-scan sweeps on one chain state (n,)."""
    n = state.shape[0]

    def body(carry, k):
        state = carry
        if random_order:
            k_perm, k_sweep = jax.random.split(k)
            order = jax.random.permutation(k_perm, n)
        else:
            k_sweep = k
            order = jnp.arange(n)
        return _sweep_ordered(k_sweep, state, J, h, temperature, order), None

    keys = jax.random.split(key, n_sweeps)
    state, _ = jax.lax.scan(body, state, keys)
    return state


def color_groups(J, atol: float = 0.0) -> np.ndarray:
    """Greedy graph coloring of the dense coupling matrix (host-side).

    Returns an int32 array ``(n_colors, group_max)`` of site indices, padded
    with the sentinel ``n`` (so kernels can scatter into an n+1-wide extended
    state and slice the pad column away). Sites within one row never couple
    (|J_ij| <= atol), so their heat-bath conditionals are mutually
    independent and the whole row updates in one vectorized step.
    """
    J = np.asarray(J)
    n = J.shape[0]
    adj = np.abs(J) > atol
    adj |= adj.T
    np.fill_diagonal(adj, False)
    # Highest-degree-first greedy coloring keeps the color count near optimal.
    order = np.argsort(-adj.sum(axis=1), kind="stable")
    color = np.full(n, -1, dtype=np.int64)
    for i in order:
        used = set(color[adj[i]].tolist()) - {-1}
        c = 0
        while c in used:
            c += 1
        color[i] = c
    n_colors = int(color.max()) + 1 if n else 1
    groups = [np.nonzero(color == c)[0] for c in range(n_colors)]
    gmax = max(len(g) for g in groups)
    out = np.full((n_colors, gmax), n, dtype=np.int32)
    for c, g in enumerate(groups):
        out[c, : len(g)] = g
    return out


@partial(jax.jit, static_argnames=("n_sweeps", "random_order"))
def blocked_sweeps(key, states, J, h, temperature, colors, n_sweeps: int,
                   random_order: bool = False):
    """Colored block Gibbs sweeps over a batch of chains.

    Args:
        states: (chains, n) bit states in {0, 1}.
        colors: (n_colors, gmax) int32 from :func:`color_groups` (pad = n).
        temperature: scalar, or (chains,) per-chain temperatures (used by
            parallel tempering, where chains = replicas).

    One sweep visits every color once; within a color all sites update
    simultaneously from a single (chains, n+1) @ (n+1, gmax) local-field
    matmul — exactly the sequential-scan kernel of tsu/gibbs.py:128-162
    with sites reordered by color. Site selection/write-back use one-hot
    matmuls rather than gather/scatter: on TPU they ride the MXU, and on
    CPU they avoid XLA's serialized scatter (~350 us/step measured — the
    r1 suite's 155 samples/s regression).
    """
    chains, n = states.shape
    n_colors, gmax = colors.shape
    # Extended layout: column n is a scratch slot all padded indices hit.
    J_ext = jnp.zeros((n + 1, n + 1), jnp.float32).at[:n, :n].set(J)
    h_ext = jnp.zeros(n + 1, jnp.float32).at[:n].set(h)
    diag_ext = jnp.diag(J_ext)
    ext = jnp.zeros((chains, n + 1), states.dtype).at[:, :n].set(states)
    T = jnp.asarray(temperature, jnp.float32)
    T = T[:, None] if T.ndim == 1 else T

    def apply_color(state, rows, hc, dc, onehot, memb, u):
        f = state @ rows.T + hc - dc[None, :] * (state @ onehot.T)
        p = jax.nn.sigmoid(f / T)
        new = jnp.where(u < p, 1.0, 0.0).astype(state.dtype)
        return state * (1.0 - memb) + new @ onehot

    # Per-color constants can be hoisted out of the scan (axis-0 gathers,
    # cheap) — but the hoisted tables are (n_colors, gmax, n+1), and gmax is
    # the LARGEST group, so a skewed coloring (small clique + big independent
    # set: n_colors ~ k, gmax ~ n) would materialize ~k*n*n floats, far more
    # than J itself. Above a ~64 MB table budget, gather per color inside the
    # scan body instead (one (gmax, n+1) gather per color step).
    hoist = n_colors * gmax * (n + 1) <= (1 << 24)

    def one_sweep(state, k):
        if random_order:
            k_perm, k = jax.random.split(k)
            perm = jax.random.permutation(k_perm, n_colors)
        else:
            perm = jnp.arange(n_colors)
        us = jax.random.uniform(k, (n_colors, chains, gmax))

        if hoist:
            def color_body(state, inp):
                rows, hc, dc, onehot, memb, u = inp
                return apply_color(state, rows, hc, dc, onehot, memb, u), None

            xs = (rows_all[perm], h_all[perm], d_all[perm], onehot_all[perm],
                  memb_all[perm], us)
        else:
            def color_body(state, inp):
                c, u = inp
                onehot = jax.nn.one_hot(c, n + 1, dtype=state.dtype)
                memb = jnp.clip(onehot.sum(axis=0), 0.0, 1.0)
                return apply_color(
                    state, J_ext[c], h_ext[c], diag_ext[c], onehot, memb, u
                ), None

            xs = (colors[perm], us)
        state, _ = jax.lax.scan(color_body, state, xs)
        return state, None

    if hoist:
        rows_all = J_ext[colors]          # (n_colors, gmax, n+1)
        h_all = h_ext[colors]             # (n_colors, gmax)
        d_all = diag_ext[colors]          # (n_colors, gmax)
        onehot_all = jax.nn.one_hot(colors, n + 1, dtype=states.dtype)
        memb_all = jnp.clip(onehot_all.sum(axis=1), 0.0, 1.0)  # (n_colors, n+1)

    ext, _ = jax.lax.scan(one_sweep, ext, jax.random.split(key, n_sweeps))
    return ext[:, :n]


@partial(
    jax.jit,
    static_argnames=("n_samples", "n_burnin", "n_sweeps", "random_order"),
)
def _dense_gibbs_blocked(
    key, J, h, x0, colors, *,
    n_samples: int, temperature, n_burnin: int, n_sweeps: int,
    random_order: bool,
):
    """(n_samples, chains, n) colored-Gibbs draws; one XLA computation."""
    k_burn, k_main = jax.random.split(key)
    states = blocked_sweeps(k_burn, x0, J, h, temperature, colors,
                            max(n_burnin, 1), random_order) if n_burnin else x0

    def collect(states, k):
        states = blocked_sweeps(k, states, J, h, temperature, colors,
                                n_sweeps, random_order)
        return states, states

    _, samples = jax.lax.scan(collect, states, jax.random.split(k_main, n_samples))
    return samples


@partial(jax.jit, static_argnames=("n_samples",))
def _iid_bernoulli_sample(key, h, temperature, x0, *, n_samples: int):
    """(chains, n_samples, n) exact iid draws for a coupling-free model.

    When J has no off-diagonal structure the heat-bath conditional of every
    bit is P(b_i=1) = sigmoid(h_i / T) independent of the rest of the state
    (the J_ii terms cancel in the local field, tsu/gibbs.py:79-100), so the
    chain forgets its state after one sweep and the target factorizes: one
    vectorized Bernoulli draw replaces the whole burn-in/thinning machinery,
    exactly. This removes the reference's only remaining throughput win
    (uniform_binary, tsu/benchmarks/sampling.py:98-163) and the deep-scan
    compile corner it triggered (r2 weakness #2: a 241 s TPU compile for a
    single-bit model).
    """
    chains = x0.shape[0]
    n = h.shape[0]
    p = jax.nn.sigmoid(h / jnp.asarray(temperature, jnp.float32))
    return jax.random.bernoulli(key, p, (chains, n_samples, n)).astype(jnp.float32)


@partial(
    jax.jit,
    static_argnames=("n_samples", "n_burnin", "n_sweeps", "random_order"),
)
def _dense_gibbs_sequential(
    key, J, h, x0, *,
    n_samples: int, temperature, n_burnin: int, n_sweeps: int,
    random_order: bool,
):
    """(n_samples, chains, n) site-ordered-scan Gibbs draws.

    The exact Markov chain of the reference's per-bit loop
    (tsu/gibbs.py:128-162): sites visited one at a time in index order
    (``random_order=True``: a fresh random permutation per sweep,
    tsu/gibbs.py:155-156), vmapped over chains. Same invariant distribution
    as the colored engine, different (slower) chain — kept for exact
    reference-semantics parity; the colored engine is the fast path.
    """
    chains = x0.shape[0]

    def chain_sweeps(k, state, n):
        return gibbs_sweeps.__wrapped__(
            k, state, J, h, temperature, n, random_order
        )

    def sweep_all(k, states, n):
        return jax.vmap(lambda kk, s: chain_sweeps(kk, s, n))(
            jax.random.split(k, chains), states
        )

    k_burn, k_main = jax.random.split(key)
    states = sweep_all(k_burn, x0, max(n_burnin, 1)) if n_burnin else x0

    def collect(states, k):
        states = sweep_all(k, states, n_sweeps)
        return states, states

    _, samples = jax.lax.scan(collect, states, jax.random.split(k_main, n_samples))
    return samples


def dense_gibbs_sample(
    key,
    J,
    h,
    x0,
    *,
    n_samples: int,
    temperature: float = 1.0,
    n_burnin: int = 100,
    n_sweeps: int = 10,
    random_order: bool = False,
    sequential: bool = False,
    colors=None,
):
    """Boltzmann sampling on dense J: (n_chains, n_samples, n) bit samples.

    Host wrapper: colors the concrete coupling graph once, then runs the
    whole job — burn-in, thinning, collection, all chains — as a single XLA
    computation (cf. tsu/gibbs.py:164-213's Python loops). A coupling-free J
    (one color) short-circuits to one exact vectorized Bernoulli draw.
    ``sequential=True`` runs the site-ordered-scan chain instead of colored
    blocks (exact reference chain semantics; same invariant distribution).
    ``colors``: optional precomputed :func:`color_groups` output (callers
    that already colored J skip the O(n^2) host pass).
    """
    x0 = jnp.atleast_2d(jnp.asarray(x0, dtype=jnp.float32))
    h = jnp.asarray(h, jnp.float32)
    if colors is None:
        colors = color_groups(np.asarray(J))
    colors = jnp.asarray(colors)
    if colors.shape[0] == 1:
        # Tiny coupling-free problems are latency-bound, not compute-bound:
        # one Bernoulli draw is ~us of work, less than a device dispatch.
        # Route them to the host CPU device — "minimise host<->device
        # transfers" means not shipping 2 KB to an accelerator at all.
        # (Where the crossover sits on a GPU is not measured yet.)
        total = x0.shape[0] * n_samples * h.shape[0]
        with _host_device_ctx(total < (1 << 22)):
            return _iid_bernoulli_sample(key, h, temperature, x0,
                                         n_samples=n_samples)
    if sequential:
        samples = _dense_gibbs_sequential(
            key, jnp.asarray(J, jnp.float32), h, x0,
            n_samples=n_samples, temperature=temperature,
            n_burnin=n_burnin, n_sweeps=n_sweeps, random_order=random_order,
        )
    else:
        samples = _dense_gibbs_blocked(
            key, jnp.asarray(J, jnp.float32), h, x0,
            colors, n_samples=n_samples, temperature=temperature,
            n_burnin=n_burnin, n_sweeps=n_sweeps, random_order=random_order,
        )
    return jnp.swapaxes(samples, 0, 1)


@jax.jit
def boltzmann_energy_batch(states, J, h):
    """E(b) = -1/2 b^T J b - h^T b over a batch (..., n) (cf. tsu/gibbs.py:215-236)."""
    Js = jnp.einsum("...i,ij->...j", states, J)
    return -0.5 * jnp.einsum("...j,...j->...", Js, states) - states @ h


class GibbsSampler:
    """Gibbs sampler for binary/probabilistic bits (cf. tsu/gibbs.py:39-59)."""

    def __init__(self, config: Optional[GibbsConfig] = None, seed: Optional[int] = None):
        self.config = config or GibbsConfig()
        # Keys are derived from a HOST-side generator rather than a device
        # key chain, so drawing a key costs no device round-trip;
        # jax.random.key(int) is a deferred op on whatever device the
        # consumer runs on. Reproducible: seed -> PCG64 stream.
        self._seed_rng = np.random.default_rng(seed)
        self.sample_count = 0
        # Which execution path the last sample_boltzmann call took:
        # "native_cpp" | "xla_iid_host" | "xla" (None before the first call).
        self.last_route: Optional[str] = None

    def _next_key(self):
        return jax.random.key(int(self._seed_rng.integers(0, 2**63 - 1)))

    # -- low-level parity methods (tsu/gibbs.py:61-126) ---------------------

    def _sigmoid(self, x):
        return float(jax.nn.sigmoid(jnp.float32(x)))

    def _compute_local_field(self, i: int, state, coupling, bias=None):
        """Local field h_i = (J state)_i - J_ii state_i + bias_i."""
        state = np.asarray(state, dtype=np.float64)
        J = np.asarray(coupling, dtype=np.float64)
        b = 0.0 if bias is None else np.asarray(bias, dtype=np.float64)[i]
        return float(J[i] @ state - J[i, i] * state[i] + b)

    def sample_conditional(self, i: int, state, coupling, bias=None) -> int:
        """Sample bit i from its conditional (cf. tsu/gibbs.py:102-126)."""
        field = self._compute_local_field(i, state, coupling, bias)
        p = self._sigmoid(field / self.config.temperature)
        u = float(jax.random.uniform(self._next_key()))
        return int(u < p)

    def gibbs_sweep(self, state, coupling, bias=None, n_sweeps: int = 1):
        """Run full sweeps over a single state vector (cf. tsu/gibbs.py:128-162)."""
        state = jnp.asarray(state, dtype=jnp.float32)
        n = state.shape[0]
        J = jnp.asarray(coupling, dtype=jnp.float32)
        h = jnp.zeros(n) if bias is None else jnp.asarray(bias, dtype=jnp.float32)
        out = gibbs_sweeps(
            self._next_key(), state, J, h, self.config.temperature,
            n_sweeps, self.config.update_order == "random",
        )
        return np.asarray(out)

    # -- main sampling entry (tsu/gibbs.py:164-213) -------------------------

    def sample_boltzmann(
        self,
        coupling: np.ndarray,
        bias: Optional[np.ndarray] = None,
        n_samples: int = 1000,
        initial_state: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Sample the Boltzmann distribution over bits; returns (n_samples, n)."""
        J = np.asarray(coupling, dtype=np.float32)
        if J.ndim != 2 or J.shape[0] != J.shape[1]:
            raise SamplingError(f"coupling must be square, got shape {J.shape}")
        n = J.shape[0]
        h = np.zeros(n, np.float32) if bias is None else np.asarray(bias, dtype=np.float32)
        if h.shape != (n,):
            raise SamplingError(f"bias shape {h.shape} does not match n={n}")
        if n_samples <= 0:
            raise SamplingError(f"n_samples must be positive, got {n_samples}")

        # update_order routing (r2 weakness #6: the old docstring claimed
        # "sequential" matched reference chain semantics while this method
        # always ran colored blocks):
        #   "checkerboard" — colored block sweeps (the TPU-native fast path;
        #     the coloring IS the checkerboard, generalized to dense graphs);
        #   "sequential" — true site-ordered scan, the exact Markov chain of
        #     tsu/gibbs.py:153-158 (vmapped over chains);
        #   "random" — site order re-permuted every sweep
        #     (tsu/gibbs.py:155-156).
        # All three share the same invariant distribution; a coupling-free J
        # short-circuits to one exact Bernoulli draw regardless of order.
        cfg = self.config
        n_chains = cfg.n_chains
        per_chain = -(-n_samples // n_chains)
        # Coupling-free models route to the host device end-to-end (keys,
        # init, draw) — see dense_gibbs_sample's iid fast path. Color once;
        # the engine call below reuses the result.
        colors = color_groups(J)
        iid = colors.shape[0] == 1

        # Tiny coupled models route to the native C++ host sampler: the
        # whole job is ~1e6 flops, less than the device dispatches it would
        # take. Site-ordered sweeps (per-sweep random permutation
        # for "random") — the exact reference chain. GATED to the
        # sequential-scan orders: a "checkerboard" request must get the
        # colored-block chain everywhere — the native library loading (or
        # not) must never silently change which Markov chain a given
        # update_order runs (r3 advisor #1). ``last_route`` records the
        # path actually taken for every call.
        flops = (cfg.n_burnin + per_chain * cfg.n_sweeps) * n_chains * n * n
        if (not iid and initial_state is None and flops < 1e8
                and cfg.update_order in ("sequential", "random")):
            from tsu_tpu.native import gibbs_dense_native

            out = gibbs_dense_native(
                J, h, temperature=cfg.temperature, n_chains=n_chains,
                n_samples=n_samples, n_burnin=cfg.n_burnin,
                n_sweeps=cfg.n_sweeps,
                random_order=cfg.update_order == "random",
                seed=int(self._seed_rng.integers(0, 2**63 - 1)),
            )
            if out is not None:
                self.sample_count += n_samples
                self.last_route = "native_cpp"
                return out
        on_host = iid and n_chains * per_chain * n < (1 << 22)
        with _host_device_ctx(on_host):
            key = self._next_key()
            if initial_state is not None:
                x0 = jnp.tile(jnp.asarray(initial_state, dtype=jnp.float32),
                              (n_chains, 1))
            else:
                x0 = jax.random.bernoulli(
                    jax.random.fold_in(key, 0), 0.5, (n_chains, n)
                ).astype(jnp.float32)
            samples = dense_gibbs_sample(
                jax.random.fold_in(key, 1),
                jnp.asarray(J), jnp.asarray(h), x0,
                n_samples=per_chain,
                temperature=cfg.temperature,
                n_burnin=cfg.n_burnin,
                n_sweeps=cfg.n_sweeps,
                random_order=cfg.update_order == "random",
                sequential=cfg.update_order in ("sequential", "random"),
                colors=colors,
            )
        out = np.asarray(samples).transpose(1, 0, 2).reshape(-1, n)[:n_samples]
        self.sample_count += n_samples
        self.last_route = "xla_iid_host" if on_host else "xla"
        return out

    def compute_energy(self, state, coupling, bias=None) -> float:
        """E(b) = -1/2 b^T J b - h^T b (cf. tsu/gibbs.py:215-236)."""
        state = jnp.asarray(state, dtype=jnp.float32)
        J = jnp.asarray(coupling, dtype=jnp.float32)
        h = (
            jnp.zeros(state.shape[-1])
            if bias is None
            else jnp.asarray(bias, dtype=jnp.float32)
        )
        return float(boltzmann_energy_batch(state, J, h))

    # -- advanced samplers (delegate to dedicated modules) ------------------

    def parallel_tempering(
        self,
        coupling: np.ndarray,
        temperatures: List[float],
        bias: Optional[np.ndarray] = None,
        n_samples: int = 1000,
        swap_interval: int = 10,
    ) -> Tuple[np.ndarray, dict]:
        """Replica-exchange sampling (cf. tsu/gibbs.py:238-338).

        All replicas advance simultaneously (vmapped / shardable over a
        ``replica`` mesh axis); even/odd adjacent pairs attempt Metropolis
        swaps every ``swap_interval`` sweeps. Returns samples from the coldest
        temperature plus swap statistics, matching the reference info dict
        (tsu/gibbs.py:330-336).
        """
        from tsu_tpu.samplers.tempering import parallel_tempering_dense

        J = jnp.asarray(coupling, dtype=jnp.float32)
        n = J.shape[0]
        h = jnp.zeros(n) if bias is None else jnp.asarray(bias, dtype=jnp.float32)
        samples, info = parallel_tempering_dense(
            self._next_key(), J, h,
            temperatures=jnp.asarray(temperatures, dtype=jnp.float32),
            n_samples=n_samples,
            swap_interval=swap_interval,
            n_sweeps=self.config.n_sweeps,
            n_burnin=self.config.n_burnin,
        )
        self.sample_count += n_samples
        return np.asarray(samples), info

    def simulated_annealing(
        self,
        coupling: np.ndarray,
        bias: Optional[np.ndarray] = None,
        T_initial: float = 10.0,
        T_final: float = 0.1,
        n_steps: int = 1000,
        cooling_schedule: str = "exponential",
    ) -> Tuple[np.ndarray, float]:
        """Annealed optimization to low-energy states (cf. tsu/gibbs.py:340-393).

        The temperature schedule is a traced array consumed by one compiled
        scan — the config is never mutated (reference quirk Q8).
        Returns (best_state, best_energy).
        """
        from tsu_tpu.samplers.annealing import simulated_annealing_dense

        J = np.asarray(coupling, dtype=np.float32)
        n = J.shape[0]
        h = (np.zeros(n, np.float32) if bias is None
             else np.asarray(bias, dtype=np.float32))
        best_state, best_energy = simulated_annealing_dense(
            int(self._seed_rng.integers(0, 2**63 - 1)), J, h,
            T_initial=T_initial, T_final=T_final,
            n_steps=n_steps, cooling_schedule=cooling_schedule,
            n_chains=self.config.n_chains,
        )
        return np.asarray(best_state), float(best_energy)

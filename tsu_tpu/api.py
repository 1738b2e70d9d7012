"""High-level sampling / optimization / probabilistic-model API.

API parity with the reference (tsu/api.py:38-424), TPU-native underneath:

* Energy functions are JAX-traceable and consumed by the jitted Langevin
  engine; ``Backend`` selects real execution targets (cpu / tpu / tpu_pod)
  instead of the reference's mostly-NotImplemented enum (tsu/api.py:38-44,
  92-100).
* ``MaxCutProblem`` compiles to an Ising (J, h) instance solved by annealed
  Gibbs — a real QUBO path, not the sign-rounded continuous relaxation of the
  reference (quirk Q7, tsu/api.py:261-270).
* Probabilistic layers vectorize Bernoulli activations over whole tensors
  (the reference calls a Langevin p_bit per scalar — tsu/api.py:379).
"""

from __future__ import annotations

import time
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from tsu_tpu.config import ConfigurationError, SamplingError, TSUConfig
from tsu_tpu.core import ThermalSamplingUnit
from tsu_tpu.energy import MixtureOfGaussians, Quadratic
from tsu_tpu.rng import as_key


class Backend(Enum):
    """Execution backends (cf. tsu/api.py:38-44).

    EMULATOR is kept as an alias of CPU for drop-in compatibility.
    """

    CPU = "cpu"
    GPU = "gpu"
    EMULATOR = "emulator"  # alias: runs on whatever jax.default_backend() is


@dataclass
class SamplingResult:
    """Samples + metadata (cf. tsu/api.py:48-56)."""

    samples: np.ndarray
    n_samples: int
    time_elapsed: float
    backend: Backend
    metadata: dict = field(default_factory=dict)


class Sampler(ABC):
    """Abstract sampler with timing metadata (cf. tsu/api.py:59-113)."""

    def __init__(
        self,
        backend: Backend = Backend.EMULATOR,
        config: Optional[TSUConfig] = None,
        seed: Optional[int] = None,
    ):
        if backend is Backend.GPU and jax.default_backend() != "gpu":
            raise ConfigurationError(
                f"backend {backend} requested but jax.default_backend() is "
                f"{jax.default_backend()!r}"
            )
        self.backend = backend
        self.config = config or TSUConfig(n_chains=16, n_burnin=200, n_steps=200)
        self.tsu = ThermalSamplingUnit(self.config, seed=seed)
        self._compiled_shapes: set = set()

    @abstractmethod
    def energy_function(self, x: jax.Array) -> jax.Array:
        """Traceable scalar energy of one state."""

    def _get_initial_state(self) -> np.ndarray:
        return np.zeros(1, dtype=np.float32)

    def sample(
        self,
        n_samples: int = 1000,
        return_metadata: bool = True,
        *,
        n: Optional[int] = None,
    ):
        """Draw ``n_samples`` samples.

        Returns a :class:`SamplingResult` (timing + device metadata) by
        default; ``return_metadata=False`` returns the bare sample array,
        matching the reference's ``Sampler.sample(n, return_metadata)``
        surface (cf. tsu/api.py:75-108 — whose default is the bare array;
        here the richer result is the default, ``.samples`` is the array).
        ``n`` is accepted as an alias for ``n_samples``.

        Timing honesty: the first call with a given shape includes JIT
        compilation; ``metadata["includes_compile"]`` marks it. Later calls
        with the same shapes report steady-state throughput.

        ``includes_compile`` is a per-INSTANCE heuristic: the underlying
        jit cache is process-wide and also keyed on the energy function and
        state shapes, so a second sampler instance over the same energy may
        report ``True`` for a warm call (harmless, conservative), and an
        exotic caller that mutates shapes behind one instance could see the
        reverse. Treat it as "this timing may include compilation", not a
        compiler-verified fact (r3 advisor #3).
        """
        if n is not None:
            n_samples = n
        first_call = n_samples not in self._compiled_shapes
        start = time.perf_counter()
        samples = self.tsu.sample_from_energy(
            self.energy_function, self._get_initial_state(), n_samples
        )
        elapsed = time.perf_counter() - start
        self._compiled_shapes.add(n_samples)
        if not return_metadata:
            return np.asarray(samples)
        return SamplingResult(
            samples=samples,
            n_samples=n_samples,
            time_elapsed=elapsed,
            backend=self.backend,
            metadata={
                "samples_per_second": n_samples / elapsed if elapsed > 0 else float("inf"),
                "device": str(jax.devices()[0]),
                "n_chains": self.config.n_chains,
                "includes_compile": first_call,
            },
        )


class GaussianSampler(Sampler):
    """N(mu, sigma) sampling via the Langevin engine (cf. tsu/api.py:116-129)."""

    def __init__(self, mu: float = 0.0, sigma: float = 1.0, **kwargs):
        if sigma <= 0:
            raise ConfigurationError(f"sigma must be positive, got {sigma}")
        super().__init__(**kwargs)
        self.mu = mu
        self.sigma = sigma

    def energy_function(self, x):
        return Quadratic(self.mu, self.sigma)(x)

    def _get_initial_state(self):
        return np.array([self.mu], dtype=np.float32)


class MultimodalSampler(Sampler):
    """Gaussian-mixture sampling (cf. tsu/api.py:132-152)."""

    def __init__(
        self,
        modes: List[float] = (-2.0, 2.0),
        sigmas: List[float] = (0.5, 0.5),
        weights: Optional[List[float]] = None,
        **kwargs,
    ):
        super().__init__(**kwargs)
        if len(modes) != len(sigmas):
            raise ConfigurationError("modes and sigmas must have equal length")
        self.modes = tuple(float(m) for m in modes)
        self.sigmas = tuple(float(s) for s in sigmas)
        self.weights = tuple(weights) if weights is not None else None
        self._energy = MixtureOfGaussians(self.modes, self.sigmas, self.weights)

    def energy_function(self, x):
        return self._energy(x)

    def _get_initial_state(self):
        return np.array([float(np.mean(self.modes))], dtype=np.float32)


class BayesianSampler(Sampler):
    """Posterior sampling for Bayesian linear regression
    (cf. tsu/api.py:155-193): E(theta) = |y - X theta|^2 / (2 s^2) + |theta|^2 / 2.
    """

    def __init__(
        self,
        X: np.ndarray,
        y: np.ndarray,
        noise_std: float = 0.1,
        prior_std: float = 1.0,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.X = jnp.asarray(np.atleast_2d(X), dtype=jnp.float32)
        self.y = jnp.asarray(np.asarray(y).ravel(), dtype=jnp.float32)
        if self.X.shape[0] != self.y.shape[0]:
            raise ConfigurationError("X and y must have matching first dimension")
        self.noise_std = noise_std
        self.prior_std = prior_std

    def energy_function(self, theta):
        resid = self.y - self.X @ theta
        nll = jnp.sum(resid**2) / (2.0 * self.noise_std**2)
        prior = jnp.sum(theta**2) / (2.0 * self.prior_std**2)
        return nll + prior

    def _get_initial_state(self):
        return np.zeros(self.X.shape[1], dtype=np.float32)


def sample_gaussian(
    mu: float = 0.0,
    sigma: float = 1.0,
    n_samples: int = 1000,
    *,
    n: Optional[int] = None,
    **kwargs,
) -> np.ndarray:
    """Functional Gaussian sampling (cf. tsu/api.py:199-206).

    ``n`` is accepted as an alias for ``n_samples`` (the reference's name).
    """
    if n is not None:
        n_samples = n
    return GaussianSampler(mu, sigma, **kwargs).sample(n_samples).samples.ravel()


def sample_multimodal(
    modes: List[float] = (-2.0, 2.0),
    sigmas: List[float] = (0.5, 0.5),
    n_samples: int = 1000,
    *,
    n: Optional[int] = None,
    centers: Optional[List[float]] = None,
    **kwargs,
) -> np.ndarray:
    """Functional mixture sampling (cf. tsu/api.py:208-214).

    ``n`` / ``centers`` are accepted as aliases for ``n_samples`` / ``modes``
    (the reference's parameter names).
    """
    if n is not None:
        n_samples = n
    if centers is not None:
        modes = centers
        if len(sigmas) != len(modes):
            sigmas = [0.5] * len(modes)
    return MultimodalSampler(modes, sigmas, **kwargs).sample(n_samples).samples.ravel()


def compare_samplers(n_samples: int = 1000) -> dict:
    """Compare engine output against direct NumPy sampling and
    Metropolis-Hastings on a standard normal (cf. tsu/api.py:217-234 — whose
    'mcmc' branch was a no-op; this one is real)."""
    out = {}
    t0 = time.perf_counter()
    s = sample_gaussian(0.0, 1.0, n_samples)
    out["tsu"] = {
        "time": time.perf_counter() - t0,
        "mean": float(np.mean(s)),
        "std": float(np.std(s)),
    }
    t0 = time.perf_counter()
    s = np.random.normal(0.0, 1.0, n_samples)
    out["direct"] = {
        "time": time.perf_counter() - t0,
        "mean": float(np.mean(s)),
        "std": float(np.std(s)),
    }
    t0 = time.perf_counter()
    x, samples = 0.0, []
    rng = np.random.default_rng(0)
    for _ in range(n_samples):
        prop = x + rng.normal(0, 0.5)
        if np.log(rng.random()) < (x**2 - prop**2) / 2.0:
            x = prop
        samples.append(x)
    out["mcmc"] = {
        "time": time.perf_counter() - t0,
        "mean": float(np.mean(samples)),
        "std": float(np.std(samples)),
    }
    return out


# -- optimization ------------------------------------------------------------


class OptimizationProblem(ABC):
    """Abstract optimization problem (cf. tsu/api.py:240-251)."""

    @abstractmethod
    def objective(self, x: np.ndarray) -> float:
        """Objective to minimize."""

    @property
    @abstractmethod
    def dimension(self) -> int:
        """Number of decision variables."""


class MaxCutProblem(OptimizationProblem):
    """MAX-CUT on a weighted graph (cf. tsu/api.py:254-273).

    Ising form: maximizing the cut equals minimizing
    E(s) = -1/2 s^T J s with J = -W (antiferromagnetic couplings), since
    cut(s) = 1/4 sum_ij W_ij (1 - s_i s_j). ``objective`` returns -cut so
    smaller is better, matching the reference sign convention.
    """

    def __init__(self, adjacency_matrix: np.ndarray):
        W = np.asarray(adjacency_matrix, dtype=np.float32)
        if W.ndim != 2 or W.shape[0] != W.shape[1]:
            raise ConfigurationError("adjacency matrix must be square")
        self.adjacency = W

    def objective(self, x: np.ndarray) -> float:
        s = np.where(np.asarray(x) >= 0, 1.0, -1.0)
        cut = 0.25 * float(np.sum(self.adjacency * (1.0 - np.outer(s, s))))
        return -cut

    def cut_value(self, spins: np.ndarray) -> float:
        s = np.asarray(spins, dtype=np.float64)
        return 0.25 * float(np.sum(self.adjacency * (1.0 - np.outer(s, s))))

    def to_ising(self):
        """(J, h) whose ground state is the max cut."""
        J = -self.adjacency
        h = np.zeros(self.adjacency.shape[0], dtype=np.float32)
        return J, h

    @property
    def dimension(self) -> int:
        return self.adjacency.shape[0]


def optimize(
    problem: OptimizationProblem,
    n_steps: int = 1000,
    initial_temp: float = 10.0,
    final_temp: float = 0.01,
    n_chains: int = 8,
    seed: Optional[int] = None,
) -> dict:
    """Annealed optimization (cf. tsu/api.py:276-325).

    Ising-expressible problems (``to_ising``) anneal with Gibbs sweeps on
    device across parallel chains; other problems fall back to annealed
    Langevin on a smoothed objective.
    """
    start = time.perf_counter()

    if hasattr(problem, "to_ising"):
        from tsu_tpu.energy import ising_to_boltzmann
        from tsu_tpu.samplers.annealing import simulated_annealing_dense

        J, h = problem.to_ising()
        J_bit, h_bit = ising_to_boltzmann(np.asarray(J), np.asarray(h))
        # Integer seed lets small problems take the native host SA loop
        # (no device dispatch); see simulated_annealing_dense. JAX PRNG
        # keys remain accepted (reference-era callers): their key data
        # seeds the host generator deterministically.
        if isinstance(seed, (int, np.integer)):
            seed_int = int(seed)
        else:
            entropy = seed
            if isinstance(seed, jax.Array):
                entropy = np.asarray(
                    jax.random.key_data(seed)
                    if jnp.issubdtype(seed.dtype, jax.dtypes.prng_key)
                    else seed
                ).ravel()
            seed_int = int(np.random.default_rng(entropy).integers(2**63))
        best_bits, _ = simulated_annealing_dense(
            seed_int, J_bit, h_bit,
            T_initial=initial_temp, T_final=final_temp,
            n_steps=n_steps, n_chains=n_chains,
        )
        best_x = np.asarray(2.0 * np.asarray(best_bits) - 1.0)
    else:
        key = as_key(seed)
        from tsu_tpu.samplers.langevin import sample_langevin

        dim = problem.dimension
        obj = problem.objective

        def energy(x):
            return obj(x)  # must be traceable for the fallback path

        # Probe traceability up front: a NumPy-only objective would otherwise
        # surface as an opaque tracer error from inside the jitted engine.
        try:
            out = jax.eval_shape(energy, jax.ShapeDtypeStruct((dim,), jnp.float32))
            if out.shape != ():
                raise ConfigurationError(
                    "objective must return a scalar; got shape "
                    f"{out.shape} (problem {type(problem).__name__})"
                )
        except ConfigurationError:
            raise
        except Exception as e:
            raise ConfigurationError(
                f"{type(problem).__name__}.objective is not JAX-traceable, so "
                "the annealed-Langevin fallback cannot differentiate it. "
                "Either implement to_ising() -> (J, h) for the discrete "
                "annealer, or write the objective with jax.numpy ops. "
                f"Underlying error: {e}"
            ) from e

        schedule = np.geomspace(initial_temp, final_temp, 10)
        x = 0.1 * jax.random.normal(jax.random.fold_in(key, 0), (n_chains, dim))
        for i, T in enumerate(schedule):
            x = sample_langevin(
                jax.random.fold_in(key, i + 1), x,
                energy_fn=energy, n_samples=1, temperature=float(T),
                dt=0.01, n_burnin=n_steps // 10, n_steps=1, underdamped=False,
            )[:, -1, :]
        objs = [problem.objective(np.asarray(xi)) for xi in x]
        best_x = np.asarray(x[int(np.argmin(objs))])

    best_obj = problem.objective(best_x)
    return {
        "best_solution": best_x,
        "best_objective": float(best_obj),
        "time_elapsed": time.perf_counter() - start,
        "n_steps": n_steps,
    }


# -- probabilistic model API (cf. tsu/api.py:331-424) ------------------------


class ProbabilisticLayer(ABC):
    """Abstract stochastic layer (cf. tsu/api.py:331-337)."""

    @abstractmethod
    def forward(self, x: np.ndarray, n_samples: Optional[int] = None) -> np.ndarray:
        """Stochastic forward pass.

        ``n_samples=None`` (default) returns one draw with the input's
        shape; an integer returns ``(n_samples, ...)`` stacked independent
        draws — the reference's convention (tsu/api.py:335, whose default
        ``n_samples=1`` returns a stacked singleton; index [0] as there).
        """


class StochasticLinear(ProbabilisticLayer):
    """Linear layer with weight noise (cf. tsu/api.py:340-363)."""

    def __init__(self, in_features: int, out_features: int,
                 weight_noise: float = 0.1, seed: Optional[int] = None):
        self.in_features = in_features
        self.out_features = out_features
        self.weight_noise = weight_noise
        self._key = as_key(seed)
        self._key, k = jax.random.split(self._key)
        scale = 1.0 / np.sqrt(max(in_features, 1))
        self.weights = np.asarray(scale * jax.random.normal(k, (in_features, out_features)))
        self.bias = np.zeros(out_features, dtype=np.float32)

    def forward(self, x: np.ndarray, n_samples: Optional[int] = None) -> np.ndarray:
        self._key, k = jax.random.split(self._key)
        # `is not None`, not truthiness: n_samples=0 must yield an empty
        # (0, batch, out) stack, not a single unstacked draw.
        shape = ((n_samples,) if n_samples is not None else ()) + self.weights.shape
        w = self.weights + self.weight_noise * np.asarray(
            jax.random.normal(k, shape)
        )
        out = np.atleast_2d(np.asarray(x)) @ w + self.bias
        return out  # (n_samples, batch, out) when n_samples is given


class BernoulliActivation(ProbabilisticLayer):
    """Stochastic binary activation, vectorized (cf. tsu/api.py:366-382 —
    the reference samples one Langevin chain per scalar; this is one
    ``jax.random.bernoulli`` over the whole tensor)."""

    def __init__(self, seed: Optional[int] = None):
        self._key = as_key(seed)

    def forward(self, x: np.ndarray, n_samples: Optional[int] = None) -> np.ndarray:
        self._key, k = jax.random.split(self._key)
        p = jax.nn.sigmoid(jnp.asarray(x))
        shape = ((n_samples,) + p.shape) if n_samples is not None else p.shape
        return np.asarray(jax.random.bernoulli(k, p, shape).astype(jnp.float32))


class ProbabilisticModel:
    """Keras-like stochastic model (cf. tsu/api.py:385-424)."""

    def __init__(self):
        self.layers: List[ProbabilisticLayer] = []

    def add(self, layer: ProbabilisticLayer) -> "ProbabilisticModel":
        if not isinstance(layer, ProbabilisticLayer):
            raise ConfigurationError("layer must be a ProbabilisticLayer")
        self.layers.append(layer)
        return self

    def forward(self, x: np.ndarray) -> np.ndarray:
        h = np.atleast_2d(np.asarray(x, dtype=np.float32))
        for layer in self.layers:
            h = layer.forward(h)
        return h

    def sample(self, x: np.ndarray, n_samples: int = 100) -> np.ndarray:
        """(n_samples, ...) independent stochastic outputs for one input
        (cf. tsu/api.py:403-414 — drop-in for ``model.sample(x, n)``)."""
        return np.stack([self.forward(x) for _ in range(n_samples)])

    def predict_proba(self, x: np.ndarray, n_samples: int = 100) -> np.ndarray:
        """Mean over stochastic forward passes."""
        return np.mean(self.sample(x, n_samples), axis=0)

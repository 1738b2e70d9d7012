"""Scaling-efficiency measurements across device topologies.

BASELINE.json demands samples/s measured at 1 chip / 1 host / N hosts with
>= 80% scaling efficiency. This harness measures two workloads on (a) a
single device and (b) the full visible mesh, and reports efficiency
= throughput_full / (throughput_single * n_devices):

  * chains workload — independent Langevin chains sharded over the mesh
    (embarrassingly parallel; the efficiency ceiling is dominated by
    dispatch and partitioning overhead);
  * lattice workload — one big lattice row-sharded with halo exchange
    (communication-bound limit).

Across hosts, run under `jax.distributed.initialize()`; topology is
recorded in the output. On a single card this degenerates to the 1-device
row (still useful as the denominator recorded for later rounds).
"""

from __future__ import annotations

import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from tsu_tpu.energy import Quadratic
from tsu_tpu.parallel.mesh import make_mesh
from tsu_tpu.samplers.langevin import sample_langevin


def _shared_host() -> bool:
    """True when the visible "devices" are virtual shards of ONE host CPU
    (xla_force_host_platform_device_count): a single-device run already
    saturates every physical core, so the meaningful weak-scaling ideal is
    the single-device throughput itself, not n_dev times it (r2 verdict #5:
    the x8 ideal produced a meaningless 0.32 "efficiency" artifact)."""
    return jax.default_backend() == "cpu" and jax.process_count() == 1


def _efficiency(single_tput: float, all_tput: float, n_dev: int) -> dict:
    """Weak-scaling efficiency with the ideal stated honestly per topology.

    On a shared-host virtual mesh NO ideal is clean — the 1-device baseline
    may under- or over-use the shared cores relative to the 8-shard run — so
    ``efficiency`` is reported null with both raw ratios, and the artifact
    exists to validate the mechanics (sharding, collectives, measurement),
    not to claim a scaling number. Real efficiency rows need distinct
    cards.
    """
    if n_dev <= 1:
        return {"efficiency": 1.0, "ideal": "single_device"}
    ratios = {
        "aggregate_vs_single_device": all_tput / single_tput,
        "aggregate_vs_ndev_x_single": all_tput / (single_tput * n_dev),
    }
    if _shared_host():
        return {
            "efficiency": None,
            "ideal": "not measurable on a shared-host virtual mesh (the "
                     "n-shard and 1-device runs contend for the same "
                     "physical cores); see ratios",
            **ratios,
        }
    return {
        "efficiency": ratios["aggregate_vs_ndev_x_single"],
        "ideal": "n_devices x single_device, constant per-device work "
                 "(weak scaling, distinct chips)",
        **ratios,
    }


def measure_chains_scaling(
    dim: int = 10,
    chains_per_device: int = 1024,
    n_samples: int = 50,
    n_steps: int = 10,
    seed: int = 0,
) -> dict:
    """Langevin samples/s: 1 device vs all devices (chains axis)."""
    devices = jax.devices()
    results = {}
    for label, devs in (("1_device", devices[:1]), ("all_devices", devices)):
        n_dev = len(devs)
        mesh = make_mesh(chains=n_dev, devices=devs)
        n_chains = chains_per_device * n_dev
        x0 = jax.device_put(
            jnp.zeros((n_chains, dim)),
            NamedSharding(mesh, P("chains", None)),
        )

        def run(i):
            return sample_langevin(
                jax.random.key(seed + i), x0,
                energy_fn=Quadratic(0.0, 1.0), n_samples=n_samples,
                dt=0.05, n_burnin=50, n_steps=n_steps,
            )

        s = run(0)
        jax.block_until_ready(s)
        t0 = time.perf_counter()
        s = run(1)
        jax.block_until_ready(s)
        dt = time.perf_counter() - t0
        results[label] = {
            "n_devices": n_dev,
            "samples_per_s": n_chains * n_samples / dt,
            "time_s": dt,
        }
    n_dev = results["all_devices"]["n_devices"]
    results.update(_efficiency(results["1_device"]["samples_per_s"],
                               results["all_devices"]["samples_per_s"], n_dev))
    return results


def measure_bnn_dp_scaling(
    points_per_device: int = 16384,
    dim: int = 8,
    hidden: int = 64,
    n_epochs: int = 20,
    seed: int = 0,
) -> dict:
    """BNN ELBO training points/s with the batch data-parallel over the
    chains axis (SURVEY §2.2; cf. the reference's epoch loop,
    tsu/ml.py:400-430, which is single-process NumPy).

    Weak scaling: points_per_device x n_devices synthetic regression points
    (>= 1e5 on the full 8-way mesh), full-batch jitted ELBO steps; XLA
    inserts the gradient psum from the sharding. Same honest shared-host
    caveat as every row here (_efficiency)."""
    import optax

    from tsu_tpu.models.ml import _init_layer, elbo_loss

    devices = jax.devices()
    results = {}
    for label, devs in (("1_device", devices[:1]), ("all_devices", devices)):
        n_dev = len(devs)
        mesh = make_mesh(chains=n_dev, devices=devs)
        n_points = points_per_device * n_dev
        rng = np.random.default_rng(seed)
        x_np = rng.normal(size=(n_points, dim)).astype(np.float32)
        y_np = np.sin(x_np.sum(axis=1, keepdims=True)).astype(np.float32)
        shard = NamedSharding(mesh, P("chains", None))
        x = jax.device_put(jnp.asarray(x_np), shard)
        y = jax.device_put(jnp.asarray(y_np), shard)

        keys = jax.random.split(jax.random.key(seed), 4)
        params = [_init_layer(keys[0], dim, hidden),
                  _init_layer(keys[1], hidden, 1)]
        optimizer = optax.adam(1e-2)
        opt_state = optimizer.init(params)

        @jax.jit
        def train_step(params, opt_state, key, x, y):
            (loss, _), grads = jax.value_and_grad(
                lambda p: elbo_loss(p, key, x, y, kl_weight=1e-3, n_mc=2,
                                    temperature=1.0, activation="relu",
                                    prior_std=1.0),
                has_aux=True,
            )(params)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state, loss

        def run(params, opt_state):
            loss = None
            for e in range(n_epochs):
                params, opt_state, loss = train_step(
                    params, opt_state, jax.random.fold_in(keys[2], e), x, y)
            return params, opt_state, loss

        params, opt_state, loss = run(params, opt_state)  # compile + warm
        jax.block_until_ready(loss)
        t0 = time.perf_counter()
        params, opt_state, loss = run(params, opt_state)
        jax.block_until_ready(loss)
        dt = time.perf_counter() - t0
        results[label] = {
            "n_devices": n_dev,
            "points_per_s": n_points * n_epochs / dt,
            "loss_final": float(loss),
            "n_points": n_points,
            "time_s": dt,
        }
    n_dev = results["all_devices"]["n_devices"]
    results.update(_efficiency(results["1_device"]["points_per_s"],
                               results["all_devices"]["points_per_s"],
                               n_dev))
    return results


def measure_lattice_scaling(
    rows_per_device: int = 1024,
    cols: int = 4096,
    n_sweeps: int = 200,
    seed: int = 0,
    use_pallas: Optional[bool] = None,
) -> dict:
    """Row-sharded lattice sweeps/s: 1 device vs all (halo-exchange bound).

    Measures the production sharded path with the sweep the chooser picks
    (tsu_tpu/ops/select.py): the GPU kernel inside shard_map on GPUs, XLA
    elsewhere.
    """
    from tsu_tpu.ops.checkerboard import split_checkerboard
    from tsu_tpu.ops.select import choose_sweep
    from tsu_tpu.parallel.lattice import sharded_checkerboard_sweeps

    devices = jax.devices()
    route = choose_sweep((rows_per_device, cols), "uniform",
                         use_pallas=use_pallas)
    dtype = jnp.int8 if route == "triton" else jnp.float32
    results = {"route": route}
    for label, devs in (("1_device", devices[:1]), ("all_devices", devices)):
        n_dev = len(devs)
        mesh = make_mesh(rows=n_dev, devices=devs)
        R = rows_per_device * n_dev
        red, black = split_checkerboard(jnp.ones((R, cols), dtype))
        sharding = NamedSharding(mesh, P("row", None))
        red = jax.device_put(red, sharding)
        black = jax.device_put(black, sharding)

        def run(i, red, black):
            return sharded_checkerboard_sweeps(
                mesh, jax.random.key(seed + i), red, black, 2.269, n_sweeps,
                periodic=True, use_pallas=use_pallas,
            )

        red, black = run(0, red, black)
        jax.block_until_ready(red)
        t0 = time.perf_counter()
        red, black = run(1, red, black)
        jax.block_until_ready(red)
        dt = time.perf_counter() - t0
        results[label] = {
            "n_devices": n_dev,
            "flips_per_s": R * cols * n_sweeps / dt,
            "time_s": dt,
        }
    n_dev = results["all_devices"]["n_devices"]
    # Weak scaling: per-device problem size constant.
    results.update(_efficiency(results["1_device"]["flips_per_s"],
                               results["all_devices"]["flips_per_s"], n_dev))
    return results


def measure_lattice_matched(
    size: int = 4096,
    n_sweeps: int = 200,
    n_iters: int = 3,
    seed: int = 0,
) -> dict:
    """MATCHED-SIZE sharded row: the production sharded path
    (parallel/lattice.py) on a 1-DEVICE mesh at the size and sweep depth of
    bench.py's headline, so the sharding tax is one ratio against bench.py
    on the same card. Reports the median of ``n_iters`` timed calls.
    """
    from tsu_tpu.ops.checkerboard import split_checkerboard
    from tsu_tpu.ops.select import choose_sweep
    from tsu_tpu.parallel.lattice import sharded_checkerboard_sweeps

    route = choose_sweep((size, size), "uniform")
    dtype = jnp.int8 if route == "triton" else jnp.float32
    mesh = make_mesh(rows=1, devices=jax.devices()[:1])
    red, black = split_checkerboard(jnp.ones((size, size), dtype))
    sharding = NamedSharding(mesh, P("row", None))
    red = jax.device_put(red, sharding)
    black = jax.device_put(black, sharding)

    def run(i, red, black):
        return sharded_checkerboard_sweeps(
            mesh, jax.random.key(seed + i), red, black, 2.269, n_sweeps,
            periodic=True,
        )

    red, black = run(0, red, black)
    jax.block_until_ready(red)
    times = []
    for i in range(1, n_iters + 1):
        t0 = time.perf_counter()
        red, black = run(i, red, black)
        jax.block_until_ready(red)
        times.append(time.perf_counter() - t0)
    return {
        "size": size,
        "n_sweeps": n_sweeps,
        "flips_per_s": size * size * n_sweeps / float(np.median(times)),
        "kernel": route,
        "dtype": str(jnp.dtype(dtype).name),
    }


def main():
    import argparse
    import json
    import os

    parser = argparse.ArgumentParser(description="scaling-efficiency rows")
    parser.add_argument("--output-dir", default=None,
                        help="also write scaling_<backend><n>.json here")
    args = parser.parse_args()

    backend = jax.default_backend()
    result = {
        "topology": {
            "backend": backend,
            "n_devices": len(jax.devices()),
            "n_hosts": jax.process_count(),
            "shared_host_virtual_mesh": _shared_host(),
        },
        "chains": measure_chains_scaling(),
        "bnn_dp": measure_bnn_dp_scaling(),
        "lattice": measure_lattice_scaling(),
        "lattice_matched": measure_lattice_matched(),
    }
    print(json.dumps(result, indent=2, default=float))
    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)
        out = os.path.join(
            args.output_dir, f"scaling_{backend}{len(jax.devices())}.json")
        with open(out, "w") as f:
            json.dump(result, f, indent=2, default=float)
        print(f"wrote {out}")


if __name__ == "__main__":
    main()

"""Replica-axis parallel tempering on the virtual device mesh."""

import jax
import numpy as np
import pytest

from tsu_tpu.parallel.mesh import make_mesh
from tsu_tpu.parallel.tempering_sharded import parallel_tempering_replica_sharded


@pytest.fixture(autouse=True)
def _four_devices():
    if len(jax.devices()) < 4:
        pytest.skip("needs >=4 (virtual) devices")


def test_shapes_and_stats():
    mesh = make_mesh(replica=4)
    temps = np.geomspace(1.5, 5.0, 8)  # 2 replicas per device
    out = parallel_tempering_replica_sharded(
        mesh, jax.random.key(0), (8, 8), temps,
        n_samples=60, swap_interval=3, n_sweeps=1, n_burnin=20,
    )
    assert out["magnetization"].shape == (60, 8)
    assert out["rungs"].shape == (60, 8)
    # Every sample assigns each rung exactly once.
    assert np.all(np.sort(out["rungs"], axis=1) == np.arange(8))
    assert out["swap_accepts"] >= 0
    assert out["cold_magnetization"].shape == (60,)


def test_cold_chain_is_most_ordered():
    """Rung 0 (coldest T) must show larger |m| than the hottest rung."""
    mesh = make_mesh(replica=4)
    temps = np.geomspace(1.2, 6.0, 4)
    out = parallel_tempering_replica_sharded(
        mesh, jax.random.key(1), (12, 12), temps,
        n_samples=150, swap_interval=5, n_sweeps=2, n_burnin=100,
    )
    # Hot-chain trace: rung n-1.
    hot_idx = out["rungs"].argmax(axis=1)
    hot_m = out["magnetization"][np.arange(len(hot_idx)), hot_idx]
    assert np.abs(out["cold_magnetization"]).mean() > np.abs(hot_m).mean() + 0.2


def test_swaps_happen():
    mesh = make_mesh(replica=4)
    temps = np.geomspace(2.0, 3.5, 4)  # close ladder -> frequent swaps
    out = parallel_tempering_replica_sharded(
        mesh, jax.random.key(2), (8, 8), temps,
        n_samples=80, swap_interval=2, n_sweeps=1, n_burnin=10,
    )
    assert out["swap_accepts"] > 0
    # Rung assignments actually move around.
    assert (out["rungs"][0] != out["rungs"][-1]).any() or out["swap_accepts"] > 5


def test_replica_sharded_fused_path_interpret(kernel_interpret):
    """The batched GPU-kernel local sweep inside the replica-sharded PT must
    run under shard_map (interpret mode) and produce valid spins + swap
    stats."""
    mesh = make_mesh(replica=2, devices=jax.devices()[:2])
    out = parallel_tempering_replica_sharded(
        mesh, jax.random.key(3), (8, 8),
        temperatures=np.geomspace(1.5, 4.0, 4),
        n_samples=3, swap_interval=1, n_sweeps=1, n_burnin=2,
        use_pallas=True,
    )
    m = np.asarray(out["magnetization"])
    assert m.shape == (3, 4)
    assert np.all(np.abs(m) <= 1.0)
    assert out["rungs"].shape == (3, 4)

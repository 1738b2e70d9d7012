"""Smoke tests for the scaling measurement harness: fast CPU-mesh coverage
of the mechanics at tiny shapes (the numbers themselves are only meaningful
on the card)."""

import numpy as np


class TestScalingHarness:
    def test_lattice_matched_smoke(self):
        from tsu_tpu.benchmarks.scaling import measure_lattice_matched

        out = measure_lattice_matched(size=32, n_sweeps=4, n_iters=1)
        assert out["kernel"] in ("triton", "xla")
        assert out["flips_per_s"] > 0
        assert out["size"] == 32 and out["n_sweeps"] == 4

    def test_chains_scaling_smoke(self):
        from tsu_tpu.benchmarks.scaling import measure_chains_scaling

        out = measure_chains_scaling(dim=2, chains_per_device=8,
                                     n_samples=3, n_steps=2)
        assert out["1_device"]["samples_per_s"] > 0
        assert out["all_devices"]["n_devices"] >= 1

    def test_lattice_scaling_smoke(self):
        from tsu_tpu.benchmarks.scaling import measure_lattice_scaling

        out = measure_lattice_scaling(rows_per_device=8, cols=16, n_sweeps=2)
        assert out["1_device"]["flips_per_s"] > 0
        # Shared-host virtual mesh reports honest null efficiency.
        if out["all_devices"]["n_devices"] > 1:
            assert out["efficiency"] is None or 0 < out["efficiency"]


class TestProjection:
    def test_bnn_dp_scaling_smoke(self):
        from tsu_tpu.benchmarks.scaling import measure_bnn_dp_scaling

        out = measure_bnn_dp_scaling(points_per_device=64, dim=2, hidden=8,
                                     n_epochs=2)
        assert out["1_device"]["points_per_s"] > 0
        assert np.isfinite(out["all_devices"]["loss_final"])
        assert out["all_devices"]["n_points"] == \
            64 * out["all_devices"]["n_devices"]

"""Auxiliary subsystem tests: checkpoint/resume, profiling, hardware models,
demos smoke."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp


class TestCheckpoint:
    def test_roundtrip_pytree(self, tmp_path):
        from tsu_tpu.checkpoint import restore_state, save_state

        state = {
            "lattice": jnp.ones((8, 8)),
            "key": np.array([1, 2], dtype=np.uint32),
            "step": np.int64(7),
            "ladder": jnp.linspace(0.5, 4.0, 5),
        }
        p = save_state(str(tmp_path / "ckpt"), state)
        example = jax.tree.map(np.zeros_like, jax.device_get(state))
        restored = restore_state(p, example)
        np.testing.assert_array_equal(np.asarray(restored["lattice"]),
                                      np.ones((8, 8)))
        assert int(restored["step"]) == 7

    def test_resume_continues_sampling(self, tmp_path):
        """Save mid-run, restore, continue — the canonical resume flow."""
        from tsu_tpu.checkpoint import restore_state, save_state
        from tsu_tpu.ops.checkerboard import checkerboard_sweeps

        key = jax.random.key(0)
        lat = jnp.ones((8, 8))
        lat = checkerboard_sweeps(jax.random.fold_in(key, 0), lat, 2.0, 5)
        p = save_state(str(tmp_path / "mid"), {"lattice": lat, "sweep": 5})
        restored = restore_state(p, {"lattice": np.zeros((8, 8)),
                                     "sweep": 0})
        lat2 = checkerboard_sweeps(
            jax.random.fold_in(key, 1), jnp.asarray(restored["lattice"]),
            2.0, 5,
        )
        assert set(np.unique(np.asarray(lat2))) <= {-1.0, 1.0}


class TestProfiling:
    def test_timer(self):
        from tsu_tpu.profiling import Timer

        x = jnp.ones((64, 64))
        with Timer(sync_array=x) as t:
            y = x @ x
        assert t.elapsed >= 0.0

    def test_annotate_runs(self):
        from tsu_tpu.profiling import annotate

        with annotate("test-region"):
            _ = jnp.sum(jnp.ones(4))


class TestHardware:
    def test_roofline(self):
        from tsu_tpu.hardware import checkerboard_roofline, device_peaks

        peaks = device_peaks("NVIDIA H100 80GB HBM3")
        r = checkerboard_roofline(peaks, 4096, 4096, bytes_per_site=2.0)
        # 2 B/site at 3.35 TB/s: 1.675e12 site updates per second.
        assert r["flips_per_s_ceiling"] == pytest.approx(1.675e12)
        assert r["bytes_per_sweep"] == 2 * 4096 * 4096

    def test_unknown_device_has_no_peaks(self):
        from tsu_tpu.hardware import device_peaks

        with pytest.raises(ValueError, match="no published peaks"):
            device_peaks("cpu")

    def test_estimator_parity(self):
        from tsu_tpu.hardware import (ConservativeEstimator,
                                      HardwarePerformanceEstimator)

        est = HardwarePerformanceEstimator()
        out = est.estimate_sampling_time(10_000, 10, emulator_time=1.0)
        assert out["hardware_parallel_s"] < out["hardware_sequential_s"]
        cons = ConservativeEstimator()
        out_c = cons.estimate_sampling_time(10_000, 10, emulator_time=1.0)
        assert out_c["realistic_speedup"] < out["realistic_speedup"]

    def test_emulator_sample_parallel(self):
        from tsu_tpu.hardware import HardwareEmulator

        emu = HardwareEmulator(n_bits=4, parallel_chains=8)
        J = np.zeros((4, 4), np.float32)
        samples, timing = emu.sample_parallel(J, n_samples=50)
        assert samples.shape == (50, 4)
        assert timing["total_time_ns"] > 0


class TestDemos:
    @pytest.mark.slow
    def test_bayesian_inference_demo(self):
        from tsu_tpu.demos import demo_bayesian_inference

        out = demo_bayesian_inference(seed=0)
        assert np.all(np.abs(out["posterior_mean"] - out["theta_true"]) < 0.3)

    @pytest.mark.slow
    def test_multimodal_demo_covers_modes(self):
        from tsu_tpu.demos import demo_continuous_sampling

        out = demo_continuous_sampling(n_samples=500, seed=0)
        assert out["tsu"]["coverage"]["n_modes_covered"] == 3

    @pytest.mark.slow
    def test_analyze_results_report(self):
        from tsu_tpu.demos import (
            MultimodalDistribution,
            analyze_results,
            demo_continuous_sampling,
        )

        dist = MultimodalDistribution(seed=0)
        res = demo_continuous_sampling(n_samples=300, seed=0)
        out = analyze_results(res, dist, hardware_time_s=1e-4)
        assert 0.0 <= out["mode_coverage_tsu"] <= 1.0
        assert out["metric_wins"] in (0, 1, 2, 3)
        assert out["time_ratio"] > 0
        assert out["hardware_speedup"] > 0
        assert np.isfinite(out["tsu_quality"]["mean_energy"])


class TestPlotlyDashboards:
    """Reference-parity comparison dashboards (tsu/demos.py:194-431)."""

    def test_mode_visualization_figure(self):
        pytest.importorskip("plotly")
        from tsu_tpu.demos import (
            MultimodalDistribution,
            create_plotly_mode_visualization,
        )

        rng = np.random.default_rng(0)
        dist = MultimodalDistribution(seed=0)
        fig = create_plotly_mode_visualization(
            rng.normal(size=(50, dist.dim)), rng.normal(size=(50, dist.dim)),
            dist,
        )
        # MCMC + TSU + one trace per mode.
        assert len(fig.data) == 2 + dist.n_modes

    def test_energy_comparison_figure(self):
        pytest.importorskip("plotly")
        from tsu_tpu.demos import create_plotly_energy_comparison

        q = {"mean_energy": 1.0, "std_energy": 0.5, "min_energy": 0.1,
             "n_modes_covered": 3}
        q2 = {"mean_energy": 2.0, "std_energy": 0.9, "min_energy": 0.4,
              "n_modes_covered": 2}
        fig = create_plotly_energy_comparison(q, q2)
        assert len(fig.data) == 4

    def test_raises_without_plotly(self):
        try:
            import plotly  # noqa: F401

            pytest.skip("plotly installed; guard not reachable")
        except ImportError:
            pass
        from tsu_tpu.demos import create_plotly_energy_comparison

        with pytest.raises(ImportError):
            create_plotly_energy_comparison({}, {})

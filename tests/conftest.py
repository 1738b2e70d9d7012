"""Test harness: a CPU-simulated 8-device mesh (SURVEY.md §4).

Multi-device behavior (halo exchange, replica swaps, psum moments) is tested
on 8 spoofed host devices. Tests that need the GPU carry the ``gpu`` marker
and skip through the ``gpu`` fixture; run them on the card with
``TSU_TEST_GPU=1 python -m pytest tests/test_sweep_kernel.py -m gpu`` (README, "Running").
"""

import os

if not os.environ.get("TSU_TEST_GPU"):
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")

try:
    import matplotlib
except ImportError:  # plotting tests skip themselves without it
    pass
else:
    matplotlib.use("Agg", force=True)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with TSU_TEST_GPU=1 on the card)")


@pytest.fixture
def kernel_interpret(monkeypatch):
    """Route the entry points to the GPU sweep kernel on the CPU: the
    chooser answers as it would on a GPU, and the kernel runs in Pallas
    interpret mode. Exercises the kernel route's wiring without a card."""
    from tsu_tpu.ops import checkerboard_triton as ct
    from tsu_tpu.ops import select

    real_choose = select.choose_sweep
    monkeypatch.setattr(
        select, "choose_sweep",
        lambda shape, contract="uniform", *, use_pallas=None, platform=None:
            real_choose(shape, contract, use_pallas=use_pallas,
                        platform="gpu"))
    real_halfsweep = ct.halfsweep
    monkeypatch.setattr(
        ct, "halfsweep",
        lambda *a, **kw: real_halfsweep(*a, **{**kw, "interpret": True}))

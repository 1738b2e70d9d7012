"""Profiling / tracing hooks (SURVEY.md §5.1).

The reference only has wall-clock spans at call sites (tsu/api.py:88-104).
Here: the same lightweight timing metadata PLUS real device profiling via
``jax.profiler`` (TensorBoard / Perfetto traces of kernels and collectives).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import jax

# The persistent compile cache's fixed place inside the checkout (listed in
# .gitignore): a cache directory that moves between runs never hits.
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def compilation_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when it is set, else the checkout's
    fixed ``.jax_cache`` directory."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    JAX itself reads ``JAX_COMPILATION_CACHE_DIR``; when that is set this
    sets no other directory. Programs that compile in under half a second
    (the sweep kernels among them) are cached too. Safe to call repeatedly.
    """
    path = compilation_cache_dir()
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path


@contextlib.contextmanager
def trace(dir: str) -> Iterator[None]:
    """Capture a device trace around a block:

        with profiling.trace("chiprun_out/trace"):
            samples = grid.sample(100)

    View with TensorBoard (profile plugin) or Perfetto.
    """
    jax.profiler.start_trace(dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside a trace (shows up on the timeline)."""
    with jax.profiler.TraceAnnotation(name):
        yield


class Timer:
    """Wall-clock span that waits for ``sync_array`` (any pytree of device
    arrays) with ``block_until_ready`` before reading the clock."""

    def __init__(self, sync_array=None):
        self.sync_array = sync_array
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync_array is not None:
            jax.block_until_ready(self.sync_array)
        self.elapsed = time.perf_counter() - self._t0
        return False

"""Compute kernels: XLA engines, the Pallas GPU sweep kernel and its chooser."""

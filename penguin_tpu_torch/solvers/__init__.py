"""Solvers of the PyTorch port (so far the benchmark's heat stepper)."""

from .heat_fast import FastHeatBE

__all__ = ["FastHeatBE"]

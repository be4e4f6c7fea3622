"""Solvers of the PyTorch port: the scalar diffusion, advection-diffusion
and Darcy solvers, and the benchmark's heat stepper."""

from .diffusion import (
    DiffusionSteadyMono,
    DiffusionUnsteadyMono,
    DiffusionSteadyDiph,
    DiffusionUnsteadyDiph,
)
from .advdiff import (
    AdvectionDiffusionSteadyMono,
    AdvectionDiffusionUnsteadyMono,
    AdvectionDiffusionSteadyDiph,
    AdvectionDiffusionUnsteadyDiph,
)
from .darcy import DarcyFlow, DarcyFlowUnsteady, solve_darcy_velocity
from .heat_fast import FastHeatBE

__all__ = [
    "DiffusionSteadyMono",
    "DiffusionUnsteadyMono",
    "DiffusionSteadyDiph",
    "DiffusionUnsteadyDiph",
    "AdvectionDiffusionSteadyMono",
    "AdvectionDiffusionUnsteadyMono",
    "AdvectionDiffusionSteadyDiph",
    "AdvectionDiffusionUnsteadyDiph",
    "DarcyFlow",
    "DarcyFlowUnsteady",
    "solve_darcy_velocity",
    "FastHeatBE",
]

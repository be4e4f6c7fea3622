"""Solvers of the PyTorch port: the scalar diffusion, advection-diffusion
and Darcy solvers, the prescribed-motion (moving interface) diffusion
solvers, the Stefan (phase-change) and species/binary-alloy solvers, the
static, two-phase and moving-boundary Stokes solvers, the Navier-Stokes,
stream-vorticity and Navier-Stokes-scalar solvers, and the benchmark's
heat stepper."""

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
from .moving_diffusion import (
    MovingDiffusionUnsteadyMono,
    MovingDiffusionUnsteadyDiph,
    MovingAdvDiffusionUnsteadyMono,
    MovingAdvDiffusionUnsteadyDiph,
)
from .stefan1d import (
    MovingLiquidDiffusionUnsteadyMono,
    MovingLiquidDiffusionUnsteadyMonoCoupled,
    MovingLiquidDiffusionUnsteadyDiph,
    solve_stefan_1d_adaptive,
)
from .stefan2d import StefanMono2D
from .stefan2d_height import (
    MovingLiquidDiffusionUnsteadyMono2D,
    MovingLiquidDiffusionUnsteadyDiph2D,
)
from .concentration import DiffusionUnsteadyConcentration
from .binary import DiffusionUnsteadyBinary
from .stokes import StokesMono, PinPressureGauge, MeanPressureGauge
from .stokes_diph import StokesDiph
from .moving_stokes import MovingStokesMono
from .navierstokes import NavierStokesMono
from .streamvort import StreamVorticity
from .ns_scalar import (
    NavierStokesScalarCoupler,
    PassiveCoupling,
    PicardCoupling,
)
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
    "MovingDiffusionUnsteadyMono",
    "MovingDiffusionUnsteadyDiph",
    "MovingAdvDiffusionUnsteadyMono",
    "MovingAdvDiffusionUnsteadyDiph",
    "MovingLiquidDiffusionUnsteadyMono",
    "MovingLiquidDiffusionUnsteadyMonoCoupled",
    "MovingLiquidDiffusionUnsteadyDiph",
    "solve_stefan_1d_adaptive",
    "StefanMono2D",
    "MovingLiquidDiffusionUnsteadyMono2D",
    "DiffusionUnsteadyConcentration",
    "DiffusionUnsteadyBinary",
    "StokesMono",
    "PinPressureGauge",
    "MeanPressureGauge",
    "StokesDiph",
    "MovingStokesMono",
    "NavierStokesMono",
    "StreamVorticity",
    "NavierStokesScalarCoupler",
    "PassiveCoupling",
    "PicardCoupling",
    "FastHeatBE",
]

"""Darcy flow: pressure Poisson via the diffusion assembly + velocity
recovery u = -∇p (torch counterpart of ``penguin_tpu.solvers.darcy``,
reference ``src/solver/darcy.jl``)."""

from __future__ import annotations

import torch

from .diffusion import DiffusionSteadyMono, DiffusionUnsteadyMono

__all__ = ["DarcyFlow", "DarcyFlowUnsteady", "solve_darcy_velocity"]


class DarcyFlow(DiffusionSteadyMono):
    """Steady Darcy pressure solve (identical system to steady diffusion
    with D = permeability; darcy.jl:1-24)."""


class DarcyFlowUnsteady(DiffusionUnsteadyMono):
    """Unsteady Darcy pressure (darcy.jl:45-90)."""


def solve_darcy_velocity(solver, phase, state_i=0):
    """Velocity from the pressure field: u = -Wꜝ(G pω + H pγ)
    (darcy.jl:26-40).  The reference NaN-masks pressures on empty cells,
    relying on sparse structural zeros to keep fluid faces finite; with
    dense tensors masked entries are zeroed for the operator application
    and only dry faces (W == 0) are NaN-marked in the output."""
    ct = phase.capacity.cell_types
    x = solver.states[state_i] if solver.states else solver.x
    pw = torch.where(ct == 0, 0.0, x[0])
    pg = torch.where((ct == 0) | (ct == 1), 0.0, x[1])
    q = phase.operator.grad(pw, pg)
    return tuple(torch.where(phase.capacity.W[d] == 0.0, torch.nan, -q[d])
                 for d in range(len(q)))

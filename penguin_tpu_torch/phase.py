"""Phase / Fluid containers (Penguin.jl ``src/phase.jl``)."""

from __future__ import annotations

import dataclasses

__all__ = ["Phase", "Fluid"]


@dataclasses.dataclass
class Phase:
    """A scalar-transport phase: capacity + operators + source + diffusivity.

    ``source``: callable ``f(x, y, z, t)`` (or fewer args) or constant.
    ``diffusion``: callable ``D(x, y, z)`` or constant.
    """

    capacity: object
    operator: object
    source: object
    diffusion: object


@dataclasses.dataclass
class Fluid:
    """Velocity/pressure discretization bundle for (Navier-)Stokes
    (reference src/phase.jl:38-69): per-component staggered velocity meshes,
    capacities and operators, plus the pressure set and material data."""

    mesh_u: tuple
    mesh_p: object
    capacity_u: tuple
    operator_u: tuple
    capacity_p: object
    operator_p: object
    mu: object
    rho: object
    f_u: object
    f_p: object

    @property
    def ndim(self):
        return len(self.mesh_u)

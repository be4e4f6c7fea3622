"""penguin_tpu_torch — the PyTorch/CUDA port of penguin_tpu.

A second package beside the JAX one, which stays the reference.  It keeps
the JAX package's module and public names; inside it works on torch tensors
with an explicit dtype and device.  So far it covers the benchmark slice:
mesh and geometry, the dense static capacity build, the diffusion
operators, the border/interface helpers, and the backward-Euler heat
stepper ``solvers.FastHeatBE``, whose CG matvec runs through the
hand-written CUDA stencil kernels of ``kernels`` on a CUDA device.  It
never imports JAX.
"""

from .mesh import Mesh, SpaceTimeMesh
from . import geometry
from .capacity import Capacity, compute_capacity
from .operators import DiffusionOps, make_diffusion_ops
from .boundary import (
    Dirichlet,
    Neumann,
    Robin,
    Periodic,
    Symmetry,
    Outflow,
    GibbsThomson,
    ScalarJump,
    FluxJump,
    BorderConditions,
    InterfaceConditions,
)
from .phase import Phase, Fluid
from .convert import capacity_from_numpy, capacity_to_numpy

__all__ = [
    "Mesh",
    "SpaceTimeMesh",
    "geometry",
    "Capacity",
    "compute_capacity",
    "DiffusionOps",
    "make_diffusion_ops",
    "Dirichlet",
    "Neumann",
    "Robin",
    "Periodic",
    "Symmetry",
    "Outflow",
    "GibbsThomson",
    "ScalarJump",
    "FluxJump",
    "BorderConditions",
    "InterfaceConditions",
    "Phase",
    "Fluid",
    "capacity_from_numpy",
    "capacity_to_numpy",
]

"""penguin_tpu_torch — the PyTorch/CUDA port of penguin_tpu.

A second package beside the JAX one, which stays the reference.  It keeps
the JAX package's module and public names; inside it works on torch tensors
with an explicit dtype and device.  It covers:

- mesh and geometry, the static, space-time and narrow-band capacity
  builds with their cut moments (``capacity``, ``quadrature``), the
  diffusion (with the cross-moment correction) and convection operators,
  the masked mono/diph assembly and the matrix-free Krylov and dense
  solvers (``linsolve``);
- marker front tracking (``front_tracking``, ``front_tracking1d``);
- the solvers of ``solvers``: scalar diffusion, advection-diffusion and
  Darcy; the prescribed-motion diffusion solvers; the 1D, marker and
  height-function Stefan solvers with the species and binary-alloy ones;
  static, two-phase and moving-boundary Stokes; Navier-Stokes with the
  stream-vorticity and coupled scalar solvers; and the backward-Euler heat
  stepper ``FastHeatBE``, whose CG matvec runs through the hand-written
  CUDA stencil kernels of ``kernels`` on a CUDA device;
- the periphery: ``checkpoint`` (an ``.npz`` layout that both packages
  read), ``diagnostics`` (profiler spans, CUDA-synced timers,
  ``torch.profiler`` traces, Krylov histories), ``vtk`` and ``viz``
  (matplotlib).

It never imports JAX.  Entry points that make tensors put them on the CUDA
device unless they are given a device (``device="cpu"`` for the CPU) or a
capacity to follow; without a CUDA device such a call raises.
"""

from .mesh import Mesh, SpaceTimeMesh
from . import geometry
from .capacity import Capacity, compute_capacity
from .operators import (
    DiffusionOps,
    ConvectionOps,
    make_diffusion_ops,
    make_convection_ops,
)
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
from .checkpoint import (checkpoint_solver, load_checkpoint, restore_solver,
                         save_checkpoint)
from .convert import capacity_from_numpy, capacity_to_numpy
from .convergence import check_convergence, check_convergence_diph, lp_norm
from .utils import clamp_merge_small_cells

__all__ = [
    "clamp_merge_small_cells",
    "Mesh",
    "SpaceTimeMesh",
    "geometry",
    "Capacity",
    "compute_capacity",
    "DiffusionOps",
    "ConvectionOps",
    "make_diffusion_ops",
    "make_convection_ops",
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
    "save_checkpoint",
    "load_checkpoint",
    "checkpoint_solver",
    "restore_solver",
    "capacity_from_numpy",
    "capacity_to_numpy",
    "check_convergence",
    "check_convergence_diph",
    "lp_norm",
]

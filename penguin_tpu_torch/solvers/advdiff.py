"""Advection-diffusion solvers (steady/unsteady, mono/diphasic), torch.

Counterpart of ``penguin_tpu.solvers.advdiff`` (reference
``src/solver/advectiondiffusion.jl``): the flux-form convection
``ΣC + ½ΣK`` augments the bulk blocks; phases carry ``ConvectionOps``
built from a bulk velocity sampled on the DOF grid and an interface
velocity.  The time loops are those of ``diffusion.py``.
"""

from __future__ import annotations

from ..assembly import (
    border_info,
    build_I_bc,
    coefficient_diag,
    diph_apply_fn,
    diph_masks,
    diph_rhs_fn,
    mono_apply_fn,
    mono_rhs_fn,
    scalar_masks,
)
from ..linsolve import solve_linear
from .diffusion import (
    _ScalarSolverBase,
    _diph_borders,
    _march,
    _num_steps,
    _stepper,
)

__all__ = [
    "AdvectionDiffusionSteadyMono",
    "AdvectionDiffusionUnsteadyMono",
    "AdvectionDiffusionSteadyDiph",
    "AdvectionDiffusionUnsteadyDiph",
]


class AdvectionDiffusionSteadyMono(_ScalarSolverBase):
    def __init__(self, phase, bc_b, bc_i):
        cap = phase.capacity
        conv = phase.operator  # ConvectionOps
        ia, ib = build_I_bc(bc_i)
        Id = coefficient_diag(phase.diffusion, cap)
        masks = scalar_masks(conv, cap.Gamma, ia, ib, steady=True, conv=conv)
        border = border_info(cap.mesh, bc_b, capacity=cap)
        self.capacity = cap
        self.apply = mono_apply_fn(conv, Id, cap.Gamma, ia, ib, border=border,
                                   masks=masks, conv=conv)
        self._rhs = mono_rhs_fn(conv, Id, cap.Gamma, ia, ib, cap,
                                phase.source, bc_i, border=border, masks=masks,
                                conv=conv)

    def solve(self, method="auto", **kw):
        self.x = solve_linear(self.apply, self._rhs(), method=method, **kw)
        self.states = [self.x]
        return self.x


class AdvectionDiffusionUnsteadyMono(_ScalarSolverBase):
    def __init__(self, phase, bc_b, bc_i, dt, u0, scheme="BE"):
        cap = phase.capacity
        conv = phase.operator
        ia, ib = build_I_bc(bc_i)
        Id = coefficient_diag(phase.diffusion, cap)
        masks = scalar_masks(conv, cap.Gamma, ia, ib, steady=False, conv=conv)
        border = border_info(cap.mesh, bc_b, capacity=cap)
        self.capacity = cap
        self.dt = float(dt)
        self.u0 = u0
        self.apply = mono_apply_fn(conv, Id, cap.Gamma, ia, ib, dt=self.dt,
                                   scheme=scheme, border=border, masks=masks,
                                   conv=conv)
        self._rhs = mono_rhs_fn(conv, Id, cap.Gamma, ia, ib, cap,
                                phase.source, bc_i, dt=self.dt, scheme=scheme,
                                border=border, masks=masks, conv=conv)

    def solve(self, t_end, method="auto", tol=1e-12, maxiter=None,
              keep_states=True):
        step, self.krylov = _stepper(self.apply, self.u0, method, tol,
                                     maxiter)
        x0, hist = _march(step, self._rhs, self.u0, self.dt,
                          _num_steps(self.dt, t_end))
        self.x = hist[-1] if hist else x0
        self.states = [x0] + hist if keep_states else [self.x]
        return self.x


class AdvectionDiffusionSteadyDiph(_ScalarSolverBase):
    def __init__(self, phase1, phase2, bc_b, ic):
        cap1, cap2 = phase1.capacity, phase2.capacity
        c1, c2 = phase1.operator, phase2.operator
        Id1 = coefficient_diag(phase1.diffusion, cap1)
        Id2 = coefficient_diag(phase2.diffusion, cap2)
        sj, fj = ic.scalar, ic.flux
        masks = diph_masks(c1, c2, cap1.Gamma, cap2.Gamma, sj.alpha1,
                           sj.alpha2, fj.beta1, fj.beta2, steady=True,
                           conv1=c1, conv2=c2)
        border1, border2 = _diph_borders(cap1, cap2, bc_b)
        self.capacity, self.capacity2 = cap1, cap2
        self.apply = diph_apply_fn(c1, c2, Id1, Id2, ic, border1=border1,
                                   border2=border2, masks=masks, conv1=c1,
                                   conv2=c2)
        self._rhs = diph_rhs_fn(c1, c2, Id1, Id2, cap1, cap2, phase1.source,
                                phase2.source, ic, border1=border1,
                                border2=border2, masks=masks, conv1=c1,
                                conv2=c2)

    def solve(self, method="auto", **kw):
        self.x = solve_linear(self.apply, self._rhs(), method=method, **kw)
        self.states = [self.x]
        return self.x


class AdvectionDiffusionUnsteadyDiph(_ScalarSolverBase):
    def __init__(self, phase1, phase2, bc_b, ic, dt, u0, scheme="BE"):
        cap1, cap2 = phase1.capacity, phase2.capacity
        c1, c2 = phase1.operator, phase2.operator
        Id1 = coefficient_diag(phase1.diffusion, cap1)
        Id2 = coefficient_diag(phase2.diffusion, cap2)
        sj, fj = ic.scalar, ic.flux
        masks = diph_masks(c1, c2, cap1.Gamma, cap2.Gamma, sj.alpha1,
                           sj.alpha2, fj.beta1, fj.beta2, steady=False,
                           conv1=c1, conv2=c2)
        border1, border2 = _diph_borders(cap1, cap2, bc_b)
        self.capacity, self.capacity2 = cap1, cap2
        self.dt = float(dt)
        self.u0 = u0
        self.apply = diph_apply_fn(c1, c2, Id1, Id2, ic, dt=self.dt,
                                   scheme=scheme, border1=border1,
                                   border2=border2, masks=masks, conv1=c1,
                                   conv2=c2)
        self._rhs = diph_rhs_fn(c1, c2, Id1, Id2, cap1, cap2, phase1.source,
                                phase2.source, ic, dt=self.dt, scheme=scheme,
                                border1=border1, border2=border2, masks=masks,
                                conv1=c1, conv2=c2, advdiff_cn=True)

    def solve(self, t_end, method="auto", tol=1e-12, maxiter=None):
        step, self.krylov = _stepper(self.apply, self.u0, method, tol,
                                     maxiter)
        x0, hist = _march(step, self._rhs, self.u0, self.dt,
                          _num_steps(self.dt, t_end))
        self.x = hist[-1] if hist else x0
        self.states = [x0, self.x]
        return self.x

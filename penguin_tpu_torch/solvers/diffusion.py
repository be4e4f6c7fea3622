"""Scalar diffusion solvers: steady/unsteady, mono/diphasic (torch).

Counterpart of ``penguin_tpu.solvers.diffusion``: the 2-block (bulk T_omega
+ interface T_gamma) and 4-block (two phases + jump rows) systems are
solved matrix-free or by a dense LU factorized once per scheme, exactly as
the reference reuses its assembled matrix.  The JAX version jits one
implicit step and runs it under ``lax.scan``; here the steps are a Python
loop, with the same step count and the rhs evaluated at the same times.

Time-loop semantics mirror the reference's time loop
(solve_DiffusionUnsteadyMono!, src/solver/diffusion.jl:268-301): one solve
at t=0 from the initial condition, then ``ceil(Tend/dt)`` further steps with
the rhs evaluated at the *advanced* time.

The tensors follow the capacity's device; ``zero_state_*`` put theirs on
``device``, by default the CUDA device.
"""

from __future__ import annotations

import math

import torch

from .._device import resolve_device
from ..assembly import (
    border_info,
    build_I_bc,
    coefficient_diag,
    diph_apply_fn,
    diph_masks,
    diph_rhs_fn,
    mono_apply_fn,
    mono_diag_fn,
    mono_rhs_fn,
    scalar_masks,
)
from ..linsolve import DenseFactorSolver, KrylovSolver, solve_linear

__all__ = [
    "DiffusionSteadyMono",
    "DiffusionUnsteadyMono",
    "DiffusionSteadyDiph",
    "DiffusionUnsteadyDiph",
    "zero_state_mono",
    "zero_state_diph",
]


def _zeros(mesh, dtype, device):
    return torch.zeros(mesh.np_shape, dtype=dtype,
                       device=resolve_device(device))


def zero_state_mono(mesh, dtype=torch.float64, device=None):
    z = _zeros(mesh, dtype, device)
    return (z, z)


def zero_state_diph(mesh, dtype=torch.float64, device=None):
    z = _zeros(mesh, dtype, device)
    return (z, z, z, z)


def _diph_borders(cap1, cap2, bc_b):
    """Each phase's border rows, restricted to its non-empty cells."""
    return (border_info(cap1.mesh, bc_b, phase_mask=cap1.cell_types != 0,
                        capacity=cap1),
            border_info(cap2.mesh, bc_b, phase_mask=cap2.cell_types != 0,
                        capacity=cap2))


class _PhaseView:
    def __init__(self, x_omega):
        self.x_omega = x_omega


def _num_steps(dt, t_end):
    return int(math.ceil(t_end / dt - 1e-12))


def _jacobi(diag):
    """``r -> r * (1/diag)`` on the state tuple."""
    dinv = tuple(1.0 / d for d in diag)
    return lambda r: tuple(a * b for a, b in zip(r, dinv))


def _stepper(apply, u0, method, tol, maxiter, M=None):
    """(solve(b, x) -> x, the KrylovSolver or None) for a time loop:
    ``auto`` is direct up to 8000 unknowns, bicgstab above."""
    if method == "auto":
        nflat = sum(u.numel() for u in u0)
        method = "direct" if nflat <= 8000 else "bicgstab"
    if method == "direct":
        factor = DenseFactorSolver(apply, u0)
        return (lambda b, x: factor.solve(b)), None
    solver = KrylovSolver(apply, method=method, tol=tol, maxiter=maxiter, M=M,
                          template=u0)
    return (lambda b, x: solver.solve(b, x0=x)), solver


def _march(step, rhs, u0, dt, n_steps, t_start=0.0, initial_solve=True):
    """The reference loop: an optional solve at ``t_start``, then
    ``n_steps`` steps, step k with the rhs at ``t_start + (k+1)·dt``.
    Returns (x0, [x_1 .. x_n])."""
    x0 = step(rhs(u0, t_start), u0) if initial_solve else u0
    hist = []
    x = x0
    for k in range(n_steps):
        x = step(rhs(x, t_start + (k + 1.0) * dt), x)
        hist.append(x)
    return x0, hist


class _ScalarSolverBase:
    x = None
    states = None
    # the KrylovSolver of the last unsteady solve (None for direct); its
    # ``history`` holds the iterations of every step
    krylov = None

    @property
    def x_omega(self):
        return self.x[0]

    @property
    def x_gamma(self):
        return self.x[1]

    def phase_view(self, i):
        return _PhaseView(self.x[2 * i])


class DiffusionSteadyMono(_ScalarSolverBase):
    """Steady monophasic diffusion (reference DiffusionSteadyMono,
    src/solver/diffusion.jl:14-58)."""

    def __init__(self, phase, bc_b, bc_i):
        cap = phase.capacity
        ops = phase.operator
        ia, ib = build_I_bc(bc_i)
        Id = coefficient_diag(phase.diffusion, cap)
        masks = scalar_masks(ops, cap.Gamma, ia, ib, steady=True)
        border = border_info(cap.mesh, bc_b, capacity=cap)
        self.capacity = cap
        self.apply = mono_apply_fn(ops, Id, cap.Gamma, ia, ib, border=border,
                                   masks=masks)
        self._rhs = mono_rhs_fn(ops, Id, cap.Gamma, ia, ib, cap, phase.source,
                                bc_i, border=border, masks=masks)
        self._diag = mono_diag_fn(ops, Id, cap.Gamma, ia, ib, border=border,
                                  masks=masks)

    def solve(self, method="auto", precondition=True, **kw):
        b = self._rhs()
        M = None
        if precondition and method in ("cg", "bicgstab", "gmres"):
            M = _jacobi(self._diag)
        self.x = solve_linear(self.apply, b, method=method, M=M, **kw)
        self.states = [self.x]
        return self.x


class DiffusionUnsteadyMono(_ScalarSolverBase):
    """Unsteady monophasic diffusion with BE/CN theta schemes
    (reference DiffusionUnsteadyMono, src/solver/diffusion.jl:192-301)."""

    def __init__(self, phase, bc_b, bc_i, dt, u0, scheme="BE"):
        cap = phase.capacity
        ops = phase.operator
        ia, ib = build_I_bc(bc_i)
        Id = coefficient_diag(phase.diffusion, cap)
        masks = scalar_masks(ops, cap.Gamma, ia, ib, steady=False)
        border = border_info(cap.mesh, bc_b, capacity=cap)
        self.capacity = cap
        self.dt = float(dt)
        self.scheme = scheme
        self.u0 = u0
        self.apply = mono_apply_fn(ops, Id, cap.Gamma, ia, ib, dt=self.dt,
                                   scheme=scheme, border=border, masks=masks)
        self._rhs = mono_rhs_fn(ops, Id, cap.Gamma, ia, ib, cap, phase.source,
                                bc_i, dt=self.dt, scheme=scheme, border=border,
                                masks=masks)
        self._diag = mono_diag_fn(ops, Id, cap.Gamma, ia, ib, dt=self.dt,
                                  scheme=scheme, border=border, masks=masks)

    def solve(self, t_end, method="auto", tol=1e-12, maxiter=None,
              keep_states=True, t_start=0.0, initial_solve=True):
        """``t_end`` is the duration from ``t_start``.  ``initial_solve``
        performs the reference's extra solve at the start time
        (diffusion.jl loop semantics); pass False when resuming from a
        checkpoint so the step count continues exactly."""
        n_steps = _num_steps(self.dt, t_end)
        # Jacobi preconditioning: the unsteady rows mix V/dt-scaled bulk with
        # O(1) border/interface surgery rows; unpreconditioned cg/bicgstab
        # diverge once an inhomogeneous border makes the solve nontrivial
        # (pgmres equilibrates internally)
        M = (_jacobi(self._diag) if method in ("cg", "bicgstab", "gmres")
             else None)
        step, self.krylov = _stepper(self.apply, self.u0, method, tol,
                                     maxiter, M)
        x0, hist = _march(step, self._rhs, self.u0, self.dt, n_steps,
                          t_start, initial_solve)
        self.x = hist[-1] if hist else x0
        self.states = [x0] + hist if keep_states else [self.x]
        return self.x


class DiffusionSteadyDiph(_ScalarSolverBase):
    """Steady diphasic diffusion with ScalarJump/FluxJump interface rows
    (reference DiffusionSteadyDiph, src/solver/diffusion.jl:88-161)."""

    def __init__(self, phase1, phase2, bc_b, ic):
        cap1, cap2 = phase1.capacity, phase2.capacity
        ops1, ops2 = phase1.operator, phase2.operator
        Id1 = coefficient_diag(phase1.diffusion, cap1)
        Id2 = coefficient_diag(phase2.diffusion, cap2)
        a1, a2 = ic.scalar.alpha1, ic.scalar.alpha2
        b1c, b2c = ic.flux.beta1, ic.flux.beta2
        masks = diph_masks(ops1, ops2, cap1.Gamma, cap2.Gamma, a1, a2, b1c,
                           b2c, steady=True)
        border1, border2 = _diph_borders(cap1, cap2, bc_b)
        self.capacity = cap1
        self.capacity2 = cap2
        self.apply = diph_apply_fn(ops1, ops2, Id1, Id2, ic, border1=border1,
                                   border2=border2, masks=masks)
        self._rhs = diph_rhs_fn(ops1, ops2, Id1, Id2, cap1, cap2,
                                phase1.source, phase2.source, ic,
                                border1=border1, border2=border2, masks=masks)

    def solve(self, method="auto", **kw):
        self.x = solve_linear(self.apply, self._rhs(), method=method, **kw)
        self.states = [self.x]
        return self.x


class DiffusionUnsteadyDiph(_ScalarSolverBase):
    """Unsteady diphasic diffusion (reference DiffusionUnsteadyDiph,
    src/solver/diffusion.jl:319-455)."""

    def __init__(self, phase1, phase2, bc_b, ic, dt, u0, scheme="BE"):
        cap1, cap2 = phase1.capacity, phase2.capacity
        ops1, ops2 = phase1.operator, phase2.operator
        Id1 = coefficient_diag(phase1.diffusion, cap1)
        Id2 = coefficient_diag(phase2.diffusion, cap2)
        a1, a2 = ic.scalar.alpha1, ic.scalar.alpha2
        b1c, b2c = ic.flux.beta1, ic.flux.beta2
        masks = diph_masks(ops1, ops2, cap1.Gamma, cap2.Gamma, a1, a2, b1c,
                           b2c, steady=False)
        border1, border2 = _diph_borders(cap1, cap2, bc_b)
        self.capacity = cap1
        self.capacity2 = cap2
        self.dt = float(dt)
        self.scheme = scheme
        self.u0 = u0
        self.apply = diph_apply_fn(ops1, ops2, Id1, Id2, ic, dt=self.dt,
                                   scheme=scheme, border1=border1,
                                   border2=border2, masks=masks)
        self._rhs = diph_rhs_fn(ops1, ops2, Id1, Id2, cap1, cap2,
                                phase1.source, phase2.source, ic, dt=self.dt,
                                scheme=scheme, border1=border1,
                                border2=border2, masks=masks)

    def solve(self, t_end, method="auto", tol=1e-12, maxiter=None,
              keep_states=False, t_start=0.0, initial_solve=True):
        n_steps = _num_steps(self.dt, t_end)
        step, self.krylov = _stepper(self.apply, self.u0, method, tol,
                                     maxiter)
        x0, hist = _march(step, self._rhs, self.u0, self.dt, n_steps,
                          t_start, initial_solve)
        self.x = hist[-1] if hist else x0
        self.states = [x0] + hist if keep_states else [x0, self.x]
        return self.x

"""Two-phase species diffusion with a moving interface at a fixed interface
concentration (torch counterpart of ``penguin_tpu.solvers.concentration``,
reference concentrationsolver/species.jl): the ψ-weighted moving diphasic
blocks with Dirichlet interface rows C1γ = C2γ = Cm.

The time loop is a Python loop over the same K+1 slabs as the JAX
``lax.scan``.  ``method="direct"`` is the dense LU of the moving classes;
any other method runs the port's unpreconditioned ``pbicgstab`` with the
JAX version's tolerance and iteration cap, where JAX calls
``jax.scipy.sparse.linalg.bicgstab``.
"""

from __future__ import annotations

import torch

from ..assembly import border_info
from ..boundary import eval_condition_value
from ..capacity import compute_capacity_spacetime
from ..linsolve import pbicgstab
from .diffusion import _ScalarSolverBase
from .moving_diffusion import (
    _direct_solve,
    _eval_D,
    _eval_f,
    _like,
    _num_slabs,
    psi_weights,
    slice_spacetime,
)

__all__ = ["DiffusionUnsteadyConcentration"]


def build_concentration_system(cap1, cap2, D1, D2, f1, f2, Cm, border1,
                               border2, t, dt, scheme):
    """(apply, rhs) for the concentration system
    (A_concentration_unsteady_diph, species.jl:13-121): moving diphasic bulk
    blocks + identity interface rows C1γ = C2γ = Cm."""
    ops1, Va1, Vb1, G1, C1, Cg1 = slice_spacetime(cap1)
    ops2, Va2, Vb2, G2, C2, Cg2 = slice_spacetime(cap2)
    p1p, p1m = psi_weights(scheme, Vb1, Va1)
    p2p, p2m = psi_weights(scheme, Vb2, Va2)
    Id1 = _eval_D(D1, C1)
    Id2 = _eval_D(D2, C2)
    dV1, dV2 = Va1 - Vb1, Va2 - Vb2

    def apply(x):
        C1w, C1g, C2w, C2g = x
        q1 = ops1.flux(p1p * C1w, p1p * C1g)
        q2 = ops2.flux(p2p * C2w, p2p * C2g)
        r1 = Va1 * C1w + Id1 * ops1.GT(q1) - dV1 * C1g
        r3 = Va2 * C2w + Id2 * ops2.GT(q2) - dV2 * C2g
        if border1 is not None:
            r1 = border1.matvec(r1, C1w)
        if border2 is not None:
            r3 = border2.matvec(r3, C2w)
        return (r1, C1g, r3, C2g)

    def rhs(x_prev):
        C1w, C1g, C2w, C2g = x_prev
        cm = (Cm * torch.ones_like(Va1) if not callable(Cm) else
              eval_condition_value(
                  Cm, [Cg1[..., d] for d in range(Cg1.shape[-1])], t))

        def bulk(ops, Vb, Id, pm, W, Gf, f, C):
            qm = ops.flux(pm * W, pm * Gf)
            fn = _eval_f(f, C, t)
            fn1 = _eval_f(f, C, t + dt)
            if scheme == "CN":
                return Vb * W - Id * ops.GT(qm) + 0.5 * ops.V * (fn + fn1)
            return Vb * W + ops.V * fn1

        b1 = bulk(ops1, Vb1, Id1, p1m, C1w, C1g, f1, C1)
        b3 = bulk(ops2, Vb2, Id2, p2m, C2w, C2g, f2, C2)
        if border1 is not None:
            b1 = border1.rhs(b1, t)
        if border2 is not None:
            b3 = border2.rhs(b3, t)
        return (b1, cm, b3, cm)

    return apply, rhs


def _species_step(apply_fn, b, x, method, maxiter):
    """One slab solve: dense LU, or unpreconditioned BiCGStab from ``x``."""
    if method == "direct":
        return _direct_solve(apply_fn, b)
    return pbicgstab(apply_fn, b, x, tol=1e-10, maxiter=maxiter)[0]


def _species_slabs(mesh, body_st, body_c_st, t, dt, p, s, like):
    """Both phases' slab capacities [t, t+dt] and their phase masks."""
    c1 = compute_capacity_spacetime(body_st, mesh, t, t + dt, p=p, s=s,
                                    **like)
    c2 = compute_capacity_spacetime(body_c_st, mesh, t, t + dt, p=p, s=s,
                                    **like)
    return c1, c2, c1.cell_types[..., 0] != 0, c2.cell_types[..., 0] != 0


class DiffusionUnsteadyConcentration(_ScalarSolverBase):
    """Moving-interface two-phase species diffusion
    (DiffusionUnsteadyConcentration, species.jl:241-507)."""

    def __init__(self, phase1, phase2, bc_b, ic, dt, u0, mesh, scheme="BE"):
        self.phase1, self.phase2 = phase1, phase2
        self.bc_b = bc_b
        self.ic = ic
        self.dt = float(dt)
        self.u0 = u0
        self.mesh = mesh
        self.scheme = scheme

    def solve(self, body_st, body_c_st, t_start, t_end, method="direct",
              p=6, s=1):
        dt = self.dt
        K = _num_slabs(dt, t_start, t_end)
        mesh, scheme = self.mesh, self.scheme
        D1, f1 = self.phase1.diffusion, self.phase1.source
        D2, f2 = self.phase2.diffusion, self.phase2.source
        Cm = self.ic.scalar.value
        like = _like(self.u0)
        x = self.u0
        for k in range(K + 1):
            t = t_start + k * dt
            cap1, cap2, m1, m2 = _species_slabs(mesh, body_st, body_c_st, t,
                                                dt, p, s, like)
            apply_fn, rhs_fn = build_concentration_system(
                cap1, cap2, D1, D2, f1, f2, Cm,
                border_info(mesh, self.bc_b, phase_mask=m1, **like),
                border_info(mesh, self.bc_b, phase_mask=m2, **like),
                t, dt, scheme)
            x = _species_step(apply_fn, rhs_fn(x), x, method, 2000)
        self.x = x
        self.states = [x]
        return self.x

"""Binary alloy solidification: coupled temperature + concentration, two
phases, moving interface (torch counterpart of
``penguin_tpu.solvers.binary``, reference binarysolver/binary.jl).

8-block unknowns (T1ω, T1γ, T2ω, T2γ, C1ω, C1γ, C2ω, C2γ) with the moving
ψ-weighted bulk blocks per field.  Interface closure (liquidus slope ``m``,
partition coefficient ``k``):

- ``T1γ = Tm + m C1γ``   (liquidus)
- ``T2γ = T1γ``          (thermal continuity)
- ``C2γ = k C1γ``        (partition)
- species flux balance   ``β1 fluxC1 + β2 fluxC2 = h``

As in the JAX version, this is the model the reference's documentation
describes, not its internally inconsistent assembled γ-rows
(binary.jl:126-165,355-362).  The time loop and the non-direct method are
as in ``concentration``.
"""

from __future__ import annotations

import torch

from ..assembly import border_info
from .concentration import _species_slabs, _species_step
from .diffusion import _ScalarSolverBase
from .moving_diffusion import (
    _eval_D,
    _eval_f,
    _like,
    _num_slabs,
    psi_weights,
    slice_spacetime,
)

__all__ = ["DiffusionUnsteadyBinary"]


def build_binary_system(capT1, capT2, capC1, capC2, DT1, DT2, DC1, DC2,
                        fT1, fT2, fC1, fC2, Tm, m_liq, k_part, beta,
                        borders, t, dt, scheme):
    sT1 = slice_spacetime(capT1)
    sT2 = slice_spacetime(capT2)
    sC1 = slice_spacetime(capC1)
    sC2 = slice_spacetime(capC2)

    def bulk_apply(sl, D, psis, W, Gf):
        ops, Va, Vb, G0, C, Cg = sl
        pp, _ = psis
        Id = _eval_D(D, C)
        q = ops.flux(pp * W, pp * Gf)
        return Va * W + Id * ops.GT(q) - (Va - Vb) * Gf

    def flux_of(sl, D, W, Gf):
        ops, Va, Vb, G0, C, Cg = sl
        return _eval_D(D, C) * ops.HT(ops.flux(W, Gf))

    psT1 = psi_weights(scheme, sT1[2], sT1[1])
    psT2 = psi_weights(scheme, sT2[2], sT2[1])
    psC1 = psi_weights(scheme, sC1[2], sC1[1])
    psC2 = psi_weights(scheme, sC2[2], sC2[1])

    bT1, bT2_, bC1, bC2_ = borders

    def apply(x):
        T1w, T1g, T2w, T2g, C1w, C1g, C2w, C2g = x
        rT1 = bulk_apply(sT1, DT1, psT1, T1w, T1g)
        rT2 = bulk_apply(sT2, DT2, psT2, T2w, T2g)
        rC1 = bulk_apply(sC1, DC1, psC1, C1w, C1g)
        rC2 = bulk_apply(sC2, DC2, psC2, C2w, C2g)
        # interface closures
        r_liq = T1g - m_liq * C1g          # = Tm
        r_cont = T2g - T1g                 # = 0
        r_part = C2g - k_part * C1g        # = 0
        r_flux = beta[0] * flux_of(sC1, DC1, C1w, C1g) \
            + beta[1] * flux_of(sC2, DC2, C2w, C2g)
        if bT1 is not None:
            rT1 = bT1.matvec(rT1, T1w)
        if bT2_ is not None:
            rT2 = bT2_.matvec(rT2, T2w)
        if bC1 is not None:
            rC1 = bC1.matvec(rC1, C1w)
        if bC2_ is not None:
            rC2 = bC2_.matvec(rC2, C2w)
        return (rT1, r_liq, rT2, r_cont, rC1, r_flux, rC2, r_part)

    def rhs(x_prev):
        T1w, T1g, T2w, T2g, C1w, C1g, C2w, C2g = x_prev

        def bulk_rhs(sl, D, psis, W, Gf, f):
            ops, Va, Vb, G0, C, Cg = sl
            _, pm = psis
            Id = _eval_D(D, C)
            qm = ops.flux(pm * W, pm * Gf)
            fn = _eval_f(f, C, t)
            fn1 = _eval_f(f, C, t + dt)
            if scheme == "CN":
                return Vb * W - Id * ops.GT(qm) + 0.5 * ops.V * (fn + fn1)
            return Vb * W + ops.V * fn1

        r1 = bulk_rhs(sT1, DT1, psT1, T1w, T1g, fT1)
        r3 = bulk_rhs(sT2, DT2, psT2, T2w, T2g, fT2)
        r5 = bulk_rhs(sC1, DC1, psC1, C1w, C1g, fC1)
        r7 = bulk_rhs(sC2, DC2, psC2, C2w, C2g, fC2)
        z = torch.zeros_like(r1)
        if bT1 is not None:
            r1 = bT1.rhs(r1, t)
        if bT2_ is not None:
            r3 = bT2_.rhs(r3, t)
        if bC1 is not None:
            r5 = bC1.rhs(r5, t)
        if bC2_ is not None:
            r7 = bC2_.rhs(r7, t)
        return (r1, Tm * torch.ones_like(r1), r3, z, r5, z, r7, z)

    return apply, rhs


class DiffusionUnsteadyBinary(_ScalarSolverBase):
    """Coupled T/C two-phase moving-interface solver
    (DiffusionUnsteadyBinary, binary.jl:372-685)."""

    def __init__(self, phaseT1, phaseT2, phaseC1, phaseC2, bc_bT, bc_bC,
                 dt, u0, mesh, scheme="BE", Tm=0.0, m_liq=0.0, k_part=1.0,
                 beta=(1.0, 1.0)):
        self.phases = (phaseT1, phaseT2, phaseC1, phaseC2)
        self.bc_bT, self.bc_bC = bc_bT, bc_bC
        self.dt = float(dt)
        self.u0 = u0
        self.mesh = mesh
        self.scheme = scheme
        self.Tm, self.m_liq, self.k_part = Tm, m_liq, k_part
        self.beta = beta

    def solve(self, body_st, body_c_st, t_start, t_end, method="direct",
              p=6, s=1):
        dt = self.dt
        K = _num_slabs(dt, t_start, t_end)
        mesh, scheme = self.mesh, self.scheme
        pT1, pT2, pC1, pC2 = self.phases
        like = _like(self.u0)
        x = self.u0
        for k in range(K + 1):
            t = t_start + k * dt
            c1, c2, m1, m2 = _species_slabs(mesh, body_st, body_c_st, t, dt,
                                            p, s, like)
            borders = tuple(border_info(mesh, bc, phase_mask=m, **like)
                            for bc, m in ((self.bc_bT, m1), (self.bc_bT, m2),
                                          (self.bc_bC, m1), (self.bc_bC, m2)))
            apply_fn, rhs_fn = build_binary_system(
                c1, c2, c1, c2,
                pT1.diffusion, pT2.diffusion, pC1.diffusion, pC2.diffusion,
                pT1.source, pT2.source, pC1.source, pC2.source,
                self.Tm, self.m_liq, self.k_part, self.beta, borders, t, dt,
                scheme)
            x = _species_step(apply_fn, rhs_fn(x), x, method, 3000)
        self.x = x
        self.states = [x]
        return self.x

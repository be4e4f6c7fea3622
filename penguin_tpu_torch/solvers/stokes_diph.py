"""Two-phase (diphasic) Stokes with velocity-jump and traction-jump
interface coupling (torch).

Counterpart of ``penguin_tpu.solvers.stokes_diph``.  State:
(u1ωx, u1γx, u1ωy, u1γy, p1, u2ωx, u2γx, u2ωy, u2γy, p2).  Rows: per-phase
momentum and continuity exactly as :class:`StokesMono`; the uγ row slots
carry the interface conditions (the reference appends them as extra rows
of a rectangular system; the square arrangement here is equivalent):

- jump rows:  α₂ u2γ_d - α₁ u1γ_d = g_jump   ([[αu]] continuity)
- flux rows:  β₂ T_d(u2) - β₁ T_d(u1) = g_flux with the traction operator
  ``T_d = Iμ Hᵀ Wꜝ (G uω + H uγ)``.

Border Dirichlet surgery per phase overrides the interface rows at domain
borders.  The tensors follow the phases' capacities.
"""

from __future__ import annotations

import torch

from ..boundary import Dirichlet, eval_condition_value
from ..linsolve import solve_linear
from .stokes import (
    PinPressureGauge,
    StokesMono,
    stokes_divergence,
)

__all__ = ["StokesDiph"]


class StokesDiph:
    def __init__(self, fluid_a, fluid_b, bc_u_a, bc_u_b, interface,
                 pressure_gauge_a=None, pressure_gauge_b=None,
                 wall_row="center"):
        self.a = StokesMono(fluid_a, bc_u_a,
                            pressure_gauge_a or PinPressureGauge(),
                            Dirichlet(0.0), wall_row=wall_row)
        self.b_ = StokesMono(fluid_b, bc_u_b,
                             pressure_gauge_b or PinPressureGauge(),
                             Dirichlet(0.0), wall_row=wall_row)
        self.interface = interface
        self.N = fluid_a.ndim

    def _traction(self, phase, d, uw, ug):
        ops = phase.fluid.operator_u[d]
        return phase.mu_diag[d] * ops.HT(ops.flux(uw, ug))

    def apply(self, x):
        N = self.N
        na = 2 * N + 1
        xa, xb = x[:na], x[na:]
        jump, flux = self.interface.scalar, self.interface.flux
        a1, a2 = jump.alpha1, jump.alpha2
        b1, b2 = flux.beta1, flux.beta2
        out = []
        for phase, xp, other in ((self.a, xa, xb), (self.b_, xb, xa)):
            uws = xp[0:2 * N:2]
            ugs = xp[1:2 * N:2]
            p = xp[2 * N]
            for d in range(N):
                yw = phase._visc(d, uws[d], ugs[d]) + phase._grad(d, p)
                yw = torch.where(phase.u_active[d], yw, uws[d])
                if phase is self.a:
                    # jump rows: alpha2 u2g - alpha1 u1g
                    yg = a2 * other[2 * d + 1] - a1 * ugs[d]
                else:
                    # flux (traction) rows: beta2 T(u2) - beta1 T(u1)
                    yg = b2 * self._traction(self.b_, d, uws[d], ugs[d]) \
                        - b1 * self._traction(self.a, d, other[2 * d],
                                              other[2 * d + 1])
                yw, yg = phase.borders[d].matvec(yw, yg, uws[d], ugs[d])
                out += [yw, yg]
            yp = stokes_divergence(phase.fluid, uws, ugs)
            yp = torch.where(phase.p_active, yp, p)
            yp = phase._gauge_fix(yp, p)
            out.append(yp)
        return tuple(out)

    def rhs(self):
        N = self.N
        jump, flux = self.interface.scalar, self.interface.flux
        out = []
        for phase, is_a in ((self.a, True), (self.b_, False)):
            for d in range(N):
                ops = phase.fluid.operator_u[d]
                f = eval_condition_value(
                    phase.fluid.f_u,
                    [phase.fluid.capacity_u[d].C_om[..., i]
                     for i in range(phase.fluid.capacity_u[d].C_om.shape[-1])])
                bw = torch.where(phase.u_active[d], ops.V * f, 0.0)
                # C_om fallback at non-cut cells (see StokesMono._tie_points)
                val = jump.value if is_a else flux.value
                bg = eval_condition_value(
                    val, phase._tie_points(phase.fluid.capacity_u[d]))
                bw, bg = phase.borders[d].rhs(bw, bg)
                out += [bw, bg]
            bp = torch.zeros_like(phase.fluid.capacity_p.V)
            out.append(phase._gauge_rhs(bp))
        return tuple(out)

    def zero_state(self):
        return self.a.zero_state() + self.b_.zero_state()

    def solve(self, method="lstsq"):
        self.x = solve_linear(self.apply, self.rhs(), method=method)
        return self.x

    def velocity(self, phase, d, gamma=False):
        na = 2 * self.N + 1
        off = 0 if phase == 0 else na
        return self.x[off + 2 * d + (1 if gamma else 0)]

    def pressure(self, phase):
        na = 2 * self.N + 1
        return self.x[(0 if phase == 0 else na) + 2 * self.N]

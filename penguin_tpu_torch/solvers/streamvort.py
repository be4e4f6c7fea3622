"""2D streamfunction-vorticity solver on cut cells (torch).

Counterpart of ``penguin_tpu.solvers.streamvort``: per step (1) a Poisson
solve for ψ with the current vorticity as source (``A ψ = -V ω``), (2)
the velocity ``(u, v) = (∂ψ/∂y, -∂ψ/∂x)`` from the cut-cell gradient, (3)
vorticity transport by the unsteady advection-diffusion assembly with the
convection rebuilt from that velocity.  The tensors follow the capacity's
device; the border rows are built once.
"""

from __future__ import annotations

import torch

from ..assembly import (
    border_info,
    build_I_bc,
    coefficient_diag,
    gamma_value_vector,
    mono_apply_fn,
    mono_rhs_fn,
    scalar_masks,
)
from ..boundary import BorderConditions, Dirichlet
from ..linsolve import solve_linear
from ..operators import make_convection_ops
from .diffusion import _ScalarSolverBase

__all__ = ["StreamVorticity"]


class StreamVorticity(_ScalarSolverBase):
    def __init__(self, capacity, nu, dt, ops,
                 bc_stream=None, bc_vorticity=None,
                 bc_stream_border=None, bc_vorticity_border=None,
                 psi0=None, omega0=None, source=None):
        self.capacity = capacity
        self.ops = ops
        self.nu = nu
        self.dt = float(dt)
        self.bc_stream = bc_stream or Dirichlet(0.0)
        self.bc_vorticity = bc_vorticity or Dirichlet(0.0)
        self.bc_stream_border = bc_stream_border or BorderConditions({})
        self.bc_vorticity_border = bc_vorticity_border or BorderConditions({})
        self.source = source or (lambda x, y, z, t: 0.0)
        z = torch.zeros_like(capacity.V)
        self.psi = psi0 if psi0 is not None else (z, z)
        self.omega = omega0 if omega0 is not None else (z, z)
        self.velocity = (z, z)
        self.time = 0.0
        self.states = [(0.0, self.psi, self.omega)]

        like = dict(dtype=capacity.V.dtype, device=capacity.V.device)
        ia, ib = build_I_bc(self.bc_stream)
        Id = coefficient_diag(1.0, capacity)
        masks = scalar_masks(ops, capacity.Gamma, ia, ib, steady=True)
        border = border_info(capacity.mesh, self.bc_stream_border, **like)
        self._psi_apply = mono_apply_fn(ops, Id, capacity.Gamma, ia, ib,
                                        border=border, masks=masks)
        self._psi_masks = masks
        self._psi_border = border
        self._omega_border = border_info(capacity.mesh,
                                         self.bc_vorticity_border, **like)

    def solve_streamfunction(self, method="direct"):
        """Poisson solve A ψ = [-V ω; Γ g]; sets ``velocity``."""
        cap, ops = self.capacity, self.ops
        b1 = -ops.V * self.omega[0]
        b2 = cap.Gamma * gamma_value_vector(self.bc_stream, cap, self.time)
        b1 = torch.where(self._psi_masks[0], b1, 0.0)
        b2 = torch.where(self._psi_masks[1], b2, 0.0)
        b1 = self._psi_border.rhs(b1, self.time)
        self.psi = solve_linear(self._psi_apply, (b1, b2), method=method)
        # velocity from the streamfunction gradient
        q = ops.grad(self.psi[0], self.psi[1])
        self.velocity = (q[1], -q[0])
        return self.psi

    def step(self, scheme="BE", method="direct"):
        self.solve_streamfunction(method=method)
        cap = self.capacity
        u, v = self.velocity
        conv = make_convection_ops(cap, (u, v), (u, v))
        ia, ib = build_I_bc(self.bc_vorticity)
        Id = coefficient_diag(self.nu, cap)
        masks = scalar_masks(conv, cap.Gamma, ia, ib, steady=False, conv=conv)
        border = self._omega_border
        apply_fn = mono_apply_fn(conv, Id, cap.Gamma, ia, ib, dt=self.dt,
                                 scheme=scheme, border=border, masks=masks,
                                 conv=conv)
        rhs_fn = mono_rhs_fn(conv, Id, cap.Gamma, ia, ib, cap, self.source,
                             self.bc_vorticity, dt=self.dt, scheme=scheme,
                             border=border, masks=masks, conv=conv)
        b = rhs_fn(self.omega, self.time)
        self.omega = solve_linear(apply_fn, b, method=method)
        self.time += self.dt
        self.states.append((self.time, self.psi, self.omega))
        return self.omega

    def run(self, steps, scheme="BE", method="direct"):
        for _ in range(steps):
            self.step(scheme=scheme, method=method)
        return self

    def run_until(self, t_end, scheme="BE", method="direct"):
        while self.time < t_end - 1e-12:
            self.step(scheme=scheme, method=method)
        return self

"""Navier-Stokes ↔ scalar (temperature) coupling with Boussinesq buoyancy
(torch).

Counterpart of ``penguin_tpu.solvers.ns_scalar``:

- ``PassiveCoupling``: advance momentum, then transport the scalar with the
  new velocity (one way);
- ``PicardCoupling``: fixed-point sweeps per step (velocity with buoyancy
  from the scalar iterate, scalar with the new velocity) until both
  updates drop below tolerance;
- ``MonolithicCoupling``: one Newton system over (u, p, T) per step with
  the exact Jacobian (``torch.func.jacfwd``);
- buoyancy ``-ρ β g_d V_d (T|_vel - T_ref)`` on the momentum rows, with the
  fields moved between meshes by nearest-neighbour gather maps (long
  tensors on the device, built once).

``run_fast`` keeps the JAX signature; the JAX version runs it as one
compiled scan, here it is a Python loop with the Krylov telemetry read
once after the loop.  The tensors follow the momentum solver's fluid.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..assembly import (
    border_info,
    build_I_bc,
    coefficient_diag,
    mono_apply_fn,
    mono_diag_fn,
    mono_rhs_fn,
    scalar_masks,
)
from ..linsolve import (
    _lstsq_min_norm,
    _ravel,
    host_read,
    pbicgstab,
    pgmres,
    solve_linear,
)
from ..operators import make_convection_ops

__all__ = ["PassiveCoupling", "PicardCoupling", "MonolithicCoupling",
           "NavierStokesScalarCoupler"]


@dataclasses.dataclass(frozen=True)
class PassiveCoupling:
    pass


@dataclasses.dataclass(frozen=True)
class PicardCoupling:
    tol_T: float = 1e-6
    tol_U: float = 1e-6
    maxiter: int = 5
    relaxation: float = 1.0


@dataclasses.dataclass(frozen=True)
class MonolithicCoupling:
    """Fully coupled Newton over (u, p, T) per step with the exact
    Jacobian."""

    tol: float = 1e-9
    maxiter: int = 8
    damping: float = 1.0


def _nearest_map(src_coords, dst_coords):
    """Per-axis nearest-neighbour gather indices (uniform shifted grids),
    in numpy."""
    idx = np.searchsorted(src_coords, dst_coords)
    idx = np.clip(idx, 1, len(src_coords) - 1)
    lo = src_coords[idx - 1]
    hi = src_coords[idx]
    choose_lo = np.abs(dst_coords - lo) <= np.abs(hi - dst_coords)
    return np.where(choose_lo, idx - 1, idx)


def _grid_map(mesh_src, mesh_dst, device):
    """Index tensors (on ``device``) mapping a field on mesh_src's DOF grid
    to mesh_dst's."""
    maps = []
    for d in range(mesh_src.ndim):
        src = np.asarray(mesh_src.nodes[d])
        dst = np.asarray(mesh_dst.nodes[d])
        maps.append(torch.as_tensor(_nearest_map(src, dst), device=device))
    return maps


def _gather2d(field, maps):
    return field[maps[0][:, None], maps[1][None, :]]


class NavierStokesScalarCoupler:
    def __init__(self, momentum, scalar_capacity, scalar_ops, kappa,
                 scalar_source, bc_scalar, bc_scalar_cut,
                 strategy=None, beta=0.0, gravity=(0.0, -1.0), T_ref=0.0,
                 T0=None, method="lstsq"):
        self.momentum = momentum
        self.cap_T = scalar_capacity
        self.ops_T = scalar_ops
        self.kappa = kappa
        self.source_T = scalar_source
        self.bc_T = bc_scalar
        self.bc_T_cut = bc_scalar_cut
        self.strategy = strategy or PassiveCoupling()
        self.beta = float(beta)
        self.gravity = tuple(float(g) for g in gravity)
        self.T_ref = float(T_ref)
        self.method = method

        z = torch.zeros_like(scalar_capacity.V)
        self.T = T0 if T0 is not None else (z, z)
        self.x = momentum.zero_state()
        self.conv_prev = None
        self.time = 0.0
        self.states = []

        V = scalar_capacity.V
        mesh_T = scalar_capacity.mesh
        # scalar -> velocity-grid gather maps (buoyancy), velocity -> scalar
        self._T_to_u = [_grid_map(mesh_T, momentum.fluid.mesh_u[d], V.device)
                        for d in range(2)]
        self._u_to_T = [_grid_map(momentum.fluid.mesh_u[d], mesh_T, V.device)
                        for d in range(2)]
        # the scalar's border rows, built once
        self._border_T = border_info(mesh_T, bc_scalar, dtype=V.dtype,
                                     device=V.device)

    def _mom_extra(self, conv, Tw, d):
        """-ρ conv_d - ρ β g_d V_d (T|_u - T_ref) on component d."""
        mom = self.momentum
        rho_val = mom._material("rho")
        term = -rho_val * conv
        if self.beta != 0.0 and self.gravity[d] != 0.0:
            T_on_u = _gather2d(Tw, self._T_to_u[d])
            Vd = mom.fluid.operator_u[d].V
            term = term - rho_val * self.beta * self.gravity[d] * Vd * (
                T_on_u - self.T_ref)
        return term

    def _scalar_system(self, dt, scheme, x_vel):
        """(apply, rhs, diag) of the scalar step with the convection of
        the velocity ``x_vel``."""
        cap = self.cap_T
        u_onT = tuple(_gather2d(x_vel[2 * d], self._u_to_T[d])
                      for d in range(2))
        ug_onT = tuple(_gather2d(x_vel[2 * d + 1], self._u_to_T[d])
                       for d in range(2))
        conv = make_convection_ops(cap, u_onT, ug_onT)
        ia, ib = build_I_bc(self.bc_T_cut)
        Id = coefficient_diag(self.kappa, cap)
        masks = scalar_masks(conv, cap.Gamma, ia, ib, steady=False, conv=conv)
        border = self._border_T
        apply_fn = mono_apply_fn(conv, Id, cap.Gamma, ia, ib, dt=dt,
                                 scheme=scheme, border=border, masks=masks,
                                 conv=conv)
        rhs_fn = mono_rhs_fn(conv, Id, cap.Gamma, ia, ib, cap, self.source_T,
                             self.bc_T_cut, dt=dt, scheme=scheme,
                             border=border, masks=masks, conv=conv)

        def diag():
            return mono_diag_fn(conv, Id, cap.Gamma, ia, ib, dt=dt,
                                scheme=scheme, border=border, masks=masks)

        return apply_fn, rhs_fn, diag

    # -- momentum substep with buoyancy from T ---------------------------
    def _momentum_step(self, dt, theta, Tw, t):
        mom = self.momentum
        apply_fn = mom.make_unsteady_apply(dt, theta)
        rhs_fn = mom.make_unsteady_rhs(dt, theta)
        conv_c = mom.conv_vectors(self.x)
        extra = []
        for d in range(2):
            conv = (conv_c[d] if self.conv_prev is None
                    else 1.5 * conv_c[d] - 0.5 * self.conv_prev[d])
            extra.append(self._mom_extra(conv, Tw, d))
        b = rhs_fn(self.x, t, t + dt, extra_mom=tuple(extra))
        x_new = solve_linear(apply_fn, b, method=self.method)
        return x_new, conv_c

    # -- scalar substep with velocity from momentum ----------------------
    def _scalar_step(self, dt, scheme, x_vel, t):
        apply_fn, rhs_fn, _ = self._scalar_system(dt, scheme, x_vel)
        return solve_linear(apply_fn, rhs_fn(self.T, t), method=self.method)

    # -- fully coupled Newton step ---------------------------------------
    def _monolithic_step(self, dt, scheme, st):
        """One implicit step of the coupled (u, p, T) system solved by
        Newton with the exact Jacobian (``torch.func.jacfwd``) and a
        minimum-norm least-squares step (cut-off 1e-12)."""
        theta = 0.5 if scheme == "CN" else 1.0
        mom = self.momentum
        t = self.time
        N = 2
        mom_rhs = mom.make_unsteady_rhs(dt, theta)
        mom_apply = mom.make_unsteady_apply(dt, theta)
        x_prev, T_prev = self.x, self.T

        def residual(z):
            xv = z[: 2 * N + 1]
            Tv = z[2 * N + 1:]
            # momentum residual with implicit convection + buoyancy at (u,T)
            conv_c = mom.conv_vectors(xv)
            extra = tuple(self._mom_extra(conv_c[d], Tv[0], d)
                          for d in range(N))
            b_mom = mom_rhs(x_prev, t, t + dt, extra_mom=extra)
            r_mom = tuple(a - bb for a, bb in zip(mom_apply(xv), b_mom))
            # scalar residual with the convection of u
            aT, bT, _ = self._scalar_system(dt, scheme, xv)
            r_T = tuple(a - bb for a, bb in zip(aT(Tv), bT(T_prev, t)))
            return r_mom + r_T

        flat, unravel = _ravel(tuple(x_prev) + tuple(T_prev))

        def R(v):
            return _ravel(residual(unravel(v)))[0]

        jac = torch.func.jacfwd(R)
        for _ in range(st.maxiter):
            r = R(flat)
            rn = float(host_read(torch.linalg.vector_norm(r)))
            if rn < st.tol:
                break
            delta = _lstsq_min_norm(jac(flat), r, 1e-12)
            flat = flat - st.damping * delta
        z = unravel(flat)
        self.x = tuple(z[: 2 * N + 1])
        self.T = tuple(z[2 * N + 1:])
        self.conv_prev = None

    def step(self, dt, scheme="BE"):
        theta = 0.5 if scheme == "CN" else 1.0
        t = self.time
        if isinstance(self.strategy, MonolithicCoupling):
            self._monolithic_step(dt, scheme, self.strategy)
            self.time += dt
            self.states.append((self.time, self.x, self.T))
            return self.x, self.T
        if isinstance(self.strategy, PicardCoupling):
            st = self.strategy
            x_it, T_it = self.x, self.T
            conv_c = None
            for _ in range(st.maxiter):
                x_new, conv_c = self._momentum_step(dt, theta, T_it[0], t)
                T_new = self._scalar_step(dt, scheme, x_new, t)
                if st.relaxation != 1.0:
                    T_new = tuple(
                        st.relaxation * a + (1 - st.relaxation) * b_
                        for a, b_ in zip(T_new, T_it))
                # one host read for both tests
                dT, dU = host_read(torch.stack([
                    (T_new[0] - T_it[0]).abs().max(),
                    torch.stack([(a - b_).abs().max()
                                 for a, b_ in zip(x_new, x_it)]).max()]))
                x_it, T_it = x_new, T_new
                if dT < st.tol_T and dU < st.tol_U:
                    break
            self.x, self.T = x_it, T_it
            self.conv_prev = conv_c
        else:  # passive
            x_new, conv_c = self._momentum_step(dt, theta, self.T[0], t)
            self.T = self._scalar_step(dt, scheme, x_new, t)
            self.x = x_new
            self.conv_prev = conv_c
        self.time += dt
        self.states.append((self.time, self.x, self.T))
        return self.x, self.T

    def run(self, dt, t_end, scheme="BE"):
        while self.time < t_end - 1e-12:
            self.step(dt, scheme)
        return self.x, self.T

    # -- the Krylov fast path ---------------------------------------------
    def run_fast(self, dt, t_end, scheme="BE", picard_iters=None,
                 tol=1e-8, maxiter=200, method="pbicgstab", restart=60):
        """Advance to ``t_end`` with preconditioned Krylov solves: the
        stepping of :meth:`step` (AB2 convection; per-step Picard sweeps
        that update the buoyancy from the scalar iterate and the scalar
        convection from the new velocity), with momentum by the
        block-Schur ``pbicgstab`` (or ``pgmres``) and the scalar by the
        Jacobi-preconditioned one.  The sweep count is fixed
        (``picard_iters``, default the Picard strategy's ``maxiter``
        capped at 3, else 1).  ``krylov_iters_u``/``_T`` and
        ``krylov_relres_u``/``_T`` hold the last sweep's per step."""
        if method == "pgmres":
            def krylov(apply_fn, b, x0, Minv):
                return pgmres(apply_fn, b, x0, Minv=Minv, tol=tol,
                              maxiter=maxiter, restart=restart)
        else:
            def krylov(apply_fn, b, x0, Minv):
                return pbicgstab(apply_fn, b, x0, Minv=Minv, tol=tol,
                                 maxiter=maxiter)

        theta = 0.5 if scheme == "CN" else 1.0
        if picard_iters is None:
            picard_iters = (self.strategy.maxiter
                            if isinstance(self.strategy, PicardCoupling) else 1)
            picard_iters = min(int(picard_iters), 3)
        mom = self.momentum
        n_steps = int(np.ceil((t_end - self.time) / dt - 1e-12))
        apply_u = mom.make_unsteady_apply(dt, theta)
        rhs_u = mom.make_unsteady_rhs(dt, theta)
        Mu = mom.make_block_preconditioner(dt=dt, theta=theta)

        def momentum_solve(xc, conv_c, conv_p, first, Tw, t):
            extra = tuple(
                self._mom_extra(conv_c[d] if first
                                else 1.5 * conv_c[d] - 0.5 * conv_p[d],
                                Tw, d)
                for d in range(2))
            b = rhs_u(xc, t, t + dt, extra_mom=extra)
            return krylov(apply_u, b, xc, Mu)

        def scalar_solve(Tc, x_vel, t):
            af, bf, diag = self._scalar_system(dt, scheme, x_vel)
            dg = diag()

            def Minv(r):
                return tuple(a / d_ for a, d_ in zip(r, dg))

            return krylov(af, bf(Tc, t), Tc, Minv)

        first = self.conv_prev is None
        conv_p = (self.conv_prev if self.conv_prev is not None
                  else mom.conv_vectors(self.x))
        x, T = self.x, self.T
        log = []
        for k in range(n_steps):
            t = self.time + k * dt
            conv_c = mom.conv_vectors(x)
            x_it, T_it = x, T
            for _ in range(picard_iters):
                x_it, itu, rru = momentum_solve(x, conv_c, conv_p, first,
                                                T_it[0], t)
                T_it, itT, rrT = scalar_solve(T, x_it, t)
            x, T = x_it, T_it
            conv_p, first = conv_c, False
            log.append((itu, rru, itT, rrT))
        self.x, self.T, self.conv_prev = x, T, conv_p
        rel = [r for row in log for r in (row[1], row[3])]
        rel = (host_read(torch.stack(rel))
               if rel and isinstance(rel[0], torch.Tensor)
               else np.asarray(rel, dtype=np.float64))
        self.krylov_iters_u = np.asarray([row[0] for row in log], np.int64)
        self.krylov_relres_u = rel[0::2]
        self.krylov_iters_T = np.asarray([row[2] for row in log], np.int64)
        self.krylov_relres_T = rel[1::2]
        self.time += n_steps * dt
        self.states.append((self.time, self.x, self.T))
        return self.x, self.T

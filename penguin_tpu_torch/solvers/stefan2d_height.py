"""2D Stefan with a column height-function interface (torch).

Counterpart of ``penguin_tpu.solvers.stefan2d_height`` (reference
liquidmotionsolver/diffusion2d.jl): the interface is y = h(x) sampled per
x-column; per time step a fixed-point iteration solves the slab
temperature, column-sums the interface flux (height_tracking.jl:22-65),
updates the column profile ``h ← h + α res / dx`` and rebuilds the slab
geometry from the interpolated height curve.

As in the JAX version the curve is always interpolated linearly: the
``interp=`` argument is accepted and unused.  The fixed-point loop and the
time loop are Python loops; the convergence test is read on the host once
per iteration and the per-step logs once after the loop.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..assembly import border_info
from ..boundary import GibbsThomson
from ..capacity import compute_capacity_spacetime
from ..interpolation import lin_interpol
from ..linsolve import host_read
from .diffusion import _ScalarSolverBase
from .moving_diffusion import (
    _eval_D,
    _like,
    _num_slabs,
    slice_spacetime,
    solve_moving_diph_stef_step,
    solve_moving_mono_step,
)
from .stefan1d import _still_iterating

__all__ = ["MovingLiquidDiffusionUnsteadyMono2D",
           "MovingLiquidDiffusionUnsteadyDiph2D"]


def _height_body(x, y, tau, params):
    """Fluid below the interpolated height curve, heights linear in slab
    time: phi = sign·(y - h(x, tau)).  Interpolate each height snapshot in
    x, then blend in time, so tau may be any quadrature-sample shape.
    ``sign=+1`` tracks the phase below the curve, ``-1`` the phase above."""
    xs_cols, ha, hb, dt, sign = params
    ha_q = lin_interpol(xs_cols, ha, x)
    hb_q = lin_interpol(xs_cols, hb, x)
    h = ((dt - tau) * ha_q + tau * hb_q) / dt
    return sign * (y - h)


def _column_centres(mesh, like):
    nodes = np.asarray(mesh.nodes[0])
    return torch.as_tensor(0.5 * (nodes[:-1] + nodes[1:]), **like)


def _column_sum(a, nx):
    """Sum over the transverse (y) direction, real cells only."""
    return a[:nx, :].sum(dim=1)


def _height_march(newton, u0, h0, t_start, dt, K, max_iter, tol, alpha, dx):
    """The K+1 steps of a height solver: ``newton(Told, h_a, h_b, extra,
    t)`` returns (state, column residual, extra) for one fixed-point
    iteration; ``extra`` (the Gibbs-Thomson velocity) starts at zero.
    Returns (state, heights, height log, errs, iterations)."""
    like = _like(u0)
    X = u0
    h = torch.as_tensor(h0, **like)
    hs, errs, iters = [], [], []
    for k in range(K + 1):
        t = t_start + k * dt
        Xold, h_start = X, h
        extra = torch.zeros_like(Xold[0])
        err = torch.full((), math.inf, **like)
        it = 0
        while _still_iterating(it, max_iter, tol, err):
            X, res, extra = newton(Xold, h_start, h, extra, t)
            # res is in column-volume units; convert to height units
            h = h + alpha * res / dx
            err = torch.linalg.norm(res)
            it += 1
        hs.append(h)
        errs.append(err)
        iters.append(it)
    return (X, host_read(h), host_read(torch.stack(hs)),
            host_read(torch.stack(errs)), np.asarray(iters))


class MovingLiquidDiffusionUnsteadyMono2D(_ScalarSolverBase):
    def __init__(self, phase, bc_b, bc_i, dt, u0, mesh, scheme="BE"):
        self.phase = phase
        self.bc_b = bc_b
        self.bc_i = bc_i
        self.dt = float(dt)
        self.u0 = u0
        self.mesh = mesh
        self.scheme = scheme
        self.border = border_info(mesh, bc_b, **_like(u0))

    def solve(self, h0, t_start, t_end, ic,
              newton_params=(100, 1e-8, 1e-8, 1.0), interp="linear",
              method="auto", p=4, s=1):
        """``h0``: initial interface positions per x-column (length nx).
        ``ic.flux.value`` is ρL.  Returns the final temperature; height
        history in ``self.height_log``."""
        dt = self.dt
        K = _num_slabs(dt, t_start, t_end)
        max_iter, tol, _, alpha = newton_params
        rhoL = ic.flux.value
        D, f = self.phase.diffusion, self.phase.source
        bc_i, border, mesh, scheme = self.bc_i, self.border, self.mesh, \
            self.scheme
        nx = mesh.n[0]
        like = _like(self.u0)
        xs_cols = _column_centres(mesh, like)
        gibbs = isinstance(bc_i, GibbsThomson)

        def slab_solve(Told, h_a, h_b, v_g, t):
            cap = compute_capacity_spacetime(
                _height_body, mesh, 0.0, dt, p=p, s=s,
                params=(xs_cols, h_a, h_b, dt, 1.0), **like)
            # Gibbs-Thomson feed (diffusion2d.jl:94-101): the interface
            # value is depressed by the kinetic term of the previous
            # iteration's flux velocity |flux|/(ρL Δt), the reference's
            # always-undercooling |v| form
            g = bc_i.Tm - bc_i.eps_v * v_g if gibbs else None
            T, _, _ = solve_moving_mono_step(
                cap, D, f, bc_i, border, Told, t, dt, scheme, tol=1e-9,
                maxiter=800, g_override=g, method=method)
            ops, Va, Vb, _, C_sp, _ = slice_spacetime(cap)
            flux = _eval_D(D, C_sp) * ops.HT(ops.flux(T[0], T[1]))
            v_new = flux.abs() / (rhoL * dt) if gibbs else v_g
            res = (_column_sum(Va, nx) - _column_sum(Vb, nx)
                   - _column_sum(flux, nx) / rhoL)
            return T, res, v_new

        (self.x, self.heights, self.height_log, self.newton_errs,
         self.newton_iters) = _height_march(
            slab_solve, self.u0, h0, t_start, dt, K, int(max_iter), tol,
            alpha, mesh.h[0])
        self.states = [self.x]
        return self.x


class MovingLiquidDiffusionUnsteadyDiph2D(_ScalarSolverBase):
    """Two-phase height-function Stefan solver
    (solve_MovingLiquidDiffusionUnsteadyDiph2D!, diffusion2d.jl:652-1100):
    phase 1 below the height curve, phase 2 above; per fixed-point
    iteration the diphasic-Stefan slab system is solved and the column
    residual sums both phases' interface fluxes:

        res(x) = H1_{n+1}(x) - H1_n(x) - (1/ρL) Σ_col (flux1 + flux2)
        h <- h + α res / dx
    """

    def __init__(self, phase1, phase2, bc_b, ic, dt, u0, mesh, scheme="BE"):
        self.phase1, self.phase2 = phase1, phase2
        self.bc_b = bc_b
        self.ic = ic
        self.dt = float(dt)
        self.u0 = u0
        self.mesh = mesh
        self.scheme = scheme

    def solve(self, h0, t_start, t_end,
              newton_params=(100, 1e-8, 1e-8, 1.0), interp="linear",
              method="auto", p=4, s=1):
        """``h0``: initial interface height per x-column.  State ``u0`` is
        (TW1, TG1, TW2, TG2).  Height history in ``self.height_log``."""
        dt = self.dt
        K = _num_slabs(dt, t_start, t_end)
        max_iter, tol, _, alpha = newton_params
        rhoL = self.ic.flux.value
        mesh, scheme, ic, bc_b = self.mesh, self.scheme, self.ic, self.bc_b
        D1, f1 = self.phase1.diffusion, self.phase1.source
        D2, f2 = self.phase2.diffusion, self.phase2.source
        nx = mesh.n[0]
        like = _like(self.u0)
        xs_cols = _column_centres(mesh, like)

        def slab_solve(Xold, h_a, h_b, extra, t):
            caps = [compute_capacity_spacetime(
                _height_body, mesh, 0.0, dt, p=p, s=s,
                params=(xs_cols, h_a, h_b, dt, sg), **like)
                for sg in (1.0, -1.0)]
            b1m, b2m = (border_info(mesh, bc_b,
                                    phase_mask=c.cell_types[..., 0] != 0,
                                    **like) for c in caps)
            X, _, _ = solve_moving_diph_stef_step(
                caps[0], caps[1], D1, D2, f1, f2, ic, b1m, b2m, Xold, t, dt,
                scheme, tol=1e-9, maxiter=800, method=method)
            s1, s2 = slice_spacetime(caps[0]), slice_spacetime(caps[1])
            flux1 = _eval_D(D1, s1[4]) * s1[0].HT(s1[0].flux(X[0], X[1]))
            flux2 = _eval_D(D2, s2[4]) * s2[0].HT(s2[0].flux(X[2], X[3]))
            res = (_column_sum(s1[1], nx) - _column_sum(s1[2], nx)
                   - _column_sum(flux1 + flux2, nx) / rhoL)
            return X, res, extra

        (self.x, self.heights, self.height_log, self.newton_errs,
         self.newton_iters) = _height_march(
            slab_solve, self.u0, h0, t_start, dt, K, int(max_iter), tol,
            alpha, mesh.h[0])
        self.states = [self.x]
        return self.x

"""Prescribed-motion (moving-boundary) Stokes (torch).

Counterpart of ``penguin_tpu.solvers.moving_stokes``: per time step the
velocity-component and pressure capacities are rebuilt on the space-time
slab (on the device) and the unsteady Stokes system is assembled from the
slab's spatial blocks:

  momentum d: (Iρ V^st/dt) uω + θ visc^st(Ψ⁺ ·) uω/uγ - ΔV uγ + grad^st p
  tie d:      Ψ⁺ uγ = Ψ⁺ g_cut
  continuity: spatial slices of the slab pressure operators

(the reference's moving_stokes2D_blocks).  For a static body this reduces
exactly to the unsteady Stokes θ-scheme: the slab capacities carry the dt
factors.  The JAX version runs the slabs under ``lax.scan``; here they are
a Python loop over the same slabs, the slab start ``t`` a host float, so
condition and force callables get a Python float time while the slab body
gets tensors.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..assembly import _col_G_nz
from ..boundary import Dirichlet, Outflow, eval_condition_value
from ..capacity import compute_capacity_spacetime, gamma_half_moments
from ..linsolve import (
    _lstsq_min_norm,
    fgmres,
    materialize_dense,
    pgmres,
    row_norm_equilibrator,
)
from ..operators import (
    _LsqGradient,
    _cross_weights,
    _shift_m,
    _shift_p,
    dm,
    dm_t,
    sw_apply,
    sw_applyT,
)
from .moving_diffusion import (
    psi_weights,
    slice_spacetime,
    spatial_capacity_from_slab,
)
from .stokes import (
    _AXIS_KEYS,
    _AXIS_KEYS_1D,
    PinPressureGauge,
    StokesMono,
    VelocityBorder,
)

__all__ = ["MovingStokesMono"]


class MovingStokesMono:
    """The tensors follow the fluid's capacities (device and dtype); every
    slab capacity is built there."""

    def __init__(self, fluid, bc_u, pressure_gauge=None, bc_cut=None,
                 cut_flux="auto"):
        self.fluid = fluid
        self.bc_u = bc_u if isinstance(bc_u, tuple) else (bc_u,)
        self.bc_cut = bc_cut or Dirichlet(0.0)
        self.N = fluid.ndim
        Vp_t = fluid.capacity_p.V
        self._like = dict(dtype=Vp_t.dtype, device=Vp_t.device)
        # ``cut_flux="moment"``: the moment-consistent cut flux on the
        # space-time slab (spatial_capacity_from_slab): per step the slab
        # capacities carry their cut moments and the γ placement and
        # wet-line cross-moment corrections act on the time-integrated
        # measures.  "auto" = "moment" for N >= 2, "centroid" in 1D
        if cut_flux == "auto":
            cut_flux = "moment" if self.N >= 2 else "centroid"
        self.cut_flux = cut_flux
        self.borders = tuple(
            VelocityBorder(fluid.mesh_u[d], self.bc_u[d], d, **self._like)
            for d in range(self.N))
        gauge = pressure_gauge or PinPressureGauge()
        Vp = Vp_t.detach().cpu().numpy()
        # Outflow plane closure (as in StokesMono): the outlet border
        # plane's continuity rows become p = 0; the plane is chosen
        # statically (the moving body must not cross the outlet)
        p_shape = Vp.shape
        keymap = _AXIS_KEYS_1D if self.N == 1 else _AXIS_KEYS
        out_mask = np.zeros(p_shape, bool)
        for bc_i_, bc in enumerate(self.bc_u):
            for key, cond in bc.borders:
                if not isinstance(cond, Outflow) or key not in keymap:
                    continue
                axis, side = keymap[key]
                if axis >= self.N or axis != bc_i_:
                    continue
                sl = [slice(None)] * len(p_shape)
                sl[axis] = 0 if side == 0 else fluid.mesh_p.n[axis] - 1
                out_mask[tuple(sl)] = True
        dev = self._like["device"]
        self.outflow_p_mask = (torch.as_tensor(out_mask, device=dev)
                               if out_mask.any() else None)
        if self.outflow_p_mask is not None:
            self.pin_mask = torch.zeros(p_shape, dtype=torch.bool, device=dev)
        else:
            idx = gauge.index if isinstance(gauge, PinPressureGauge) \
                else None
            if idx is None:
                flatF = Vp.ravel(order="F")
                k = int(np.argmax(flatF > 1e-12)) \
                    if (flatF > 1e-12).any() else 0
                idx = np.unravel_index(k, Vp.shape, order="F")
            pin = np.zeros(Vp.shape, bool)
            pin[tuple(int(v) for v in idx)] = True
            self.pin_mask = torch.as_tensor(pin, device=dev)

    def _slab_system(self, body_st, t, dt, theta, scheme, p, s, x_prev,
                     t_next):
        """(apply, rhs) of the slab starting at ``t``: ``apply(x)`` the slab
        operator, ``rhs()`` its right-hand side from ``x_prev``."""
        N = self.N
        fl = self.fluid
        like = self._like
        moment = self.cut_flux == "moment"
        comp = []
        caps_sp = []
        ghm = []
        for d in range(N):
            cap_st = compute_capacity_spacetime(
                body_st, fl.mesh_u[d], 0.0, dt, p=p, s=s, params=(t,),
                cut_moments=moment, **like)
            sl = slice_spacetime(cap_st)
            if moment:
                cap_sp = spatial_capacity_from_slab(cap_st, fl.mesh_u[d])
                caps_sp.append(cap_sp)
                ghm.append(gamma_half_moments(cap_sp))
                sl = (dataclasses.replace(sl[0],
                                          Xw=_cross_weights(cap_sp)),) \
                    + sl[1:]
            comp.append(sl)
        cap_p_st = compute_capacity_spacetime(
            body_st, fl.mesh_p, 0.0, dt, p=p, s=s, params=(t,),
            cut_moments=moment, **like)
        ops_p, Va_p, Vb_p, _, _, _ = slice_spacetime(cap_p_st)
        ghm_p = None
        divw = None
        if moment:
            cap_p_sp = spatial_capacity_from_slab(cap_p_st, fl.mesh_p)
            ghm_p = gamma_half_moments(cap_p_sp)
            # wet-face cross-moment div/grad pair (see StokesMono.__init__)
            divw = []
            hmax = max(float(v) for v in fl.mesh_p.h)
            for d in range(N):
                cap_u = caps_sp[d]
                lsq = _LsqGradient(cap_u)
                delta = torch.clamp(cap_p_sp.Am[d] - cap_u.C_om, -hmax, hmax)
                face_cut = (cap_p_sp.cell_types == -1) | \
                    (cap_u.cell_types == -1)
                delta = torch.where(face_cut[..., None], delta, 0.0)
                delta = delta * cap_p_sp.A[d][..., None]
                divw.append(lsq.weights_for(delta))

        mu = fl.mu
        rho = fl.rho

        def coef(c, C_sp):
            if callable(c):
                return eval_condition_value(
                    c, [C_sp[..., i] for i in range(C_sp.shape[-1])])
            return c

        def cut_value(d, pts, tt):
            return eval_condition_value(self._cut(d).value,
                                        [pts[..., i] for i in range(N)], tt)

        psis = [psi_weights(scheme, sl[2], sl[1]) for sl in comp]
        u_act = [_col_G_nz(sl[0]) | (sl[1] != 0) | (sl[2] != 0)
                 for sl in comp]
        p_act = _col_G_nz(ops_p)

        def apply(x):
            uws = x[0:2 * N:2]
            ugs = x[1:2 * N:2]
            pp = x[2 * N]
            out = []
            for d in range(N):
                ops, Va, Vb, G0, C_sp, Cg = comp[d]
                Imu = coef(mu, C_sp)
                Irho = coef(rho, C_sp)
                pplus = psis[d][0]
                q = ops.flux(pplus * uws[d], pplus * ugs[d])
                dV = Va - Vb
                # the mass carries the slab-face volumes (Va here, Vb in
                # the rhs): with the -dV uγ swept-momentum term any rigid
                # motion u = uγ = U solves the momentum row exactly
                yw = (
                    Irho * Va * uws[d]
                    + theta * Imu * ops.GT(q)
                    - dV * ugs[d]
                    - ops_p.A[d] * dm(pp, d)
                )
                if divw is not None:
                    yw = yw - sw_applyT(divw[d], dm(pp, d))
                yw = torch.where(u_act[d], yw, uws[d])
                yg = pplus * ugs[d]
                yg = torch.where(pplus != 0, yg, ugs[d])
                yw, yg = self.borders[d].matvec(yw, yg, uws[d], ugs[d])
                out += [yw, yg]
            yp = 0.0
            for d in range(N):
                Ap = ops_p.A[d]
                Bp = ops_p.B[d]
                yp = yp - dm_t(Ap * uws[d], d) + dm_t(Ap * ugs[d], d) \
                    - Bp * dm_t(ugs[d], d)
                if divw is not None:
                    yp = yp - dm_t(sw_apply(divw[d], uws[d]), d)
            yp = torch.where(p_act, yp, pp)
            yp = torch.where(self.pin_mask, pp, yp)
            if self.outflow_p_mask is not None:
                yp = torch.where(self.outflow_p_mask, pp, yp)
            return tuple(out) + (yp,)

        def rhs():
            out = []
            for d in range(N):
                ops, Va, Vb, G0, C_sp, Cg = comp[d]
                Imu = coef(mu, C_sp)
                Irho = coef(rho, C_sp)
                pplus = psis[d][0]
                uw_p = x_prev[2 * d]
                ug_p = x_prev[2 * d + 1]
                coords = [C_sp[..., i] for i in range(C_sp.shape[-1])]
                fu_d = fl.f_u[d] if isinstance(fl.f_u, (tuple, list)) \
                    else fl.f_u
                f_p = eval_condition_value(fu_d, coords, t_next - dt)
                f_n = eval_condition_value(fu_d, coords, t_next)
                load = ops.V * (theta * f_n + (1 - theta) * f_p)
                q = ops.flux(pplus * uw_p, pplus * ug_p)
                # Vb mass here pairs with the Va mass and the swept -dV uγ
                # of the operator: rigid motions are exact
                bw = Irho * Vb * uw_p \
                    - (1 - theta) * Imu * ops.GT(q) + load
                # γ-tie points: C_ga where the slab is cut, the slab cell
                # centroid elsewhere (the slab C_ga is the zero vector at
                # non-cut cells, whose uγ still reach cut continuity rows)
                Cgf = torch.where((G0 > 0)[..., None], Cg, C_sp)
                if moment:
                    # slab γ placement correction (StokesMono.
                    # _gamma_moment_rhs on the time-integrated half-strip
                    # measures), in time by the scheme's own θ weights
                    for tw, tt in ((theta, t_next),
                                   (1.0 - theta, t_next - dt)):
                        if tw == 0.0:
                            continue
                        g_cga = cut_value(d, Cgf, tt)
                        dq = []
                        for a in range(N):
                            S_lo, X_lo, S_hi, X_hi = ghm[d][a]
                            D_lo = pplus * S_lo * (cut_value(d, X_lo, tt)
                                                   - g_cga)
                            D_hi = pplus * S_hi * (cut_value(d, X_hi, tt)
                                                   - g_cga)
                            dq.append(_shift_m(D_hi, a) + D_lo)
                        bw = bw - tw * Imu * ops.GT(ops.Wq(tuple(dq)))
                bw = torch.where(u_act[d], bw, 0.0)
                g = eval_condition_value(
                    self._cut(d).value,
                    [Cgf[..., i] for i in range(Cgf.shape[-1])], t_next)
                bg = pplus * g
                # dead slots keep an identity row solving uγ = g (not 0):
                # the continuity H-term differences uγ across cells
                bg = torch.where(pplus != 0, bg, g * torch.ones_like(bg))
                bw, bg = self.borders[d].rhs(bw, bg, t_next)
                out += [bw, bg]
            bp = torch.zeros_like(self.fluid.capacity_p.V)
            if moment:
                # continuity γ placement correction (StokesMono.
                # _cont_moment_rhs) on the slab p-mesh half-strip moments
                delta = 0.0
                for d in range(N):
                    _, _, _, G0d, C_spd, Cgd = comp[d]
                    Cgf = torch.where((G0d > 0)[..., None], Cgd, C_spd)
                    gtie = torch.broadcast_to(cut_value(d, Cgf, t_next),
                                              G0d.shape)
                    S_lo, X_lo, S_hi, X_hi = ghm_p[d]
                    delta = delta \
                        + S_lo * (cut_value(d, X_lo, t_next) - gtie) \
                        + S_hi * (cut_value(d, X_hi, t_next)
                                  - _shift_p(gtie, d))
                bp = torch.where(p_act, -delta, bp)
            bp = torch.where(self.pin_mask, 0.0, bp)
            if self.outflow_p_mask is not None:
                bp = torch.where(self.outflow_p_mask, 0.0, bp)
            return tuple(out) + (bp,)

        return apply, rhs

    def _cut(self, d):
        bc = self.bc_cut
        return bc[d] if isinstance(bc, (tuple, list)) else bc

    def zero_state(self):
        out = []
        for d in range(self.N):
            z = torch.zeros_like(self.fluid.operator_u[d].V)
            out += [z, z]
        return tuple(out) + (torch.zeros_like(self.fluid.capacity_p.V),)

    def solve(self, body_st, dt, t_start, t_end, scheme="BE", x0=None,
              p=4, s=1, method="lstsq", tol=1e-10, maxiter=2000):
        """``body_st(x..., tau, params)`` is evaluated on the slab with the
        slab-relative time tau in [0, dt]; ``params[0]`` is the absolute
        slab start (a Python float), so rigid motions can be expressed.

        ``method``: "lstsq" (the dense minimum-norm SVD solve of every slab,
        cut-off 1e-12, on every device: robust on small grids, O(n³)),
        "pgmres" (row-equilibrated restarted GMRES warm-started from the
        previous step) or "fgmres" (flexible GMRES with the static
        geometry's block-Schur/DCT preconditioner, the scalable choice at
        n >= 32 where equilibrated pgmres stalls).  The slabs start at
        ``t_start + k·dt`` for k < ceil((t_end - t_start)/dt).  Sets
        ``krylov_iters`` and ``krylov_relres`` per slab."""
        theta = 0.5 if scheme == "CN" else 1.0
        K = int(math.ceil((t_end - t_start) / dt - 1e-12))
        x = x0 if x0 is not None else self.zero_state()

        M_static = None
        if method == "fgmres":
            ref = StokesMono(self.fluid, self.bc_u, PinPressureGauge(),
                             self.bc_cut, cut_flux="centroid")
            M_static = ref.make_block_preconditioner(
                dt=dt, theta=theta, schur="dct_cg", schur_cg_iters=8)

        iters, res = [], []
        for k in range(K):
            t = t_start + k * dt
            apply_fn, rhs_fn = self._slab_system(
                body_st, t, dt, theta, scheme, p, s, x, t + dt)
            b = rhs_fn()
            if method == "fgmres":
                x, it, rr = fgmres(apply_fn, b, x, Minv=M_static, tol=tol,
                                   maxiter=maxiter, restart=60)
            elif method == "pgmres":
                Minv = row_norm_equilibrator(apply_fn, b)
                x, it, rr = pgmres(apply_fn, b, x, Minv=Minv, tol=tol,
                                   maxiter=maxiter, restart=60)
            else:
                x, it, rr = _lstsq_slab(apply_fn, b), 0, 0.0
            iters.append(it)
            res.append(float(rr))
        self.x = x
        # telemetry per slab (the JAX class keeps none): Krylov iterations
        # and relative residual (true for fgmres, equilibrated for pgmres,
        # 0 for lstsq)
        self.krylov_iters = np.asarray(iters)
        self.krylov_relres = np.asarray(res)
        return self.x

    def velocity(self, d, gamma=False):
        return self.x[2 * d + (1 if gamma else 0)]

    @property
    def pressure(self):
        return self.x[2 * self.N]


def _lstsq_slab(apply_fn, b):
    """The slab matrix materialized, rows and columns below 1e-13 in
    absolute sum made identity, and solved by the minimum-norm SVD least
    squares with the cut-off 1e-12 (``torch.linalg.lstsq`` on CUDA assumes
    full rank; the sliver rows here are near-singular)."""
    A, unravel = materialize_dense(apply_fn, b)
    flat = torch.cat([leaf.reshape(-1) for leaf in b])
    keep = (A.abs().sum(dim=1) > 1e-13) & (A.abs().sum(dim=0) > 1e-13)
    dd = keep.to(A.dtype)
    A = A * dd[:, None] * dd[None, :] + torch.diag(1.0 - dd)
    return unravel(_lstsq_min_norm(A, torch.where(keep, flat, 0.0), 1e-12))

"""Incompressible Navier-Stokes on the staggered cut-cell Stokes layout
(torch).

Counterpart of ``penguin_tpu.solvers.navierstokes``:

- flux-form skew convection per component d: the primary term
  ``Dp_d(Sm_d(A_d u_d) ⊙ Sm_d(q))`` plus the cross terms ``Dp_j(Sm_d(A_j
  u_j) ⊙ Sm_j(q))``, with a one-sided upwind replacement on the last live
  plane of an own-axis Outflow border (either side);
- interface transfer ``K_d = diag(Sp_d(Hᵀ u_γ^rot))``;
- the unsteady θ-scheme with Adams-Bashforth-2 extrapolated explicit
  convection, or implicit (Picard-linearised) convection per step;
- steady Picard, dense Newton (``torch.func.jacfwd`` of the residual) and
  Jacobian-free Newton-Krylov (``torch.func.jvp``);
- control-volume forces and least-squares pressure probes.

The JAX version runs each time span as one ``lax.scan`` and caches the
compiled scan; here the steps are a Python loop with ``t`` a host float.
A per-step ``record`` is evaluated on the device, and its values and the
Krylov telemetry are read once after the loop.  A callable ρ or μ raises
where the JAX version silently uses 1 (convection, forces).
"""

from __future__ import annotations

import numpy as np
import torch

from ..boundary import Outflow
from ..linsolve import (
    DenseFactorSolver,
    _lstsq_min_norm,
    _ravel,
    fgmres,
    gmres,
    host_read,
    pbicgstab,
    pgmres,
    solve_linear,
)
from ..operators import _shift_m, _shift_p, dp, sm, sp
from .stokes import _AXIS_KEYS, _AXIS_KEYS_1D, StokesMono

__all__ = ["NavierStokesMono"]


def _max_diff(xs, ys):
    """max_k max|xs[k] - ys[k]| as one host read."""
    return float(host_read(torch.stack(
        [(a - c).abs().max() for a, c in zip(xs, ys)]).max()))


class NavierStokesMono(StokesMono):
    """Steady and unsteady incompressible Navier-Stokes (the Stokes blocks
    plus convection).  The tensors follow the fluid's capacities."""

    # the unsteady steppers' Krylov ``_reduce`` (``linsolve``): None on the
    # whole grid; ``parallel.sharding``'s rank solver sums over the ranks
    _krylov_reduce = None

    def __init__(self, fluid, bc_u, pressure_gauge=None, bc_cut=None,
                 wall_row="center", cut_row="center", cut_flux="auto"):
        super().__init__(fluid, bc_u, pressure_gauge, bc_cut,
                         wall_row=wall_row, cut_row=cut_row,
                         cut_flux=cut_flux)
        # the outlet-plane masks, built once on the fluid's device (a copy
        # from the host per call would wait for the device every time)
        keymap = _AXIS_KEYS_1D if self.N == 1 else _AXIS_KEYS
        masks = []
        for c in range(self.N):
            items = []
            for key, cond in self.bc_u[c].borders:
                if not isinstance(cond, Outflow) or key not in keymap:
                    continue
                axis, side = keymap[key]
                if axis != c:
                    continue
                shape = self.fluid.mesh_u[c].np_shape
                m = np.zeros(shape, bool)
                sl = [slice(None)] * len(shape)
                sl[axis] = 0 if side == 0 else \
                    self.fluid.mesh_u[c].n[axis] - 1
                m[tuple(sl)] = True
                items.append((axis, side, torch.as_tensor(
                    m, device=self._like["device"])))
            masks.append(tuple(items))
        self._conv_out_masks = tuple(masks)

    def _material(self, name):
        """ρ or μ as a float; a callable raises (the JAX version uses 1)."""
        v = getattr(self.fluid, name)
        if callable(v):
            raise ValueError(
                f"NavierStokesMono: a callable {name} is not supported by "
                f"the convection term and the force diagnostics (the JAX "
                f"package silently uses 1 there); pass a number")
        return float(v)

    # ------------------------------------------------------------------
    # convection operators (matrix-free)
    # ------------------------------------------------------------------
    def _conv_outflow_masks(self, d):
        """Outlet-plane masks (one per own-axis Outflow border, either
        side) on component d's grid: ``(axis, side, mask)`` items."""
        return self._conv_out_masks[d]

    def conv_bulk(self, d, uw_all, q):
        """C_d(u) q: flux-form convection of q on component d's grid.  On
        the last live plane of an own-axis Outflow border the centred
        stencil (which sees the structurally zeroed padding plane, a
        75%-blocked wall) is replaced by an upwind one-sided difference."""
        A = self.fluid.capacity_u[d].A
        own_g = sm(A[d] * uw_all[d], d) * sm(q, d)
        out = dp(own_g, d)
        for axis, side, mask in self._conv_outflow_masks(d):
            if side == 1:      # high-side outlet: backward one-sided diff
                repl = own_g - _shift_m(own_g, axis)
            else:              # low-side outlet: forward one-sided diff,
                # one face inward (own_g[0] is the truncated quarter flux)
                s1 = _shift_p(own_g, axis)
                repl = _shift_p(s1, axis) - s1
            out = torch.where(mask, repl, out)
        for j in range(self.N):
            if j == d:
                continue
            flux_c = sm(A[j] * uw_all[j], d)
            out = out + dp(flux_c * sm(q, j), j)
        return out

    def conv_K(self, d, ug_all):
        """diag weights of K_d (interface transfer)."""
        faces = tuple(ug_all[(d + a) % self.N] for a in range(self.N))
        return sp(self.fluid.operator_u[d].HT(faces), d)

    def conv_vectors(self, x):
        """conv_d = C_d(u) uω_d - K_d(uγ) uω_d (same-state form)."""
        N = self.N
        uws = x[0:2 * N:2]
        ugs = x[1:2 * N:2]
        out = []
        for d in range(N):
            Kw = self.conv_K(d, ugs)
            out.append(self.conv_bulk(d, uws, uws[d]) - Kw * uws[d])
        return tuple(out)

    def _picard_rows(self, x_k, dt=None, theta=1.0):
        """The operator linearised at ``x_k``: Stokes rows plus ρ C(u_k)
        - ρ/2 K(u_k) in the momentum diagonal; with ``dt`` the unsteady
        mass and θ-scaled viscous and convective blocks."""
        N = self.N
        uws_k = x_k[0:2 * N:2]
        ugs_k = x_k[1:2 * N:2]
        rho_val = self._material("rho")
        Kws = [self.conv_K(d, ugs_k) for d in range(N)]

        def apply(x):
            uws = x[0:2 * N:2]
            ugs = x[1:2 * N:2]
            p = x[2 * N]
            out = []
            for d in range(N):
                if dt is None:
                    yw = (self._visc(d, uws[d], ugs[d])
                          + self._grad(d, p)
                          + rho_val * self.conv_bulk(d, uws_k, uws[d])
                          - 0.5 * rho_val * Kws[d] * uws[d])
                else:
                    mass = self.rho_diag[d] * self.fluid.operator_u[d].V / dt
                    yw = (mass * uws[d]
                          + theta * self._visc(d, uws[d], ugs[d])
                          + theta * rho_val * self.conv_bulk(d, uws_k, uws[d])
                          - 0.5 * theta * rho_val * Kws[d] * uws[d]
                          + self._grad(d, p))
                yw = torch.where(self.u_active[d], yw, uws[d])
                yg = ugs[d]
                yw, yg = self.borders[d].matvec(yw, yg, uws[d], ugs[d])
                out += [yw, yg]
            yp = self._div(uws, ugs)
            yp = torch.where(self.p_active, yp, p)
            yp = self._gauge_fix(yp, p)
            return tuple(out) + (yp,)

        return apply

    # ------------------------------------------------------------------
    # unsteady: implicit viscous + AB2 explicit convection
    # ------------------------------------------------------------------
    def solve_unsteady(self, dt, t_end, scheme="CN", method="auto", x0=None,
                       tol=1e-10, maxiter=None, record=None, t_start=0.0,
                       conv_prev=None):
        """θ-scheme steps from ``t_start`` to ``t_end`` with AB2 convection
        (AB1 on the first step unless ``conv_prev`` carries the previous
        span's convection, ``conv_prev_out``).  ``method``: ``auto``
        (direct up to 12,000 unknowns, else pbicgstab), ``direct`` (one
        LU, reused), ``pbicgstab``/``pgmres`` with the block-Schur M,
        ``fgmres`` with the DCT-CG Schur M, else the batched ``gmres``.
        ``record``: ``f(x) -> tree of 0-d tensors`` evaluated on every
        step's state; ``record_log`` holds the values stacked over the
        steps.  The Krylov methods set ``krylov_iters``/``krylov_relres``
        per step."""
        theta = 0.5 if scheme in ("CN", "cn") else 1.0
        rho_val = self._material("rho")
        N = self.N
        x = x0 if x0 is not None else self.zero_state()
        n_steps = int(np.ceil((t_end - t_start) / dt - 1e-12))
        nflat = sum(u.numel() for u in x)
        if method == "auto":
            method = "direct" if nflat <= 12000 else "pbicgstab"
        telemetry = method in ("pbicgstab", "pgmres", "fgmres")
        apply_fn = self.make_unsteady_apply(dt, theta)
        base_rhs = self.make_unsteady_rhs(dt, theta)
        if method == "direct":
            factor = DenseFactorSolver(apply_fn, x)

            def lin_solve(b, xc):
                return factor.solve(b)
        elif method == "pbicgstab":
            M = self.make_block_preconditioner(dt=dt, theta=theta)

            def lin_solve(b, xc):
                return pbicgstab(apply_fn, b, xc, Minv=M, tol=tol,
                                 maxiter=maxiter or 400,
                                 _reduce=self._krylov_reduce)
        elif method == "pgmres":
            M = self.make_block_preconditioner(dt=dt, theta=theta)

            def lin_solve(b, xc):
                return pgmres(apply_fn, b, xc, Minv=M, tol=tol,
                              maxiter=maxiter or 400, restart=60,
                              _reduce=self._krylov_reduce)
        elif method == "fgmres":
            # no spectral bounds in the Schur solve: survives geometries
            # where the Chebyshev bound estimate mistunes
            M = self.make_block_preconditioner(dt=dt, theta=theta,
                                               schur="dct_cg",
                                               schur_cg_iters=20)

            def lin_solve(b, xc):
                return fgmres(apply_fn, b, xc, Minv=M, tol=tol,
                              maxiter=maxiter or 400, restart=40,
                              _reduce=self._krylov_reduce)
        else:
            def lin_solve(b, xc):
                return gmres(apply_fn, b, x0=xc, tol=tol,
                             maxiter=maxiter or 2000)[0]

        first = conv_prev is None
        conv_p = self.conv_vectors(x) if first else conv_prev
        iters, rels, recs = [], [], []
        for k in range(n_steps):
            t = t_start + k * dt
            conv_c = self.conv_vectors(x)
            extra = tuple(
                -rho_val * (conv_c[d] if first
                            else 1.5 * conv_c[d] - 0.5 * conv_p[d])
                for d in range(N))
            b = base_rhs(x, t, t + dt, extra_mom=extra)
            if telemetry:
                x, it, rr = lin_solve(b, x)
                iters.append(it)
                rels.append(rr)
            else:
                x = lin_solve(b, x)
            if record is not None:
                recs.append(record(x))
            conv_p, first = conv_c, False
        self.x, self.conv_prev_out = x, conv_p
        self._store_logs(iters if telemetry else None, rels, record, recs)
        return self.x

    # ------------------------------------------------------------------
    # unsteady: fully implicit Picard convection
    # ------------------------------------------------------------------
    def solve_unsteady_picard(self, dt, t_end, scheme="BE", picard_iters=4,
                              picard_tol=1e-9, method="lstsq", x0=None,
                              verbose=False, tol=1e-6, maxiter=240,
                              t_start=0.0, record=None):
        """θ-scheme with implicit (Picard-linearised) convection per step.
        ``method="fgmres"`` runs a fixed ``picard_iters`` sweeps a step by
        flexible GMRES with the DCT-CG block-Schur M, and records the last
        sweep's ``krylov_iters``/``krylov_relres`` per step; other methods
        solve each sweep through ``solve_linear`` and stop a step's sweeps
        once max|Δx| < ``picard_tol``.  With CN the (1-θ) explicit
        convection goes on the rhs.  ``t_start``/``record`` as in
        :meth:`solve_unsteady`."""
        theta = 0.5 if scheme in ("CN", "cn") else 1.0
        base_rhs = self.make_unsteady_rhs(dt, theta)
        rho_val = self._material("rho")
        x = x0 if x0 is not None else self.zero_state()
        n_steps = int(np.ceil((t_end - t_start) / dt - 1e-12))

        def step_rhs(xc, t):
            if theta < 1.0:
                extra = tuple(-(1.0 - theta) * rho_val * c
                              for c in self.conv_vectors(xc))
                return base_rhs(xc, t, t + dt, extra_mom=extra)
            return base_rhs(xc, t, t + dt)

        if method == "fgmres":
            M = self.make_block_preconditioner(dt=dt, theta=theta,
                                               schur="dct_cg",
                                               schur_cg_iters=8)
            iters, rels, recs = [], [], []
            for k in range(n_steps):
                b = step_rhs(x, t_start + k * dt)
                x_it = x
                for _ in range(picard_iters):
                    x_it, its, rel = fgmres(
                        self._picard_rows(x_it, dt, theta), b, x_it, Minv=M,
                        tol=tol, maxiter=maxiter, restart=40,
                        _reduce=self._krylov_reduce)
                x = x_it
                iters.append(its)
                rels.append(rel)
                if record is not None:
                    recs.append(record(x))
            self.x = x
            self._store_logs(iters, rels, record, recs)
            return self.x

        for k in range(n_steps):
            b = step_rhs(x, t_start + k * dt)
            x_it = x
            for it in range(picard_iters):
                x_new = solve_linear(self._picard_rows(x_it, dt, theta), b,
                                     method=method)
                diff = _max_diff(x_new, x_it)
                x_it = x_new
                if verbose:
                    print(f"step {k} picard {it}: {diff:.2e}")
                if diff < picard_tol:
                    break
            x = x_it
        self.x = x
        return self.x

    # ------------------------------------------------------------------
    # diagnostics: reaction forces on the cut boundary
    # ------------------------------------------------------------------
    def _cv_edges(self, box, nsamp):
        """The box's four edges as (normal, px, py, trapezoid weights)."""
        x_lo, x_hi, y_lo, y_hi = (float(v) for v in box)
        edges = []
        for (n_vec, const_axis, cval, t_lo, t_hi) in (
                ((1.0, 0.0), 0, x_hi, y_lo, y_hi),
                ((-1.0, 0.0), 0, x_lo, y_lo, y_hi),
                ((0.0, 1.0), 1, y_hi, x_lo, x_hi),
                ((0.0, -1.0), 1, y_lo, x_lo, x_hi)):
            t = np.linspace(t_lo, t_hi, nsamp)
            w = np.full(nsamp, (t_hi - t_lo) / (nsamp - 1))
            w[0] *= 0.5
            w[-1] *= 0.5  # trapezoid
            if const_axis == 0:
                px, py = np.full(nsamp, cval), t
            else:
                px, py = t, np.full(nsamp, cval)
            edges.append((n_vec, px, py, w))
        return edges

    def _cv_setup(self, box, nsamp):
        if self.N != 2:
            raise ValueError("control_volume_force is 2D")
        hmin = min(float(self.fluid.mesh_p.h[0]),
                   float(self.fluid.mesh_p.h[1]))
        x_lo, x_hi, y_lo, y_hi = (float(v) for v in box)
        if nsamp is None:
            nsamp = 4 * max(int((x_hi - x_lo) / hmin),
                            int((y_hi - y_lo) / hmin), 8)
        return hmin, 0.25 * hmin, nsamp

    def control_volume_force(self, box, x=None, nsamp=None):
        """Body force by the momentum-deficit (control-volume) integral of
        a STEADY state: ``F_d = ∮_S [−p n_d + μ(∂u_d/∂x_n + ∂u_n/∂x_d) n_n
        − ρ u_d (u·n)] dS`` over the box ``(x_lo, x_hi, y_lo, y_hi)``,
        by bilinear sampling (scipy ``map_coordinates``) on the host.  2D
        only."""
        from scipy.ndimage import map_coordinates

        hmin, dlt, nsamp = self._cv_setup(box, nsamp)
        x = x if x is not None else self.x
        mu_val = self._material("mu")
        rho_val = self._material("rho")
        ux, uy, pm = (host_read(x[i]).astype(float) for i in (0, 2, 4))
        p = -pm  # state stores -p_phys
        meshes = (self.fluid.mesh_u[0], self.fluid.mesh_u[1],
                  self.fluid.mesh_p)

        def sampler(arr, mesh):
            # fields live at cell centres of their mesh: nodes[d] + h/2
            orig = [float(mesh.nodes[d][0]) + 0.5 * mesh.h[d]
                    for d in range(2)]
            h = [float(v) for v in mesh.h]

            def f(px, py):
                ci = (np.asarray(px) - orig[0]) / h[0]
                cj = (np.asarray(py) - orig[1]) / h[1]
                return map_coordinates(arr, [ci, cj], order=1,
                                       mode="nearest")
            return f

        f_ux, f_uy, f_p = (sampler(a, m)
                           for a, m in zip((ux, uy, p), meshes))

        def grad(f, px, py):
            dfdx = (f(px + dlt, py) - f(px - dlt, py)) / (2 * dlt)
            dfdy = (f(px, py + dlt) - f(px, py - dlt)) / (2 * dlt)
            return dfdx, dfdy

        Fx = Fy = 0.0
        for (nx_, ny_), px, py, w in self._cv_edges(box, nsamp):
            uxs, uys, ps = f_ux(px, py), f_uy(px, py), f_p(px, py)
            duxdx, duxdy = grad(f_ux, px, py)
            duydx, duydy = grad(f_uy, px, py)
            un = uxs * nx_ + uys * ny_
            tx = (-ps * nx_ + mu_val * (2 * duxdx * nx_
                                        + (duxdy + duydx) * ny_)
                  - rho_val * uxs * un)
            ty = (-ps * ny_ + mu_val * ((duydx + duxdy) * nx_
                                        + 2 * duydy * ny_)
                  - rho_val * uys * un)
            Fx += float(np.sum(w * tx))
            Fy += float(np.sum(w * ty))
        return Fx, Fy

    def make_control_volume_recorder(self, box, nsamp=None, nq=2):
        """The control-volume force for UNSTEADY runs on the device:
        returns ``cvf(x) -> (Fs_x, Fs_y, M_x, M_y)`` (0-d tensors), the
        surface integral of ``−p n + μ(∇u+∇uᵀ)n − ρ u (u·n)`` over the box
        and ``M = ∫_box ρ u dV`` (bilinear quadrature, ``nq`` points per
        pressure cell per axis); the force on the body is ``Fs − dM/dt``.
        The gather indices and bilinear weights are built once in numpy
        and moved to the fluid's device once."""
        hmin, dlt, nsamp = self._cv_setup(box, nsamp)
        mu_val = self._material("mu")
        rho_val = self._material("rho")
        like = self._like
        dev = like["device"]
        meshes = (self.fluid.mesh_u[0], self.fluid.mesh_u[1],
                  self.fluid.mesh_p)
        shapes = tuple(m.np_shape for m in meshes)

        def bilin(mesh, shape, px, py):
            orig = [float(mesh.nodes[d][0]) + 0.5 * mesh.h[d]
                    for d in range(2)]
            h = [float(v) for v in mesh.h]
            ci = (np.asarray(px, float) - orig[0]) / h[0]
            cj = (np.asarray(py, float) - orig[1]) / h[1]
            i0 = np.clip(np.floor(ci).astype(np.int64), 0, shape[0] - 2)
            j0 = np.clip(np.floor(cj).astype(np.int64), 0, shape[1] - 2)
            fi = np.clip(ci - i0, 0.0, 1.0)
            fj = np.clip(cj - j0, 0.0, 1.0)
            # the four corners' flat indices and weights, (4, npts)
            idx = np.stack([i0 * shape[1] + j0, (i0 + 1) * shape[1] + j0,
                            i0 * shape[1] + j0 + 1,
                            (i0 + 1) * shape[1] + j0 + 1])
            w = np.stack([(1 - fi) * (1 - fj), fi * (1 - fj),
                          (1 - fi) * fj, fi * fj])
            idx_t = torch.as_tensor(idx, device=dev)
            w_t = torch.as_tensor(w, **like)

            def f(arr):
                a = arr.reshape(-1)[idx_t] * w_t.to(arr.dtype)
                return ((a[0] + a[1]) + a[2]) + a[3]
            return f

        x_lo, x_hi, y_lo, y_hi = (float(v) for v in box)
        edges = self._cv_edges(box, nsamp)
        px_all = np.concatenate([e[1] for e in edges])
        py_all = np.concatenate([e[2] for e in edges])
        w_all = np.concatenate([e[3] for e in edges])
        nx_all = np.concatenate([np.full(nsamp, e[0][0]) for e in edges])
        ny_all = np.concatenate([np.full(nsamp, e[0][1]) for e in edges])
        stencil = [(0.0, 0.0), (dlt, 0.0), (-dlt, 0.0),
                   (0.0, dlt), (0.0, -dlt)]
        samplers = [[bilin(m, s, px_all + ox, py_all + oy)
                     for (ox, oy) in stencil]
                    for m, s in zip(meshes, shapes)]
        # volume quadrature: midpoints of an nq-per-cell subgrid
        hq = hmin / nq
        qx = np.arange(x_lo + 0.5 * hq, x_hi, hq)
        qy = np.arange(y_lo + 0.5 * hq, y_hi, hq)
        QX, QY = (a.ravel() for a in np.meshgrid(qx, qy, indexing="ij"))
        wq = hq * hq
        vol_samp = [bilin(meshes[d], shapes[d], QX, QY) for d in range(2)]
        wj, nxj, nyj = (torch.as_tensor(a, **like)
                        for a in (w_all, nx_all, ny_all))

        def cvf(x):
            ux, uy = x[0], x[2]
            p = -x[2 * self.N]  # state stores -p_phys
            sx, sy, sp_ = samplers

            def vals_grads(samp, arr):
                v = samp[0](arr)
                dx_ = (samp[1](arr) - samp[2](arr)) / (2 * dlt)
                dy_ = (samp[3](arr) - samp[4](arr)) / (2 * dlt)
                return v, dx_, dy_

            uxs, duxdx, duxdy = vals_grads(sx, ux)
            uys, duydx, duydy = vals_grads(sy, uy)
            ps = sp_[0](p)
            un = uxs * nxj + uys * nyj
            tx = (-ps * nxj + mu_val * (2 * duxdx * nxj
                                        + (duxdy + duydx) * nyj)
                  - rho_val * uxs * un)
            ty = (-ps * nyj + mu_val * ((duydx + duxdy) * nxj
                                        + 2 * duydy * nyj)
                  - rho_val * uys * un)
            Fsx = torch.sum(wj * tx)
            Fsy = torch.sum(wj * ty)
            Mx = rho_val * wq * torch.sum(vol_samp[0](ux))
            My = rho_val * wq * torch.sum(vol_samp[1](uy))
            return Fsx, Fsy, Mx, My

        return cvf

    def pressure_probe(self, points, x=None, radius=2.5):
        """O(h²) pointwise physical pressure by a weighted least-squares
        linear fit over the active pressure-cell centroids within
        ``radius`` cell widths of each point (a list of N-tuples); returns
        a list of floats.  Host-side (numpy)."""
        x = x if x is not None else self.x
        p = -host_read(x[2 * self.N]).astype(float)
        idxs, wts = self._probe_weights(points, radius)
        return [float(np.dot(w, p.ravel()[i])) for i, w in zip(idxs, wts)]

    def _probe_weights(self, points, radius=2.5):
        """The LSQ probe is linear in the cell pressures: p(x₀) = Σ wᵢ pᵢ
        with w = e₀ᵀ(AᵀWA)⁻¹AᵀW.  Returns per point (flat indices,
        weights) in numpy.  The normal equations are solved with no
        conditioning guard, as in the JAX version."""
        pc = host_read(self.fluid.capacity_p.C_om).astype(float)
        act = host_read(self.p_active)
        # distances in per-axis cell units (anisotropic meshes)
        h = np.array([float(v) for v in self.fluid.mesh_p.h])
        flat_idx = np.arange(act.size)[act.ravel()]
        cen = pc.reshape(-1, self.N)[act.ravel()]
        # damp barely-constrained sliver-cell pressures by fluid fraction
        vfrac = host_read(self.fluid.capacity_p.V).astype(float).ravel()[
            act.ravel()] / float(np.prod(h))
        vfrac = np.clip(vfrac, 0.0, 1.0)
        idxs, wts = [], []
        for pt_xy in points:
            d = (cen - np.asarray(pt_xy, float)) / h
            r = np.sqrt((d * d).sum(1))
            sel = r < radius
            if sel.sum() < self.N + 2:  # tiny grids: the nearest cell
                idxs.append(flat_idx[[np.argmin(r)]])
                wts.append(np.ones(1))
                continue
            ds = d[sel]
            w = vfrac[sel] * (1.0 - r[sel] / radius) ** 2  # Wendland-style
            A = np.concatenate([np.ones((sel.sum(), 1)), ds], axis=1)
            Aw = A * w[:, None]
            M = np.linalg.solve(Aw.T @ A, Aw.T)  # (N+1, npts)
            idxs.append(flat_idx[sel])
            wts.append(M[0])
        return idxs, wts

    def make_pressure_probe(self, points, radius=2.5):
        """:meth:`pressure_probe` on the device: ``f(x) ->`` a tensor of
        the physical pressures at ``points``, one gather and one dot per
        point (indices and weights moved to the device once)."""
        idxs, wts = self._probe_weights(points, radius)
        dev = self._like["device"]
        pairs = [(torch.as_tensor(i, device=dev),
                  torch.as_tensor(w, **self._like)) for i, w in
                 zip(idxs, wts)]

        def f(x):
            p = -x[2 * self.N].reshape(-1)  # state stores -p_phys
            return torch.stack([torch.dot(w.to(p.dtype), p[i])
                                for i, w in pairs])
        return f

    # ------------------------------------------------------------------
    # steady: Picard, Newton, JFNK
    # ------------------------------------------------------------------
    def make_picard_apply(self, x_k):
        """Linearised steady operator at the Picard iterate x_k."""
        return self._picard_rows(x_k)

    def nonlinear_residual(self, x, b):
        """R(x) = A(x)x - b with the convection evaluated at x itself."""
        Ax = self.make_picard_apply(x)(x)
        return tuple(a - bb for a, bb in zip(Ax, b))

    def solve_steady_newton(self, max_iter=20, tol=1e-10, damping=1.0,
                            x0=None, picard_warmup=3, verbose=False):
        """Steady Newton with the exact Jacobian (``torch.func.jacfwd`` of
        the flattened residual) after ``picard_warmup`` Picard sweeps; the
        step is the minimum-norm least-squares solve with the cut-off
        1e-12.  ``residual_history`` holds |R| per iteration."""
        b = self.rhs_steady()
        x = x0 if x0 is not None else self.zero_state()
        if picard_warmup:
            x = self.solve_steady(max_iter=picard_warmup, tol=0.0, x0=x)
        flat_x, unravel = _ravel(x)

        def R(v):
            return _ravel(self.nonlinear_residual(unravel(v), b))[0]

        jac = torch.func.jacfwd(R)
        self.residual_history = []
        for it in range(max_iter):
            r = R(flat_x)
            rn = float(host_read(torch.linalg.vector_norm(r)))
            self.residual_history.append(rn)
            if verbose:
                print(f"newton iter {it}: |R|={rn:.3e}")
            if rn < tol:
                break
            delta = _lstsq_min_norm(jac(flat_x), r, 1e-12)
            flat_x = flat_x - damping * delta
        self.x = unravel(flat_x)
        return self.x

    def solve_steady_newton_krylov(self, max_iter=25, tol=1e-9,
                                   lin_maxiter=400, x0=None,
                                   picard_warmup=0, verbose=False,
                                   inner="fgmres", restart=100,
                                   mom="jacobi", mom_cg_iters=8,
                                   schur=None):
        """Jacobian-free Newton-Krylov: block-Schur-preconditioned Krylov
        (``inner``: ``fgmres`` with the DCT-CG Schur solve, ``pgmres`` or
        ``pbicgstab`` with the Chebyshev one) over the exact
        Jacobian-vector product ``torch.func.jvp`` of the residual, with
        the forcing ``η = clip(√‖R‖, 1e-4, 0.1)`` and a backtracking line
        search over α ∈ {1, ½, ¼, 0.1}.  Stops at ``tol``, or after three
        iterations without a new best |R|, and returns the best iterate.
        ``residual_history`` and ``newton_lin_iters`` per Newton step."""
        b = self.rhs_steady()
        x = x0 if x0 is not None else self.zero_state()
        if schur is None:
            schur = "dct_cg" if inner == "fgmres" else "cheb"
        M = self.make_block_preconditioner(
            dt=None, theta=1.0, mom=mom, mom_cg_iters=mom_cg_iters,
            schur=schur)
        if picard_warmup:
            for _ in range(picard_warmup):
                # loose warm-up solves; reject a diverged update
                xw, _, rr = pbicgstab(self.make_picard_apply(x), b, x,
                                      Minv=M, tol=1e-3, maxiter=lin_maxiter)
                rr = float(host_read(rr))
                if np.isfinite(rr) and rr < 1.0:
                    x = xw

        def R(v):
            return self.nonlinear_residual(v, b)

        def rn_fn(v):
            r = R(v)
            return float(host_read(torch.sqrt(sum(torch.sum(a * a)
                                                  for a in r))))

        zeros = tuple(torch.zeros_like(a) for a in x)

        def newton_delta(xc, eta):
            r = R(xc)

            def Jv(v):
                return torch.func.jvp(R, (xc,), (v,))[1]

            if inner == "pbicgstab":
                delta, its, _ = pbicgstab(Jv, r, zeros, Minv=M, tol=eta,
                                          maxiter=lin_maxiter)
            elif inner == "fgmres":
                delta, its, _ = fgmres(Jv, r, zeros, Minv=M, tol=eta,
                                       maxiter=lin_maxiter, restart=restart)
            else:
                delta, its, _ = pgmres(Jv, r, zeros, Minv=M, tol=eta,
                                       maxiter=lin_maxiter, restart=restart)
            return delta, its

        self.residual_history = []
        self.newton_lin_iters = []
        best_rn, best_x, stall = np.inf, x, 0
        for it in range(max_iter):
            rn = rn_fn(x)
            self.residual_history.append(rn)
            if verbose:
                print(f"jfnk iter {it}: |R|={rn:.3e}")
            if rn < best_rn:
                best_rn, best_x, stall = rn, x, 0
            else:
                # the inner Krylov no longer improves on the forcing
                stall += 1
                if stall >= 3:
                    break
            if rn < tol:
                break
            eta = float(np.clip(np.sqrt(max(rn, 1e-300)), 1e-4, 0.1))
            delta, its = newton_delta(x, eta)
            self.newton_lin_iters.append(int(its))
            # accept the first step that does not worsen |R|
            accepted = False
            for alpha in (1.0, 0.5, 0.25, 0.1):
                xa = tuple(a - alpha * d for a, d in zip(x, delta))
                ra = rn_fn(xa)
                if np.isfinite(ra) and ra < rn * (1.0 + 1e-8):
                    x, accepted = xa, True
                    break
            if not accepted:
                stall += 2  # no usable direction: stop at the next check
        self.x = best_x
        return self.x

    def solve_steady(self, max_iter=30, tol=1e-8, relax=1.0, method="lstsq",
                     x0=None, verbose=False):
        """Picard iteration: each sweep solves the operator linearised at
        the iterate, by ``pbicgstab`` with the block-Schur M or through
        ``solve_linear``.  ``residual_history`` holds max|Δx| per
        sweep."""
        x = x0 if x0 is not None else self.zero_state()
        b = self.rhs_steady()
        self.residual_history = []
        M = (self.make_block_preconditioner(dt=None, theta=1.0)
             if method == "pbicgstab" else None)
        for it in range(max_iter):
            apply_fn = self.make_picard_apply(x)
            if method == "pbicgstab":
                x_new, _, _ = pbicgstab(apply_fn, b, x, Minv=M, tol=1e-9,
                                        maxiter=600)
            else:
                x_new = solve_linear(apply_fn, b, method=method)
            if relax != 1.0:
                x_new = tuple(relax * a + (1 - relax) * c
                              for a, c in zip(x_new, x))
            diff = _max_diff(x_new, x)
            self.residual_history.append(diff)
            x = x_new
            if verbose:
                print(f"picard iter {it}: diff={diff:.3e}")
            if diff < tol:
                break
        self.x = x
        return self.x

    def solve_steady_marching(self, dt, t_max=100.0, chunk=2.0, tol=1e-6,
                              scheme="CN", method="pbicgstab", lin_tol=1e-7,
                              maxiter=300, x0=None, verbose=False):
        """Steady state by pseudo-time continuation: ``solve_unsteady`` in
        chunks of ``chunk`` until ``max|Δu|/chunk < tol``.  Each chunk
        restarts from AB1, as in the JAX version."""
        x = x0
        t = 0.0
        self.residual_history = []
        while t < t_max - 1e-12:
            span = min(chunk, t_max - t)
            x_prev = x
            x = self.solve_unsteady(dt, span, scheme=scheme, method=method,
                                    x0=x, tol=lin_tol, maxiter=maxiter)
            t += span
            if x_prev is not None:
                rate = _max_diff(x[:2 * self.N], x_prev[:2 * self.N]) / span
                self.residual_history.append(rate)
                if verbose:
                    print(f"marching t={t:.2f}: |du/dt|={rate:.3e}")
                if rate < tol:
                    break
        self.x = x
        return self.x

"""2D Stefan phase change with marker front tracking (torch), the flagship
solver.

Counterpart of ``penguin_tpu.solvers.stefan2d`` (reference
liquidmotionsolver/stefan.jl).  Per time step, a Gauss-Newton /
Levenberg-Marquardt iteration over the marker normal displacements d
(stefan.jl:546-1091):

1. slab temperature solve with the space-time body interpolating the
   marker SDFs between the step-start front and the displaced front;
2. per-cell interface flux ``Id Hᵀ Wꜝ (G Tω + H Tγ)``;
3. residual ``F_cell = ρL (V(t0)_cell - V(t1)_cell) - flux_cell``,
   optionally 3×3 stencil-fused (a box filter);
4. volume Jacobian ∂F/∂d: forward-mode autodiff of the cut-cell volumes
   through the capacity quadrature (``jac="autodiff"``), or the analytic
   intercept Jacobian from segment∩cell moments (``jac="intercept"``);
5. damped normal-equations solve ``(JᵀJ + λ diag) δ = Jᵀ F`` with LM λ
   adaptation (stefan.jl:875-941);
6. circular moving-average smoothing of d and the marker update along
   the normals, then an arclength resampling.

The JAX version runs the time loop as one jitted ``lax.scan`` with a
``lax.while_loop`` GN inside and caches the compiled loop across ``solve``
calls.  Here both loops are Python loops and nothing is compiled, so there
is no loop cache.  The displacements, the LM λ, the residual norms and the
NaN-padded residual history stay on the device; the test ``rn > tol`` is
read on the host once per GN iteration (each iteration is a whole slab
capacity build), and the per-step logs are copied to numpy once after the
loop.  The slab time ``t_start + k·dt`` is a Python float.

The autodiff Jacobian is a ``torch.func.vmap`` of ``torch.func.jvp`` over
blocks of ``_JAC_CHUNK`` marker tangents, through
``compute_cell_volumes(..., band_budget=)`` (whose band masks are detached
plain tensors); its SDF runs in segment blocks of 32, the JAX default, so a
query tied between three or more segments splits its tangent as in JAX.
The LM system is solved by ``torch.linalg.solve_ex`` in the markers'
dtype: a singular system gives a non-finite step, which the guard drops,
as JAX's ``solve`` does, instead of raising.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..assembly import border_info
from ..boundary import GibbsThomson
from ..capacity import (
    _BAND_DEFAULT_SAFETY,
    _is_traced,
    _round_budget,
    compute_capacity_spacetime,
    compute_cell_volumes,
)
from ..front_tracking import (
    polyline_curvature,
    polyline_normals,
    polyline_sdf,
    resample_markers,
    segment_cell_intersection_moments,
    segment_cell_intersections,
    smooth_displacements,
)
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

__all__ = ["StefanMono2D", "StefanDiph2D"]

# marker tangents carried at once by the autodiff volume Jacobian: memory
# grows with it times the quadrature's intermediates, the result does not
# depend on it
_JAC_CHUNK = 32


def _st_marker_body(x, y, t, params):
    """Space-time SDF: linear-in-time interpolation of the marker SDFs
    between slab start and end (slab times [0, dt]); ``sign=-1`` tracks a
    fluid exterior to the polygon."""
    mk_a, mk_b, dt, sign = params
    phi_a = polyline_sdf(mk_a, x, y)
    phi_b = polyline_sdf(mk_b, x, y)
    return sign * ((dt - t) * phi_a + t * phi_b) / dt


# the spatial bodies feed only the autodiff Jacobian: segment blocks of 32
def _sp_vol_body_pos(x, y, mk):
    return polyline_sdf(mk, x, y, chunk=32)


def _sp_vol_body_neg(x, y, mk):
    return -polyline_sdf(mk, x, y, chunk=32)


def _spatial_volumes(markers, mesh, sign, p, s, band_budget=None):
    """Cut-cell fluid volumes of the spatial grid for a marker polygon
    (cells only, padded grid), narrow-band when ``band_budget`` is set."""
    body = _sp_vol_body_pos if sign > 0 else _sp_vol_body_neg
    return compute_cell_volumes(body, mesh, p=p, s=s, params=markers,
                                band_budget=band_budget, dtype=markers.dtype,
                                device=markers.device)


def _auto_band_budget(markers, mesh, dt, sign, band_budget, headroom=4):
    """Size the narrow-band budget from the *initial* front: perimeter/h ×
    band width in cells, ``headroom``× for front growth over the run
    (overflow degrades to corner-sign full/empty far values).  Reads the
    markers on the host once."""
    if band_budget != "auto":
        return band_budget
    if _is_traced(markers):
        return None
    mk = host_read(markers)
    seg = np.roll(mk, -1, axis=0) - mk
    P = float(np.sum(np.hypot(seg[:, 0], seg[:, 1])))
    h = float(min(mesh.h[:2]))
    width = 2.0 * _BAND_DEFAULT_SAFETY * 1.5 + 3.0  # cells across the band
    count = max(int(P / h * width), 256)
    return _round_budget(headroom * count, mesh.ncells())


def _sticky_band_budget(solver, markers, mesh, dt, sign, band_budget):
    """Per-solver sticky budget: repeated ``solve`` calls keep the previous
    (sufficient) budget, so a grown front does not change the band's size
    and with it the numerics of a repeated run."""
    est = _auto_band_budget(markers, mesh, dt, sign, band_budget)
    prev = getattr(solver, "_band_budget", None)
    if (band_budget == "auto" and est is not None and prev is not None
            and est <= prev):
        est = prev
    if est is not None:
        solver._band_budget = est
    return est


def _box3_filter(F):
    """3x3 stencil fusion: each cell's residual becomes the sum over its
    3x3 neighborhood (stefan.jl get_stencil_cells, '3x3' strategy), over
    the first two axes of ``F`` (trailing axes are batch axes)."""
    out = F
    for ax in (0, 1):
        n = out.shape[ax]
        zero = torch.zeros_like(out.narrow(ax, 0, 1))
        out = (out + torch.cat([zero, out.narrow(ax, 0, n - 1)], ax)
               + torch.cat([out.narrow(ax, 1, n - 1), zero], ax))
    return out


def _slab_flux(cap, D, T):
    """(interface flux per cell, Va, Vb) of a mono slab solution."""
    ops, Va, Vb, Gamma0, C_sp, _ = slice_spacetime(cap)
    return _eval_D(D, C_sp) * ops.HT(ops.flux(T[0], T[1])), Va, Vb


def _gibbs_thomson_value(cap, bc_i, mk_b, sign):
    """Gibbs-Thomson interface value g = Tm - eps_k κ + eps_v v_liq per
    cell, with the normal velocity recovered from the slab volume change and
    κ the nearest marker's curvature (the JAX version's derivation, kept in
    its comments: the space-time measure gives ΔV/Γ0 = v/sqrt(1+v²), the
    kinetic term undercools a solidifying front, and the curvature is the
    solid's)."""
    _, Va, Vb, G0, _, Cg = slice_spacetime(cap)
    v_r = (Vb - Va) / torch.where(G0 > 0, G0, 1.0)
    v_r = torch.clamp(torch.where(G0 > 0, v_r, 0.0), -0.999, 0.999)
    v_liq = v_r / torch.sqrt(1.0 - v_r * v_r)
    g = bc_i.Tm + bc_i.eps_v * v_liq
    if bc_i.eps_k:
        kap_m = -sign * polyline_curvature(mk_b)
        d2 = torch.sum((Cg[..., None, :] - mk_b[None, None, :, :]) ** 2,
                       dim=-1)
        kap_cell = kap_m[torch.argmin(d2, dim=-1)]
        g = g - bc_i.eps_k * torch.where(G0 > 0, kap_cell, 0.0)
    return g


def _autodiff_jacobian(d, mk_a, normals, mesh, sign, scale, fuse, p, s,
                       band_budget):
    """∂F/∂d of the volume part ``scale · Vb`` of the residual (box-filtered
    when ``fuse``), exact through the quadrature: shape (cells, markers).
    The temperature and flux are frozen, as in the reference
    (stefan.jl:793-807)."""
    def vol_residual(dd):
        Vb = _spatial_volumes(mk_a + dd[:, None] * normals, mesh, sign, p, s,
                              band_budget)
        F = scale * Vb
        if fuse:
            F = _box3_filter(F)
        return F.reshape(-1)

    eye = torch.eye(d.shape[0], dtype=d.dtype, device=d.device)
    return torch.func.vmap(
        lambda v: torch.func.jvp(vol_residual, (d,), (v,))[1],
        chunk_size=_JAC_CHUNK)(eye).T


def _intercept_jacobian(d, mk_a, normals, mesh, scale, fuse):
    """The analytic linear-tilt Jacobian ``scale · dV_cell/dd_i``: moving
    marker i sweeps the triangle-weighted strips of its two adjacent
    segments (weight t on incoming segment i-1, 1-t on outgoing segment i),
    one Liang-Barsky clipping pass (front_tracking.jl:2630-2678)."""
    L0, L1 = segment_cell_intersection_moments(mesh, mk_a + d[:, None]
                                               * normals)
    Jm = torch.roll(L1, 1, dims=2) + (L0 - L1)
    np0, np1 = mesh.np_shape[:2]
    Jm = torch.nn.functional.pad(Jm, (0, 0, 0, np1 - Jm.shape[1],
                                      0, np0 - Jm.shape[0]))
    Jm = scale * Jm
    if fuse:
        Jm = _box3_filter(Jm)
    return Jm.reshape(-1, Jm.shape[-1])


def _jacobian_fn(jac, mesh, sign, scale, fuse, jac_p, jac_s, band_budget):
    if jac == "intercept":
        return lambda d, mk_a, normals: _intercept_jacobian(
            d, mk_a, normals, mesh, sign * scale, fuse)
    return lambda d, mk_a, normals: _autodiff_jacobian(
        d, mk_a, normals, mesh, sign, scale, fuse, jac_p, jac_s, band_budget)


def _normal_equations(J, Fv):
    """(JᵀJ, JᵀF, ‖F‖) of the GN step."""
    return J.T @ J, J.T @ Fv, torch.linalg.norm(Fv)


def _lm_step(J, Fv, d, lam, alpha, smooth_window, smooth_passes, max_disp):
    """One damped normal-equations update of the displacements."""
    return _lm_normal_step(J.T @ J, J.T @ Fv, d, lam, alpha, smooth_window,
                           smooth_passes, max_disp)


def _lm_normal_step(JTJ, JTF, d, lam, alpha, smooth_window, smooth_passes,
                    max_disp):
    """:func:`_lm_step` from the normal equations ``JᵀJ``, ``JᵀF``."""
    diag = torch.diagonal(JTJ)
    diag = torch.maximum(diag, 1e-10 * torch.max(diag))
    delta = torch.linalg.solve_ex(JTJ + lam * torch.diag(diag), JTF)[0]
    # a non-finite LM step (singular J, diverged inner solve) must not
    # poison the markers: skip it, let λ adaptation and the next residual
    # recover
    delta = torch.where(torch.isfinite(delta), delta, 0.0)
    d_new = smooth_displacements(d - alpha * delta, smooth_window,
                                 smooth_passes)
    return torch.clamp(d_new, -max_disp, max_disp)


def _gauss_newton(residual, jac_fn, mk_a, d0, newton_params, lm, smooth,
                  max_disp, capture, normal=_normal_equations):
    """The GN/LM iteration of one step.  ``residual(mk_b) -> (F, state,
    Krylov iterations)``; ``normal(J, F) -> (JᵀJ, JᵀF, ‖F‖)``
    (``parallel.sharding`` sums a rank's over the ranks).  Returns (d,
    state, last F or None, NaN-padded residual history, final residual
    norm, iterations, Krylov iterations)."""
    max_iter, tol, _, alpha = newton_params
    max_iter = int(max_iter)
    lm_init, lm_factor, lm_min, lm_max = lm
    normals = polyline_normals(mk_a)
    like = dict(dtype=d0.dtype, device=d0.device)
    d, T, Fg = d0, None, None
    lam = torch.full((), lm_init, **like)
    rn = torch.full((), math.inf, **like)
    rns, it, kit = [], 0, 0
    while _still_iterating(it, max_iter, tol, rn):
        # deliberately no warm start from the previous GN iterate: the slab
        # solution stays a deterministic function of d (see the JAX version)
        F, T, klv_it = residual(mk_a + d[:, None] * normals)
        Fv = F.reshape(-1)
        JTJ, JTF, rn_new = normal(jac_fn(d, mk_a, normals), Fv)
        d_new = _lm_normal_step(JTJ, JTF, d, lam, alpha, *smooth, max_disp)
        if it > 0:
            lam = torch.where(rn_new < rn,
                              torch.clamp_min(lam / lm_factor, lm_min),
                              torch.clamp_max(lam * lm_factor, lm_max))
        d, rn = d_new, rn_new
        Fg = F if capture else None
        rns.append(rn)
        it += 1
        kit += int(klv_it)
    hist = torch.full((max_iter,), math.nan, **like)
    if rns:
        hist = torch.cat([torch.stack(rns), hist[len(rns):]])
    return d, T, Fg, hist, rn, it, kit


def _march_markers(inner, u0, markers0, t_start, dt, K,
                   extrapolation_factor):
    """The K+1 steps of a marker solver.  ``inner(state, markers, d0, t)``
    returns (d, state or None, per-step values); the markers move along
    their normals by d and are resampled.  Returns (state, markers, marker
    log, per-step values as tuples)."""
    T, mk = u0, markers0
    d = torch.zeros(mk.shape[0], dtype=mk.dtype, device=mk.device)
    mk_log, logs = [], []
    for k in range(K + 1):
        d0 = extrapolation_factor * d if k > 0 else torch.zeros_like(d)
        d, Tn, out = inner(T, mk, d0, t_start + k * dt)
        T = T if Tn is None else Tn
        mk = resample_markers(mk + d[:, None] * polyline_normals(mk))
        mk_log.append(mk)
        logs.append(out)
    return T, mk, host_read(torch.stack(mk_log)), tuple(zip(*logs))


def _stacked(values):
    return host_read(torch.stack(list(values)))


class StefanMono2D(_ScalarSolverBase):
    """One-phase 2D Stefan solver with front tracking."""

    def __init__(self, phase, bc_b, bc_i, dt, u0, mesh, scheme="BE"):
        self.phase = phase
        self.bc_b = bc_b
        self.bc_i = bc_i
        self.dt = float(dt)
        self.u0 = u0
        self.mesh = mesh
        self.scheme = scheme
        self.border = border_info(mesh, bc_b, **_like(u0))

    def _slab_solver(self, sign, band_budget, p, s, method, lin_tol,
                     lin_maxiter, gibbs=False):
        """``(Told, mk_a, mk_b, t) -> (T, flux, Va, Vb, Krylov its)``."""
        dt, mesh = self.dt, self.mesh
        D, f = self.phase.diffusion, self.phase.source

        def slab_solve(Told, mk_a, mk_b, t):
            cap = compute_capacity_spacetime(
                _st_marker_body, mesh, 0.0, dt, p=p, s=s,
                params=(mk_a, mk_b, dt, sign), band_budget=band_budget,
                dtype=mk_b.dtype, device=mk_b.device)
            g = (_gibbs_thomson_value(cap, self.bc_i, mk_b, sign) if gibbs
                 else None)
            T, klv_it, _ = solve_moving_mono_step(
                cap, D, f, self.bc_i, self.border, Told, t, dt, self.scheme,
                tol=lin_tol, maxiter=lin_maxiter, g_override=g,
                method=method)
            return (T,) + _slab_flux(cap, D, T) + (klv_it,)

        return slab_solve

    def solve(self, front, t_start, t_end, ic,
              newton_params=(30, 1e-6, 1e-6, 1.0),
              interior_fluid=True,
              method="auto", lin_tol=1e-9, lin_maxiter=400,
              lm_init_lambda=1e-4, lm_lambda_factor=10.0,
              lm_min_lambda=1e-10, lm_max_lambda=1e6,
              enable_stencil_fusion=True,
              smooth_window=5, smooth_passes=1,
              extrapolation_factor=0.8, max_disp_cells=0.5,
              jac="autodiff",
              p=4, s=1, jac_p=4, jac_s=1, band_budget="auto",
              capture_residual_field=False):
        """``front``: FrontTracker (markers define the solid/fluid polygon;
        ``interior_fluid`` chooses which side is the simulated phase).
        Returns the final temperature; marker history in
        ``self.marker_log``.

        Per-step telemetry: ``self.residual_hist`` (n_steps, max_iter), the
        GN residual of every inner iteration, NaN-padded past convergence;
        ``self.residual_log``/``iters_log``/``krylov_iters`` per step;
        ``capture_residual_field=True`` also records the final per-cell
        residual grid of each step in ``self.residual_fields``.

        ``jac``: ``"autodiff"`` differentiates the cut-cell volume
        quadrature exactly (one JVP per marker); ``"intercept"`` uses the
        analytic intercept Jacobian (one clipping pass)."""
        dt = self.dt
        K = _num_slabs(dt, t_start, t_end)
        rhoL = ic.flux.value
        sign = 1.0 if interior_fluid else -1.0
        mesh = self.mesh
        fuse = enable_stencil_fusion
        band_budget = _sticky_band_budget(self, front.markers, mesh, dt,
                                          sign, band_budget)
        slab_solve = self._slab_solver(
            sign, band_budget, p, s, method, lin_tol, lin_maxiter,
            gibbs=isinstance(self.bc_i, GibbsThomson))
        jac_fn = _jacobian_fn(jac, mesh, sign, -rhoL, fuse, jac_p, jac_s,
                              band_budget)
        lm = (lm_init_lambda, lm_lambda_factor, lm_min_lambda, lm_max_lambda)
        max_disp = max_disp_cells * min(mesh.h[:2])

        def inner(Told, mk_a, d0, t):
            def residual(mk_b):
                T, flux, Va, Vb, klv_it = slab_solve(Told, mk_a, mk_b, t)
                F = rhoL * (Va - Vb) - flux
                return (_box3_filter(F) if fuse else F), T, klv_it

            d, T, Fg, hist, rn, it, kit = _gauss_newton(
                residual, jac_fn, mk_a, d0, newton_params, lm,
                (smooth_window, smooth_passes), max_disp,
                capture_residual_field)
            if capture_residual_field and Fg is None:
                Fg = torch.zeros(mesh.np_shape, dtype=d.dtype,
                                 device=d.device)
            return d, T, (rn, it, kit, hist, Fg)

        Tf, mkf, mk_log, (rns, its, kits, hists, Fgs) = _march_markers(
            inner, self.u0, front.markers, t_start, dt, K,
            extrapolation_factor)
        self.x = Tf
        self.markers = mkf
        self.marker_log = mk_log
        self.residual_log = _stacked(rns)
        self.iters_log = np.asarray(its)
        self.krylov_iters = np.asarray(kits)  # total Krylov its per step
        self.residual_hist = _stacked(hists)  # (steps, max_iter), NaN-pad
        self.residual_fields = (_stacked(Fgs) if capture_residual_field
                                else None)
        self.states = [Tf]
        front.markers = mkf
        return self.x

    def solve_geom(self, front, t_start, t_end, ic,
                   newton_params=(20, 1e-6, 1e-6, 0.8),
                   interior_fluid=True,
                   method="auto", lin_tol=1e-9, lin_maxiter=400,
                   smooth_window=11, smooth_passes=2,
                   extrapolation_factor=0.8, max_disp_cells=0.5,
                   p=4, s=1, band_budget="auto"):
        """Geometric front update (solve_StefanMono2D_geom!,
        stefan.jl:1135-1403): each iteration converts the per-cell energy
        residual ``F = ρL (Va - Vb) - flux`` into a cell displacement
        ``δ_cell = F / (ρL L_cell sign)``, distributes it to interface
        segments weighted by segment∩cell intersection lengths and averages
        segments onto markers.  Cheaper than GN (no Jacobian) at the cost of
        ignoring cross-cell coupling."""
        dt = self.dt
        K = _num_slabs(dt, t_start, t_end)
        max_iter, tol, _, alpha = newton_params
        max_iter = int(max_iter)
        rhoL = ic.flux.value
        sign = 1.0 if interior_fluid else -1.0
        mesh = self.mesh
        nx, ny = mesh.n
        max_disp = max_disp_cells * min(mesh.h[:2])
        band_budget = _sticky_band_budget(self, front.markers, mesh, dt,
                                          sign, band_budget)
        slab_solve = self._slab_solver(sign, band_budget, p, s, method,
                                       lin_tol, lin_maxiter)

        def geom_displacements(mk_b, F_grid):
            """Per-cell residual -> per-marker normal displacement."""
            L = segment_cell_intersections(mesh, mk_b)  # (nx, ny, ns)
            tot = L.sum(-1)
            D_cell = torch.where(
                tot > 1e-12,
                F_grid[:nx, :ny] / (rhoL * torch.clamp_min(tot, 1e-12)
                                    * sign), 0.0)
            seg_acc = torch.einsum("xys,xy->s", L, D_cell)
            seg_w = L.sum((0, 1))
            seg_d = torch.where(seg_w > 1e-12,
                                seg_acc / torch.clamp_min(seg_w, 1e-12), 0.0)
            # segments -> markers: length-weighted average of the two
            # segments adjoining each marker (segment i starts at marker i)
            w = torch.clamp_min(torch.linalg.norm(
                torch.roll(mk_b, -1, dims=0) - mk_b, dim=-1), 1e-10)
            wd = w * seg_d
            return (wd + torch.roll(wd, 1)) / (w + torch.roll(w, 1))

        def inner(Told, mk_a, d0, t):
            normals = polyline_normals(mk_a)
            d, T = d0, None
            inc = torch.full((), math.inf, dtype=d0.dtype, device=d0.device)
            it = 0
            while _still_iterating(it, max_iter, tol, inc):
                mk_b = mk_a + d[:, None] * normals
                T, flux, Va, Vb, _ = slab_solve(Told, mk_a, mk_b, t)
                F = rhoL * (Va - Vb) - flux
                d_inc = smooth_displacements(
                    alpha * geom_displacements(mk_b, F), smooth_window,
                    smooth_passes)
                d = torch.clamp(d + d_inc, -max_disp, max_disp)
                inc = torch.linalg.norm(d_inc)
                it += 1
            return d, T, (inc, it)

        Tf, mkf, mk_log, (incs, its) = _march_markers(
            inner, self.u0, front.markers, t_start, dt, K,
            extrapolation_factor)
        self.x = Tf
        self.markers = mkf
        self.marker_log = mk_log
        self.residual_log = _stacked(incs)
        self.iters_log = np.asarray(its)
        self.states = [Tf]
        front.markers = mkf
        return self.x


class StefanDiph2D(_ScalarSolverBase):
    """Two-phase 2D Stefan with front tracking (reference StefanDiph2D,
    stefan.jl:1404-1852): the marker GN/LM loop of StefanMono2D driving the
    _stef diphasic slab system; the residual sums both phases' interface
    fluxes:  F = ρL (V1(t0) - V1(t1)) - (flux1 + flux2)."""

    def __init__(self, phase1, phase2, bc_b, ic, dt, u0, mesh, scheme="BE"):
        self.phase1, self.phase2 = phase1, phase2
        self.bc_b = bc_b
        self.ic = ic
        self.dt = float(dt)
        self.u0 = u0
        self.mesh = mesh
        self.scheme = scheme

    def solve(self, front, t_start, t_end,
              newton_params=(12, 1e-4, 1e-6, 1.0),
              interior_phase1=True,
              latent_sign=1.0,
              method="auto", lin_tol=1e-9, lin_maxiter=800,
              lm_init_lambda=1e-4, lm_lambda_factor=10.0,
              lm_min_lambda=1e-10, lm_max_lambda=1e6,
              enable_stencil_fusion=True,
              smooth_window=5, smooth_passes=1,
              extrapolation_factor=0.8, max_disp_cells=0.5,
              jac="autodiff",
              p=4, s=1, jac_p=4, jac_s=1, band_budget="auto"):
        """``latent_sign``: +1 when phase-1 growth *absorbs* latent heat
        (melting into phase 1, the 1D reference bookkeeping), -1 when
        phase-1 growth *releases* it (solidification, e.g. Frank disk)."""
        dt = self.dt
        K = _num_slabs(dt, t_start, t_end)
        rhoL = self.ic.flux.value
        sign = 1.0 if interior_phase1 else -1.0
        mesh, scheme, ic, bc_b = self.mesh, self.scheme, self.ic, self.bc_b
        D1, f1 = self.phase1.diffusion, self.phase1.source
        D2, f2 = self.phase2.diffusion, self.phase2.source
        fuse = enable_stencil_fusion
        band_budget = _sticky_band_budget(self, front.markers, mesh, dt,
                                          sign, band_budget)
        jac_fn = _jacobian_fn(jac, mesh, sign, -latent_sign * rhoL, fuse,
                              jac_p, jac_s, band_budget)
        lm = (lm_init_lambda, lm_lambda_factor, lm_min_lambda, lm_max_lambda)
        max_disp = max_disp_cells * min(mesh.h[:2])

        def slab_solve(Xold, mk_a, mk_b, t):
            like = dict(dtype=mk_b.dtype, device=mk_b.device)
            caps = [compute_capacity_spacetime(
                _st_marker_body, mesh, 0.0, dt, p=p, s=s,
                params=(mk_a, mk_b, dt, sg), band_budget=band_budget, **like)
                for sg in (sign, -sign)]
            b1m, b2m = (border_info(mesh, bc_b,
                                    phase_mask=c.cell_types[..., 0] != 0,
                                    **like) for c in caps)
            X, klv_it, _ = solve_moving_diph_stef_step(
                caps[0], caps[1], D1, D2, f1, f2, ic, b1m, b2m, Xold, t, dt,
                scheme, tol=lin_tol, maxiter=lin_maxiter, method=method)
            flux1, Va1, Vb1 = _slab_flux(caps[0], D1, X[:2])
            flux2, _, _ = _slab_flux(caps[1], D2, X[2:])
            F = latent_sign * rhoL * (Va1 - Vb1) - (flux1 + flux2)
            return (_box3_filter(F) if fuse else F), X, klv_it

        def inner(Xold, mk_a, d0, t):
            d, X, _, _, rn, it, _ = _gauss_newton(
                lambda mk_b: slab_solve(Xold, mk_a, mk_b, t), jac_fn, mk_a,
                d0, newton_params, lm, (smooth_window, smooth_passes),
                max_disp, False)
            return d, X, (rn, it)

        Xf, mkf, mk_log, (rns, its) = _march_markers(
            inner, self.u0, front.markers, t_start, dt, K,
            extrapolation_factor)
        self.x = Xf
        self.markers = mkf
        self.marker_log = mk_log
        self.residual_log = _stacked(rns)
        self.iters_log = np.asarray(its)
        self.states = [Xf]
        front.markers = mkf
        return self.x

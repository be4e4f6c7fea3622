"""Prescribed-motion (moving interface) diffusion solvers (torch).

Counterpart of ``penguin_tpu.solvers.moving_diffusion``: each step
integrates over the space-time slab [t, t+dt], whose cut-cell capacities
are rebuilt on the device every step.  The JAX version runs the steps under
``lax.scan``; here they are a Python loop over the same K+1 slabs.

Discrete system per slab (A_mono_unstead_diff_moving, diffusion.jl:100-160):
with Va = spatial volume at slab start (capacity.A[time][first half]),
Vb = at slab end, and fresh/dead cell weights Psi+/Psi- (psip/psim,
diffusion.jl:58-98):

  [ Va + Id G^T W G Psi+ ,  -(Va-Vb) + Id G^T W H Psi+ ] [Tw]   [ Vb Tw^n + V f ]
  [ Ib H^T W G           ,  Ib H^T W H + Ia Gamma      ] [Tg] = [ Gamma g       ]

where G/H/W/Gamma/V are the *spatial* (time-slot-0) blocks of the space-time
operators; the dt factors live inside the space-time capacities.

The activity masks compare with 0 exactly: they rely on the capacity build
writing exact zeros for empty cells.

The slab body ``body_st(x..., t)`` is called with tensors, the time nodes
included.  Source and condition callables get the time as a Python float
(``t_start + k·dt``), so they take its sine with ``math.sin``.
"""

from __future__ import annotations

import math
import types

import numpy as np
import torch

from ..assembly import (
    _col_G_nz,
    _col_H_nz,
    _diag_GtWG,
    _diag_HtWH,
    border_info,
    build_I_bc,
)
from ..boundary import (
    Dirichlet,
    GibbsThomson,
    Neumann,
    Periodic,
    eval_condition_value,
)
from ..capacity import Capacity, compute_capacity_spacetime
from ..linsolve import (
    host_read,
    materialize_dense,
    pbicgstab,
    pcg,
    pgmres,
    row_norm_equilibrator,
)
from ..operators import (
    DiffusionOps,
    _shift_m,
    make_convection_ops,
    make_wdag,
)
from .diffusion import _ScalarSolverBase

__all__ = [
    "MovingDiffusionUnsteadyMono",
    "MovingDiffusionUnsteadyDiph",
    "MovingAdvDiffusionUnsteadyMono",
    "MovingAdvDiffusionUnsteadyDiph",
    "slice_spacetime",
    "spatial_capacity_from_slab",
    "psi_weights",
    "moving_mono_diag",
    "solve_moving_mono_step",
    "solve_moving_mono_step_reduced",
    "solve_moving_diph_step",
    "moving_diph_diag",
    "solve_moving_diph_stef_step",
    "solve_moving_diph_stef_step_reduced",
]


def slice_spacetime(cap_st, clamp_rel=0.0):
    """Split a space-time capacity into its spatial time-slot-0 operator
    data + the start/end volumes (reference slicing, diffusion.jl:112-151).

    ``clamp_rel``: per-slab small-cell clamp (the moving analogue of
    ``remove_small_volumes!``).  A cell *born or dying inside the slab*
    (e.g. Va = 0, Vb ~ 1e-5·h²) produces a bulk row whose every entry is
    O(sliver): the slab system becomes numerically singular.  Cells whose
    spatial volume never exceeds ``clamp_rel``·(max cell volume) during the
    slab are disconnected: their V/A/B/Gamma entries zero, so the activity
    masks turn them into identity DOFs.  Error is O(clamp_rel) in the
    sliver only.  Default 0 (off): the front-coupled paths need exact
    sliver dV for the interface velocity; the general prescribed-motion
    ``build_*`` functions pass clamp_rel=1e-4 explicitly."""
    N = cap_st.ndim - 1
    A_sp = tuple(cap_st.A[d][..., 0] for d in range(N))
    B_sp = tuple(cap_st.B[d][..., 0] for d in range(N))
    W_sp = tuple(cap_st.W[d][..., 0] for d in range(N))
    V0 = cap_st.V[..., 0]
    Gamma0 = cap_st.Gamma[..., 0]
    Va = cap_st.A[N][..., 0]  # spatial volumes at slab start
    Vb = cap_st.A[N][..., 1]  # at slab end
    C_sp = cap_st.C_om[..., 0, :N]
    Cg_sp = cap_st.C_ga[..., 0, :N]
    if clamp_rel:
        vmax = torch.maximum(Va, Vb)
        vfull = torch.max(vmax)
        vol_rel = clamp_rel ** 0.5          # 1e-2 for the 1e-4 default
        ap_rel = 10.0 * clamp_rel ** 0.5    # 1e-1
        # Disconnect sliver cells that are BOTH nearly volume-free and
        # nearly uncoupled: a partially-born cell (vmax > 0; truly-empty
        # cells keep their staggered W slots, which carry the neighbor's
        # interface flux) with tiny apertures owns a bulk row whose every
        # entry is O(sliver).  Disconnection zeroes the cell's V/A/B/Gamma
        # and the adjacent W slots, turning it into an identity DOF; the
        # local mass/flux error is O(sqrt(clamp_rel)).
        small = (vmax > 0) & (vmax < vol_rel * vfull)
        for arr in A_sp + B_sp:
            small = small & (arr < ap_rel * torch.max(arr))
        # Tangency slivers: when an interface extremum crosses a grid
        # line, a strictly born/dying cell (min(Va,Vb) = 0) can carry a
        # LARGE face aperture (the thin crescent hugs a fully-wet face),
        # so the all-apertures-small veto above never fires, yet its bulk
        # row mixes a zero mass with O(1/sliver) flux weights.  Disconnect
        # those outright below a 5x looser volume threshold.
        small = small | ((torch.minimum(Va, Vb) <= 0)
                         & (vmax > 0) & (vmax < 5 * vol_rel * vfull))
        kf = (~small).to(Va.dtype)
        A_sp = tuple(a * kf for a in A_sp)
        B_sp = tuple(b * kf for b in B_sp)
        # no flux through a removed sliver: W slot d/j touches cells j and
        # j-1 (dm is backward), so zero it when either one is disconnected
        # (1 - shift(1-kf) keeps out-of-domain "neighbors" alive).
        W_sp = tuple(
            w * kf * (1.0 - _shift_m(1.0 - kf, d)) for d, w in enumerate(W_sp)
        )
        Va = Va * kf
        Vb = Vb * kf
        V0 = V0 * kf
        Gamma0 = Gamma0 * kf
    ops = DiffusionOps(A=A_sp, B=B_sp, V=V0, Wdag=make_wdag(W_sp))
    return ops, Va, Vb, Gamma0, C_sp, Cg_sp


def spatial_capacity_from_slab(cap_st, mesh_sp):
    """Spatial :class:`~penguin_tpu_torch.capacity.Capacity` view of a
    ``cut_moments=True`` space-time slab build.

    A/B/V/W are the slab's TIME-INTEGRATED measures (slot-0 slices, the
    same data :func:`slice_spacetime` feeds the slab operators), C_om/C_ga
    the slab centroids' spatial components, and Am/Bm/Vh the slab cut
    moments (built on spatial axes only).  The Gauss half-box identities
    behind ``gamma_half_moments`` hold verbatim on the slab (the time
    faces have ``e_a·n = 0`` for every spatial axis a, so they drop out),
    which makes the whole moment cut-flux machinery (``gamma_half_moments``
    + the cross-moment ``Xw`` operators) consume this view unchanged."""
    N = cap_st.ndim - 1
    if cap_st.Am is None:
        raise ValueError("spatial_capacity_from_slab needs a slab built "
                         "with compute_capacity_spacetime(..., "
                         "cut_moments=True)")
    return Capacity(
        A=tuple(cap_st.A[d][..., 0] for d in range(N)),
        B=tuple(cap_st.B[d][..., 0] for d in range(N)),
        V=cap_st.V[..., 0],
        W=tuple(cap_st.W[d][..., 0] for d in range(N)),
        C_om=cap_st.C_om[..., 0, :N],
        C_ga=cap_st.C_ga[..., 0, :N],
        Gamma=cap_st.Gamma[..., 0],
        cell_types=cap_st.cell_types[..., 0],
        mesh=mesh_sp,
        body=None,
        Am=tuple(cap_st.Am[d][..., 0, :N] for d in range(N)),
        Bm=tuple(cap_st.Bm[d][..., 0, :N] for d in range(N)),
        Vh=tuple(cap_st.Vh[d][..., 0] for d in range(N)),
    )


def psi_weights(scheme, Vb, Va):
    """Psi+ (matrix side) and Psi- (rhs side) fresh/dead-cell weights,
    matching psip_cn/psim_cn/psip_be/psim_be exactly (args order (Vn, Vn_1)
    = (slab-end, slab-start) as at diffusion.jl:121,184)."""
    nzb, nza = Vb != 0, Va != 0
    if scheme == "CN":
        psip = torch.where(
            ~nzb & ~nza, 0.0,
            torch.where(nzb & nza, 0.5, torch.where(~nzb & nza, 0.5, 1.0)),
        ).to(Vb.dtype)
        psim = torch.where(nzb & nza, 0.5,
                           torch.where(~nzb & nza, 0.5, 0.0)).to(Vb.dtype)
    else:
        psip = (nzb | nza).to(Vb.dtype)
        psim = torch.zeros_like(Vb)
    return psip, psim


def _coords(C):
    return [C[..., d] for d in range(C.shape[-1])]


def _eval_f(f, C_sp, t):
    """Source at spatial centroid components + explicit time."""
    return eval_condition_value(f, _coords(C_sp), t)


def _eval_g(bc_i, Cg_sp, like, t=None):
    if isinstance(bc_i, GibbsThomson):
        g = bc_i.Tm * torch.ones_like(like)
        if bc_i.v_gamma is not None:
            g = g - bc_i.eps_v * bc_i.v_gamma
        return g
    return eval_condition_value(bc_i.value, _coords(Cg_sp), t)


def _eval_D(D, C_sp):
    if callable(D):
        return eval_condition_value(D, _coords(C_sp))
    return D


def _jump_value(value, Cg, like, t):
    """A jump condition's value at the interface centroids."""
    if callable(value):
        return eval_condition_value(value, _coords(Cg), t)
    return value * torch.ones_like(like)


def _direct_solve(apply_fn, b):
    """Dense materialization + LU (zero rows/cols fixed numerically: the
    per-slab analogue of remove_zero_rows_cols!)."""
    A, unravel = materialize_dense(apply_fn, b)
    flat = torch.cat([leaf.reshape(-1) for leaf in b])
    row_nz = A.abs().sum(dim=1) > 1e-14
    col_nz = A.abs().sum(dim=0) > 1e-14
    keep = row_nz & col_nz
    d = keep.to(A.dtype)
    A = A * d[:, None] * d[None, :] + torch.diag(1.0 - d)
    x = torch.linalg.solve(A, torch.where(keep, flat, 0.0))
    return unravel(x)


def moving_masks(ops, Va, Vb, Gamma0, ia, ib):
    """(bulk_active, iface_active) DOF masks for one slab, with the exact
    reference drop semantics (remove_zero_rows_cols!, src/solver.jl:59-78:
    index kept iff its row AND column are structurally nonzero):

    - bulk j: row has Va (or dV/G terms); kept when the cell exists at
      either slab end or touches the gradient stencil.
    - iface j (row ``ib H^T… + ia Gamma T_g``): row nonzero iff
      (colH & ib!=0) | (Gamma!=0 & ia!=0); column nonzero iff
      colH | (Gamma!=0 & ia!=0).  For a pure Dirichlet closure this trims
      the T_g of non-cut cells whose H column is nonzero: rows that would
      otherwise be identically zero (singular under Krylov)."""
    bulk_act = (Va != 0) | (Vb != 0) | _col_G_nz(ops)
    colH = _col_H_nz(ops)
    ia_nz, ib_nz = ia != 0.0, ib != 0.0
    g_nz = Gamma0 != 0
    ifc_row = (colH & ib_nz) | (g_nz & ia_nz)
    ifc_col = colH | (g_nz & ia_nz)
    return bulk_act, ifc_row & ifc_col


def _border_diag(d, border):
    """The border rows' diagonal entries written into a bulk diagonal."""
    if border is not None:
        for key, cond, axis, side, mask in border.items:
            if isinstance(cond, (Dirichlet, GibbsThomson, Periodic)):
                d = torch.where(mask, 1.0, d)
            elif isinstance(cond, Neumann):
                d = torch.where(mask, 1.0 / border.mesh.h[axis], d)
    return d


def _nonzero_diag(d):
    return torch.where(d == 0.0, 1.0, d)


def moving_mono_diag(cap_st, D, bc_i, border, scheme, masks=None):
    """Diagonal of the moving mono slab system (Jacobi preconditioner):
    the moving-system analogue of ``assembly.mono_diag_fn``."""
    ops, Va, Vb, Gamma0, C_sp, _ = slice_spacetime(cap_st)
    psip, _ = psi_weights(scheme, Vb, Va)
    ia, ib = build_I_bc(bc_i)
    Id = _eval_D(D, C_sp)
    bulk = Va + psip * Id * _diag_GtWG(ops)
    ifc = ib * _diag_HtWH(ops) + ia * Gamma0
    if masks is None:
        masks = moving_masks(ops, Va, Vb, Gamma0, ia, ib)
    bulk = torch.where(masks[0], bulk, 1.0)
    ifc = torch.where(masks[1], ifc, 1.0)
    bulk = _border_diag(bulk, border)
    return (_nonzero_diag(bulk), _nonzero_diag(ifc))


def build_moving_mono_system(cap_st, D, f, bc_i, border, t, dt, scheme,
                             g_override=None):
    """Returns (apply, rhs) closures for one slab.  ``g_override`` replaces
    the interface value g_gamma (used by the Stefan solvers to feed a
    Gibbs-Thomson value Tm - eps_v v_gamma per iteration)."""
    ops, Va, Vb, Gamma0, C_sp, Cg_sp = slice_spacetime(cap_st)
    psip, psim = psi_weights(scheme, Vb, Va)
    ia, ib = build_I_bc(bc_i)
    Id = _eval_D(D, C_sp)
    dV = Va - Vb
    # per-slab activity masks (zero-row/col elimination -> identity DOFs)
    bulk_act, ifc_act = moving_masks(ops, Va, Vb, Gamma0, ia, ib)

    def apply(x):
        TW, TG = x
        # dropped DOFs are zeroed on the way in (column elimination) and
        # replaced by identity rows on the way out (row elimination)
        TWa = torch.where(bulk_act, TW, 0.0)
        TGa = torch.where(ifc_act, TG, 0.0)
        q = ops.flux(psip * TWa, psip * TGa)
        r1 = Va * TWa + Id * ops.GT(q) - dV * TGa
        q2 = ops.flux(TWa, TGa)
        r2 = ib * ops.HT(q2) + ia * Gamma0 * TGa
        r1 = torch.where(bulk_act, r1, TW)
        r2 = torch.where(ifc_act, r2, TG)
        if border is not None:
            r1 = border.matvec(r1, TW)
        return (r1, r2)

    def rhs(x_prev):
        TW, TG = x_prev
        gg = g_override if g_override is not None else _eval_g(
            bc_i, Cg_sp, Gamma0, t
        )
        gg = torch.where(ifc_act, gg, 0.0)
        if scheme == "CN":
            fn = _eval_f(f, C_sp, t)
            fn1 = _eval_f(f, C_sp, t + dt)
            qm = ops.flux(psim * TW, torch.zeros_like(TG))
            hterm = ops.flux(torch.zeros_like(TW), TG)
            b1 = (
                Vb * TW
                - Id * ops.GT(qm)
                - 0.5 * Id * ops.GT(hterm)
                + 0.5 * ops.V * (fn + fn1)
            )
        else:
            fn1 = _eval_f(f, C_sp, t + dt)
            b1 = Vb * TW + ops.V * fn1
        b2 = Gamma0 * gg
        b1 = torch.where(bulk_act, b1, 0.0)
        if border is not None:
            b1 = border.rhs(b1, t)
        return (b1, b2)

    return apply, rhs


def _reduced_phase(ops, Va, Vb, psip, Id, Tg, TWp, f, C_sp, border, t, dt):
    """The bulk system of one phase under BE with its interface unknown
    ``Tg`` known: ``(Va + Psi+ Id G^T W G) Tw = Vb Tw^n + V f
    - Id G^T W H (Psi+ Tg) + dV Tg``.  Returns (apply, rhs, diagonal,
    activity mask)."""
    act = (Va != 0) | (Vb != 0)

    def apply(TW):
        TWa = torch.where(act, TW, 0.0)
        q = ops.flux(psip * TWa, torch.zeros_like(TWa))
        r = Va * TWa + Id * ops.GT(q)
        r = torch.where(act, r, TW)
        if border is not None:
            r = border.matvec(r, TW)
        return r

    fn1 = _eval_f(f, C_sp, t + dt)
    qh = ops.flux(torch.zeros_like(TWp), psip * Tg)
    b = Vb * TWp + ops.V * fn1 - Id * ops.GT(qh) + (Va - Vb) * Tg
    b = torch.where(act, b, 0.0)
    if border is not None:
        b = border.rhs(b, t)

    dG = Va + psip * Id * _diag_GtWG(ops)
    dG = torch.where(act, dG, 1.0)
    dG = _nonzero_diag(_border_diag(dG, border))
    return apply, b, dG, act


def _reduced_slab(cap_st, D, f, bc_i, border, x_prev, t, dt,
                  g_override=None, x0=None):
    """The pieces of :func:`solve_moving_mono_step_reduced`'s CG: (apply,
    rhs, inverse diagonal, initial guess, T_g).  ``parallel.sharding``
    builds them on one rank's window."""
    ops, Va, Vb, Gamma0, C_sp, Cg_sp = slice_spacetime(cap_st)
    ia, ib = build_I_bc(bc_i)
    if not (np.isscalar(ib) and ib == 0.0):
        raise ValueError("reduced slab solve requires a Dirichlet-type "
                         "interface closure (ib == 0)")
    psip, _ = psi_weights("BE", Vb, Va)
    Id = _eval_D(D, C_sp)
    _, ifc_act = moving_masks(ops, Va, Vb, Gamma0, ia, ib)

    gg = g_override if g_override is not None else _eval_g(bc_i, Cg_sp,
                                                           Gamma0, t)
    # the gamma row is ia*Gamma*T_g = Gamma*g, so T_g = g/ia (ia != 1 for
    # Robin(alpha, beta=0) closures)
    if not np.isscalar(ia):
        raise ValueError("reduced slab solve requires a scalar ia")
    Tg = torch.where(ifc_act, (gg / ia) * torch.ones_like(Va), 0.0)

    TWp = x_prev[0]
    apply, b, dG, act = _reduced_phase(ops, Va, Vb, psip, Id, Tg, TWp, f,
                                       C_sp, border, t, dt)

    # warm start: an explicit x0 (e.g. the previous Gauss-Newton iterate of
    # a front-position loop, whose system differs only by the front
    # displacement) beats the time-step-start field by a large margin.
    # Only cells live at the slab END (Va > 0) take the warm value: dead
    # cells (Va = 0) sit on near-null rows CG cannot correct, and feeding
    # the previous iterate back would accumulate junk across iterations.
    guess = torch.where(Va > 0, x0[0], TWp) if x0 is not None else TWp
    xinit = torch.where(act, guess, 0.0)
    return apply, b, 1.0 / dG, xinit, Tg


def solve_moving_mono_step_reduced(cap_st, D, f, bc_i, border, x_prev, t, dt,
                                   tol=1e-9, maxiter=500, g_override=None,
                                   x0=None):
    """BE slab solve with the interface unknown eliminated analytically.

    For a Dirichlet-type interface closure (``ib == 0``: Dirichlet or
    GibbsThomson) the gamma row is ``Gamma T_g = Gamma g``, so ``T_g := g``
    on cut cells and the slab system collapses to one SPD bulk system::

        (Va + Psi+ Id G^T W G) T_w = Vb T_w^n + V f - Id G^T W H (Psi+ g) + dV g

    the moving-interface analogue of the FastHeatBE elimination
    (solvers/heat_fast.py).  Half the DOFs of the coupled system and CG
    instead of BiCGStab (one matvec per iteration); under BE, Psi+ = 1 on
    every live cell so the operator restricted to the active set is
    symmetric whenever the diffusivity is uniform.

    Returns ``((T_w, T_g), iters, relres)`` shaped exactly like the full
    solve (T_g filled with g on active interface cells)."""
    apply, b, minv, xinit, Tg = _reduced_slab(
        cap_st, D, f, bc_i, border, x_prev, t, dt, g_override=g_override,
        x0=x0)
    TW, iters, relres = pcg(apply, b, xinit, Minv=minv, tol=tol,
                            maxiter=maxiter)
    return (TW, Tg), iters, relres


def solve_moving_mono_step(cap_st, D, f, bc_i, border, x_prev, t, dt, scheme,
                           tol=1e-9, maxiter=500, g_override=None,
                           method="auto", x0=None):
    """One moving-interface slab solve by Jacobi-preconditioned matrix-free
    Krylov with warm start from ``x_prev``.

    ``method="auto"`` picks the reduced SPD CG path (T_g eliminated,
    ``solve_moving_mono_step_reduced``) whenever the closure is
    Dirichlet-type and the scheme is BE, else preconditioned BiCGStab on
    the coupled system.

    Returns ``(x, iters, relres)``: per-solve Krylov telemetry."""
    ia, ib = build_I_bc(bc_i)
    if method == "auto":
        # reducible: Dirichlet-type closure under BE with a *uniform*
        # diffusivity; for callable (spatially varying) D the reduced
        # operator Va + Id*GtWG is not Euclidean-symmetric, so CG is
        # unsound: route it to BiCGStab on the coupled system instead
        reducible = (np.isscalar(ib) and ib == 0.0 and scheme == "BE"
                     and np.isscalar(ia) and not callable(D))
        method = "reduced" if reducible else "pbicgstab"
    if method == "reduced":
        return solve_moving_mono_step_reduced(
            cap_st, D, f, bc_i, border, x_prev, t, dt,
            tol=tol, maxiter=maxiter, g_override=g_override, x0=x0,
        )
    apply_fn, rhs_fn = build_moving_mono_system(
        cap_st, D, f, bc_i, border, t, dt, scheme, g_override=g_override
    )
    diag = moving_mono_diag(cap_st, D, bc_i, border, scheme)
    Minv = tuple(1.0 / d for d in diag)
    b = rhs_fn(x_prev)
    if method == "direct":
        return _direct_solve(apply_fn, b), 0, 0.0
    solver = pcg if method == "pcg" else pbicgstab
    return solver(apply_fn, b, x_prev if x0 is None else x0, Minv=Minv,
                  tol=tol, maxiter=maxiter)


def _diph_cut(ops1, ops2, G1, G2, dV1, dV2):
    """Interface DOF activity of the diphasic systems
    (remove_zero_rows_cols! semantics, solver.jl:59-78): away from cut
    cells the jump/flux rows would be zero (H columns and dV vanish),
    leaving T_g free -> identity rows instead."""
    return (_col_H_nz(ops1) | _col_H_nz(ops2) | (G1 != 0) | (G2 != 0)
            | (dV1 != 0) | (dV2 != 0))


def build_moving_diph_system(cap1, cap2, D1, D2, f1, f2, ic, border1,
                             border2, t, dt, scheme, clamp_rel=1e-4):
    """(apply, rhs) for the diphasic slab system
    (A_diph_unstead_diff_moving, diffusion.jl:292-501)."""
    ops1, Va1, Vb1, G1, C1, Cg1 = slice_spacetime(cap1, clamp_rel)
    ops2, Va2, Vb2, G2, C2, Cg2 = slice_spacetime(cap2, clamp_rel)
    p1p, p1m = psi_weights(scheme, Vb1, Va1)
    p2p, p2m = psi_weights(scheme, Vb2, Va2)
    a1, a2 = ic.scalar.alpha1, ic.scalar.alpha2
    be1, be2 = ic.flux.beta1, ic.flux.beta2
    Id1 = _eval_D(D1, C1)
    Id2 = _eval_D(D2, C2)
    dV1, dV2 = Va1 - Vb1, Va2 - Vb2
    act1 = (Va1 != 0) | (Vb1 != 0) | _col_G_nz(ops1)
    act2 = (Va2 != 0) | (Vb2 != 0) | _col_G_nz(ops2)
    cut = _diph_cut(ops1, ops2, G1, G2, dV1, dV2)

    def apply(x):
        TW1, TG1, TW2, TG2 = x
        TG1a = torch.where(cut, TG1, 0.0)
        TG2a = torch.where(cut, TG2, 0.0)
        q1 = ops1.flux(p1p * TW1, p1p * TG1a)
        q2 = ops2.flux(p2p * TW2, p2p * TG2a)
        r1 = Va1 * TW1 + Id1 * ops1.GT(q1) - dV1 * TG1a
        r3 = Va2 * TW2 + Id2 * ops2.GT(q2) - dV2 * TG2a
        r2 = torch.where(cut, a1 * TG1a - a2 * TG2a, TG1)
        r4 = (
            be1 * ops1.HT(q1)
            - dV1 * TG1a
            + be2 * ops2.HT(q2)
            - dV2 * TG2a
        )
        r4 = torch.where(cut, r4, TG2)
        r1 = torch.where(act1, r1, TW1)
        r3 = torch.where(act2, r3, TW2)
        if border1 is not None:
            r1 = border1.matvec(r1, TW1)
        if border2 is not None:
            r3 = border2.matvec(r3, TW2)
        return (r1, r2, r3, r4)

    def rhs(x_prev):
        TW1, TG1, TW2, TG2 = x_prev
        gg = _jump_value(ic.scalar.value, Cg1, Vb1, t)
        hh = _jump_value(ic.flux.value, Cg2, Vb2, t)

        def bulk(ops, Vb, Id, pm, TW, TG, f, V0, C):
            qm = ops.flux(pm * TW, pm * TG)
            fn = _eval_f(f, C, t)
            fn1 = _eval_f(f, C, t + dt)
            if scheme == "CN":
                src = 0.5 * V0 * (fn + fn1)
            else:
                src = V0 * fn1
            return Vb * TW - Id * ops.GT(qm) + src

        b1 = bulk(ops1, Vb1, Id1, p1m, TW1, torch.where(cut, TG1, 0.0),
                  f1, ops1.V, C1)
        b3 = bulk(ops2, Vb2, Id2, p2m, TW2, torch.where(cut, TG2, 0.0),
                  f2, ops2.V, C2)
        b2 = torch.where(cut, gg, 0.0)
        b4 = torch.where(cut, G2 * hh, 0.0)
        if border1 is not None:
            b1 = border1.rhs(b1, t)
        if border2 is not None:
            b3 = border2.rhs(b3, t)
        return (b1, b2, b3, b4)

    return apply, rhs


def _phase_bulk_diag(cap, D, border, scheme, clamp_rel=0.0):
    """Jacobi diagonal of one phase's bulk row of a diphasic slab system,
    plus the sliced data the interface rows need."""
    ops, Va, Vb, G0, C_sp, _ = slice_spacetime(cap, clamp_rel)
    pp, _ = psi_weights(scheme, Vb, Va)
    Id = _eval_D(D, C_sp)
    act = (Va != 0) | (Vb != 0) | _col_G_nz(ops)
    d = Va + pp * Id * _diag_GtWG(ops)
    d = torch.where(act, d, 1.0)
    return _nonzero_diag(_border_diag(d, border)), ops, Va, Vb, G0


def moving_diph_diag(cap1, cap2, D1, D2, ic, border1, border2, scheme,
                     clamp_rel=1e-4):
    """Jacobi diagonal of the general diphasic slab system (rows r1..r4 of
    ``build_moving_diph_system`` wrt their own unknowns TW1/TG1/TW2/TG2)."""
    d1, ops1, Va1, Vb1, G1 = _phase_bulk_diag(cap1, D1, border1, scheme,
                                              clamp_rel)
    d3, ops2, Va2, Vb2, G2 = _phase_bulk_diag(cap2, D2, border2, scheme,
                                              clamp_rel)
    cut = _diph_cut(ops1, ops2, G1, G2, Va1 - Vb1, Va2 - Vb2)
    a1 = ic.scalar.alpha1
    be2 = ic.flux.beta2
    d2 = torch.where(cut, a1 * torch.ones_like(d1), 1.0)
    d4 = torch.where(cut, be2 * _diag_HtWH(ops2) - (Va2 - Vb2), 1.0)
    return (d1, _nonzero_diag(d2), d3, _nonzero_diag(d4))


def solve_moving_diph_step(cap1, cap2, D1, D2, f1, f2, ic, border1, border2,
                           x_prev, t, dt, scheme, tol=1e-10, maxiter=3000,
                           method="pgmres", restart=150):
    """Row-equilibrated Krylov solve of the general diphasic slab system
    with warm start; returns ``(x, iters, relres)`` telemetry.

    Default is left-preconditioned GMRES with row-norm equilibration: the
    4-block jump system mixes bulk rows (scale V ~ h^d) with O(1) jump
    rows, and BiCGStab stalls on that row-scaling even when the
    equilibrated spectrum is benign."""
    apply_fn, rhs_fn = build_moving_diph_system(
        cap1, cap2, D1, D2, f1, f2, ic, border1, border2, t, dt, scheme
    )
    b = rhs_fn(x_prev)
    if method == "direct":
        return _direct_solve(apply_fn, b), 0, 0.0
    if method == "pbicgstab":
        diag = moving_diph_diag(cap1, cap2, D1, D2, ic, border1, border2,
                                scheme)
        Minv = tuple(1.0 / d for d in diag)
        return pbicgstab(apply_fn, b, x_prev, Minv=Minv, tol=tol,
                         maxiter=maxiter)
    Minv = row_norm_equilibrator(apply_fn, b)
    return pgmres(apply_fn, b, x_prev, Minv=Minv, tol=tol, maxiter=maxiter,
                  restart=restart)


def psi_conv_weights(Vb, Va):
    """Fresh/dead convection weights (psip_conv/psim_conv,
    prescribedmotionsolver/advectiondiffusion.jl:35-61): implicit convection
    only on fresh cells, explicit on alive/dead cells."""
    nzb, nza = Vb != 0, Va != 0
    psip = (~nzb & nza).to(Vb.dtype)  # fresh
    psim = ((nzb & nza) | (nzb & ~nza)).to(Vb.dtype)  # alive or dead
    return psip, psim


def _spatial_conv(ops, u_bulk, u_gamma):
    """Flux-form convection operators on a slab's spatial blocks."""
    cap_sp = types.SimpleNamespace(
        A=ops.A, B=ops.B, V=ops.V,
        W=tuple(torch.where(w != 0, 1.0 / w, 0.0) for w in ops.Wdag),
    )
    return make_convection_ops(cap_sp, u_bulk, u_gamma)


def build_moving_advdiff_system(cap_st, D, f, bc_i, border, u_bulk, u_gamma,
                                t, dt, scheme, clamp_rel=1e-4):
    """(apply, rhs) for prescribed-motion advection-diffusion
    (A/b_mono_unstead_advdiff_moving, advectiondiffusion.jl:64-200): the
    moving diffusion blocks plus spatial flux-form convection weighted by
    the fresh/dead psi_conv factors."""
    ops, Va, Vb, Gamma0, C_sp, Cg_sp = slice_spacetime(cap_st, clamp_rel)
    psip, psim = psi_weights(scheme, Vb, Va)
    cpp, cpm = psi_conv_weights(Vb, Va)
    ia, ib = build_I_bc(bc_i)
    Id = _eval_D(D, C_sp)
    dV = Va - Vb
    conv = _spatial_conv(ops, u_bulk, u_gamma)
    # zero-row/col elimination -> identity DOFs (see build_moving_mono_system)
    bulk_act, ifc_act = moving_masks(ops, Va, Vb, Gamma0, ia, ib)

    def apply(x):
        TW, TG = x
        TWa = torch.where(bulk_act, TW, 0.0)
        TGa = torch.where(ifc_act, TG, 0.0)
        q = ops.flux(psip * TWa, psip * TGa)
        r1 = (
            Va * TWa
            + Id * ops.GT(q)
            - dV * TGa
            - (conv.conv(cpp * TWa) + 0.5 * conv.kconv(cpp * TWa))
            - 0.5 * conv.kconv(cpp * TGa)
        )
        q2 = ops.flux(TWa, TGa)
        r2 = ib * ops.HT(q2) + ia * Gamma0 * TGa
        r1 = torch.where(bulk_act, r1, TW)
        r2 = torch.where(ifc_act, r2, TG)
        if border is not None:
            r1 = border.matvec(r1, TW)
        return (r1, r2)

    def rhs(x_prev):
        TW, TG = x_prev
        gg = _eval_g(bc_i, Cg_sp, Gamma0, t)
        gg = torch.where(ifc_act, gg, 0.0)
        fn1 = _eval_f(f, C_sp, t + dt)
        if scheme == "CN":
            fn = _eval_f(f, C_sp, t)
            qm = ops.flux(psim * TW, torch.zeros_like(TG))
            hterm = ops.flux(torch.zeros_like(TW), TG)
            b1 = (
                Vb * TW
                - Id * ops.GT(qm)
                - 0.5 * Id * ops.GT(hterm)
                + 0.5 * ops.V * (fn + fn1)
                - 0.5 * conv.kconv(psim * TW)
                - 0.5 * conv.kconv(TG)
                - conv.conv(TW)
            )
        else:
            b1 = (
                Vb * TW
                + ops.V * fn1
                - 0.5 * conv.kconv(cpm * TW)
                - 0.5 * conv.kconv(TG)
                - conv.conv(cpm * TW)
            )
        b2 = torch.where(ifc_act, Gamma0 * gg, 0.0)
        if border is not None:
            b1 = border.rhs(b1, t)
        return (b1, b2)

    return apply, rhs


# ---------------------------------------------------------------------------
# the time loop shared by the four classes
# ---------------------------------------------------------------------------

def _num_slabs(dt, t_start, t_end):
    return int(math.ceil((t_end - t_start) / dt - 1e-12))


def _march_slabs(step, u0, t_start, dt, K, keep_states=False):
    """Solve the K+1 slabs starting at ``t_start + k·dt``, k = 0..K (the
    reference loop: one solve from the initial condition, then K more).
    Returns (x, states or None, iterations, relative residuals); the
    residuals stay on the device until one read after the loop."""
    x = u0
    hist = [] if keep_states else None
    iters, res = [], []
    for k in range(K + 1):
        x, it, rr = step(x, t_start + k * dt)
        iters.append(int(it))
        res.append(rr)
        if keep_states:
            hist.append(x)
    like = x[0]
    if any(isinstance(r, torch.Tensor) for r in res):
        res = host_read(torch.stack([
            r.to(like.dtype) if isinstance(r, torch.Tensor)
            else torch.full((), float(r), dtype=like.dtype,
                            device=like.device) for r in res]))
    return x, hist, np.asarray(iters), np.asarray(res, dtype=np.float64)


def _like(u0):
    return dict(dtype=u0[0].dtype, device=u0[0].device)


def _equilibrated_step(apply_fn, b, x, method, diag_fn, tol, maxiter,
                       restart):
    """``direct``, Jacobi ``pbicgstab`` (``diag_fn()`` gives the diagonal)
    or row-equilibrated ``pgmres`` on one assembled slab system."""
    if method == "direct":
        return _direct_solve(apply_fn, b), 0, 0.0
    if method == "pbicgstab":
        Minv = tuple(1.0 / d for d in diag_fn())
        return pbicgstab(apply_fn, b, x, Minv=Minv, tol=tol, maxiter=maxiter)
    Minv = row_norm_equilibrator(apply_fn, b)
    return pgmres(apply_fn, b, x, Minv=Minv, tol=tol, maxiter=maxiter,
                  restart=restart)


class _MovingMonoBase(_ScalarSolverBase):
    def __init__(self, phase, bc_b, bc_i, dt, u0, mesh, scheme="BE"):
        self.phase = phase
        self.bc_b = bc_b
        self.bc_i = bc_i
        self.dt = float(dt)
        self.u0 = u0
        self.mesh = mesh
        self.scheme = scheme
        self.border = border_info(mesh, bc_b, **_like(u0))


class _MovingDiphBase(_ScalarSolverBase):
    def __init__(self, phase1, phase2, bc_b, ic, dt, u0, mesh, scheme="BE"):
        self.phase1, self.phase2 = phase1, phase2
        self.bc_b = bc_b
        self.ic = ic
        self.dt = float(dt)
        self.u0 = u0
        self.mesh = mesh
        self.scheme = scheme

    def _slab(self, body_st, body_c_st, t, p, s):
        """Both phases' slab capacities and their border rows, restricted
        to each phase's non-empty cells."""
        like = _like(self.u0)
        dt, mesh = self.dt, self.mesh
        cap1 = compute_capacity_spacetime(body_st, mesh, t, t + dt, p=p, s=s,
                                          **like)
        cap2 = compute_capacity_spacetime(body_c_st, mesh, t, t + dt, p=p,
                                          s=s, **like)
        b1m = border_info(mesh, self.bc_b,
                          phase_mask=cap1.cell_types[..., 0] != 0, **like)
        b2m = border_info(mesh, self.bc_b,
                          phase_mask=cap2.cell_types[..., 0] != 0, **like)
        return cap1, cap2, b1m, b2m


class MovingAdvDiffusionUnsteadyMono(_MovingMonoBase):
    """Prescribed-motion advection-diffusion
    (solve_MovingAdvDiffusionUnsteadyMono!, advectiondiffusion.jl:203+)."""

    def solve(self, body_st, t_start, t_end, u_bulk, u_gamma,
              method="pgmres", p=6, s=1, tol=1e-10, maxiter=2000,
              restart=150):
        dt = self.dt
        K = _num_slabs(dt, t_start, t_end)
        D, f = self.phase.diffusion, self.phase.source
        bc_i, border, mesh, scheme = (self.bc_i, self.border, self.mesh,
                                      self.scheme)
        like = _like(self.u0)

        def step(x, t):
            cap_st = compute_capacity_spacetime(body_st, mesh, t, t + dt,
                                                p=p, s=s, **like)
            apply_fn, rhs_fn = build_moving_advdiff_system(
                cap_st, D, f, bc_i, border, u_bulk, u_gamma, t, dt, scheme
            )
            # the diffusion diagonal preconditions the advective system
            # too (convection is off-diagonal in flux form)
            return _equilibrated_step(
                apply_fn, rhs_fn(x), x, method,
                lambda: moving_mono_diag(cap_st, D, bc_i, border, scheme),
                tol, maxiter, restart)

        self.x, _, self.krylov_iters, self.krylov_relres = _march_slabs(
            step, self.u0, t_start, dt, K)
        self.states = [self.x]
        return self.x


def build_moving_diph_stef_system(cap1, cap2, D1, D2, f1, f2, ic, border1,
                                  border2, t, dt, scheme):
    """Stefan variant of the diphasic slab system
    (A/b_diph_unstead_diff_moving_stef, liquidmotionsolver/diffusion.jl:
    445-652): the gamma rows pin the interface temperature (jump row
    ``a1 T1g - a2 T2g = g`` and ``a2 T2g = g``), leaving the interface
    fluxes free for the outer front-position Newton."""
    ops1, Va1, Vb1, G1, C1, Cg1 = slice_spacetime(cap1)
    ops2, Va2, Vb2, G2, C2, Cg2 = slice_spacetime(cap2)
    p1p, p1m = psi_weights(scheme, Vb1, Va1)
    p2p, p2m = psi_weights(scheme, Vb2, Va2)
    a1, a2 = ic.scalar.alpha1, ic.scalar.alpha2
    Id1 = _eval_D(D1, C1)
    Id2 = _eval_D(D2, C2)
    dV1, dV2 = Va1 - Vb1, Va2 - Vb2
    act1 = (Va1 != 0) | (Vb1 != 0) | _col_G_nz(ops1)
    act2 = (Va2 != 0) | (Vb2 != 0) | _col_G_nz(ops2)

    def apply(x):
        TW1, TG1, TW2, TG2 = x
        TW1a = torch.where(act1, TW1, 0.0)
        TW2a = torch.where(act2, TW2, 0.0)
        q1 = ops1.flux(p1p * TW1a, p1p * TG1)
        q2 = ops2.flux(p2p * TW2a, p2p * TG2)
        r1 = Va1 * TW1a + Id1 * ops1.GT(q1) - dV1 * TG1
        r3 = Va2 * TW2a + Id2 * ops2.GT(q2) - dV2 * TG2
        r2 = a1 * TG1 - a2 * TG2
        r4 = a2 * TG2
        r1 = torch.where(act1, r1, TW1)
        r3 = torch.where(act2, r3, TW2)
        if border1 is not None:
            r1 = border1.matvec(r1, TW1)
        if border2 is not None:
            r3 = border2.matvec(r3, TW2)
        return (r1, r2, r3, r4)

    def rhs(x_prev):
        TW1, TG1, TW2, TG2 = x_prev
        gg = _jump_value(ic.scalar.value, Cg1, Vb1, t)

        def bulk(ops, Vb, Id, pm, TW, TG, f, C):
            qm = ops.flux(pm * TW, pm * TG)
            fn = _eval_f(f, C, t)
            fn1 = _eval_f(f, C, t + dt)
            if scheme == "CN":
                return Vb * TW - Id * ops.GT(qm) + 0.5 * ops.V * (fn + fn1)
            return Vb * TW + ops.V * fn1

        b1 = bulk(ops1, Vb1, Id1, p1m, TW1, TG1, f1, C1)
        b3 = bulk(ops2, Vb2, Id2, p2m, TW2, TG2, f2, C2)
        b1 = torch.where(act1, b1, 0.0)
        b3 = torch.where(act2, b3, 0.0)
        if border1 is not None:
            b1 = border1.rhs(b1, t)
        if border2 is not None:
            b3 = border2.rhs(b3, t)
        return (b1, gg, b3, gg)

    return apply, rhs


def solve_moving_diph_stef_step_reduced(cap1, cap2, D1, D2, f1, f2, ic,
                                        border1, border2, x_prev, t, dt,
                                        tol=1e-9, maxiter=500, x0=None):
    """BE Stefan diphasic slab solve with both interface unknowns eliminated.

    The gamma rows of the _stef system are pure diagonal ties
    (``a2 T2g = g`` and ``a1 T1g - a2 T2g = g``), so T1g/T2g are known and
    the 4-block system decouples into two independent SPD bulk systems,
    solved together by one CG on the pair (block-diagonal operator).
    Returns ``((TW1, TG1, TW2, TG2), iters, relres)`` like the coupled
    solve."""
    ops1, Va1, Vb1, G1, C1, Cg1 = slice_spacetime(cap1)
    ops2, Va2, Vb2, G2, C2, Cg2 = slice_spacetime(cap2)
    p1p, _ = psi_weights("BE", Vb1, Va1)
    p2p, _ = psi_weights("BE", Vb2, Va2)
    a1, a2 = ic.scalar.alpha1, ic.scalar.alpha2
    Id1, Id2 = _eval_D(D1, C1), _eval_D(D2, C2)

    gg = _jump_value(ic.scalar.value, Cg1, Vb1, t)
    TG2 = gg / a2
    TG1 = (gg + a2 * TG2) / a1

    TW1p, _, TW2p, _ = x_prev
    ap1, b1, dg1, act1 = _reduced_phase(ops1, Va1, Vb1, p1p, Id1, TG1, TW1p,
                                        f1, C1, border1, t, dt)
    ap2, b2, dg2, act2 = _reduced_phase(ops2, Va2, Vb2, p2p, Id2, TG2, TW2p,
                                        f2, C2, border2, t, dt)

    def apply(x):
        return (ap1(x[0]), ap2(x[1]))

    # dead cells (Va = 0) keep the cold-start value, see the mono solver
    g1 = torch.where(Va1 > 0, x0[0], TW1p) if x0 is not None else TW1p
    g2 = torch.where(Va2 > 0, x0[2], TW2p) if x0 is not None else TW2p
    xinit = (torch.where(act1, g1, 0.0), torch.where(act2, g2, 0.0))
    (TW1, TW2), iters, relres = pcg(apply, (b1, b2), xinit,
                                    Minv=(1.0 / dg1, 1.0 / dg2),
                                    tol=tol, maxiter=maxiter)
    return (TW1, TG1, TW2, TG2), iters, relres


def solve_moving_diph_stef_step(cap1, cap2, D1, D2, f1, f2, ic, border1,
                                border2, x_prev, t, dt, scheme,
                                tol=1e-9, maxiter=800, method="auto",
                                x0=None):
    """Jacobi-preconditioned Krylov solve of the Stefan diphasic slab system
    with warm start; returns ``(x, iters, relres)``.  The gamma rows are
    pure diagonals (a1/a2), so the Jacobi preconditioner resolves them in
    one application.  ``method="auto"`` eliminates the gamma unknowns
    analytically under BE (``solve_moving_diph_stef_step_reduced``)."""
    if method == "auto":
        method = "reduced" if scheme == "BE" else "pbicgstab"
    if method == "reduced":
        return solve_moving_diph_stef_step_reduced(
            cap1, cap2, D1, D2, f1, f2, ic, border1, border2, x_prev, t, dt,
            tol=tol, maxiter=maxiter, x0=x0,
        )
    apply_fn, rhs_fn = build_moving_diph_stef_system(
        cap1, cap2, D1, D2, f1, f2, ic, border1, border2, t, dt, scheme
    )
    d1 = _phase_bulk_diag(cap1, D1, border1, scheme)[0]
    d3 = _phase_bulk_diag(cap2, D2, border2, scheme)[0]
    a1, a2 = ic.scalar.alpha1, ic.scalar.alpha2
    d2 = a1 * torch.ones_like(d1)
    d4 = a2 * torch.ones_like(d3)
    Minv = tuple(1.0 / d for d in (d1, d2, d3, d4))
    b = rhs_fn(x_prev)
    if method == "direct":
        return _direct_solve(apply_fn, b), 0, 0.0
    solver = pcg if method == "pcg" else pbicgstab
    return solver(apply_fn, b, x_prev if x0 is None else x0, Minv=Minv,
                  tol=tol, maxiter=maxiter)


class MovingDiffusionUnsteadyMono(_MovingMonoBase):
    """Prescribed-motion mono diffusion (MovingDiffusionUnsteadyMono,
    diffusion.jl:15-268)."""

    def solve(self, body_st, t_start, t_end, method="auto", p=6, s=1,
              keep_states=False, tol=1e-10, maxiter=2000):
        dt = self.dt
        K = _num_slabs(dt, t_start, t_end)
        D, f = self.phase.diffusion, self.phase.source
        bc_i, border, mesh, scheme = (self.bc_i, self.border, self.mesh,
                                      self.scheme)
        like = _like(self.u0)

        def step(x, t):
            cap_st = compute_capacity_spacetime(body_st, mesh, t, t + dt,
                                                p=p, s=s, **like)
            return solve_moving_mono_step(
                cap_st, D, f, bc_i, border, x, t, dt, scheme,
                tol=tol, maxiter=maxiter, method=method,
            )

        self.x, hist, self.krylov_iters, self.krylov_relres = _march_slabs(
            step, self.u0, t_start, dt, K, keep_states)
        self.states = hist if keep_states else [self.x]
        # final capacity for convergence checks
        tK = t_start + K * dt
        self.capacity_final = compute_capacity_spacetime(
            body_st, mesh, tK, tK + dt, p=p, s=s, **like
        )
        return self.x


class MovingDiffusionUnsteadyDiph(_MovingDiphBase):
    """Prescribed-motion diphasic diffusion (diffusion.jl:272-501)."""

    def solve(self, body_st, body_c_st, t_start, t_end, method="pgmres",
              p=6, s=1, keep_states=False, tol=1e-10, maxiter=3000,
              restart=150):
        dt = self.dt
        K = _num_slabs(dt, t_start, t_end)
        scheme, ic = self.scheme, self.ic
        D1, f1 = self.phase1.diffusion, self.phase1.source
        D2, f2 = self.phase2.diffusion, self.phase2.source

        def step(x, t):
            cap1, cap2, b1m, b2m = self._slab(body_st, body_c_st, t, p, s)
            return solve_moving_diph_step(
                cap1, cap2, D1, D2, f1, f2, ic, b1m, b2m, x, t, dt, scheme,
                tol=tol, maxiter=maxiter, method=method, restart=restart,
            )

        self.x, _, self.krylov_iters, self.krylov_relres = _march_slabs(
            step, self.u0, t_start, dt, K)
        self.states = [self.x]
        return self.x


def build_moving_advdiff_diph_system(cap1, cap2, D1, D2, f1, f2, ic,
                                     border1, border2, u_bulk, u_gamma,
                                     t, dt, scheme, clamp_rel=1e-4):
    """(apply, rhs) for prescribed-motion diphasic advection-diffusion
    (A/b_diph_unstead_advdiff_moving, advectiondiffusion.jl:266-508): the
    diphasic moving-diffusion blocks with flux-form convection added to the
    two bulk rows, weighted by the fresh/dead psi_conv factors (the same
    velocity field drives both phases, as in the reference's time loop)."""
    ops1, Va1, Vb1, G1, C1, Cg1 = slice_spacetime(cap1, clamp_rel)
    ops2, Va2, Vb2, G2, C2, Cg2 = slice_spacetime(cap2, clamp_rel)
    p1p, p1m = psi_weights(scheme, Vb1, Va1)
    p2p, p2m = psi_weights(scheme, Vb2, Va2)
    c1p, c1m = psi_conv_weights(Vb1, Va1)
    c2p, c2m = psi_conv_weights(Vb2, Va2)
    a1, a2 = ic.scalar.alpha1, ic.scalar.alpha2
    be1, be2 = ic.flux.beta1, ic.flux.beta2
    Id1, Id2 = _eval_D(D1, C1), _eval_D(D2, C2)
    dV1, dV2 = Va1 - Vb1, Va2 - Vb2
    act1 = (Va1 != 0) | (Vb1 != 0) | _col_G_nz(ops1)
    act2 = (Va2 != 0) | (Vb2 != 0) | _col_G_nz(ops2)
    # identity rows for TG DOFs away from the interface (see
    # build_moving_diph_system; zero r2/r4 rows make the system singular)
    cut = _diph_cut(ops1, ops2, G1, G2, dV1, dV2)
    conv1 = _spatial_conv(ops1, u_bulk, u_gamma)
    conv2 = _spatial_conv(ops2, u_bulk, u_gamma)

    def apply(x):
        TW1, TG1, TW2, TG2 = x
        TG1a = torch.where(cut, TG1, 0.0)
        TG2a = torch.where(cut, TG2, 0.0)
        q1 = ops1.flux(p1p * TW1, p1p * TG1a)
        q2 = ops2.flux(p2p * TW2, p2p * TG2a)
        r1 = (
            Va1 * TW1 + Id1 * ops1.GT(q1) - dV1 * TG1a
            - (conv1.conv(c1p * TW1) + 0.5 * conv1.kconv(c1p * TW1))
            - 0.5 * conv1.kconv(c1p * TG1a)
        )
        r3 = (
            Va2 * TW2 + Id2 * ops2.GT(q2) - dV2 * TG2a
            - (conv2.conv(c2p * TW2) + 0.5 * conv2.kconv(c2p * TW2))
            - 0.5 * conv2.kconv(c2p * TG2a)
        )
        r2 = torch.where(cut, a1 * TG1a - a2 * TG2a, TG1)
        r4 = (
            be1 * ops1.HT(q1) - dV1 * TG1a
            + be2 * ops2.HT(q2) - dV2 * TG2a
        )
        r4 = torch.where(cut, r4, TG2)
        r1 = torch.where(act1, r1, TW1)
        r3 = torch.where(act2, r3, TW2)
        if border1 is not None:
            r1 = border1.matvec(r1, TW1)
        if border2 is not None:
            r3 = border2.matvec(r3, TW2)
        return (r1, r2, r3, r4)

    def rhs(x_prev):
        TW1, TG1, TW2, TG2 = x_prev
        gg = _jump_value(ic.scalar.value, Cg1, Vb1, t)
        hh = _jump_value(ic.flux.value, Cg2, Vb2, t)

        def bulk(ops, Vb, Id, pm, cm, conv, TW, TG, f, C):
            fn1 = _eval_f(f, C, t + dt)
            if scheme == "CN":
                fn = _eval_f(f, C, t)
                qm = ops.flux(pm * TW, torch.zeros_like(TG))
                hterm = ops.flux(torch.zeros_like(TW), TG)
                return (
                    Vb * TW - Id * ops.GT(qm) - 0.5 * Id * ops.GT(hterm)
                    + 0.5 * ops.V * (fn + fn1)
                    - 0.5 * conv.kconv(pm * TW) - 0.5 * conv.kconv(TG)
                    - conv.conv(TW)
                )
            return (
                Vb * TW + ops.V * fn1
                - 0.5 * conv.kconv(cm * TW) - 0.5 * conv.kconv(TG)
                - conv.conv(cm * TW)
            )

        b1 = bulk(ops1, Vb1, Id1, p1m, c1m, conv1, TW1,
                  torch.where(cut, TG1, 0.0), f1, C1)
        b3 = bulk(ops2, Vb2, Id2, p2m, c2m, conv2, TW2,
                  torch.where(cut, TG2, 0.0), f2, C2)
        b2 = torch.where(cut, gg, 0.0)
        b4 = torch.where(cut, G2 * hh, 0.0)
        if border1 is not None:
            b1 = border1.rhs(b1, t)
        if border2 is not None:
            b3 = border2.rhs(b3, t)
        return (b1, b2, b3, b4)

    return apply, rhs


class MovingAdvDiffusionUnsteadyDiph(_MovingDiphBase):
    """Prescribed-motion diphasic advection-diffusion
    (solve_MovingAdvDiffusionUnsteadyDiph!, advectiondiffusion.jl:510-553)."""

    def solve(self, body_st, body_c_st, t_start, t_end, u_bulk, u_gamma,
              method="pgmres", p=6, s=1, tol=1e-10, maxiter=3000,
              restart=150):
        dt = self.dt
        K = _num_slabs(dt, t_start, t_end)
        scheme, ic = self.scheme, self.ic
        D1, f1 = self.phase1.diffusion, self.phase1.source
        D2, f2 = self.phase2.diffusion, self.phase2.source

        def step(x, t):
            cap1, cap2, b1m, b2m = self._slab(body_st, body_c_st, t, p, s)
            apply_fn, rhs_fn = build_moving_advdiff_diph_system(
                cap1, cap2, D1, D2, f1, f2, ic, b1m, b2m,
                u_bulk, u_gamma, t, dt, scheme
            )
            return _equilibrated_step(
                apply_fn, rhs_fn(x), x, method,
                lambda: moving_diph_diag(cap1, cap2, D1, D2, ic, b1m, b2m,
                                         scheme),
                tol, maxiter, restart)

        self.x, _, self.krylov_iters, self.krylov_relres = _march_slabs(
            step, self.u0, t_start, dt, K)
        self.states = [self.x]
        return self.x

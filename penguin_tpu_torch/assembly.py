"""System assembly for scalar cut-cell transport problems (torch).

Counterpart of ``penguin_tpu.assembly``: what the reference does with
assembled sparse block matrices is expressed as closures over the
matrix-free operators plus masking:

- zero-row/column elimination  -> identity-masked DOFs (activity masks)
- border-condition row surgery -> masked row replacement in the matvec/rhs

The apply/rhs closures are pure and out of place, so ``torch.func.vmap``
can materialize them (``linsolve.materialize_dense``).
"""

from __future__ import annotations

import numpy as np
import torch

from .boundary import (
    Dirichlet,
    Neumann,
    Periodic,
    Robin,
    GibbsThomson,
    eval_condition_value,
)
from ._device import resolve_device
from .operators import _shift_p, _zlast, sm

__all__ = [
    "classify_border_cells",
    "border_positions",
    "border_info",
    "BorderBC",
    "build_I_bc",
    "centroid_coords",
    "coefficient_diag",
    "source_vector",
    "gamma_value_vector",
    "scalar_masks",
    "mono_diag_fn",
    "mono_apply_fn",
    "mono_rhs_fn",
    "diph_masks",
    "diph_apply_fn",
    "diph_rhs_fn",
]


# ---------------------------------------------------------------------------
# border classification (parity with reference src/solver.jl:379-409)
# ---------------------------------------------------------------------------

_KEY_TABLE = {
    # key -> (axis, side) ; side 0 = low end, 1 = high end
    "left": (1, 0),
    "right": (1, 1),
    "bottom": (0, 0),
    "top": (0, 1),
    "backward": (2, 0),
    "forward": (2, 1),
}


def classify_border_cells(mesh):
    """Assign each border cell exactly one key using the reference's priority
    order (y-axis left/right first in 2D/3D, then x-axis bottom/top, then
    z-axis backward/forward).  Returns dict key -> numpy bool array
    (np_shape)."""
    N = mesh.ndim
    n = mesh.n
    shape = mesh.np_shape
    idx = np.indices(n)
    label = np.zeros(n, dtype="U8")
    order = []
    if N >= 2:
        order += [("left", idx[1] == 0), ("right", idx[1] == n[1] - 1)]
    order += [("bottom", idx[0] == 0), ("top", idx[0] == n[0] - 1)]
    if N >= 3:
        order += [("backward", idx[2] == 0), ("forward", idx[2] == n[2] - 1)]
    for key, mask in order:
        sel = mask & (label == "")
        label[sel] = key
    masks = {}
    for key in set(label.ravel()) - {""}:
        m = np.zeros(shape, dtype=bool)
        m[tuple(slice(0, n[d]) for d in range(N))] = label == key
        masks[key] = m
    return masks


def border_positions(mesh, dtype=torch.float64, device=None):
    """Per-cell 'positions' used to evaluate border values: the reference
    stores ``mesh.centers`` coordinates for each border cell
    (src/mesh.jl:52-71).  Padded slots get zeros.  ``device`` defaults to
    the CUDA device."""
    device = resolve_device(device)
    N = mesh.ndim
    shape = mesh.np_shape
    coords = []
    for d in range(N):
        c = np.zeros(shape[d])
        c[: mesh.n[d]] = np.asarray(mesh.centers[d])
        shp = [1] * N
        shp[d] = shape[d]
        coords.append(torch.as_tensor(c, dtype=dtype, device=device)
                      .reshape(shp).expand(shape))
    return coords


class BorderBC:
    """Precompiled border-condition surgery for one scalar field.

    ``matvec(y, x)``: overwrite rows of ``y = A x`` at border cells.
    ``rhs(b, t)``   : overwrite rhs entries at border cells.

    Masks and positions live on ``capacity``'s device and in its dtype when
    a capacity is given, else on ``device`` (by default the CUDA device) in
    ``dtype``.
    """

    def __init__(self, mesh, bc_b, phase_mask=None, capacity=None,
                 dtype=torch.float64, device=None):
        self.mesh = mesh
        self.items = []
        if capacity is not None:
            dtype, device = capacity.V.dtype, capacity.V.device
        device = resolve_device(device)
        cell_masks = classify_border_cells(mesh)
        pos = border_positions(mesh, dtype, device)
        if capacity is not None:
            # evaluate border values at the WET-CELL CENTROID instead of the
            # cell center (see penguin_tpu.assembly.BorderBC)
            wet = capacity.V > 0
            pos = [torch.where(wet, capacity.C_om[..., d], pos[d])
                   for d in range(mesh.ndim)]
        for key, cond in bc_b.borders:
            if key not in cell_masks:
                continue
            axis, side = _KEY_TABLE[key]
            if axis >= mesh.ndim:
                continue
            mask = torch.as_tensor(cell_masks[key], device=device)
            if phase_mask is not None:
                mask = mask & phase_mask
            self.items.append((key, cond, axis, side, mask))
        self.pos = pos

    def matvec(self, y, x):
        for key, cond, axis, side, mask in self.items:
            if isinstance(cond, (Dirichlet, GibbsThomson)):
                y = torch.where(mask, x, y)
            elif isinstance(cond, Periodic):
                # tie value to the opposite *real* cell along the axis
                n_real = self.mesh.n[axis]
                partner = 0 if side == 1 else n_real - 1
                y = torch.where(mask, x - x.narrow(axis, partner, 1), y)
            elif isinstance(cond, Neumann):
                # one-sided difference toward the interior
                h = self.mesh.h[axis]
                inward = (_shift_p(x, axis) if side == 0
                          else torch.roll(x, 1, axis))
                y = torch.where(mask, (x - inward) / h, y)
            else:
                y = torch.where(mask, x, y)
        return y

    def rhs(self, b, t=None):
        for key, cond, axis, side, mask in self.items:
            if isinstance(cond, Periodic):
                b = torch.where(mask, 0.0, b)
            else:
                val = eval_condition_value(getattr(cond, "value", 0.0),
                                           self.pos, t)
                b = torch.where(mask, val, b)
        return b


def border_info(mesh, bc_b, phase_mask=None, capacity=None,
                dtype=torch.float64, device=None):
    return BorderBC(mesh, bc_b, phase_mask, capacity, dtype, device)


# ---------------------------------------------------------------------------
# interface-condition coefficient builders
# ---------------------------------------------------------------------------

def build_I_bc(bc_i):
    """(ia, ib) diagonal coefficients of the interface closure row
    (reference build_I_bc, src/solver.jl:203-223)."""
    if isinstance(bc_i, (Dirichlet, GibbsThomson)):
        return 1.0, 0.0
    if isinstance(bc_i, Neumann):
        return 0.0, 1.0
    if isinstance(bc_i, Robin):
        return bc_i.alpha, bc_i.beta
    raise TypeError(f"unsupported interface condition {type(bc_i)}")


def centroid_coords(capacity, which="omega"):
    C = capacity.C_om if which == "omega" else capacity.C_ga
    return [C[..., d] for d in range(C.shape[-1])]


def coefficient_diag(coeff, capacity):
    """Diffusion coefficient diagonal Id = D(C_om) (reference build_I_D)."""
    if callable(coeff):
        return eval_condition_value(coeff, centroid_coords(capacity, "omega"))
    return torch.full_like(capacity.V, coeff)


def source_vector(f, capacity, t=None):
    """Source sampled at cell centroids (reference build_source)."""
    return eval_condition_value(f, centroid_coords(capacity, "omega"), t)


def gamma_value_vector(bc_i, capacity, t=None):
    """Interface value g_gamma sampled at interface centroids
    (reference build_g_g, src/solver.jl:293-329)."""
    if isinstance(bc_i, GibbsThomson):
        g = torch.full_like(capacity.V, bc_i.Tm)
        if bc_i.v_gamma is not None:
            g = g - bc_i.eps_v * bc_i.v_gamma
        return g
    return eval_condition_value(bc_i.value, centroid_coords(capacity, "gamma"), t)


# ---------------------------------------------------------------------------
# activity masks (zero row/col elimination, reference src/solver.jl:59-78)
# ---------------------------------------------------------------------------

def _col_G_nz(ops):
    out = None
    for Bd in ops.B:
        nz = Bd != 0.0
        out = nz if out is None else (out | nz)
    return out


def _col_H_nz(ops):
    """H column j is nonzero iff for some axis d:
    ``A_d[j] != B_d[j]`` (row j, valid for j < m) or
    ``A_d[j+1] != B_d[j]`` (row j+1, valid for j < m)."""
    out = None
    for d in range(len(ops.A)):
        Ad, Bd = ops.A[d], ops.B[d]
        nz = _zlast((Ad != Bd) | (_shift_p(Ad, d) != Bd), d)
        out = nz if out is None else (out | nz)
    return out


def _conv_nz(ops):
    """Row/col activity contributed by the convection operator C_d =
    Dp·diag(Sm(A_d u_d))·Sm: nonzero where the face-velocity-capacity
    product is nonzero at face j or j+1."""
    out = None
    for d in range(len(ops.A)):
        au = sm(ops.A[d] * ops.u_face[d], d, ops._per(d))
        nz = _zlast((au != 0) | (_shift_p(au, d) != 0), d)
        out = nz if out is None else (out | nz)
    return out


def scalar_masks(ops, Gamma, ia, ib, steady, conv=None):
    """(bulk_active, iface_active) for one phase's 2-block scalar system."""
    colG = _col_G_nz(ops)
    colH = _col_H_nz(ops)
    bulk = colG if steady else (ops.V != 0.0) | colG
    if conv is not None:
        bulk = bulk | _conv_nz(conv)
    g_nz = Gamma != 0.0
    # ia, ib: Python scalars (a bool here) or tensors (a bool tensor)
    iface_row = (colH & (ib != 0.0)) | (g_nz & (ia != 0.0))
    iface_col = colH | (g_nz & (ia != 0.0))
    return bulk, iface_row & iface_col


# ---------------------------------------------------------------------------
# monophasic scalar diffusion operator / rhs
# ---------------------------------------------------------------------------

def _theta(scheme):
    return 0.5 if scheme == "CN" else 1.0


def _diag_GtWG(ops):
    """diag(Gᵀ Wꜝ G): per cell j, Σ_d B_d[j]² (Wꜝ_d[j] + Wꜝ_d[j+1]),
    zero at the padding slot (no Dm row there)."""
    out = 0.0
    for d in range(len(ops.B)):
        t = ops.B[d] ** 2 * (ops.Wdag[d] + _shift_p(ops.Wdag[d], d))
        out = out + _zlast(t, d)
    return out


def _diag_HtWH(ops):
    out = 0.0
    for d in range(len(ops.A)):
        h0 = ops.A[d] - ops.B[d]
        h1 = _shift_p(ops.A[d], d) - ops.B[d]
        t = h0 ** 2 * ops.Wdag[d] + h1 ** 2 * _shift_p(ops.Wdag[d], d)
        out = out + _zlast(t, d)
    return out


def mono_diag_fn(ops, Id, Gamma, ia, ib, dt=None, scheme="BE", border=None,
                 masks=None):
    """Diagonal of the mono system (for Jacobi preconditioning)."""
    steady = dt is None
    th = _theta(scheme)
    dG = _diag_GtWG(ops)
    dH = _diag_HtWH(ops)
    if steady:
        bulk = Id * dG
        ifc = ib * dH + ia * Gamma
    elif scheme == "CN":
        bulk = ops.V + dt * th * Id * dG
        ifc = dt * th * (ib * dH + ia * Gamma)
    else:
        bulk = ops.V + dt * Id * dG
        ifc = ib * dH + ia * Gamma
    if masks is not None:
        bulk = torch.where(masks[0], bulk, 1.0)
        ifc = torch.where(masks[1], ifc, 1.0)
    if border is not None:
        for key, cond, axis, side, mask in border.items:
            if isinstance(cond, (Dirichlet, GibbsThomson, Periodic)):
                bulk = torch.where(mask, 1.0, bulk)
            elif isinstance(cond, Neumann):
                bulk = torch.where(mask, 1.0 / border.mesh.h[axis], bulk)
    # guard against exact zeros on kept-but-degenerate rows
    bulk = torch.where(bulk == 0.0, 1.0, bulk)
    ifc = torch.where(ifc == 0.0, 1.0, ifc)
    return (bulk, ifc)


def _conv_terms(conv, TW, TG):
    """(ΣC TW + ½ΣK TW, ½ΣK TG): the bulk-bulk and bulk-interface parts of
    the flux-form convection."""
    return conv.conv(TW) + 0.5 * conv.kconv(TW), 0.5 * conv.kconv(TG)


def mono_apply_fn(ops, Id, Gamma, ia, ib, dt=None, scheme="BE", border=None,
                  masks=None, conv=None):
    """Matrix-free A(x) for the mono scalar system
    (A_mono_stead_diff / A_mono_unstead_diff, src/solver/diffusion.jl:30-43,
    212-241; advection terms per A_mono_*_advdiff,
    src/solver/advectiondiffusion.jl:28-44,180-213), including
    identity-masked inactive DOFs and border surgery."""
    steady = dt is None
    th = _theta(scheme)

    def apply(x):
        TW, TG = x
        q = ops.flux(TW, TG)
        gt = Id * ops.GT(q)
        ht = ops.HT(q)
        if conv is not None:
            cw, cg = _conv_terms(conv, TW, TG)
            cv = cw + cg
        else:
            cv = 0.0
        if steady:
            bulk = gt + cv
            ifc = ib * ht + ia * Gamma * TG
        elif scheme == "CN":
            bulk = ops.V * TW + dt * th * (gt + cv)
            ifc = dt * th * (ib * ht + ia * Gamma * TG)
        else:
            bulk = ops.V * TW + dt * (gt + cv)
            ifc = ib * ht + ia * Gamma * TG
        if masks is not None:
            bulk = torch.where(masks[0], bulk, TW)
            ifc = torch.where(masks[1], ifc, TG)
        if border is not None:
            bulk = border.matvec(bulk, TW)
        return (bulk, ifc)

    return apply


def _later(t, dt):
    return t + dt if t is not None else None


def mono_rhs_fn(ops, Id, Gamma, ia, ib, capacity, f, bc_i, dt=None,
                scheme="BE", border=None, masks=None, conv=None):
    """b(x_prev, t) for the mono scalar system (b_mono_*_diff /
    b_mono_unstead_advdiff)."""
    steady = dt is None

    def rhs(x_prev=None, t=None):
        if steady:
            fo = source_vector(f, capacity, None)
            gg = gamma_value_vector(bc_i, capacity, None)
            b1 = ops.V * fo
            b2 = Gamma * gg
        else:
            TW, TG = x_prev
            if scheme == "CN":
                fn = source_vector(f, capacity, t)
                fn1 = source_vector(f, capacity, t + dt)
                gn = gamma_value_vector(bc_i, capacity, t)
                gn1 = gamma_value_vector(bc_i, capacity, t + dt)
                q = ops.flux(TW, TG)
                if conv is not None:
                    cw, cg = _conv_terms(conv, TW, TG)
                    cv = cw + cg
                else:
                    cv = 0.0
                b1 = (
                    ops.V * TW
                    - 0.5 * dt * (Id * ops.GT(q) + cv)
                    + 0.5 * dt * ops.V * (fn + fn1)
                )
                b2 = (
                    0.5 * dt * Gamma * (gn + gn1)
                    - 0.5 * dt * ib * ops.HT(q)
                    - 0.5 * dt * ia * Gamma * TG
                )
            else:
                fn1 = source_vector(f, capacity, _later(t, dt))
                gn1 = gamma_value_vector(bc_i, capacity, _later(t, dt))
                b1 = ops.V * TW + dt * ops.V * fn1
                b2 = Gamma * gn1
        if masks is not None:
            b1 = torch.where(masks[0], b1, 0.0)
            b2 = torch.where(masks[1], b2, 0.0)
        if border is not None:
            b1 = border.rhs(b1, t)
        return (b1, b2)

    return rhs


# ---------------------------------------------------------------------------
# diphasic scalar diffusion operator / rhs
# ---------------------------------------------------------------------------

def diph_masks(ops1, ops2, G1, G2, a1, a2, b1c, b2c, steady, conv1=None,
               conv2=None):
    colG1, colH1 = _col_G_nz(ops1), _col_H_nz(ops1)
    colG2, colH2 = _col_G_nz(ops2), _col_H_nz(ops2)
    if steady:
        bulk1, bulk2 = colG1, colG2
    else:
        bulk1 = (ops1.V != 0.0) | colG1
        bulk2 = (ops2.V != 0.0) | colG2
    if conv1 is not None:
        bulk1 = bulk1 | _conv_nz(conv1)
    if conv2 is not None:
        bulk2 = bulk2 | _conv_nz(conv2)
    a1_nz, a2_nz = a1 != 0.0, a2 != 0.0
    ones = torch.ones_like(G1, dtype=torch.bool)
    jump_row = ones if (a1_nz or a2_nz) else ~ones
    tg1_col = colH1 | (ones & a1_nz)
    tg2_col = colH2 | (ones & a2_nz)
    flux_row = (colH1 & (b1c != 0.0)) | (colH2 & (b2c != 0.0))
    return bulk1, jump_row & tg1_col, bulk2, flux_row & tg2_col


def diph_apply_fn(ops1, ops2, Id1, Id2, ic, dt=None, scheme="BE",
                  border1=None, border2=None, masks=None, conv1=None,
                  conv2=None):
    """4-block diphasic operator (A_diph_*_diff,
    src/solver/diffusion.jl:104-144, 334-389; advective terms per
    A_diph_*_advdiff, src/solver/advectiondiffusion.jl:97-124,313-354).
    Unknowns (TW1, TG1, TW2, TG2); rows: phase-1 bulk, scalar-jump,
    phase-2 bulk, flux-jump."""
    steady = dt is None
    a1, a2 = ic.scalar.alpha1, ic.scalar.alpha2
    be1, be2 = ic.flux.beta1, ic.flux.beta2
    th = _theta(scheme)

    def cvb(conv, TW, TG):
        return (0.0, 0.0) if conv is None else _conv_terms(conv, TW, TG)

    def apply(x):
        TW1, TG1, TW2, TG2 = x
        q1 = ops1.flux(TW1, TG1)
        q2 = ops2.flux(TW2, TG2)
        gt1 = Id1 * ops1.GT(q1)
        gt2 = Id2 * ops2.GT(q2)
        cw1, cg1 = cvb(conv1, TW1, TG1)
        cw2, cg2 = cvb(conv2, TW2, TG2)
        if steady:
            r1 = gt1 + cw1 + cg1
            r3 = gt2 + cw2 + cg2
        else:
            c = dt * th
            r1 = ops1.V * TW1 + c * (gt1 + cw1 + cg1)
            r3 = ops2.V * TW2 + c * (gt2 + cw2 + cg2)
        r2 = a1 * TG1 - a2 * TG2
        r4 = be1 * ops1.HT(q1) + be2 * ops2.HT(q2)
        if masks is not None:
            r1 = torch.where(masks[0], r1, TW1)
            r2 = torch.where(masks[1], r2, TG1)
            r3 = torch.where(masks[2], r3, TW2)
            r4 = torch.where(masks[3], r4, TG2)
        if border1 is not None:
            r1 = border1.matvec(r1, TW1)
        if border2 is not None:
            r3 = border2.matvec(r3, TW2)
        return (r1, r2, r3, r4)

    return apply


def _interface_value(value, capacity, t):
    """A jump value: a callable sampled at the interface centroids, or a
    constant broadcast over the DOF grid."""
    if callable(value):
        return eval_condition_value(value, centroid_coords(capacity, "gamma"),
                                    t)
    return value * torch.ones_like(capacity.V)


def diph_rhs_fn(ops1, ops2, Id1, Id2, cap1, cap2, f1, f2, ic, dt=None,
                scheme="BE", border1=None, border2=None, masks=None,
                conv1=None, conv2=None, advdiff_cn=False):
    """``advdiff_cn``: the reference's advdiff CN rhs subtracts only the
    convective part of the old state (src/solver/advectiondiffusion.jl:
    371-375), unlike the diffusion CN rhs which subtracts diffusion."""
    steady = dt is None
    G2 = cap2.Gamma

    def rhs(x_prev=None, t=None):
        gg = _interface_value(ic.scalar.value, cap1, t)
        hh = _interface_value(ic.flux.value, cap2, t)
        if steady:
            b1 = ops1.V * source_vector(f1, cap1, None)
            b3 = ops2.V * source_vector(f2, cap2, None)
        else:
            TW1, TG1, TW2, TG2 = x_prev
            if scheme == "CN":
                f1n = source_vector(f1, cap1, t)
                f1n1 = source_vector(f1, cap1, t + dt)
                f2n = source_vector(f2, cap2, t)
                f2n1 = source_vector(f2, cap2, t + dt)
                if advdiff_cn:
                    cw1, cg1 = ((0.0, 0.0) if conv1 is None
                                else _conv_terms(conv1, TW1, TG1))
                    cw2, cg2 = ((0.0, 0.0) if conv2 is None
                                else _conv_terms(conv2, TW2, TG2))
                    b1 = (ops1.V * TW1 - 0.5 * dt * (cw1 + cg1)
                          + 0.5 * dt * ops1.V * (f1n + f1n1))
                    b3 = (ops2.V * TW2 - 0.5 * dt * (cw2 + cg2)
                          + 0.5 * dt * ops2.V * (f2n + f2n1))
                else:
                    q1 = ops1.flux(TW1, TG1)
                    q2 = ops2.flux(TW2, TG2)
                    b1 = (ops1.V * TW1 - 0.5 * dt * Id1 * ops1.GT(q1)
                          + 0.5 * dt * ops1.V * (f1n + f1n1))
                    b3 = (ops2.V * TW2 - 0.5 * dt * Id2 * ops2.GT(q2)
                          + 0.5 * dt * ops2.V * (f2n + f2n1))
            else:
                f1n1 = source_vector(f1, cap1, _later(t, dt))
                f2n1 = source_vector(f2, cap2, _later(t, dt))
                b1 = ops1.V * TW1 + dt * ops1.V * f1n1
                b3 = ops2.V * TW2 + dt * ops2.V * f2n1
        b2 = gg
        b4 = G2 * hh
        if masks is not None:
            b1 = torch.where(masks[0], b1, 0.0)
            b2 = torch.where(masks[1], b2, 0.0)
            b3 = torch.where(masks[2], b3, 0.0)
            b4 = torch.where(masks[3], b4, 0.0)
        if border1 is not None:
            b1 = border1.rhs(b1, t)
        if border2 is not None:
            b3 = border2.rhs(b3, t)
        return (b1, b2, b3, b4)

    return rhs

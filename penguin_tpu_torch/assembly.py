"""Border classification and coefficient builders for scalar cut-cell
problems (torch).

Counterpart of ``penguin_tpu.assembly`` up to the activity masks
(``assembly.py:44-231``): the helpers FastHeatBE needs.  The general masked
mono/diph systems (``scalar_masks``, ``mono_apply_fn`` ...) are ROADMAP
Queue 1 item 4.
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
from .operators import _shift_p

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


def border_positions(mesh, dtype=torch.float64, device="cpu"):
    """Per-cell 'positions' used to evaluate border values: the reference
    stores ``mesh.centers`` coordinates for each border cell
    (src/mesh.jl:52-71).  Padded slots get zeros."""
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
    a capacity is given, else on ``device`` in ``dtype``.
    """

    def __init__(self, mesh, bc_b, phase_mask=None, capacity=None,
                 dtype=torch.float64, device="cpu"):
        self.mesh = mesh
        self.items = []
        if capacity is not None:
            dtype, device = capacity.V.dtype, capacity.V.device
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
                dtype=torch.float64, device="cpu"):
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

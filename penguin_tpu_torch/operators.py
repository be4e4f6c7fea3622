"""Matrix-free discrete cut-cell operators (torch).

Counterpart of ``penguin_tpu.operators``.  Every operator is an
elementwise + shift pipeline over dense padded N-D tensors, out of place.

Exact stencil semantics (including the quirky padding-row behaviour of the
reference matrices, which the assembled systems rely on), with ``m = np-1``
the last index along the axis:

- ``Dm(x)``  : ``y[0]=x[0]``, ``y[k]=x[k]-x[k-1]``, ``y[m]=-x[m-1]``
- ``Dp(x)``  : ``y[k]=x[k+1]-x[k]`` for ``k<m``, ``y[m]=0``
- ``Sm(x)``  : ``y[0]=x[0]/2``, ``y[k]=(x[k]+x[k-1])/2``, ``y[m]=x[m-1]/2``
- ``Sp(x)``  : ``y[k]=(x[k]+x[k+1])/2`` for ``k<m``, ``y[m]=0``

Transposes are exact adjoints.  Periodic variants reproduce the reference
wrap entries (0-based: columns ``m-1`` and ``0`` in rows ``0`` and ``m``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

__all__ = [
    "dm", "dm_t", "dp", "dp_t", "sm", "sm_t", "sp", "sp_t",
    "DiffusionOps", "ConvectionOps", "make_diffusion_ops",
    "make_convection_ops", "make_wdag", "grad_op", "div_op",
    "sw_apply", "sw_applyT",
]


# ---------------------------------------------------------------------------
# axis helpers
# ---------------------------------------------------------------------------

def _pad_axis(x, axis, before, after):
    axis = axis % x.ndim
    flat = [0, 0] * (x.ndim - 1 - axis) + [before, after]
    return F.pad(x, flat)


def _shift_m(x, axis):
    """y[k] = x[k-1], y[0] = 0."""
    return _pad_axis(x, axis, 1, 0).narrow(axis, 0, x.shape[axis])


def _shift_p(x, axis):
    """y[k] = x[k+1], y[m] = 0."""
    return _pad_axis(x, axis, 0, 1).narrow(axis, 1, x.shape[axis])


# _zlast and _addat pad a slice instead of indexing: an index tensor made
# on the card is a copy from the host that waits for the device, once per
# call, and these run inside every operator application.

def _zlast(x, axis):
    """Zero the last slice along ``axis``."""
    return _pad_axis(x.narrow(axis, 0, x.shape[axis] - 1), axis, 0, 1)


def _take(x, axis, i):
    return x.narrow(axis, i, 1)


def _addat(x, axis, i, val):
    """``x`` with ``val`` (one slice) added at index ``i`` along ``axis``."""
    return x + _pad_axis(val, axis, i, x.shape[axis] - 1 - i)


# ---------------------------------------------------------------------------
# elementary stencils and adjoints
# ---------------------------------------------------------------------------

def dm(x, axis, periodic=False):
    y = _zlast(x, axis) - _shift_m(x, axis)
    if periodic:
        m = x.shape[axis] - 1
        y = _addat(y, axis, 0, -_take(x, axis, m - 1))
        y = _addat(y, axis, m, _take(x, axis, 0))
    return y


def dm_t(y, axis, periodic=False):
    out = _zlast(y - _shift_p(y, axis), axis)
    if periodic:
        m = y.shape[axis] - 1
        out = _addat(out, axis, m - 1, -_take(y, axis, 0))
        out = _addat(out, axis, 0, _take(y, axis, m))
    return out


def dp(x, axis, periodic=False):
    y = _zlast(_shift_p(x, axis) - x, axis)
    if periodic:
        m = x.shape[axis] - 1
        y = _addat(y, axis, 0, -_take(x, axis, m - 1))
        y = _addat(y, axis, m, _take(x, axis, 0))
    return y


def dp_t(y, axis, periodic=False):
    out = _shift_m(y, axis) - _zlast(y, axis)
    if periodic:
        m = y.shape[axis] - 1
        out = _addat(out, axis, m - 1, -_take(y, axis, 0))
        out = _addat(out, axis, 0, _take(y, axis, m))
    return out


def sm(x, axis, periodic=False):
    y = 0.5 * (_zlast(x, axis) + _shift_m(x, axis))
    if periodic:
        m = x.shape[axis] - 1
        y = _addat(y, axis, 0, 0.5 * _take(x, axis, m - 1))
        y = _addat(y, axis, m, 0.5 * _take(x, axis, 0))
    return y


def sm_t(y, axis, periodic=False):
    out = 0.5 * _zlast(y + _shift_p(y, axis), axis)
    if periodic:
        m = y.shape[axis] - 1
        out = _addat(out, axis, m - 1, 0.5 * _take(y, axis, 0))
        out = _addat(out, axis, 0, 0.5 * _take(y, axis, m))
    return out


def sp(x, axis, periodic=False):
    y = 0.5 * _zlast(x + _shift_p(x, axis), axis)
    if periodic:
        m = x.shape[axis] - 1
        y = _addat(y, axis, 0, 0.5 * _take(x, axis, m - 1))
        y = _addat(y, axis, m, 0.5 * _take(x, axis, 0))
    return y


def sp_t(y, axis, periodic=False):
    out = 0.5 * (_shift_m(y, axis) + _zlast(y, axis))
    if periodic:
        m = y.shape[axis] - 1
        out = _addat(out, axis, m - 1, 0.5 * _take(y, axis, 0))
        out = _addat(out, axis, 0, 0.5 * _take(y, axis, m))
    return out


# ---------------------------------------------------------------------------
# capacity-weighted operator bundle
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DiffusionOps:
    """Matrix-free equivalents of the reference ``DiffusionOps`` (G, H, Wꜝ, V).

    ``G_d x = Dm_d(B_d x)``; ``H_d x = A_d Dm_d(x) - Dm_d(B_d x)``;
    ``Wdag = 1/W`` where ``W != 0`` else 1 (src/operators.jl:144-152).

    ``Xw`` (optional, from ``make_diffusion_ops(..., cross_moment=True)``)
    is the wet-line cross-moment correction: ``B_d x`` samples the field at
    the cell centroid, but the exact Gauss identity for the staggered-strip
    flux needs the average of ``x`` over the *wet section* of the centroid
    plane, whose own centroid is offset transversally by up to h/2 in cut
    cells.  With ``Xw`` set, ``G_d x = Dm_d(P_d x)`` where ``P_d x = B_d x
    + sum_{e != d} B_d delta_{d,e} dx/dx_e`` (masked transverse differences
    of wet neighbours), which makes the flux exact for linear fields;
    ``GT`` uses the exact adjoint ``P_d^T`` so the viscous form stays
    symmetric.
    """

    A: tuple
    B: tuple
    V: torch.Tensor
    Wdag: tuple
    periodic: tuple = None
    Xw: tuple = None  # per d: (K0, ((wp_e, wm_e))_e) or None

    @property
    def ndim(self):
        return len(self.A)

    def _per(self, d):
        return False if self.periodic is None else self.periodic[d]

    def _P(self, d, x):
        """B_d x plus the wet-line transverse cross-moment correction."""
        y = self.B[d] * x
        if self.Xw is not None:
            y = y + sw_apply(self.Xw[d], x)
        return y

    def _PT(self, d, y):
        """Exact adjoint of ``_P(d, ·)``."""
        x = self.B[d] * y
        if self.Xw is not None:
            x = x + sw_applyT(self.Xw[d], y)
        return x

    # --- building blocks ---------------------------------------------------
    def G(self, x):
        return tuple(dm(self._P(d, x), d, self._per(d)) for d in range(self.ndim))

    def H(self, x):
        return tuple(
            self.A[d] * dm(x, d, self._per(d)) - dm(self.B[d] * x, d, self._per(d))
            for d in range(self.ndim)
        )

    def GT(self, q):
        out = 0.0
        for d in range(self.ndim):
            out = out + self._PT(d, dm_t(q[d], d, self._per(d)))
        return out

    def HT(self, q):
        out = 0.0
        for d in range(self.ndim):
            out = out + dm_t(self.A[d] * q[d], d, self._per(d)) - self.B[d] * dm_t(
                q[d], d, self._per(d)
            )
        return out

    def Wq(self, q):
        return tuple(self.Wdag[d] * q[d] for d in range(self.ndim))

    # --- composite operators ----------------------------------------------
    def flux(self, x_omega, x_gamma):
        """q = Wꜝ (G xω + H xγ): the discrete cut-cell gradient flux."""
        return tuple(
            self.Wdag[d]
            * (
                dm(self._P(d, x_omega), d, self._per(d))
                + self.A[d] * dm(x_gamma, d, self._per(d))
                - dm(self.B[d] * x_gamma, d, self._per(d))
            )
            for d in range(self.ndim)
        )

    def grad(self, x_omega, x_gamma):
        """Reference ``∇`` (src/operators.jl:20-23)."""
        return self.flux(x_omega, x_gamma)

    def div(self, q_omega, q_gamma):
        """Reference ``∇₋`` (src/operators.jl:30-34):
        ``-(Gᵀ+Hᵀ) qω + Hᵀ qγ``."""
        return -(self.GT(q_omega) + self.HT(q_omega)) + self.HT(q_gamma)


def make_wdag(W):
    return tuple(torch.where(w != 0.0, 1.0 / torch.where(w != 0.0, w, 1.0), 1.0)
                 for w in W)


class _LsqGradient:
    """Per-cell weighted least-squares gradient fit over all wet
    face-neighbours at their FULL centroid offsets.

    Cut-cell centroids are displaced in every coordinate, so a plain
    axis-aligned difference quotient picks up an O(1) cross-axis
    contamination exactly at the cut cells the moment corrections target.
    ``weights_for(delta)`` turns a per-cell offset vector into the
    shift-stencil weights ``(K0, ((wp_e, wm_e))_e)`` realizing
    ``delta · grad x``; apply with :func:`sw_apply` (exact adjoint
    :func:`sw_applyT`)."""

    def __init__(self, capacity):
        N = len(capacity.A)
        C = capacity.C_om
        dt_ = capacity.V.dtype
        fi = torch.finfo(dt_)
        tiny = fi.tiny
        wet = (capacity.V > 0.0).to(dt_)
        shape = tuple(capacity.V.shape)
        self.N, self.dtype, self.shape = N, dt_, shape

        # neighbour slots: (axis e, ±1) -> shift_p / shift_m source
        slots = []
        for e in range(N):
            for sgn, sh in ((+1, _shift_p), (-1, _shift_m)):
                m_i = sh(wet, e)
                dC = torch.stack([sh(C[..., j], e) - C[..., j]
                                  for j in range(N)], dim=-1)
                dC = dC * m_i[..., None]
                d2 = torch.sum(dC * dC, dim=-1)
                wgt = torch.where(d2 > tiny, m_i / torch.clamp_min(d2, tiny),
                                  0.0)
                slots.append((e, sgn, dC, wgt))
        self.slots = slots

        # normal matrix S = sum w_i dC dC^T  (per cell, N×N), regularized
        S = torch.zeros(shape + (N, N), dtype=dt_, device=C.device)
        for (_, _, dC, wgt) in slots:
            S = S + wgt[..., None, None] * dC[..., :, None] * dC[..., None, :]
        tr = torch.diagonal(S, dim1=-2, dim2=-1).sum(-1)
        reg_rel = 1e-10 if fi.bits >= 64 else 1e-5
        reg = (reg_rel * torch.clamp_min(tr, tiny) + tiny)[..., None, None] \
            * torch.eye(N, dtype=dt_, device=C.device)
        # inv_ex reports a singular matrix in `info` instead of raising, so
        # nothing waits for the device; the entries are masked below
        Sinv = torch.linalg.inv_ex(S + reg).inverse
        self.Sinv = torch.where(torch.isfinite(Sinv), Sinv, 0.0)
        # degenerate fits (fewer than N independent neighbours): drop the
        # correction rather than trust an ill-conditioned gradient.  det
        # threshold relative to (tr/N)^N, dtype-aware for f32.
        det_rel = 1e-8 if fi.bits >= 64 else 1e-4
        self.ok = (tr > tiny) & (torch.linalg.det(S) >
                                 (det_rel ** (1.0 / N)
                                  * torch.clamp_min(tr, tiny) / N) ** N)

    def weights_for(self, delta):
        """Shift weights for ``delta · grad x`` (``delta``: shape + (N,))."""
        N = self.N
        dS = torch.einsum("...j,...jk->...k", delta, self.Sinv)
        k0 = torch.zeros(self.shape, dtype=self.dtype, device=delta.device)
        per_axis = [[None, None] for _ in range(N)]
        for (e, sgn, dC, wgt) in self.slots:
            c = torch.einsum("...k,...k->...", dS, dC) * wgt
            c = torch.where(self.ok, c, 0.0)
            k0 = k0 - c
            per_axis[e][0 if sgn > 0 else 1] = c
        return (k0, tuple((pa[0], pa[1]) for pa in per_axis))


def sw_apply(w, x):
    """Apply shift-stencil weights ``(K0, ((wp_e, wm_e))_e)`` to x."""
    k0, slots = w
    y = k0 * x
    for e, (wp, wm) in enumerate(slots):
        y = y + wp * _shift_p(x, e) + wm * _shift_m(x, e)
    return y


def sw_applyT(w, y):
    """Exact adjoint of :func:`sw_apply`."""
    k0, slots = w
    x = k0 * y
    for e, (wp, wm) in enumerate(slots):
        x = x + _shift_m(wp * y, e) + _shift_p(wm * y, e)
    return x


def _cross_weights(capacity):
    """Xw weights realizing ``B_d sum_{e != d} delta_{d,e} dx/dx_e`` at
    every cut cell, ``delta_{d,e} = Bm[d]_e - C_om_e`` the transverse offset
    of the wet-line centroid (see :class:`_LsqGradient`)."""
    N = len(capacity.A)
    C = capacity.C_om
    is_cut = capacity.cell_types == -1
    lsq = _LsqGradient(capacity)
    Xw = []
    for d in range(N):
        delta = torch.stack(
            [torch.where(is_cut, capacity.Bm[d][..., e] - C[..., e], 0.0)
             if e != d else torch.zeros_like(capacity.V) for e in range(N)],
            dim=-1) * capacity.B[d][..., None]
        Xw.append(lsq.weights_for(delta))
    return tuple(Xw)


def make_diffusion_ops(capacity, periodic=None,
                       cross_moment=False) -> DiffusionOps:
    """``cross_moment=True`` (requires a ``cut_moments=True`` capacity
    build) activates the wet-line cross-moment correction of ``B_d x``, see
    :class:`DiffusionOps`."""
    Xw = None
    if cross_moment:
        if capacity.Bm is None:
            raise ValueError(
                "cross_moment=True needs capacity cut moments; build with "
                "compute_capacity(..., cut_moments=True)")
        Xw = _cross_weights(capacity)
    return DiffusionOps(
        A=capacity.A,
        B=capacity.B,
        V=capacity.V,
        Wdag=make_wdag(capacity.W),
        periodic=periodic,
        Xw=Xw,
    )


@dataclasses.dataclass
class ConvectionOps(DiffusionOps):
    """Adds the flux-form convection operators (src/operators.jl:194-210):

    ``C_d x = Dp_d( (Sm_d(A_d uₒ_d)) * Sm_d(x) )``
    ``K_d x = diag(Sp_d(Hᵀ uᵧ)) x``

    ``u_face``: per-axis bulk velocity sampled on the DOF grid;
    ``k_diag``: per-axis diagonal ``Sp_d(Hᵀ(uᵧ))``.
    """

    u_face: tuple = None
    k_diag: tuple = None

    def C(self, x, d):
        a_u = sm(self.A[d] * self.u_face[d], d, self._per(d))
        return dp(a_u * sm(x, d, self._per(d)), d, self._per(d))

    def K(self, x, d):
        return self.k_diag[d] * x

    def conv(self, x):
        """Σ_d C_d x (bulk convection)."""
        out = 0.0
        for d in range(self.ndim):
            out = out + self.C(x, d)
        return out

    def kconv(self, x):
        out = 0.0
        for d in range(self.ndim):
            out = out + self.K(x, d)
        return out


def make_convection_ops(capacity, u_bulk, u_gamma, periodic=None) -> ConvectionOps:
    """``u_bulk``: tuple of N tensors on the DOF grid (per-axis velocity);
    ``u_gamma``: one DOF-grid tensor used on every axis, or a tuple of N
    per-axis face tensors (interface velocity along normals)."""
    base = make_diffusion_ops(capacity, periodic)
    ndim = len(capacity.A)
    if not isinstance(u_gamma, (tuple, list)):
        u_gamma = tuple(u_gamma for _ in range(ndim))
    ht_u = base.HT(tuple(u_gamma))
    k_diag = tuple(sp(ht_u, d, base._per(d)) for d in range(ndim))
    return ConvectionOps(
        A=capacity.A,
        B=capacity.B,
        V=capacity.V,
        Wdag=base.Wdag,
        periodic=periodic,
        u_face=tuple(u_bulk),
        k_diag=k_diag,
    )


def grad_op(ops: DiffusionOps, x_omega, x_gamma):
    return ops.grad(x_omega, x_gamma)


def div_op(ops: DiffusionOps, q_omega, q_gamma):
    return ops.div(q_omega, q_gamma)

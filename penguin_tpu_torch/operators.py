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

Not ported yet: the ``cross_moment`` correction (``_LsqGradient``), ROADMAP
Queue 1 item 6.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

__all__ = [
    "dm", "dm_t", "dp", "dp_t", "sm", "sm_t", "sp", "sp_t",
    "DiffusionOps", "ConvectionOps", "make_diffusion_ops",
    "make_convection_ops", "make_wdag", "grad_op", "div_op",
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
    """

    A: tuple
    B: tuple
    V: torch.Tensor
    Wdag: tuple
    periodic: tuple = None

    @property
    def ndim(self):
        return len(self.A)

    def _per(self, d):
        return False if self.periodic is None else self.periodic[d]

    # --- building blocks ---------------------------------------------------
    def G(self, x):
        return tuple(dm(self.B[d] * x, d, self._per(d)) for d in range(self.ndim))

    def H(self, x):
        return tuple(
            self.A[d] * dm(x, d, self._per(d)) - dm(self.B[d] * x, d, self._per(d))
            for d in range(self.ndim)
        )

    def GT(self, q):
        out = 0.0
        for d in range(self.ndim):
            out = out + self.B[d] * dm_t(q[d], d, self._per(d))
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
                dm(self.B[d] * x_omega, d, self._per(d))
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


def make_diffusion_ops(capacity, periodic=None,
                       cross_moment=False) -> DiffusionOps:
    if cross_moment:
        raise NotImplementedError(
            "cross_moment=True (the wet-line cross-moment correction) is not "
            "ported yet: ROADMAP Queue 1 item 6")
    return DiffusionOps(
        A=capacity.A,
        B=capacity.B,
        V=capacity.V,
        Wdag=make_wdag(capacity.W),
        periodic=periodic,
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

"""Monolithic cut-cell Stokes solver, steady and unsteady θ-scheme (torch).

Counterpart of ``penguin_tpu.solvers.stokes``.  Unknowns per velocity
component live on staggered component meshes (offset −h/2 along their own
axis); the state is the tuple ``(uω_0, uγ_0, ..., uω_{N-1}, uγ_{N-1}, p)``
on the shared padded grid.

Matrix-free blocks (the reference's stokes2D_blocks):

- momentum d: ``Iμ_d GᵀWꜝG uω_d + Iμ_d GᵀWꜝH uγ_d - A^p_d Dm_d(p)``; the
  state stores p = -p_physical, as the reference does;
- tie rows: ``uγ_d = g_cut`` (identity);
- continuity: ``Σ_d [-DmTd(A^p_d uω_d) + DmTd(A^p_d uγ_d) - B^p_d DmTd(uγ_d)]``;
- velocity Dirichlet/Symmetry/Outflow/Neumann border surgery on both uω and
  uγ rows (Stokes borders use the standard axis naming: left/right are the
  x extremes);
- pressure gauge: pin one wet DOF or impose a volume-weighted zero mean.

Unsteady θ-scheme: ``(ρV/dt) u' + θ·visc(u') + grad p' = (ρV/dt) u -
(1-θ)·visc(u) + load``, the physical sign of the reference's Navier-Stokes
assembly (its Stokes-only unsteady path has a sign slip that is not
copied).

The set-up (activity masks, ghost cut rows, outflow planes, gauges) runs on
the host in numpy and moves its results to the capacity's device once; the
operators, the block preconditioner and the solves stay on that device.
The JAX version runs the time steps under ``lax.scan``; here they are a
Python loop with ``t`` a host float, the Krylov telemetry read once after
the loop.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .._device import resolve_device
from ..assembly import (
    _col_G_nz,
    _col_H_nz,
    _diag_GtWG,
    coefficient_diag,
)
from ..boundary import (
    Dirichlet,
    Neumann,
    Outflow,
    Periodic,
    Symmetry,
    Traction,
    eval_condition_value,
)
from ..capacity import gamma_half_moments
from ..linsolve import (
    DenseFactorSolver,
    _leaves,
    _unflatten,
    gmres,
    host_read,
    pbicgstab,
    pgmres,
    solve_linear,
)
from ..operators import (
    _LsqGradient,
    _shift_m,
    _shift_p,
    dm,
    dm_t,
    make_diffusion_ops,
    sw_apply,
    sw_applyT,
)

__all__ = ["StokesMono", "PinPressureGauge", "MeanPressureGauge",
           "VelocityBorder", "stokes_divergence"]


@dataclasses.dataclass(frozen=True)
class PinPressureGauge:
    index: object = None


@dataclasses.dataclass(frozen=True)
class MeanPressureGauge:
    pass


_AXIS_KEYS = {
    "left": (0, 0), "right": (0, 1),
    "bottom": (1, 0), "top": (1, 1),
    "backward": (2, 0), "forward": (2, 1),
}
_AXIS_KEYS_1D = {"bottom": (0, 0), "top": (0, 1), "left": (0, 0), "right": (0, 1)}


def _host(t):
    return t.detach().cpu().numpy()


def _vdot(a, b):
    return torch.sum(a * b)


def _pad_core(sc, shape):
    """Embed ``sc`` (the leading ``sc.shape`` block) in zeros of ``shape``."""
    flat = []
    for d in reversed(range(sc.ndim)):
        flat += [0, shape[d] - sc.shape[d]]
    return torch.nn.functional.pad(sc, flat)


def _along(M, x, axis):
    """``M`` applied along ``axis`` of ``x`` (a DCT/DST as a matmul)."""
    return torch.movedim(torch.movedim(x, axis, -1) @ M.T, -1, axis)


def _dct2_matrix(n, **like):
    """The orthonormal DCT-II as a matrix: ``C[k, j] = s_k cos(π (j+½) k /
    n)``; its inverse is ``Cᵀ``."""
    jj = np.arange(n)
    kk = np.arange(n)[:, None]
    C = np.cos(np.pi * (jj[None, :] + 0.5) * kk / n) * np.sqrt(2.0 / n)
    C[0] *= np.sqrt(0.5)
    return torch.as_tensor(C, **like)


class _WholeGrid:
    """The global operations of :meth:`StokesMono.make_block_preconditioner`
    on one array holding the whole grid: no halo, plain sums, the DCT as
    matmuls.  ``parallel.sharding`` passes a rank's counterpart as the
    private ``_rank``: there the fields are the rank's window, ``grow``
    brings a block's halo, ``fresh`` renews it before a stencil, sums run
    over the block and the ranks, and the DCT is reduce-scattered along the
    rank grid."""

    # reach-1 stencil sweeps a renewed halo affords before the next one
    depth = math.inf

    def __init__(self, shape):
        self.shape = tuple(shape)

    def grow(self, x):
        return x

    crop = fresh = grow

    def sum(self, *ts):
        return tuple(torch.sum(t) for t in ts)

    def dot_norm(self, a, w):
        return _vdot(a, w), torch.linalg.vector_norm(w)

    def index(self, d, **like):
        """Global index of each slot of the fields along axis d."""
        return torch.arange(self.shape[d], **like)

    def core_index(self, d, n, **like):
        """Global index of each of the DCT's first ``n`` slots along axis d
        that these fields hold."""
        return torch.arange(n, **like)

    def core(self, ncell):
        return tuple(slice(0, nc) for nc in ncell)

    def pad_core(self, sc, shape):
        return _pad_core(sc, shape)

    def along(self, M, x, axis):
        return _along(M, x, axis)


class VelocityBorder:
    """Border surgery for one velocity component (applied to both uω and uγ
    rows).  ``comp``: which velocity component this mesh carries.

    ``wall_row="ghost"`` replaces the first-cell-center Dirichlet row with a
    linearly extrapolated wall-face row: ``1.5 u₀ − 0.5 u₁ = g(wall)`` for a
    tangential component (its DOF line sits h/2 inside the wall), ``2
    u_{n-1} − u_{n-2} = g(wall)`` for the normal component on the high side
    (a full h inside).  This moves the wall-placement error from O(h) to
    O(h²).  Masks and positions go to ``device`` (by default the CUDA
    device) in ``dtype``."""

    def __init__(self, mesh_comp, bc, comp: int, wall_row: str = "center",
                 dtype=torch.float64, device=None):
        device = resolve_device(device)
        self.items = []
        self.ghost = wall_row == "ghost"
        N = mesh_comp.ndim
        shape = mesh_comp.np_shape
        keymap = _AXIS_KEYS_1D if N == 1 else _AXIS_KEYS
        # DOF positions over the full padded grid: border rows evaluate
        # their Dirichlet data at the DOF (cell-centroid) positions
        # nodes[d] + h/2, not at the nodes
        pos = []
        for d in range(N):
            c = np.zeros(shape[d])
            nd = mesh_comp.n[d] + 1
            c[:nd] = np.asarray(mesh_comp.nodes[d]) + 0.5 * mesh_comp.h[d]
            c[nd:] = c[nd - 1]
            shp = [1] * N
            shp[d] = shape[d]
            pos.append(torch.as_tensor(c.reshape(shp), dtype=dtype,
                                       device=device).expand(shape))
        self.pos = pos
        self.mesh_comp = mesh_comp
        for key, cond in bc.borders:
            if key not in keymap:
                continue
            if isinstance(cond, Periodic):
                # periodicity is an operator property (make_diffusion_ops(
                # periodic=...)): the wrap rows stay momentum equations
                continue
            axis, side = keymap[key]
            if axis >= N:
                continue
            if isinstance(cond, Outflow) and axis == comp:
                # normal component at an open boundary keeps its momentum
                # row: it sets the through-flow rate with the outflow
                # pressure plane (StokesMono.__init__)
                continue
            n_real = mesh_comp.n[axis]
            idx = 0 if side == 0 else n_real - 1
            mask = np.zeros(shape, dtype=bool)
            sl = [slice(None)] * N
            sl[axis] = idx
            mask[tuple(sl)] = True
            self.items.append((key, cond, axis, side, comp,
                               torch.as_tensor(mask, device=device)))
        self.h = mesh_comp.h

    def _ghost_coefs(self, axis, side, comp):
        """(c0, c1) of the extrapolated wall row c0·u_b + c1·u_inner = g;
        None when the DOF already sits on the wall."""
        if comp == axis:
            return None if side == 0 else (2.0, -1.0)
        return (1.5, -0.5)

    def matvec(self, yw, yg, uw, ug):
        for key, cond, axis, side, comp, mask in self.items:
            if isinstance(cond, Dirichlet):
                coefs = self._ghost_coefs(axis, side, comp) if self.ghost \
                    else None
                if coefs is not None:
                    c0, c1 = coefs
                    nb_w = _shift_p(uw, axis) if side == 0 else _shift_m(uw, axis)
                    yw = torch.where(mask, c0 * uw + c1 * nb_w, yw)
                else:
                    yw = torch.where(mask, uw, yw)
                yg = torch.where(mask, ug, yg)
            elif isinstance(cond, Symmetry):
                if comp == axis:  # normal component: u = 0
                    yw = torch.where(mask, uw, yw)
                    yg = torch.where(mask, ug, yg)
                else:  # tangential: zero gradient
                    nb_w = _shift_p(uw, axis) if side == 0 else _shift_m(uw, axis)
                    nb_g = _shift_p(ug, axis) if side == 0 else _shift_m(ug, axis)
                    yw = torch.where(mask, uw - nb_w, yw)
                    yg = torch.where(mask, ug - nb_g, yg)
            elif isinstance(cond, Outflow):
                nb_w = _shift_p(uw, axis) if side == 0 else _shift_m(uw, axis)
                nb_g = _shift_p(ug, axis) if side == 0 else _shift_m(ug, axis)
                yw = torch.where(mask, uw - nb_w, yw)
                yg = torch.where(mask, ug - nb_g, yg)
            elif isinstance(cond, Neumann):
                nb_w = _shift_p(uw, axis) if side == 0 else _shift_m(uw, axis)
                yw = torch.where(mask, (uw - nb_w) / self.h[axis], yw)
        return yw, yg

    def _wall_pos(self, axis, side, comp):
        """Positions with the border-axis coordinate snapped to the exact
        wall face (ghost rows impose the value at the wall)."""
        m = self.mesh_comp
        n = m.n[axis]
        wall = float(m.nodes[axis][0] if side == 0 else m.nodes[axis][n])
        if comp == axis:  # this mesh is offset -h/2 along its own axis
            wall += 0.5 * m.h[axis]
        pos = list(self.pos)
        pos[axis] = torch.full_like(pos[axis], wall)
        return pos

    def rhs(self, bw, bg, t=None):
        for key, cond, axis, side, comp, mask in self.items:
            if isinstance(cond, Dirichlet):
                ghost = self.ghost and \
                    self._ghost_coefs(axis, side, comp) is not None
                p = self._wall_pos(axis, side, comp) if ghost else self.pos
                val = eval_condition_value(cond.value, p, t)
                bw = torch.where(mask, val, bw)
                bg = torch.where(mask, val, bg)
            elif isinstance(cond, (Symmetry, Outflow)):
                bw = torch.where(mask, 0.0, bw)
                bg = torch.where(mask, 0.0, bg)
            elif isinstance(cond, Neumann):
                val = eval_condition_value(cond.value, self.pos, t)
                bw = torch.where(mask, val, bw)
        return bw, bg


def stokes_divergence(fluid, uws, ugs):
    """Continuity residual Σ_d div_d (matrix-free)."""
    opp = fluid.operator_p
    out = 0.0
    for d in range(len(uws)):
        Ap = opp.A[d]
        Bp = opp.B[d]
        per = opp._per(d)
        out = (out - dm_t(Ap * uws[d], d, per) + dm_t(Ap * ugs[d], d, per)
               - Bp * dm_t(ugs[d], d, per))
    return out


def _read_steps(steps):
    """Per-step lists of tensors (0-d or 1-d, each position the same
    shape every step) stacked over the steps: numpy arrays, in one host
    read."""
    cols = [torch.stack(c) for c in zip(*steps)]
    flat = host_read(torch.cat([c.reshape(-1).to(torch.float64)
                                for c in cols]))
    out, pos = [], 0
    for c in cols:
        dt = torch.empty((), dtype=c.dtype).numpy().dtype
        out.append(flat[pos:pos + c.numel()].reshape(tuple(c.shape))
                   .astype(dt))
        pos += c.numel()
    return out


class StokesMono:
    """Fully coupled steady/unsteady Stokes.  The tensors follow the
    fluid's capacities (device and dtype)."""

    def __init__(self, fluid, bc_u, pressure_gauge=None, bc_cut=None,
                 wall_row="center", cut_row="center", cut_flux="auto"):
        self.fluid = fluid
        self.bc_u = bc_u if isinstance(bc_u, tuple) else (bc_u,)
        self.gauge = pressure_gauge or PinPressureGauge()
        # one cut condition for every velocity component, or a tuple of
        # them (a rotating wall: uγ_x = -Ω y, uγ_y = Ω x)
        self.bc_cut = bc_cut or Dirichlet(0.0)
        N = fluid.ndim
        self.N = N
        Vp_t = fluid.capacity_p.V
        dtype, device = Vp_t.dtype, Vp_t.device
        self._like = dict(dtype=dtype, device=device)
        # ``cut_flux="moment"``: the moment-consistent cut viscous flux:
        # wet-line cross-moment sampling of B·u in G/Gᵀ (operators rebuilt
        # with cross_moment=True) and the uγ boundary term at the per-axis
        # per-half-strip Γ centroids instead of C_ga (a rhs correction,
        # _gamma_moment_rhs).  Exact for linear velocity fields.  "auto":
        # "moment" when the capacities carry the cut moments and the cut
        # condition is Dirichlet-like (N >= 2), else "centroid"
        if cut_flux == "auto":
            cut_flux = ("moment"
                        if (not isinstance(self._cut(0), Traction)
                            and N >= 2
                            and all(fluid.capacity_u[d].Bm is not None
                                    for d in range(N)))
                        else "centroid")
        self.cut_flux = cut_flux
        self._ghm = None
        self._ghm_p = None
        self._divw = None
        if cut_flux == "moment" and isinstance(self._cut(0), Traction):
            raise ValueError("cut_flux='moment' supports Dirichlet cut "
                             "conditions only (not Traction); the 'auto' "
                             "default falls back to 'centroid' for "
                             "Traction rows")
        if cut_flux == "moment":
            if any(fluid.capacity_u[d].Bm is None for d in range(N)):
                raise ValueError(
                    "cut_flux='moment' needs capacities built with "
                    "compute_capacity(..., cut_moments=True)")
            new_ops = tuple(
                (make_diffusion_ops(fluid.capacity_u[d],
                                    periodic=fluid.operator_u[d].periodic,
                                    cross_moment=True)
                 if fluid.operator_u[d].Xw is None else fluid.operator_u[d])
                for d in range(N))
            self.fluid = fluid = dataclasses.replace(fluid,
                                                     operator_u=new_ops)
            self._ghm = tuple(gamma_half_moments(fluid.capacity_u[d])
                              for d in range(N))
            self._ghm_p = (gamma_half_moments(fluid.capacity_p)
                           if fluid.capacity_p.Bm is not None else None)
            # divergence/pressure-gradient cross-moment pair: the exact
            # mass flux samples u_d at the wet-face centroid Am^p, not at
            # the u_d DOF; P^A(u) = A·u + A·(δ·∇u), δ = Am^p[d] − C_om^{u_d},
            # with the LSQ gradients of the component-d capacity, and the
            # pressure gradient takes the exact adjoint so the saddle point
            # stays symmetric
            if self._ghm_p is not None:
                cap_p = fluid.capacity_p
                hmax = max(float(v) for v in fluid.mesh_p.h)
                divw = []
                for d in range(N):
                    cap_u = fluid.capacity_u[d]
                    lsq = _LsqGradient(cap_u)
                    delta = torch.clamp(cap_p.Am[d] - cap_u.C_om, -hmax, hmax)
                    # active only where the face is partially wet or the
                    # u-cell is cut; elsewhere δ is quadrature noise
                    face_cut = (cap_p.cell_types == -1) | \
                        (cap_u.cell_types == -1)
                    delta = torch.where(face_cut[..., None], delta, 0.0)
                    delta = delta * cap_p.A[d][..., None]
                    divw.append(lsq.weights_for(delta))
                self._divw = tuple(divw)
        self.mu_diag = tuple(
            coefficient_diag(fluid.mu, fluid.capacity_u[d]) for d in range(N))
        self.rho_diag = tuple(
            coefficient_diag(fluid.rho, fluid.capacity_u[d]) for d in range(N))
        self.borders = tuple(
            VelocityBorder(fluid.mesh_u[d], self.bc_u[d], d,
                           wall_row=wall_row, **self._like)
            for d in range(N))
        # activity masks (zero-row/col elimination): padding and dry DOFs
        # become identity rows
        self.u_active = tuple(
            _col_G_nz(fluid.operator_u[d]) | (fluid.operator_u[d].V != 0)
            for d in range(N))
        # Gibou-style one-sided ghost rows for badly cut momentum DOFs
        # (opt-in, static geometry), built before the orphan-pressure
        # elimination: a replaced momentum row has no pressure column
        self.traction = isinstance(self._cut(0), Traction)
        self._ghost = (None,) * N
        if cut_row == "ghost" and not self.traction:
            self._ghost = self._build_ghost_cut_rows()

        p_act = _host(_col_G_nz(fluid.operator_p) | (fluid.operator_p.V != 0))
        # orphan-pressure elimination (the reference's
        # remove_zero_rows_cols!): p[j] feeds momentum-d rows j and j+1;
        # rows replaced by border surgery or masked inactive don't count
        p_feeds = np.zeros(p_act.shape, bool)
        for d in range(N):
            live = _host(self.u_active[d])
            for item in self.borders[d].items:
                live = live & ~_host(item[5])
            if self._ghost[d] is not None:
                live = live.copy()
                live.ravel()[_host(self._ghost[d]["gpos"])] = False
            c = (_host(fluid.operator_p.A[d]) != 0) & live
            cp = np.zeros_like(c)
            sl_dst = [slice(None)] * c.ndim
            sl_src = [slice(None)] * c.ndim
            sl_dst[d] = slice(0, -1)
            sl_src[d] = slice(1, None)
            cp[tuple(sl_dst)] = c[tuple(sl_src)]
            p_feeds |= c | cp
        p_active_np = p_act & p_feeds
        self.p_active = torch.as_tensor(p_active_np, device=device)
        # Traction cut condition: the uγ tie rows become traction-balance
        # rows [Iμ HᵀWꜝG, Iμ HᵀWꜝH, -Hp]
        if self.traction:
            self.trac_active = tuple(
                _col_H_nz(fluid.operator_u[d]) for d in range(N))
        # Outflow(pressure): the prescribed reference pressure on the
        # border pressure plane; without a value the level is 0
        p_shape = tuple(Vp_t.shape)
        keymap = _AXIS_KEYS_1D if N == 1 else _AXIS_KEYS
        out_mask = np.zeros(p_shape, bool)
        out_vals = np.zeros(p_shape)
        pos_p = []
        for d in range(N):
            c = np.zeros(p_shape[d])
            c[: fluid.mesh_p.n[d]] = np.asarray(fluid.mesh_p.centers[d])
            shp = [1] * N
            shp[d] = p_shape[d]
            pos_p.append(np.broadcast_to(c.reshape(shp), p_shape))
        for bc_i_, bc in enumerate(self.bc_u):
            for key, cond in bc.borders:
                if not isinstance(cond, Outflow) or key not in keymap:
                    continue
                axis, side = keymap[key]
                if axis >= N or axis != bc_i_:
                    continue
                # the whole outflow plane is prescribed: a single-cell pin
                # would leave an exact through-flow null mode in an open
                # system.  The plane nearest the border holding active
                # pressure DOFs is used (the border plane can be dry)
                n_ax = fluid.mesh_p.n[axis]
                step = 1 if side == 0 else -1
                start = 0 if side == 0 else n_ax - 1
                m = np.zeros(p_shape, bool)
                for idx in range(start, start + step * n_ax, step):
                    sl = [slice(None)] * N
                    sl[axis] = idx
                    m = np.zeros(p_shape, bool)
                    m[tuple(sl)] = True
                    m &= p_active_np
                    if m.any():
                        break
                if not m.any():
                    continue
                # Outflow(pressure=...) is the PHYSICAL pressure; the state
                # stores -p_physical, so the plane rows pin -value
                val = cond.pressure
                if callable(val):
                    v = -_host(eval_condition_value(val, [
                        torch.as_tensor(np.ascontiguousarray(q), **self._like)
                        for q in pos_p]))
                elif val is not None:
                    v = -float(val) * np.ones(p_shape)
                else:
                    v = np.zeros(p_shape)
                out_vals = np.where(m, v, out_vals)
                out_mask |= m
        if out_mask.any():
            # the outflow pin fixes the level of its own connected fluid
            # region only: pin one cell of every other region at level 0
            from scipy import ndimage
            lab, nlab = ndimage.label(p_active_np)
            pinned = set(np.unique(lab[out_mask & (lab > 0)]).tolist())
            for comp in range(1, nlab + 1):
                if comp in pinned:
                    continue
                cells = np.flatnonzero((lab == comp).ravel())
                m1 = np.zeros(p_shape, bool)
                m1.ravel()[cells[cells.size // 2]] = True
                out_mask |= m1  # out_vals stays 0 there (gauge level)
        self.outflow_p_mask = (torch.as_tensor(out_mask, device=device)
                               if out_mask.any() else None)
        self.outflow_p_vals = torch.as_tensor(out_vals, **self._like)

        # pressure gauge bookkeeping (static); a prescribed Outflow
        # pressure already fixes the level, so no gauge row then
        Vp = _host(Vp_t)
        e0 = np.zeros(p_shape, bool)
        e0[(0,) * N] = True
        self._e0 = torch.as_tensor(e0, device=device)
        if self.outflow_p_mask is not None:
            self.pin_mask = None
            self.pin_idx = None
            self.mean_w = None
        elif isinstance(self.gauge, PinPressureGauge):
            idx = self.gauge.index
            if idx is None:
                # pin the first wet active cell, scanning x fastest as the
                # reference does
                wet = (Vp > 1e-12) & p_active_np
                flatF = wet.ravel(order="F")
                k = int(np.argmax(flatF)) if flatF.any() else 0
                idx = np.unravel_index(k, Vp.shape, order="F")
            self.pin_idx = tuple(int(v) for v in idx)
            pin = np.zeros(Vp.shape, bool)
            pin[self.pin_idx] = True
            self.pin_mask = torch.as_tensor(pin, device=device)
            self.mean_w = None
        else:
            w = Vp.astype(np.float64)
            if np.allclose(w, 0.0):
                w[:] = 1.0
            self.mean_w = torch.as_tensor(w / w.sum(), **self._like)
            self.pin_mask = None

    # ------------------------------------------------------------------
    def _build_ghost_cut_rows(self, frac_max=0.5):
        """Per velocity component, the replacement rows (host-side, static
        geometry) of cut cells with wet fraction < ``frac_max``: u_c −
        θ·I(u)(x_f) = (1−θ)·u_wall(x_w), with x_w the wall foot point of the
        DOF centroid, x_f probe points 1.5–3 h into the fluid along the
        inward normal, I bilinear interpolation from trusted cells.  Built
        in numpy once; the row data then move to the device."""
        out = []
        N = self.N
        for d in range(N):
            cap = self.fluid.capacity_u[d]
            mesh_c = self.fluid.mesh_u[d]
            V = _host(cap.V).astype(float)
            ct = _host(cap.cell_types)
            shape = V.shape
            h = np.asarray(mesh_c.h, float)
            cellvol = float(np.prod(h))
            frac = V / cellvol
            cand = (ct == -1) & (frac < frac_max) & _host(self.u_active[d])
            for item in self.borders[d].items:
                cand &= ~_host(item[5])
            if not cand.any():
                out.append(None)
                continue
            # fluid-inward interface normal from the aperture closure
            # n_in,e |Γ| = A_hi,e − A_lo,e
            nvec = np.zeros(shape + (N,))
            for e in range(N):
                Ae = _host(cap.A[e]).astype(float)
                hi = np.zeros_like(Ae)
                sl_dst = [slice(None)] * N
                sl_src = [slice(None)] * N
                sl_dst[e] = slice(0, -1)
                sl_src[e] = slice(1, None)
                hi[tuple(sl_dst)] = Ae[tuple(sl_src)]
                nvec[..., e] = hi - Ae
            nn = np.linalg.norm(nvec, axis=-1)
            Com = _host(cap.C_om).astype(float)[..., :N]
            Cga = _host(cap.C_ga).astype(float)[..., :N]
            alt = Com - Cga
            use_alt = nn < 1e-12
            nvec = np.where(use_alt[..., None], alt, nvec)
            nn = np.linalg.norm(nvec, axis=-1)
            cand &= nn > 1e-12
            nvec = nvec / np.maximum(nn, 1e-300)[..., None]
            hbar = float(np.max(h))
            d_c = np.einsum("...k,...k->...", Com - Cga, nvec)
            d_c = np.clip(d_c, 0.05 * hbar, 2.0 * hbar)
            # trusted interpolation sources: every wet cell keeping a real
            # row (momentum or border-Dirichlet identity)
            good_src = (V > 1e-12) & ~cand
            x0 = np.array([float(mesh_c.centers[e][0]) for e in range(N)])
            gidx = np.argwhere(cand)
            K = len(gidx)
            corners = 2 ** N

            def bilinear(xf):
                """(flat ids, weights) of the lattice cell around xf, or
                None when a source cell is untrusted or out of range."""
                i0 = np.floor((xf - x0) / h).astype(int)
                if np.any(i0 < 0) or np.any(i0 + 1 > np.array(shape) - 1):
                    return None
                fr = (xf - (x0 + i0 * h)) / h
                ids, ws = [], []
                for corner in range(corners):
                    off = [(corner >> e) & 1 for e in range(N)]
                    cidx = tuple(int(i0[e] + off[e]) for e in range(N))
                    if not good_src[cidx]:
                        return None
                    w = 1.0
                    for e in range(N):
                        w *= fr[e] if off[e] else (1.0 - fr[e])
                    ids.append(np.ravel_multi_index(cidx, shape))
                    ws.append(w)
                return ids, ws

            # two probe points along the inward normal: quadratic Lagrange
            # extrapolation through (0, u_w), (s1, u1), (s2, u2), s the
            # distance from the wall, evaluated at s = d_c
            idx_all = np.zeros((K, 2 * corners), np.int64)
            wts_all = np.zeros((K, 2 * corners))
            cwall = np.zeros(K)
            xw = np.zeros((K, N))
            keep = np.zeros(K, bool)
            for k in range(K):
                ji = tuple(gidx[k])
                xc, nv, dc = Com[ji], nvec[ji], d_c[ji]
                for tmul in (1.5, 2.0, 2.5, 3.0):
                    t = tmul * hbar
                    b1 = bilinear(xc + t * nv)
                    b2 = bilinear(xc + 2.0 * t * nv)
                    if b1 is None or b2 is None:
                        continue
                    s1, s2 = dc + t, dc + 2.0 * t
                    lw = ((dc - s1) * (dc - s2)) / (s1 * s2)
                    l1 = (dc * (dc - s2)) / (s1 * (s1 - s2))
                    l2 = (dc * (dc - s1)) / (s2 * (s2 - s1))
                    idx_all[k] = b1[0] + b2[0]
                    wts_all[k] = ([l1 * w for w in b1[1]]
                                  + [l2 * w for w in b2[1]])
                    cwall[k] = lw
                    xw[k] = xc - dc * nv
                    keep[k] = True
                    break
            if not keep.any():
                out.append(None)
                continue
            gpos = np.ravel_multi_index(tuple(gidx[keep].T), shape)
            gmask = np.zeros(shape, bool)
            gmask.ravel()[gpos] = True
            dev = self._like["device"]
            out.append({
                "gpos": torch.as_tensor(gpos, device=dev),
                "gmask": torch.as_tensor(gmask, device=dev),
                "idx": torch.as_tensor(idx_all[keep], device=dev),
                "wts": torch.as_tensor(wts_all[keep], **self._like),
                "cwall": torch.as_tensor(cwall[keep], **self._like),
                "xw": tuple(torch.as_tensor(np.ascontiguousarray(
                    xw[keep][:, e]), **self._like) for e in range(N)),
            })
        return tuple(out)

    def _ghost_fix(self, d, yw, uw):
        g = self._ghost[d]
        if g is None:
            return yw
        flat = uw.reshape(-1)
        uf = (flat[g["idx"]] * g["wts"]).sum(1)
        val = flat[g["gpos"]] - uf
        return yw.reshape(-1).index_put((g["gpos"],), val).reshape(yw.shape)

    def _ghost_rhs(self, d, bw, t=None):
        g = self._ghost[d]
        if g is None:
            return bw
        uwall = eval_condition_value(self._cut(d).value, list(g["xw"]), t)
        val = g["cwall"] * uwall
        return bw.reshape(-1).index_put((g["gpos"],), val).reshape(bw.shape)

    # ------------------------------------------------------------------
    def _tie_points(self, cap):
        """Tie evaluation points: the interface centroid where the cell is
        cut, the cell centroid elsewhere.  C_ga is the zero vector at
        non-cut cells, whose uγ DOFs still enter cut continuity rows
        through the hi-half pairing: evaluating g at the origin there
        injected bogus wall values as mass sources."""
        Cg = torch.where((cap.cell_types == -1)[..., None], cap.C_ga,
                         cap.C_om)
        return [Cg[..., i] for i in range(self.N)]

    def _gamma_moment_rhs(self, d, t=None):
        """μ Gᵀ Wꜝ Δq, the uγ placement correction of the cut viscous flux
        (``cut_flux="moment"``): Δq_a(face k) = S_hi(k−1)·[g(X_hi) −
        g(C_ga)](k−1) + S_lo(k)·[g(X_lo) − g(C_ga)](k), the exact per-half-
        strip Γ boundary term for the Dirichlet data g minus what the tie
        delivers through H.  Subtracted from the momentum rhs."""
        if self._ghm is None:
            return None
        N = self.N
        cap = self.fluid.capacity_u[d]
        ops = self.fluid.operator_u[d]
        g = self._cut(d).value
        g_cga = eval_condition_value(g, self._tie_points(cap), t)
        dq = []
        for a in range(N):
            S_lo, X_lo, S_hi, X_hi = self._ghm[d][a]
            g_lo = eval_condition_value(
                g, [X_lo[..., i] for i in range(N)], t)
            g_hi = eval_condition_value(
                g, [X_hi[..., i] for i in range(N)], t)
            D_lo = S_lo * (g_lo - g_cga)
            D_hi = S_hi * (g_hi - g_cga)
            dq.append(_shift_m(D_hi, a) + D_lo)
        return self.mu_diag[d] * ops.GT(ops.Wq(tuple(dq)))

    def _cont_moment_rhs(self, t=None):
        """Continuity γ-placement correction (``cut_flux="moment"``): the
        discrete γ-term at p-cell k along d is ``S_lo(k)·uγ_d(k) +
        S_hi(k)·uγ_d(k+1)``; the exact Γ mass term ``S_lo·g_d(X_lo) +
        S_hi·g_d(X_hi)``.  Returns exact − discrete(data), subtracted from
        the continuity rhs."""
        if self._ghm_p is None:
            return None
        N = self.N
        delta = 0.0
        for d in range(N):
            cap_u = self.fluid.capacity_u[d]
            g = self._cut(d).value
            gtie = eval_condition_value(g, self._tie_points(cap_u), t)
            gtie = torch.broadcast_to(gtie, cap_u.V.shape)
            S_lo, X_lo, S_hi, X_hi = self._ghm_p[d]
            g_lo = eval_condition_value(
                g, [X_lo[..., i] for i in range(N)], t)
            g_hi = eval_condition_value(
                g, [X_hi[..., i] for i in range(N)], t)
            delta = delta + S_lo * (g_lo - gtie) \
                + S_hi * (g_hi - _shift_p(gtie, d))
        return delta

    def _traction_row(self, d, uw, ug, p):
        ops = self.fluid.operator_u[d]
        visc_trac = self.mu_diag[d] * ops.HT(ops.flux(uw, ug))
        opp = self.fluid.operator_p
        per = opp._per(d)
        hp = opp.A[d] * dm(p, d, per) - dm(opp.B[d] * p, d, per)
        return visc_trac - hp

    def _tie_or_traction(self, d, uw, ug, p):
        if not self.traction:
            return ug
        row = self._traction_row(d, uw, ug, p)
        return torch.where(self.trac_active[d], row, ug)

    def _visc(self, d, uw, ug):
        ops = self.fluid.operator_u[d]
        return self.mu_diag[d] * ops.GT(ops.flux(uw, ug))

    def _grad(self, d, p):
        opp = self.fluid.operator_p
        dp = dm(p, d, opp._per(d))
        g = -(opp.A[d] * dp)
        if self._divw is not None:
            g = g - sw_applyT(self._divw[d], dp)
        return g

    def _div(self, uws, ugs):
        """Continuity operator with the wet-face cross-moment correction
        (the adjoint pair of :meth:`_grad`)."""
        out = stokes_divergence(self.fluid, uws, ugs)
        if self._divw is not None:
            opp = self.fluid.operator_p
            for d in range(self.N):
                out = out - dm_t(sw_apply(self._divw[d], uws[d]), d,
                                 opp._per(d))
        return out

    def _gauge_fix(self, yp, p):
        if self.outflow_p_mask is not None:
            return torch.where(self.outflow_p_mask, p, yp)
        if self.pin_mask is not None:
            return torch.where(self.pin_mask, p, yp)
        # mean gauge: the first continuity row becomes the weighted mean
        return torch.where(self._e0, torch.sum(self.mean_w * p), yp)

    def _gauge_rhs(self, bp):
        if self.outflow_p_mask is not None:
            return torch.where(self.outflow_p_mask, self.outflow_p_vals, bp)
        if self.pin_mask is not None:
            return torch.where(self.pin_mask, 0.0, bp)
        return torch.where(self._e0, 0.0, bp)

    def _rows(self, x, mass=None, theta=1.0):
        """The momentum, tie and continuity rows of ``x``; ``mass`` (per
        component) adds the unsteady diagonal, ``theta`` scales the
        viscous block."""
        N = self.N
        uws = x[0:2 * N:2]
        ugs = x[1:2 * N:2]
        p = x[2 * N]
        out = []
        for d in range(N):
            yw = self._visc(d, uws[d], ugs[d])
            if theta != 1.0:
                yw = theta * yw
            if mass is not None:
                yw = mass[d] * uws[d] + yw
            yw = yw + self._grad(d, p)
            yw = torch.where(self.u_active[d], yw, uws[d])
            yw = self._ghost_fix(d, yw, uws[d])
            yg = self._tie_or_traction(d, uws[d], ugs[d], p)
            yw, yg = self.borders[d].matvec(yw, yg, uws[d], ugs[d])
            out += [yw, yg]
        yp = self._div(uws, ugs)
        yp = torch.where(self.p_active, yp, p)
        yp = self._gauge_fix(yp, p)
        return tuple(out) + (yp,)

    def apply_steady(self, x):
        return self._rows(x)

    def _cut(self, d):
        bc = self.bc_cut
        return bc[d] if isinstance(bc, (tuple, list)) else bc

    def _force(self, d, t):
        cap = self.fluid.capacity_u[d]
        fu = self.fluid.f_u
        fu_d = fu[d] if isinstance(fu, (tuple, list)) else fu
        C = cap.C_om
        return eval_condition_value(fu_d, [C[..., i] for i in
                                           range(C.shape[-1])], t)

    def _tie_rhs(self, d, t):
        cap = self.fluid.capacity_u[d]
        bg = eval_condition_value(self._cut(d).value, self._tie_points(cap), t)
        if self.traction:
            bg = torch.where(self.trac_active[d], bg, 0.0)
        return bg

    def _continuity_rhs(self, t):
        bp = torch.zeros_like(self.fluid.capacity_p.V)
        dc = self._cont_moment_rhs(t)
        if dc is not None:
            bp = torch.where(self.p_active, -dc, bp)
        return self._gauge_rhs(bp)

    def rhs_steady(self, t=None):
        out = []
        for d in range(self.N):
            bw = self.fluid.operator_u[d].V * self._force(d, t)
            bg = self._tie_rhs(d, t)
            corr = self._gamma_moment_rhs(d, t)
            if corr is not None:
                bw = bw - corr
            bw = torch.where(self.u_active[d], bw, 0.0)
            bw = self._ghost_rhs(d, bw, t)
            bw, bg = self.borders[d].rhs(bw, bg, t)
            out += [bw, bg]
        return tuple(out) + (self._continuity_rhs(t),)

    def _mass(self, dt):
        return tuple(self.rho_diag[d] * self.fluid.operator_u[d].V / dt
                     for d in range(self.N))

    def make_unsteady_apply(self, dt, theta):
        mass = self._mass(dt)

        def apply(x):
            return self._rows(x, mass, theta)

        return apply

    def make_unsteady_rhs(self, dt, theta):
        N = self.N
        mass = self._mass(dt)

        def rhs(x_prev, t_prev, t_next, extra_mom=None):
            out = []
            for d in range(N):
                ops = self.fluid.operator_u[d]
                uw_p = x_prev[2 * d]
                ug_p = x_prev[2 * d + 1]
                load = ops.V * (theta * self._force(d, t_next)
                                + (1 - theta) * self._force(d, t_prev))
                bw = mass[d] * uw_p - (1 - theta) * self._visc(d, uw_p, ug_p) \
                    + load
                if extra_mom is not None:
                    bw = bw + extra_mom[d]
                if self._ghm is not None:
                    corr_n = self._gamma_moment_rhs(d, t_next)
                    corr_p = self._gamma_moment_rhs(d, t_prev)
                    bw = bw - theta * corr_n - (1 - theta) * corr_p
                bw = torch.where(self.u_active[d], bw, 0.0)
                bg = self._tie_rhs(d, t_next)
                bw = self._ghost_rhs(d, bw, t_next)
                bw, bg = self.borders[d].rhs(bw, bg, t_next)
                out += [bw, bg]
            return tuple(out) + (self._continuity_rhs(t_next),)

        return rhs

    # ------------------------------------------------------------------
    def zero_state(self):
        out = []
        for d in range(self.N):
            z = torch.zeros_like(self.fluid.operator_u[d].V)
            out += [z, z]
        return tuple(out) + (torch.zeros_like(self.fluid.capacity_p.V),)

    def force_diagnostics(self, x=None, parts=False):
        """Reaction force on the immersed boundary, pressure plus viscous
        momentum-residual parts: F_d = Σ [ A_p ∂_d p + Iμ Gᵀ Wꜝ (G uω_d + H
        uγ_d) ].  ``parts=True`` returns ((Fp_d, Fv_d), ...).  By the
        telescoping of Gᵀ/Dm the domain sum is the traction integral over
        all boundaries (body and outer borders); with Outflow or driven
        borders use :meth:`interface_force`."""
        x = x if x is not None else self.x
        N = self.N
        p = x[2 * N]
        sums = []
        for d in range(N):
            ops = self.fluid.operator_u[d]
            q = ops.flux(x[2 * d], x[2 * d + 1])
            sums += [torch.sum(-self._grad(d, p)),
                     torch.sum(self.mu_diag[d] * ops.GT(q))]
        vals = host_read(torch.stack(sums)).tolist()
        out = []
        for d in range(N):
            pres, visc = vals[2 * d], vals[2 * d + 1]
            out.append((pres, visc) if parts else pres + visc)
        return tuple(out)

    def interface_force(self, x=None, parts=False):
        """Traction integral on the embedded boundary only: the H-column
        parts of the viscous and pressure operators, F_d = Σ [ Iμ Hᵀ Wꜝ (G
        uω_d + H uγ_d) + Hᵖ_d p ] with Hᵖ_d p = A^p_d ∂_d p − ∂_d(B^p_d p).
        Sign: the force ON the fluid; the drag on the body is its
        negative."""
        x = x if x is not None else self.x
        out = self.interface_force_traced(x, parts=parts)
        flat = [v for item in out for v in (item if parts else (item,))]
        vals = host_read(torch.stack(flat)).tolist()
        if parts:
            return tuple((vals[2 * d], vals[2 * d + 1])
                         for d in range(self.N))
        return tuple(vals)

    def interface_force_traced(self, x, parts=False):
        """:meth:`interface_force` as 0-d tensors on the device, with no
        read on the host (a per-step force series)."""
        N = self.N
        p = x[2 * N]
        opp = self.fluid.operator_p
        out = []
        for d in range(N):
            ops = self.fluid.operator_u[d]
            q = ops.flux(x[2 * d], x[2 * d + 1])
            visc = torch.sum(self.mu_diag[d] * ops.HT(q))
            Hp = (opp.A[d] * dm(p, d, opp._per(d))
                  - dm(opp.B[d] * p, d, opp._per(d)))
            pres = torch.sum(Hp)
            out.append((pres, visc) if parts else pres + visc)
        return tuple(out)

    def drag_lift_coefficients(self, u_ref=1.0, l_ref=1.0, x=None,
                               interface_only=False):
        """C_d, C_l = 2 |F| / (ρ u_ref² l_ref).  ``interface_only=True``
        uses :meth:`interface_force` (body only)."""
        rho = self.fluid.rho
        rho_val = 1.0 if callable(rho) else float(rho)
        F = (self.interface_force(x) if interface_only
             else self.force_diagnostics(x))
        scale = 0.5 * rho_val * u_ref**2 * l_ref
        return tuple(f / scale for f in F)

    # ------------------------------------------------------------------
    # block (Schur-complement) preconditioner: an approximate block-LDU
    # inverse of the saddle point [A G; Gᵀ 0]:
    #   y   = Â⁻¹ r_u                (Â: the momentum block's Jacobi
    #                                 diagonal, or inner CG sweeps)
    #   s   = r_p − Gᵀ y − (uγ terms)
    #   z_p = −Ŝ⁻¹ s                 (Ŝ = Gᵀ Â⁻¹ G, the pressure Poisson
    #                                 operator: Chebyshev on its Jacobi-
    #                                 scaled form, inner PCG, or the
    #                                 pressure mass matrix)
    #   z_u = y − Â⁻¹ G z_p
    # The reference factorizes the saddle point with UMFPACK instead.
    # ------------------------------------------------------------------
    def make_block_preconditioner(self, dt=None, theta=1.0, cheb_iters=20,
                                  lmin=None, lmax=None, conv_diag=None,
                                  schur="cheb", schur_cg_iters=25,
                                  mom="jacobi", mom_cg_iters=8, _rank=None):
        """Returns ``M(r) -> z`` approximating the inverse of the (unsteady
        if ``dt`` given) Stokes operator.  ``conv_diag``: extra per-component
        momentum diagonal (Picard convection).

        ``schur``: "cheb" (Chebyshev on the Jacobi-scaled pressure Schur
        complement, linear in r), "cg" (``schur_cg_iters`` Jacobi-PCG
        sweeps), "dct_cg" (PCG with a constant-coefficient DCT-II Poisson
        surrogate as its preconditioner) or "mass" (μ times the inverse
        pressure mass matrix).  ``mom``: "jacobi" (the momentum diagonal),
        "cg" (``mom_cg_iters`` Jacobi-PCG sweeps on the masked SPD viscous
        block) or "cg_dst" (PCG with a DST-I surrogate).  The inner CG
        variants are NONLINEAR preconditioners: use them under a flexible
        outer method (``linsolve.fgmres``) only.  Every inner loop runs its
        fixed count with guarded divisions and reads nothing on the host.

        ``lmin``/``lmax`` bound the spectrum of the Jacobi-scaled pressure
        Schur complement for the Chebyshev; ``None`` estimates them by
        power iteration, and the Chebyshev depth then follows their ratio
        (one read on the host per build).

        ``_rank`` (private, ``parallel.sharding``): the M of one rank of a
        decomposed solve, built on a windowed view; it takes and returns the
        rank's blocks (see :class:`_WholeGrid`).  Only ``mom="jacobi"``."""
        N = self.N
        like = self._like
        rk = _WholeGrid(self.fluid.capacity_p.V.shape) if _rank is None \
            else _rank
        if _rank is not None and mom != "jacobi":
            raise ValueError("a rank's block preconditioner takes "
                             "mom='jacobi' only")
        diag_mom, dinv = [], []
        for d in range(N):
            ops = self.fluid.operator_u[d]
            dm_ = theta * self.mu_diag[d] * _diag_GtWG(ops)
            if dt is not None:
                dm_ = dm_ + self.rho_diag[d] * ops.V / dt
            if conv_diag is not None:
                dm_ = dm_ + conv_diag[d]
            dm_ = torch.where(self.u_active[d], dm_, 1.0)
            for item in self.borders[d].items:
                dm_ = torch.where(item[5], 1.0, dm_)
            if self._ghost[d] is not None:
                # ghost cut rows are unit-diagonal interpolation rows
                dm_ = torch.where(self._ghost[d]["gmask"], 1.0, dm_)
            dm_ = rk.fresh(torch.where(dm_ == 0.0, 1.0, dm_))
            diag_mom.append(dm_)
            dinv.append(1.0 / dm_)

        opp = self.fluid.operator_p
        coeff = tuple(opp.A[d] ** 2 * dinv[d] for d in range(N))
        dLp = 0.0
        for d in range(N):
            dLp = dLp + coeff[d] + _shift_p(coeff[d], d)
        dLp = torch.where(self.p_active, dLp, 1.0)
        dLp = rk.fresh(torch.where(dLp == 0.0, 1.0, dLp))
        dLp_inv = 1.0 / dLp

        def Lp_here(p):
            # Lp on the fields as they are: on a rank's window, exact on
            # the cells ``depth`` sweeps away from a renewed halo
            pa = torch.where(self.p_active, p, 0.0)
            out = 0.0
            for d in range(N):
                per = opp._per(d)
                out = out + dm_t(coeff[d] * dm(pa, d, per), d, per)
            return torch.where(self.p_active, out, p)

        def Lp(p):
            return Lp_here(rk.fresh(p))

        mask = self.p_active
        m_act = mask.to(like["dtype"])
        nact = torch.clamp_min(rk.sum(m_act)[0], 1.0)

        def _mean(p):
            return rk.sum(torch.where(mask, p, 0.0))[0] / nact

        def _deflate(p, mean=None):
            # remove the gauge constant mode over the active set (Lp's
            # null space)
            mean = _mean(p) if mean is None else mean
            return torch.where(mask, p - mean, 0.0)

        if lmin is None or lmax is None:
            # spectrum bounds of D⁻¹Lp on the active set by power iteration,
            # from a deterministic start with an index modulation
            mod = 0.0
            for d in range(N):
                shp = [1] * mask.ndim
                shp[d] = mask.shape[d]
                mod = mod + rk.index(d, **like).reshape(shp) * (d + 1.3)
            v = _deflate(torch.where(mask, 1.0 + torch.sin(mod), 0.0))

            def scaled(p):
                return torch.where(mask, dLp_inv * Lp(p), 0.0)

            def _power(op, v0, iters=16):
                vk = v0 / torch.clamp_min(rk.dot_norm(v0, v0)[1], 1e-300)
                lam = None
                for _ in range(iters):
                    w = _deflate(op(vk))
                    # two independent sums: one reduction on a rank
                    lam, nw = rk.dot_norm(vk, w)
                    vk = w / torch.clamp_min(nw, 1e-300)
                return lam

            lmax_e = _power(scaled, v)
            lmax_eff = 1.05 * torch.clamp_min(lmax_e, 1e-8)
            # smallest deflated eigenvalue via the shifted operator
            mu = _power(lambda p: lmax_eff * torch.where(mask, p, 0.0)
                        - scaled(p), v)
            lmin_e = lmax_eff - mu
            if lmax is None:
                lmax = lmax_eff
            if lmin is None:
                # power iteration approaches the smallest eigenvalue from
                # above: halve it for safety
                lmin = torch.minimum(torch.maximum(0.5 * lmin_e,
                                                   1e-4 * lmax_eff),
                                     0.5 * lmax_eff)

        # deepen the sweep to the spectral width (JAX reads the concrete
        # bounds outside a trace; every caller builds M outside one)
        if isinstance(lmax, torch.Tensor) or isinstance(lmin, torch.Tensor):
            pair = torch.stack([torch.as_tensor(v, **like)
                                for v in (lmax, lmin)])
            lmax_f, lmin_f = (float(v) for v in host_read(pair))
        else:
            lmax_f, lmin_f = float(lmax), float(lmin)
        ratio_f = lmax_f / max(lmin_f, 1e-30)
        cheb_iters = int(min(max(1.6 * np.sqrt(ratio_f), cheb_iters), 48))

        self._schur_bounds = (lmin, lmax, cheb_iters)  # diagnostics
        th_c = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma = th_c / delta

        if schur == "dct_cg":
            # constant-coefficient DCT-II Poisson surrogate of Lp as the
            # inner-CG preconditioner: exact for the uniform Neumann
            # Laplacian that Lp is away from the cut region and borders, so
            # the inner count is O(1) in mesh size.  The DCT is a matmul
            # with C[k,j] = s_k cos(pi (j+1/2) k / n) (ortho), inverse Cᵀ
            # the whole grid's slots less its last (padding) slot per axis
            ncell = tuple(s_ - 1 for s_ in rk.shape)
            ks = [rk.core_index(d, ncell[d], **like) for d in range(N)]
            wbars = rk.sum(*(coeff[d] * m_act for d in range(N)))
            lam = torch.zeros(tuple(len(k) for k in ks), **like)
            origin = torch.ones(lam.shape, dtype=torch.bool,
                                device=like["device"])
            for d in range(N):
                wbar = wbars[d] / nact
                shp = [1] * N
                shp[d] = len(ks[d])
                lam = lam + wbar * 2.0 * (
                    1.0 - torch.cos(math.pi * ks[d] / ncell[d])).reshape(shp)
                origin = origin & (ks[d] == 0).reshape(shp)
            lam = torch.where(lam <= 0.0, 1.0, lam)  # zero mode: deflated
            core = rk.core(ncell)
            Cmats = [_dct2_matrix(ncell[d], **like) for d in range(N)]

            def dct_inv(s):
                sc = s[core]
                for d in range(N):
                    sc = rk.along(Cmats[d], sc, d)        # DCT-II
                sc = sc / lam
                sc = torch.where(origin, 0.0, sc)
                for d in range(N):
                    sc = rk.along(Cmats[d].T, sc, d)      # DCT-III (inverse)
                return _deflate(rk.pad_core(sc, s.shape))

            inner_prec = dct_inv
        elif schur == "mass":
            # a viscous-dominated steady Schur complement is spectrally
            # equivalent to the (1/μ)-scaled pressure mass matrix
            # (Elman-Silvester-Wathen): Ŝ⁻¹ = μ Mp⁻¹
            mu_p = self.fluid.mu
            mu_p_val = 1.0 if callable(mu_p) else float(mu_p)
            Vp = self.fluid.operator_p.V
            Vp_inv = torch.where(mask & (Vp > 0.0), 1.0 / torch.where(
                Vp > 0.0, Vp, 1.0), 0.0)

            def inner_prec(r):
                return mu_p_val * Vp_inv * r
        else:
            def inner_prec(r):
                return dLp_inv * r

        def schur_cg(bp):
            """~Lp⁻¹ bp by ``schur_cg_iters`` PCG steps on the deflated
            active set (nonlinear in bp); needs no spectral bounds."""
            r = bp
            x = torch.zeros_like(bp)
            z = inner_prec(r)
            p_ = z
            rz = rk.sum(r * z)[0]
            for _ in range(schur_cg_iters):
                Ap_ = _deflate(Lp(p_))
                pAp = rk.sum(p_ * Ap_)[0]
                alpha = rz / torch.where(pAp <= 0.0, 1.0, pAp)
                alpha = torch.where(pAp <= 0.0, 0.0, alpha)
                x = x + alpha * p_
                r = r - alpha * Ap_
                z = inner_prec(r)
                rz_new = rk.sum(r * z)[0]
                beta = rz_new / torch.where(rz == 0.0, 1.0, rz)
                beta = torch.where(rz == 0.0, 0.0, beta)
                rz = rz_new
                p_ = z + beta * p_
            return x

        def cheb(bp):
            """~Lp⁻¹ bp by Chebyshev on the Jacobi-scaled operator (linear
            in bp; spectrum of D⁻¹Lp assumed in [lmin, lmax])."""
            x = torch.zeros_like(bp)
            r = dLp_inv * bp
            dvec = r / th_c
            rho = 1.0 / sigma
            for k in range(cheb_iters):
                if k % rk.depth == 0:
                    # no reduction in the sweep: on a rank, one renewed halo
                    # of (r, dvec) carries ``depth`` sweeps
                    r, dvec = rk.fresh((r, dvec))
                x = x + dvec
                r = r - dLp_inv * Lp_here(dvec)
                rho_new = 1.0 / (2.0 * sigma - rho)
                dvec = rho_new * rho * dvec + (2.0 * rho_new / delta) * r
                rho = rho_new
            return x

        if mom in ("cg", "cg_dst"):
            mom_solvers = [self._mom_cg(d, dt, theta, conv_diag, dinv[d],
                                        mom, mom_cg_iters)
                           for d in range(N)]

            def mom_solve(d, rb):
                return mom_solvers[d](rb)
        else:
            def mom_solve(d, rb):
                return dinv[d] * rb

        solve_s = (inner_prec if schur == "mass"
                   else schur_cg if schur in ("cg", "dct_cg") else cheb)
        lmax_floor = (torch.clamp_min(lmax, 1e-30)
                      if isinstance(lmax, torch.Tensor) else max(lmax, 1e-30))

        def M(r):
            r = rk.grow(r)
            rws = r[0:2 * N:2]
            rgs = r[1:2 * N:2]
            rp = r[2 * N]
            y = tuple(mom_solve(d, rws[d]) for d in range(N))
            zg = rgs
            s = rp - self._div(y, zg)
            s = torch.where(self.p_active, s, 0.0)
            if self.pin_mask is not None:
                s = torch.where(self.pin_mask, 0.0, s)
            if self.outflow_p_mask is not None:
                s = torch.where(self.outflow_p_mask, 0.0, s)
            # Lp's constant null mode goes through a bounded identity, not
            # the Chebyshev (which would amplify it); the pin/gauge rows
            # own the level anyway
            mean_s = _mean(s)
            zp = -(solve_s(_deflate(s, mean_s))
                   + (mean_s / lmax_floor) * m_act)
            zp = torch.where(self.p_active, zp, rp)
            if self.pin_mask is not None:
                zp = torch.where(self.pin_mask, rp, zp)
            if self.outflow_p_mask is not None:
                zp = torch.where(self.outflow_p_mask, rp, zp)
            out = []
            zp_h = rk.fresh(zp)
            for d in range(N):
                zw = y[d] - mom_solve(d, self._grad(d, zp_h))
                zw = torch.where(self.u_active[d], zw, rws[d])
                for item in self.borders[d].items:
                    zw = torch.where(item[5], rws[d], zw)
                out += [zw, zg[d]]
            return rk.crop(tuple(out) + (zp,))

        M.mom_solve = mom_solve  # diagnostics / tests
        M.schur_solve = solve_s
        return M

    def _mom_cg(self, d, dt, theta, conv_diag, dinv_d, mom, iters):
        """``rb -> ~A_d⁻¹ rb``: ``iters`` PCG sweeps on the masked SPD
        viscous block of component d (inactive, border and ghost rows and
        columns zeroed), preconditioned by its Jacobi diagonal (``"cg"``)
        or by a constant-coefficient DST-I surrogate (``"cg_dst"``)."""
        like = self._like
        N = self.N
        idm = self.u_active[d].to(like["dtype"])
        for item in self.borders[d].items:
            idm = torch.where(item[5], 0.0, idm)
        if self._ghost[d] is not None:
            idm = torch.where(self._ghost[d]["gmask"], 0.0, idm)
        act_d = idm > 0.5
        extra = torch.zeros_like(idm)
        if dt is not None:
            extra = extra + (self.rho_diag[d]
                             * self.fluid.operator_u[d].V / dt)
        if conv_diag is not None:
            extra = extra + conv_diag[d]

        if mom == "cg_dst":
            # DST-I (homogeneous Dirichlet) surrogate of the masked viscous
            # block, with per-axis coefficients from the active mean of
            # the interior stencil weight μ B_a² Wꜝ_a (anisotropy-correct)
            ops_d = self.fluid.operator_u[d]
            m_act = act_d.to(like["dtype"])
            nact_d = torch.clamp_min(torch.sum(m_act), 1.0)
            ncell_d = tuple(s_ - 1 for s_ in act_d.shape)
            lam_m = torch.zeros(ncell_d, **like)
            for a in range(N):
                wa = (theta * self.mu_diag[d] * ops_d.B[a] ** 2
                      * ops_d.Wdag[a])
                wbar = torch.sum(wa * m_act) / nact_d
                k = torch.arange(ncell_d[a], **like)
                shp = [1] * N
                shp[a] = ncell_d[a]
                lam_m = lam_m + wbar * 2.0 * (
                    1.0 - torch.cos(math.pi * (k + 1.0)
                                    / (ncell_d[a] + 1))).reshape(shp)
            lam_m = lam_m + torch.sum(extra * m_act) / nact_d
            lam_m = torch.where(lam_m <= 0.0, 1.0, lam_m)
            Smats = []
            for a in range(N):
                na = ncell_d[a]
                jj = np.arange(na)
                kk = np.arange(na)[:, None]
                Sa = (np.sin(np.pi * (jj[None, :] + 1.0) * (kk + 1.0)
                             / (na + 1)) * np.sqrt(2.0 / (na + 1)))
                Smats.append(torch.as_tensor(Sa, **like))
            core_d = tuple(slice(0, nc) for nc in ncell_d)

            def prec(r_):
                rc = r_[core_d]
                for a in range(N):
                    rc = _along(Smats[a], rc, a)  # DST-I is its own inverse
                rc = rc / lam_m
                for a in range(N):
                    rc = _along(Smats[a], rc, a)
                return torch.where(act_d, _pad_core(rc, r_.shape), 0.0)
        else:
            def prec(r_):
                return torch.where(act_d, dinv_d * r_, 0.0)

        def Aop(u):
            # masked SPD viscous (+ diagonal mass/convection) block
            um = torch.where(act_d, u, 0.0)
            y = theta * self._visc(d, um, torch.zeros_like(um)) + extra * um
            return torch.where(act_d, y, 0.0)

        def solve(rb):
            b_ = torch.where(act_d, rb, 0.0)
            x = torch.zeros_like(b_)
            r_ = b_
            z = prec(r_)
            p_ = z
            rz = _vdot(r_, z)
            for _ in range(iters):
                Ap_ = Aop(p_)
                pAp = _vdot(p_, Ap_)
                alpha = rz / torch.where(pAp <= 0.0, 1.0, pAp)
                alpha = torch.where(pAp <= 0.0, 0.0, alpha)
                x = x + alpha * p_
                r_ = r_ - alpha * Ap_
                z = prec(r_)
                rz_new = _vdot(r_, z)
                beta = rz_new / torch.where(rz == 0.0, 1.0, rz)
                beta = torch.where(rz == 0.0, 0.0, beta)
                rz = rz_new
                p_ = z + beta * p_
            return torch.where(act_d, x, rb)

        return solve

    def solve(self, method="auto", tol=1e-10, maxiter=None, x0=None,
              restart=100):
        """Steady solve.  ``auto``: dense LU for systems of at most 12,000
        unknowns, else block-Schur-preconditioned GMRES (``schur_gmres``);
        ``schur_bicgstab``; or any :func:`~penguin_tpu_torch.linsolve.
        solve_linear` method.  The Krylov paths set ``krylov_iters`` and
        ``krylov_relres``."""
        b = self.rhs_steady()
        if method == "auto":
            nflat = sum(u.numel() for u in b)
            method = "direct" if nflat <= 12000 else "schur_gmres"
        if method in ("schur_gmres", "schur_bicgstab"):
            M = self.make_block_preconditioner(dt=None, theta=1.0)
            x0_ = x0 if x0 is not None else self.zero_state()
            if method == "schur_gmres":
                x, its, rr = pgmres(self.apply_steady, b, x0_, Minv=M,
                                    tol=tol, maxiter=maxiter or 2000,
                                    restart=restart)
            else:
                x, its, rr = pbicgstab(self.apply_steady, b, x0_, Minv=M,
                                       tol=tol, maxiter=maxiter or 2000)
            self.x = x
            self.krylov_iters = int(its)
            self.krylov_relres = float(host_read(rr) if isinstance(
                rr, torch.Tensor) else rr)
            return self.x
        self.x = solve_linear(self.apply_steady, b, method=method, tol=tol,
                              maxiter=maxiter)
        return self.x

    def solve_unsteady(self, dt, t_end, scheme="CN", method="auto",
                       x0=None, tol=1e-10, maxiter=None):
        """θ-scheme steps (``CN``: θ = 1/2, else backward Euler) from ``x0``
        (default zero) over ``ceil(t_end/dt)`` steps, the k-th from t = k·dt.
        ``method``: ``direct`` (one LU, reused), ``pbicgstab`` with the
        block-Schur preconditioner and per-step telemetry
        (``krylov_iters``/``krylov_relres``), ``pgmres`` (the preconditioned
        JAX-batched ``linsolve.gmres``) or ``gmres``; ``auto``: direct up
        to 12,000 unknowns, else pbicgstab."""
        theta = 0.5 if scheme in ("CN", "cn") else 1.0
        apply_fn = self.make_unsteady_apply(dt, theta)
        rhs_fn = self.make_unsteady_rhs(dt, theta)
        x = x0 if x0 is not None else self.zero_state()
        n_steps = int(np.ceil(t_end / dt - 1e-12))
        nflat = sum(u.numel() for u in x)
        if method == "auto":
            method = "direct" if nflat <= 12000 else "pbicgstab"
        telemetry = method == "pbicgstab"
        if method == "direct":
            factor = DenseFactorSolver(apply_fn, x)

            def step(xc, t):
                return factor.solve(rhs_fn(xc, t, t + dt))
        elif telemetry:
            M = self.make_block_preconditioner(dt=dt, theta=theta)

            def step(xc, t):
                return pbicgstab(apply_fn, rhs_fn(xc, t, t + dt), xc,
                                 Minv=M, tol=tol, maxiter=maxiter or 400)
        else:
            M = (self.make_block_preconditioner(dt=dt, theta=theta)
                 if method == "pgmres" else None)

            def step(xc, t):
                return gmres(apply_fn, rhs_fn(xc, t, t + dt), x0=xc, tol=tol,
                             maxiter=maxiter or 2000, M=M)[0]

        iters, res = [], []
        for k in range(n_steps):
            t = k * dt
            if telemetry:
                x, it, rr = step(x, t)
                iters.append(it)
                res.append(rr)
            else:
                x = step(x, t)
        self.x = x
        if telemetry:
            self._store_logs(iters, res)
        return self.x

    def _store_logs(self, iters, rels, record=None, recs=()):
        """``krylov_iters``/``krylov_relres`` (unless ``iters`` is None)
        and ``record_log`` (when a ``record`` was given) from the per-step
        values, with one host read after the loop."""
        telemetry = iters is not None
        # pbicgstab's relres is a device tensor, the GMRES ones host floats
        dev_rel = telemetry and bool(rels) and isinstance(rels[0],
                                                          torch.Tensor)
        n = max(len(rels), len(recs))
        steps = [([rels[k]] if dev_rel else [])
                 + (_leaves(recs[k]) if recs else []) for k in range(n)]
        cols = _read_steps(steps) if n and steps[0] else []
        if telemetry:
            self.krylov_iters = np.asarray(iters, dtype=np.int64)
            self.krylov_relres = (cols[0] if dev_rel else
                                  np.asarray(rels, dtype=np.float64))
        if record is not None:
            self.record_log = (_unflatten(recs[0], iter(cols[int(dev_rel):]))
                               if recs else None)

    # views
    def velocity(self, d, gamma=False):
        return self.x[2 * d + (1 if gamma else 0)]

    @property
    def pressure(self):
        return self.x[2 * self.N]

"""Plain reference for the DFG channel cells: the cut-cell Navier-Stokes
Picard stepper, assembled as sparse matrices and solved exactly.

From a configuration (channel, cylinder, fluid, boundary data), a traffic
mix (time step, scheme, sweeps, episode length) and a run's inputs (only the
seeded ``probe`` of ``perfbench/traffic.py``) it works out, by default in
float64:

- the cut-cell capacities of the three staggered meshes (the x-velocity,
  y-velocity and pressure meshes, their origins shifted by -h/2 so the walls
  lie on the channel's edges): ``V``, ``A[d]``, ``B[d]``, ``W[d]``, the
  centroids ``C``, the wet centroid-line centroids ``Bm[d]`` and wet-face
  centroids ``Am[d]``, with the dense quadrature of ``quadrature.py`` (a
  frozen copy);
- the Stokes blocks of every velocity component d, as sparse matrices on the
  padded grid (state ``(uω_0, uγ_0, uω_1, uγ_1, p)``, p the negated physical
  pressure)::

      visc_d = μ Σ_a P_aᵀ Dm_aᵀ W_a⁻¹ (Dm_a P_a uω_d + (A_a Dm_a − Dm_a B_a) uγ_d)
      grad_d = −(A^p_d + Y_dᵀ) Dm_d p
      div    = Σ_d −Dm_dᵀ (A^p_d + Y_d) uω_d + (Dm_dᵀ A^p_d − B^p_d Dm_dᵀ) uγ_d

  with ``P_a = B_a + X_a`` the moment-consistent cut flux: ``X_a`` samples
  the transverse offset of the wet line's centroid, ``B_a (Bm_a − C)``, as a
  least-squares gradient over the wet face-neighbours at their centroid
  offsets, and ``Y_d`` the same for the wet pressure face's centroid against
  the velocity DOF, ``A^p_d (Am^p_d − C^{u_d})``, on cut faces;
- the Picard-linearised convection at a state ``u_k``::

      C_d(u_k) q = Dp_d(Sm_d(A_d u_k,d) Sm_d q) + Σ_{j≠d} Dp_j(Sm_d(A_j u_k,j) Sm_j q)
                   − ½ Sp_d(Hᵀ(uγ_k)) q

  whose last live plane at the outflow takes the one-sided difference
  ``g − g[−1]`` of the flux ``g`` in place of ``Dp``;
- the rows: momentum ``ρV/dt + θ visc + θρ C(u_k)`` with ``grad``, identity
  on inactive DOFs (no wet volume and no wet line); the tie rows ``uγ = 0``
  on the cylinder; ghost wall rows ``1.5 u₀ − 0.5 u₁ = 0`` (tangential) and
  ``2 u_{n−1} − u_{n−2} = 0`` (normal, high side) at the walls, the
  parabolic profile on the inflow plane, the normal velocity's momentum row
  kept at the outflow; continuity on the active pressure DOFs (wet, and
  fed by a live momentum row), identity elsewhere, and the pressure pinned
  to 0 on the last active plane before the outflow (and one cell of any
  region that plane does not reach).

It solves the steady Stokes start (``stokes_start``, also the program's
initial state) and then every Picard sweep of
``episode_steps`` θ-steps (two sweeps a step; CN puts ``(1−θ)`` of the
viscous and convective terms of the previous state on the right-hand side)
exactly: a sparse LU (``scipy.sparse.linalg.splu``) of the assembled matrix
on the host, its identity rows eliminated first.  No Krylov method and no
preconditioner.  It imports nothing of the program and takes nothing the
program made.

Departures from Penguin.jl's ``flow_around_circle_cd_cl.jl``, all the port's
formulation as the configuration runs it: the ghost wall rows and the
moment-consistent cut flux (Penguin.jl samples the wall and the cut flux at
the cell centroids); the implicit-Picard CN step (Penguin.jl's is CN with
Adams-Bashforth convection); the outflow pressure plane in place of a pinned
cell; the Γ-placement corrections of the moment flux vanish for a no-slip
cylinder (its boundary value is 0 everywhere), so none is assembled.

``precision=CONTROL[dtype]`` gives the control: each stage computed with
every array in the precision below the configuration's (float32 for
float64) from the float64 result of the stage before it: the capacities
from the mesh, the operator and the steps (Stokes start included, its LU in
that precision) from the float64 capacities.  The thresholds of the method
stay the configuration's.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.ndimage
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

from perfbench.reference.quadrature import box_integrals

# the control's precision: the nearest below the configuration's
CONTROL = {torch.float64: torch.float32, torch.float32: torch.bfloat16}

FACE_GATE_REL = 1e-3  # relative volume at which a face starts to close
CARRIER_REL = 1e-10   # aperture-divergence threshold of an interface cell
SLIVER = 1e-2         # a capacity below this share of its full measure
                      # amplifies the rounding of its quadrature
REACH = 3             # cells an operator row reaches through its capacities


def empty_rel(dtype):
    """The share of a full cell below which a cell counts as empty."""
    return 1e-10 if dtype == torch.float64 else 2e-5


def probe_blocks(probe, shape):
    """Five distinct ``shape`` blocks of the square ``probe``: its left and
    right column bands, those of its transpose, and the left band of its
    row-reversed copy."""
    a, c = shape
    if probe.shape[0] != a or c > a:
        raise ValueError(f"probe {tuple(probe.shape)} cannot give {shape}")
    t = probe.T
    return (probe[:, :c].contiguous(), probe[:, a - c:].contiguous(),
            t[:, :c].contiguous(), t[:, a - c:].contiguous(),
            probe.flip(0)[:, :c].contiguous())


# ---------------------------------------------------------------------------
# meshes and capacities
# ---------------------------------------------------------------------------

def meshes(config):
    """Per mesh (ux, uy, p): its node arrays (cell i spans node i to node
    i + 1; node k = x0 + (k + 1/2) h) as float64 numpy."""
    n = [int(v) for v in config["grid"]]
    L = [float(v) for v in config["domain"]]
    h = [L[d] / n[d] for d in range(2)]
    shifts = {"ux": (-h[0], -0.5 * h[1]), "uy": (-0.5 * h[0], -h[1]),
              "p": (-0.5 * h[0], -0.5 * h[1])}
    return {m: [x0 + (np.arange(n[d] + 1) + 0.5) * h[d]
                for d, x0 in enumerate(shifts[m])] for m in shifts}


def body(config):
    """Signed distance, negative in the fluid: outside the cylinder."""
    cx, cy = (float(c) for c in config["cylinder"])
    radius = float(config["radius"])

    def phi(x, y):
        return radius - torch.sqrt((x - cx) ** 2 + (y - cy) ** 2)

    return phi


def _pad(x, shape):
    flat = []
    for d in reversed(range(x.dim())):
        flat += [0, shape[d] - x.shape[d]]
    return torch.nn.functional.pad(x, flat)


def _along(v, d):
    return v.reshape([-1, 1] if d == 0 else [1, -1])


def capacities(phi, nodes, p, s, eps):
    """``dict(V, A, B, W, C, Am, Bm, cut, raw)`` of one 2D mesh on its padded
    grid, in the nodes' dtype: torch tensors, vectors with a last axis of 2."""
    N = 2
    n = tuple(v.numel() - 1 for v in nodes)
    shape = tuple(k + 1 for k in n)
    dtype = nodes[0].dtype
    tiny = torch.finfo(dtype).tiny
    eps_rel = 1e-12 if dtype == torch.float64 else 1e-5
    lo = [_along(nodes[d][:-1], d) for d in range(N)]
    hi = [_along(nodes[d][1:], d) for d in range(N)]
    full = (hi[0] - lo[0]) * (hi[1] - lo[1])

    V, moms = box_integrals(phi, lo, hi, p=p, s=s)
    raw = V
    empty = V <= eps * full
    whole = V >= (1.0 - eps) * full
    cut = ~empty & ~whole
    V = torch.where(empty, 0.0, torch.where(whole, full.expand(n), V))
    centre = [(0.5 * (lo[d] + hi[d])).expand(n) for d in range(N)]
    Vsafe = torch.clamp_min(V, 1e-300)
    C = [torch.where(cut, moms[d] / Vsafe, centre[d]) for d in range(N)]

    t = torch.clamp(V / (FACE_GATE_REL * full.expand(n)), 0.0, 1.0)
    gate = t * t * (3.0 - 2.0 * t)

    def cross(d, coord):
        """phi on the line or face through ``coord`` normal to axis d."""
        if d == 0:
            return lambda y: phi(coord, y)
        return lambda x: phi(x, coord)

    A, Am, B, Bm = [], [], [], []
    for d in range(N):
        e = 1 - d
        face = _along(nodes[d], d)
        fshape = tuple(n[i] + 1 if i == d else n[i] for i in range(N))
        Ad, (mom,) = box_integrals(cross(d, face), [lo[e]], [hi[e]], p=p,
                                   s=s)
        meas = hi[e] - lo[e]
        cen = torch.where(Ad > eps_rel * meas,
                          mom / torch.clamp_min(Ad, tiny), 0.5 * (lo[e]
                                                                + hi[e]))
        cen = torch.clamp(cen, lo[e], hi[e]).expand(fshape)
        comps = [face.expand(fshape), cen] if d == 0 else \
            [cen, face.expand(fshape)]
        Am.append(torch.stack([_pad(c, shape) for c in comps], dim=-1))
        one = torch.ones([1, n[1]] if d == 0 else [n[0], 1], dtype=dtype,
                         device=V.device)
        below = torch.cat([one, gate.narrow(d, 0, n[d] - 1), one], dim=d)
        above = torch.cat([one, gate.narrow(d, 1, n[d] - 1), one], dim=d)
        A.append(_pad(Ad.expand(fshape) * below * above, shape))

        Bd, (mom,) = box_integrals(cross(d, C[d]), [lo[e]], [hi[e]], p=p,
                                   s=s)
        cen = torch.where(Bd > eps_rel * meas,
                          mom / torch.clamp_min(Bd, tiny), centre[e])
        cen = torch.clamp(cen, lo[e], hi[e]).expand(n)
        comps = [C[d].expand(n), cen] if d == 0 else [cen, C[d].expand(n)]
        Bm.append(torch.stack([_pad(c, shape) for c in comps], dim=-1))
        B.append(_pad(torch.where(empty, 0.0, Bd).expand(n), shape))

    W = []
    for d in range(N):
        m = n[d] - 1
        st_lo = [C[d].narrow(d, 0, m) if i == d
                 else lo[i].expand(n).narrow(d, 0, m) for i in range(N)]
        st_hi = [C[d].narrow(d, 1, m) if i == d
                 else hi[i].expand(n).narrow(d, 1, m) for i in range(N)]
        Wd, _ = box_integrals(phi, st_lo, st_hi, p=p, s=s)
        Wd = torch.nn.functional.pad(Wd, [0, 0, 1, 0] if d == 0 else [1, 0])
        W.append(_pad(Wd, shape))

    # interface cells: wherever the apertures do not balance
    S2 = 0.0
    face_meas = torch.zeros(n, dtype=dtype, device=V.device)
    cells = (slice(0, n[0]), slice(0, n[1]))
    for d in range(N):
        upper = tuple(slice(1, n[d] + 1) if i == d else slice(0, n[i])
                      for i in range(N))
        S2 = S2 + (A[d][cells] - A[d][upper]) ** 2
        face_meas = torch.maximum(face_meas,
                                  (full / (hi[d] - lo[d])).expand(n))
    cut = cut | (~empty & (S2 > (CARRIER_REL * face_meas) ** 2))
    return dict(V=_pad(V, shape), A=A, B=B, W=W,
                C=torch.stack([_pad(c.expand(n), shape) for c in C], dim=-1),
                Am=Am, Bm=Bm, cut=_pad(cut, shape), raw=_pad(raw, shape))


def all_capacities(config, dtype, device):
    """The three meshes' capacities, as torch tensors in ``dtype``."""
    quad = config["quadrature"]
    phi = body(config)
    eps = empty_rel(getattr(torch, config["dtype"]))
    return {m: capacities(phi, [torch.as_tensor(v, dtype=dtype,
                                                device=device)
                                for v in nodes],
                          int(quad["p"]), int(quad["s"]), eps)
            for m, nodes in meshes(config).items()}


# ---------------------------------------------------------------------------
# sparse building blocks on the padded grid (row-major flat index)
# ---------------------------------------------------------------------------

class Grid:
    def __init__(self, shape, dtype):
        self.shape, self.dtype = tuple(shape), dtype
        self.n = int(np.prod(shape))
        self.idx = np.arange(self.n).reshape(shape)
        self.I = sps.identity(self.n, dtype=dtype, format="csr")

    def D(self, v):
        return sps.diags(np.asarray(v, dtype=self.dtype).ravel(), 0,
                         format="csr")

    def shift(self, axis, k):
        """y[i] = x[i + k] along ``axis``, zero past the edge."""
        m = self.shape[axis]
        dst = [slice(None)] * 2
        src = [slice(None)] * 2
        dst[axis] = slice(max(0, -k), m - max(0, k))
        src[axis] = slice(max(0, k), m - max(0, -k))
        rows = self.idx[tuple(dst)].ravel()
        cols = self.idx[tuple(src)].ravel()
        return sps.csr_matrix((np.ones(rows.size, self.dtype), (rows, cols)),
                              shape=(self.n, self.n))

    def zlast(self, axis):
        keep = np.ones(self.shape, bool)
        sl = [slice(None)] * 2
        sl[axis] = -1
        keep[tuple(sl)] = False
        return self.D(keep)

    def Dm(self, a):
        """y[0] = x[0], y[k] = x[k] − x[k−1], y[last] = −x[last−1]."""
        return self.zlast(a) - self.shift(a, -1)

    def Dp(self, a):
        """y[k] = x[k+1] − x[k], y[last] = 0."""
        return self.zlast(a) @ (self.shift(a, 1) - self.I)

    def Sm(self, a):
        return 0.5 * (self.zlast(a) + self.shift(a, -1))

    def Sp(self, a):
        return 0.5 * self.zlast(a) @ (self.I + self.shift(a, 1))

    def stencil(self, w):
        """The matrix of shift-stencil weights ``(k0, ((wp_e, wm_e))_e)``."""
        k0, slots = w
        out = self.D(k0)
        for e, (wp, wm) in enumerate(slots):
            out = out + self.D(wp) @ self.shift(e, 1) \
                + self.D(wm) @ self.shift(e, -1)
        return out


def lsq_gradient(V, C, f64):
    """The per-cell weighted least-squares gradient over the wet
    face-neighbours at their full centroid offsets: returns
    ``weights(delta)``, the shift-stencil weights of ``delta · ∇x``.  Its
    regularisation and its test of a degenerate fit are the configuration
    dtype's (``f64``)."""
    dt = V.dtype
    tiny = np.finfo(dt).tiny
    wet = (V > 0).astype(dt)
    shape = V.shape

    def shifted(x, e, sgn):
        y = np.zeros_like(x)
        if sgn > 0:
            sl_d = [slice(None)] * 2
            sl_s = [slice(None)] * 2
            sl_d[e], sl_s[e] = slice(0, -1), slice(1, None)
        else:
            sl_d = [slice(None)] * 2
            sl_s = [slice(None)] * 2
            sl_d[e], sl_s[e] = slice(1, None), slice(0, -1)
        y[tuple(sl_d)] = x[tuple(sl_s)]
        return y

    slots = []
    S = np.zeros(shape + (2, 2), dt)
    for e in range(2):
        for sgn in (1, -1):
            m_i = shifted(wet, e, sgn)
            dC = np.stack([shifted(C[..., j], e, sgn) - C[..., j]
                           for j in range(2)], axis=-1) * m_i[..., None]
            d2 = np.sum(dC * dC, axis=-1)
            wgt = np.where(d2 > tiny, m_i / np.maximum(d2, tiny), 0.0
                           ).astype(dt)
            slots.append((e, sgn, dC, wgt))
            S = S + wgt[..., None, None] * dC[..., :, None] * dC[..., None, :]
    tr = S[..., 0, 0] + S[..., 1, 1]
    reg_rel, det_rel = (1e-10, 1e-8) if f64 else (1e-5, 1e-4)
    reg = (reg_rel * np.maximum(tr, tiny) + tiny)[..., None, None] \
        * np.eye(2, dtype=dt)
    with np.errstate(all="ignore"):
        Sinv = np.linalg.inv(S + reg)
    Sinv = np.where(np.isfinite(Sinv), Sinv, 0.0).astype(dt)
    det = S[..., 0, 0] * S[..., 1, 1] - S[..., 0, 1] * S[..., 1, 0]
    ok = (tr > tiny) & (det > (math.sqrt(det_rel) * np.maximum(tr, tiny)
                               / 2) ** 2)

    def weights(delta):
        dS = np.einsum("...j,...jk->...k", delta, Sinv)
        k0 = np.zeros(shape, dt)
        per = [[None, None] for _ in range(2)]
        for e, sgn, dC, wgt in slots:
            c = np.where(ok, np.einsum("...k,...k->...", dS, dC) * wgt, 0.0
                         ).astype(dt)
            k0 = k0 - c
            per[e][0 if sgn > 0 else 1] = c
        return k0, tuple((a, b) for a, b in per)

    return weights


# ---------------------------------------------------------------------------
# the system
# ---------------------------------------------------------------------------

def _np(cap, dtype):
    """A mesh's capacities as numpy arrays in ``dtype``."""
    to = lambda t: t.detach().cpu().numpy().astype(dtype)
    return dict(V=to(cap["V"]), A=[to(a) for a in cap["A"]],
                B=[to(b) for b in cap["B"]], W=[to(w) for w in cap["W"]],
                C=to(cap["C"]), Am=[to(a) for a in cap["Am"]],
                Bm=[to(b) for b in cap["Bm"]],
                cut=cap["cut"].cpu().numpy())


class System:
    """The rows of the DFG channel's Stokes and Picard systems, in the
    numpy dtype of the capacities it is given."""

    def __init__(self, caps, config, f64=True):
        ux, uy, cp = caps["ux"], caps["uy"], caps["p"]
        self.caps = (ux, uy)
        dt_ = ux["V"].dtype
        g = self.g = Grid(ux["V"].shape, dt_)
        self.dtype = dt_
        n = [int(v) for v in config["grid"]]
        L = [float(v) for v in config["domain"]]
        h = [L[d] / n[d] for d in range(2)]
        self.rho = float(config["rho"])
        self.mu = self.rho * float(config["nu"])
        self.u_max, self.height = float(config["u_max"]), L[1]

        # the moment-consistent cut flux of each velocity mesh
        self.P, self.visc_w, self.visc_g, self.active = [], [], [], []
        for d, cu in enumerate(self.caps):
            weights = lsq_gradient(cu["V"], cu["C"], f64)
            P, Vw, Vg = [], 0, 0
            for a in range(2):
                delta = np.zeros(cu["V"].shape + (2,), dt_)
                e = 1 - a
                delta[..., e] = np.where(cu["cut"], cu["Bm"][a][..., e]
                                         - cu["C"][..., e], 0.0)
                delta = delta * cu["B"][a][..., None]
                Pa = g.D(cu["B"][a]) + g.stencil(weights(delta))
                W = cu["W"][a]
                Wd = g.D(np.where(W != 0, 1.0 / np.where(W != 0, W, 1.0),
                                  1.0))
                Dm = g.Dm(a)
                Vw = Vw + Pa.T @ Dm.T @ Wd @ Dm @ Pa
                Vg = Vg + Pa.T @ Dm.T @ Wd @ (g.D(cu["A"][a]) @ Dm
                                              - Dm @ g.D(cu["B"][a]))
                P.append(Pa)
            self.visc_w.append(self.mu * Vw)
            self.visc_g.append(self.mu * Vg)
            self.active.append((cu["B"][0] != 0) | (cu["B"][1] != 0)
                               | (cu["V"] != 0))

        # pressure gradient and continuity, with the wet-face cross moment
        hmax = max(h)
        self.grad, self.div_w, self.div_g = [], [], []
        for d, cu in enumerate(self.caps):
            weights = lsq_gradient(cu["V"], cu["C"], f64)
            face_cut = cp["cut"] | cu["cut"]
            delta = np.clip(cp["Am"][d] - cu["C"], -hmax, hmax)
            delta = np.where(face_cut[..., None], delta, 0.0).astype(dt_)
            Y = g.stencil(weights(delta * cp["A"][d][..., None]))
            Dm = g.Dm(d)
            Ap = g.D(cp["A"][d])
            self.grad.append(-(Ap + Y.T) @ Dm)
            self.div_w.append(-Dm.T @ (Ap + Y))
            self.div_g.append(Dm.T @ Ap - g.D(cp["B"][d]) @ Dm.T)

        # border rows, in the order of their keys (bottom, left, right,
        # top): a later one overwrites a corner
        shape = ux["V"].shape
        self.items = []
        for d in range(2):
            for key, axis, side in (("bottom", 1, 0), ("left", 0, 0),
                                    ("right", 0, 1), ("top", 1, 1)):
                if d == 0 and key == "right":
                    continue          # outflow: the momentum row stays
                mask = np.zeros(shape, bool)
                sl = [slice(None)] * 2
                sl[axis] = 0 if side == 0 else n[axis] - 1
                mask[tuple(sl)] = True
                if axis != d:
                    coefs = (1.5, -0.5)
                elif side == 1:
                    coefs = (2.0, -1.0)
                else:
                    coefs = None
                nb = g.shift(axis, 1 if side == 0 else -1)
                row = g.I if coefs is None else coefs[0] * g.I + coefs[1] * nb
                inflow = d == 0 and key == "left"
                self.items.append((d, mask, row, inflow))

        # the outflow plane of the x-velocity's convection flux
        self.outlet = np.zeros(shape, bool)
        self.outlet[n[0] - 1, :] = True

        # active pressure DOFs: wet, and fed by a live momentum row
        p_act = (cp["B"][0] != 0) | (cp["B"][1] != 0) | (cp["V"] != 0)
        feeds = np.zeros(shape, bool)
        for d in range(2):
            live = self.active[d].copy()
            for dd, mask, _, _ in self.items:
                if dd == d:
                    live &= ~mask
            c = (cp["A"][d] != 0) & live
            up = np.zeros_like(c)
            if d == 0:
                up[:-1] = c[1:]
            else:
                up[:, :-1] = c[:, 1:]
            feeds |= c | up
        self.p_active = p_act & feeds
        # the pressure pinned on the last active plane before the outflow,
        # and at one cell of every region that plane does not reach
        pin = np.zeros(shape, bool)
        for i in range(n[0] - 1, -1, -1):
            if self.p_active[i].any():
                pin[i] = self.p_active[i]
                break
        lab, nlab = scipy.ndimage.label(self.p_active)
        reached = set(np.unique(lab[pin & (lab > 0)]).tolist())
        for comp in range(1, nlab + 1):
            if comp not in reached:
                cells = np.flatnonzero((lab == comp).ravel())
                pin.ravel()[cells[cells.size // 2]] = True
        self.pin = pin

        # DOF positions of the x-velocity's inflow plane
        ynodes = meshes(config)["ux"][1]
        self.inflow_y = np.broadcast_to(
            (ynodes + 0.5 * h[1])[None, :], shape)
        self.mass = [self.rho * cu["V"] for cu in self.caps]

    # --- convection at a state ----------------------------------------------
    def conv(self, d, uw, ug):
        """``C_d(u_k) − ½ K_d(uγ_k)`` as a matrix on component d's uω, and
        ``K_d``'s diagonal weights."""
        g, cu = self.g, self.caps[d]
        a = g.Sm(d) @ (cu["A"][d] * uw[d]).ravel()
        own = g.D(a) @ g.Sm(d)
        out = g.Dp(d) @ own
        if d == 0:
            repl = (g.I - g.shift(0, -1)) @ own
            keep = g.D(~self.outlet)
            out = keep @ out + g.D(self.outlet) @ repl
        for j in range(2):
            if j != d:
                fc = g.Sm(d) @ (cu["A"][j] * uw[j]).ravel()
                out = out + g.Dp(j) @ g.D(fc) @ g.Sm(j)
        # Hᵀ of the interface velocities, taken in the port's rotated
        # order: axis a carries component (d + a) mod 2
        ht = 0.0
        for a in range(2):
            q = ug[(d + a) % 2].ravel()
            Dm = g.Dm(a)
            ht = ht + Dm.T @ (cu["A"][a].ravel() * q) \
                - cu["B"][a].ravel() * (Dm.T @ q)
        K = g.Sp(d) @ ht
        return out, K

    # --- assembly --------------------------------------------------------------
    def matrix(self, dt=None, theta=1.0, state=None):
        """The Stokes rows (``dt`` None), or the unsteady rows with the
        Picard convection at ``state`` (a tuple of five 2D arrays)."""
        g = self.g
        Z = sps.csr_matrix((g.n, g.n), dtype=self.dtype)
        rows = []
        for d in range(2):
            uw_blocks = [Z] * 5
            Mw = (theta if dt is not None else 1.0) * self.visc_w[d]
            if dt is not None:
                Mw = Mw + g.D(self.mass[d] / dt)
            if state is not None:
                C, K = self.conv(d, (state[0], state[2]), (state[1],
                                                           state[3]))
                Mw = Mw + theta * self.rho * (C - 0.5 * g.D(K))
            uw_blocks[2 * d] = Mw
            uw_blocks[2 * d + 1] = (theta if dt is not None else 1.0) \
                * self.visc_g[d]
            uw_blocks[4] = self.grad[d]
            act = self.active[d].ravel()
            keep = g.D(act)
            uw_blocks = [keep @ b for b in uw_blocks]
            uw_blocks[2 * d] = uw_blocks[2 * d] + g.D(~act)
            ug_blocks = [Z] * 5
            ug_blocks[2 * d + 1] = g.I
            for dd, mask, row, _ in self.items:
                if dd != d:
                    continue
                m = mask.ravel()
                keep, put = g.D(~m), g.D(m)
                uw_blocks = [keep @ b for b in uw_blocks]
                uw_blocks[2 * d] = uw_blocks[2 * d] + put @ row
                ug_blocks = [keep @ b for b in ug_blocks]
                ug_blocks[2 * d + 1] = ug_blocks[2 * d + 1] + put
            rows += [uw_blocks, ug_blocks]
        pa = self.p_active.ravel() & ~self.pin.ravel()
        keep = g.D(pa)
        p_blocks = [keep @ self.div_w[0], keep @ self.div_g[0],
                    keep @ self.div_w[1], keep @ self.div_g[1], g.D(~pa)]
        rows.append(p_blocks)
        A = sps.bmat(rows, format="csr")
        A.eliminate_zeros()
        return A

    def _border_rhs(self, d, bw, bg):
        for dd, mask, _, inflow in self.items:
            if dd != d:
                continue
            val = 0.0
            if inflow:
                xi = self.inflow_y / self.height
                val = self.u_max * 4.0 * xi * (1.0 - xi)
            bw = np.where(mask, val, bw)
            bg = np.where(mask, val, bg)
        return bw, bg

    def rhs(self, dt=None, theta=1.0, state=None):
        """The right-hand side: Stokes (``dt`` None), else the θ-step's from
        the previous ``state``."""
        g = self.g
        out = []
        for d in range(2):
            bw = np.zeros(g.shape, self.dtype)
            if dt is not None:
                uw, ug = state[2 * d].ravel(), state[2 * d + 1].ravel()
                C, K = self.conv(d, (state[0], state[2]), (state[1],
                                                           state[3]))
                conv = C @ uw - K * uw
                b = (self.mass[d].ravel() / dt * uw
                     - (1 - theta) * (self.visc_w[d] @ uw
                                      + self.visc_g[d] @ ug)
                     - (1 - theta) * self.rho * conv)
                bw = np.where(self.active[d], b.reshape(g.shape), 0.0)
            bg = np.zeros(g.shape, self.dtype)
            bw, bg = self._border_rhs(d, bw, bg)
            out += [bw.astype(self.dtype), bg.astype(self.dtype)]
        out.append(np.zeros(g.shape, self.dtype))
        return out


def flat(state):
    return np.concatenate([np.asarray(s).ravel() for s in state])


def unflat(v, shape):
    n = int(np.prod(shape))
    return tuple(v[k * n:(k + 1) * n].reshape(shape) for k in range(5))


def solve(A, b):
    """``A⁻¹ b`` by sparse LU, the identity rows eliminated first."""
    A = A.tocsr()
    n = A.shape[0]
    count = np.diff(A.indptr)
    first = A.indices[np.minimum(A.indptr[:-1], max(A.indices.size - 1, 0))]
    ident = (count == 1) & (first == np.arange(n)) & (A.diagonal() == 1)
    free, fixed = np.flatnonzero(~ident), np.flatnonzero(ident)
    x = np.where(ident, b, 0).astype(b.dtype)
    rows = A[free]
    Aff = rows[:, free].tocsc()
    rhs = b[free] - rows[:, fixed] @ b[fixed]
    try:
        x[free] = spla.splu(Aff).solve(rhs)
    except RuntimeError as err:
        raise RuntimeError(f"reference LU failed: {err}") from err
    return x


def stokes_start(config, device):
    """The steady Stokes flow of the channel at full inflow, solved exactly:
    the start state of every episode, as five float64 numpy arrays.  The
    entry path hands it to the program as the run's initial state, as the
    generator hands a heat cell its ``T0``."""
    caps = all_capacities(config, torch.float64, device)
    system = System({m: _np(c, np.float64) for m, c in caps.items()}, config,
                    f64=getattr(torch, config["dtype"]) == torch.float64)
    return unflat(solve(system.matrix(), flat(system.rhs())), system.g.shape)


# ---------------------------------------------------------------------------
# the run's answers, and the comparison
# ---------------------------------------------------------------------------

def reference(config, traffic, inputs, device, precision=torch.float64):
    """The answers the program's run is judged against: ``capacity`` (V, A,
    B, W of the ux, uy and p meshes), ``operator`` (the Picard rows at the
    Stokes start on the probe blocks), ``scale`` (|A| on |probe|, row by
    row), ``field`` (the state after one episode), and what ``compare``
    weighs with: the masks, the last sweep's matrix and right-hand side."""
    if precision not in (torch.float64, torch.float32):
        raise ValueError(f"no sparse LU in {precision}")
    exact = precision == torch.float64
    npdt = np.float64 if exact else np.float32
    cap64 = all_capacities(config, torch.float64, device)
    answer = cap64 if exact else all_capacities(config, precision, device)
    system = System({m: _np(c, npdt) for m, c in cap64.items()}, config,
                    f64=getattr(torch, config["dtype"]) == torch.float64)
    dt = float(traffic["dt"])
    theta = 0.5 if traffic["scheme"] == "CN" else 1.0
    shape = system.g.shape

    x0 = solve(system.matrix(), flat(system.rhs()))
    start = unflat(x0, shape)
    probe = flat([b.detach().cpu().numpy().astype(npdt) for b in probe_blocks(
        inputs["probe"].to(torch.float64), shape)])
    A0 = system.matrix(dt, theta, start)
    y = A0 @ probe
    scale = abs(A0) @ np.abs(probe)

    x = start
    for _ in range(int(traffic["episode_steps"])):
        b = flat(system.rhs(dt, theta, x))
        x_it = x
        for _ in range(int(traffic["picard_iters"])):
            A = system.matrix(dt, theta, x_it)
            last = (A, b)
            x_it = unflat(solve(A, b), shape)
        x = x_it
    tens = lambda v: torch.as_tensor(np.ascontiguousarray(v))
    return dict(capacity=capacity_answer([answer[m] for m in ("ux", "uy",
                                                             "p")]),
                raw={m: cap64[m]["raw"] for m in cap64},
                operator=tuple(tens(v) for v in unflat(y, shape)),
                scale=unflat(scale, shape), field=tuple(tens(v) for v in x),
                last=last, system=system, caps64=cap64)


def capacity_answer(caps):
    """The capacities the check compares, of the ux, uy and p meshes in
    that order (dicts or objects with ``V``, ``A``, ``B``, ``W``): ``V``
    stacked into one tensor, ``A``, ``B``, ``W`` as tuples per mesh."""
    get = (lambda c, k: c[k]) if isinstance(caps[0], dict) else getattr
    out = {k: tuple(tuple(get(c, k)) for c in caps) for k in ("A", "B", "W")}
    out["V"] = torch.stack([get(c, "V") for c in caps])
    return out


def volume_gap(V, config):
    """|Σ V − |Ω|| / |Ω| of the pressure mesh (the last of ``V``) against the
    channel less the disk, a reading that shares nothing with the
    quadrature.  It reads the method's truncation error, which is the same
    in any precision, so it is not one of the numbers compared."""
    L = [float(v) for v in config["domain"]]
    exact = L[0] * L[1] - math.pi * float(config["radius"]) ** 2
    return abs(float(V[-1].double().sum()) - exact) / exact


def _dilate(mask, k=1):
    out = mask.copy()
    for _ in range(k):
        grown = out.copy()
        grown[1:] |= out[:-1]
        grown[:-1] |= out[1:]
        grown[:, 1:] |= out[:, :-1]
        grown[:, :-1] |= out[:, 1:]
        out = grown
    return out


def compared(ref, config):
    """Which entries the comparison reads, by rules on the reference's own
    float64 capacities (never on the program's):

    - ``capacity``: every cell and face but those within one cell of a
      cell whose volume lies within a factor 4 of the empty threshold;
    - ``operator``: rows at least ``REACH`` cells from any cell of any mesh
      whose V, B or W is short of its full measure: rows whose every
      coefficient is the matvec's own and not the capacity build's;
    - ``residual``: momentum rows that no sliver of their mesh touches (a
      nonzero V, B or W below ``SLIVER`` of its full measure, or a
      neighbour of one);
    - ``field``: active DOFs of at least ``SLIVER`` of a full volume, away
      from an undecided cell.
    """
    n = [int(v) for v in config["grid"]]
    L = [float(v) for v in config["domain"]]
    h = [L[d] / n[d] for d in range(2)]
    cell, face = h[0] * h[1], (h[1], h[0])
    eps = empty_rel(getattr(torch, config["dtype"]))
    undecided, decided, short, slivers, wide = {}, {}, None, {}, {}
    for m, cap in ref["caps64"].items():
        c = {k: (v.cpu().numpy() if torch.is_tensor(v)
                 else [t.cpu().numpy() for t in v])
             for k, v in cap.items() if k in ("V", "B", "W", "raw")}
        raw = c["raw"]
        undecided[m] = _dilate((raw >= eps / 4 * cell)
                               & (raw <= eps * 4 * cell))
        decided[m] = ~undecided[m]
        tiny = lambda x, full: (x != 0) & (x < SLIVER * full)
        lack = lambda x, full: x < (1.0 - 1e-9) * full
        sl = tiny(c["V"], cell)
        sh = lack(c["V"], cell)
        for d in range(2):
            W_next = np.zeros_like(c["W"][d])
            if d == 0:
                W_next[:-1] = c["W"][d][1:]
            else:
                W_next[:, :-1] = c["W"][d][:, 1:]
            sl = sl | tiny(c["B"][d], face[d]) | tiny(c["W"][d], cell) \
                | tiny(W_next, cell)
            # a staggered volume between two whole cells is whole: V and B
            # find every short one, and W's border slots are 0 by design
            sh = sh | lack(c["B"][d], face[d])
        # the padding slots are short by construction; only real cells count
        sh[n[0]:, :] = False
        sh[:, n[1]:] = False
        short = sh if short is None else (short | sh)
        slivers[m] = _dilate(sl)
        wide[m] = c["V"] >= SLIVER * cell
    sysm = ref["system"]
    far = ~_dilate(short, REACH)
    field = []
    for m in ("ux", "ux", "uy", "uy", "p"):
        act = (sysm.p_active if m == "p"
               else sysm.active[0 if m == "ux" else 1])
        field.append(act & wide[m] & ~undecided[m])
    resid = [sysm.active[0] & ~slivers["ux"], sysm.active[1]
             & ~slivers["uy"]]
    return dict(capacity=decided, operator=far, field=field,
                residual=resid)


def _host(t):
    return t.detach().to("cpu", torch.float64).numpy()


def compare(prog, ref, config):
    """The numbers that decide ``correct``, each a widest gap in units of
    its own scale, over the entries ``compared`` selects:

    - ``capacity``: V and W against the full cell, A and B against the full
      face, the largest over the three meshes;
    - ``operator``: the program's Picard rows at its Stokes start against
      the reference's at its own, on the probe blocks, row by row, over the
      row's own sum of |terms|, on whole rows of all five blocks;
    - ``field``: the state at the end of every whole episode of the window,
      velocities over the reference's largest |uω|, pressure over its
      largest |p|.  The program hands over ``fields``, the elementwise
      least and greatest of those end states, so every episode is judged;
    - ``field_residual``: the reference's last sweep applied to the
      program's end state, less its right-hand side, on the momentum rows,
      over the largest row of |A| |x| at the reference's end state.  It
      weighs the gap by its roughness, so the smooth error of an fgmres
      tolerance reads small and rounding noise, or one wrong cell, large.
    """
    n = [int(v) for v in config["grid"]]
    L = [float(v) for v in config["domain"]]
    h = [L[d] / n[d] for d in range(2)]
    cell, face = h[0] * h[1], (h[1], h[0])
    keep = compared(ref, config)

    cap = 0.0
    pc, rc = prog["capacity"], ref["capacity"]
    for k, m in enumerate(("ux", "uy", "p")):
        on = keep["capacity"][m]
        gap = lambda a, b: float(np.max(np.where(
            on, np.abs(_host(a) - _host(b)), 0.0)))
        cap = max(cap, gap(pc["V"][k], rc["V"][k]) / cell)
        for key, scales in (("A", face), ("B", face), ("W", (cell, cell))):
            for d in range(2):
                cap = max(cap, gap(pc[key][k][d], rc[key][k][d]) / scales[d])

    op = 0.0
    for a, b, s in zip(prog["operator"], ref["operator"], ref["scale"]):
        rows = np.abs(_host(a) - _host(b)) / np.maximum(
            s.astype(np.float64), np.finfo(np.float64).tiny)
        op = max(op, float(np.max(np.where(keep["operator"], rows, 0.0))))

    T = [_host(f) for f in ref["field"]]
    u_scale = max(float(np.max(np.where(keep["field"][k], np.abs(T[k]),
                                        0.0))) for k in (0, 2))
    p_scale = float(np.max(np.where(keep["field"][4], np.abs(T[4]), 0.0)))
    A, b = ref["last"]
    A = A.astype(np.float64)
    absA = abs(A)
    shape = T[0].shape
    r_rows = unflat(absA @ flat(T), shape)
    r_scale = max(float(np.max(np.where(keep["residual"][k],
                                        r_rows[2 * k], 0.0)))
                  for k in range(2))
    field = resid = 0.0
    for X in prog["fields"]:
        X = [_host(f) for f in X]
        for k in range(5):
            sc = p_scale if k == 4 else u_scale
            field = max(field, float(np.max(np.where(
                keep["field"][k], np.abs(X[k] - T[k]), 0.0))) / sc)
        r = unflat(A @ flat(X) - b.astype(np.float64), shape)
        for k in range(2):
            resid = max(resid, float(np.max(np.where(
                keep["residual"][k], np.abs(r[2 * k]), 0.0))) / r_scale)
    return dict(capacity=cap, operator=op, field=field,
                field_residual=resid)

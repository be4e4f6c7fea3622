"""Plain reference for the Frank-disk Stefan cell, in plain PyTorch and scipy.

The problem (Penguin.jl's ``examples/2D/StefanFT/stefan_disk.jl``, solved by
``solve_StefanMono2D!``): a solid disk of radius ``S·sqrt(t)`` grows at
``centre`` in an ``L × L`` box into liquid undercooled to
``T_inf = -(S²/4) e^{S²/4} E1(S²/4)``; the interface is held at 0, the
border cells at ``T_inf``; ``ρL`` the latent heat; backward Euler from the
similarity solution at ``t0``.

What the reference computes, from the configuration and the traffic, by
default in float64:

- the start: ``markers`` points on the circle of radius ``S·sqrt(t0)``
  (counterclockwise, the first at angle 0) and ``T0``, the similarity
  solution on the centroids of the liquid's static cut cells;
- for a slab given as ``(Told, mk_a, mk_b)`` (the temperature at the slab's
  start and the two fronts): the space-time cut-cell capacities of the
  liquid under the body ``-((dt - t) φ_a + t φ_b) / dt`` on the slab
  ``[0, dt]``, ``φ`` its own polyline signed distance, by the frozen
  quadrature of ``quadrature.py`` with the closed-form axis the port's
  method uses for each measure (``y`` for cell and staggered volumes, ``t``
  for the spatial faces and centroid lines, ``y`` for the time faces);
- the reduced backward-Euler slab system, assembled as a scipy sparse
  matrix on the padded grid, on live cells (``Va ≠ 0`` or ``Vb ≠ 0``)::

      (Va + Σ_d B_d Dt_d W_d⁻¹ D_d B_d) T = Vb Told,

  ``D_d`` the backward difference on the padded grid (the padding slot
  read as 0, so the last face carries the flux through the grid's upper
  border) and ``Dt_d`` its adjoint, identity rows on dead cells and on the
  border cells (whose right-hand side is ``T_inf``), solved by sparse LU;
- the residual of the Stefan condition on that slab,
  ``F = box3(ρL (Va - Vb) - Σ_d [Dt_d (A_d q_d) - B_d Dt_d q_d])`` with
  ``q_d = W_d⁻¹ D_d (B_d T)``, ``box3`` the 3 × 3 box filter over the
  padded grid, and ``‖F‖₂``.

For the CPU tests it also holds a plain whole-step march (``march``): the
GN/LM iteration over the markers' normal displacements with the same λ
rule and displacement limiter as ``stefan.jl:875-941``, the circular
moving-average smoothing and the arclength resampling.

The march's volume Jacobian is Penguin.jl's own method
(``stefan.jl:573``): central differences of exactly clipped polygon∩cell
areas.  Departures from ``stefan.jl``, each noted where it is made: the
dense LM system is solved by ``numpy.linalg.solve``; the time faces and
the flux use the port's slot conventions (slot 0 the slab start).

It imports nothing of the program.  ``precision=CONTROL[dtype]`` gives the
control: each stage computed in the precision below the configuration's
(float32 for float64) from the float64 stage before it, the capacities
from the mesh, the operator from the float64 capacities, the field from
that operator by LU in the control's precision.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch
from scipy.special import exp1

from perfbench.reference.quadrature import box_integrals

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# the control's precision: the nearest below the configuration's
CONTROL = {torch.float64: torch.float32, torch.float32: torch.bfloat16}

SEG_BLOCK = 64        # segments visited at once by the signed distance
UNDECIDED = 4.0       # factor about a snapping threshold within which a
                      # cell may be snapped by one side and not the other
FD_STEP = 1e-6        # central-difference step of the march's Jacobian,
                      # in cells


def empty_rel(dtype):
    """The share of a full cell below which a cell counts as empty (and
    above ``1 - empty_rel`` as full): part of the method as the
    configuration's dtype defines it."""
    return 1e-10 if dtype == torch.float64 else 2e-5


def undercooling(S):
    """``T_inf`` of the similarity solution with front ``S·sqrt(t)``."""
    q = S * S / 4.0
    return -q * math.exp(q) * exp1(q)


def similarity(r, t, S):
    """The Frank temperature at distance ``r`` from the centre at time
    ``t`` (numpy): 0 in the solid, ``T_inf (1 - E1(r²/4t) / E1(S²/4))``
    in the liquid."""
    s2 = np.maximum(r * r / (4.0 * t), 1e-300)
    T_inf = undercooling(S)
    return np.where(r >= S * math.sqrt(t),
                    T_inf * (1.0 - exp1(s2) / exp1(S * S / 4.0)), 0.0)


# ---------------------------------------------------------------------------
# the front
# ---------------------------------------------------------------------------

def circle(centre, radius, n, dtype, device):
    th = torch.arange(n, dtype=torch.float64) * (2.0 * math.pi / n)
    mk = torch.stack([centre[0] + radius * torch.cos(th),
                      centre[1] + radius * torch.sin(th)], dim=-1)
    return mk.to(dtype=dtype, device=device)


def polyline_sdf(mk, x, y):
    """Signed distance from the points ``(x, y)`` (broadcasting) to the
    closed polygon ``mk``: the least distance to its segments, negative
    where a ray to +x crosses it an odd number of times (a crossing counts
    where one end lies at or below the point's height and the other
    above)."""
    x, y = torch.broadcast_tensors(x, y)
    a = mk
    b = torch.roll(mk, -1, dims=0)
    d2 = torch.full(x.shape, math.inf, dtype=x.dtype, device=x.device)
    odd = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    px, py = x[..., None], y[..., None]
    for k in range(0, mk.shape[0], SEG_BLOCK):
        ax, ay = a[k:k + SEG_BLOCK, 0], a[k:k + SEG_BLOCK, 1]
        bx, by = b[k:k + SEG_BLOCK, 0], b[k:k + SEG_BLOCK, 1]
        ex, ey = bx - ax, by - ay
        ee = ex * ex + ey * ey
        u = ((px - ax) * ex + (py - ay) * ey) / torch.where(ee > 0, ee, 1.0)
        u = torch.clamp(u, 0.0, 1.0)
        dx, dy = px - ax - u * ex, py - ay - u * ey
        d2 = torch.minimum(d2, (dx * dx + dy * dy).min(dim=-1).values)
        straddle = (ay <= py) != (by <= py)
        xc = ax + (py - ay) * ex / torch.where(ey != 0, ey, 1.0)
        crossings = (straddle & (px < xc)).sum(dim=-1)
        odd = odd ^ (crossings % 2 == 1)
    dist = torch.sqrt(d2)
    return torch.where(odd, -dist, dist)


def normals(mk):
    """Outward unit normals at the markers of a counterclockwise polygon:
    the mean of the two adjoining segments' unit tangents, turned by -90°."""
    prev = mk - torch.roll(mk, 1, dims=0)
    nxt = torch.roll(mk, -1, dims=0) - mk
    tang = (prev / prev.norm(dim=-1, keepdim=True)
            + nxt / nxt.norm(dim=-1, keepdim=True))
    nrm = torch.stack([tang[:, 1], -tang[:, 0]], dim=-1)
    return nrm / nrm.norm(dim=-1, keepdim=True)


def smooth(d, window, passes):
    """Circular moving average of ``window`` (odd) points, ``passes``
    times."""
    half = window // 2
    for _ in range(passes):
        d = sum(torch.roll(d, k) for k in range(-half, half + 1)) / window
    return d


def resample(mk):
    """The same number of markers, equally spaced in arclength along the
    closed polygon, the first kept."""
    pts = mk.double().cpu().numpy()
    closed = np.vstack([pts, pts[:1]])
    s = np.concatenate([[0.0], np.cumsum(np.hypot(*np.diff(closed, axis=0).T))])
    targets = np.arange(len(pts)) * (s[-1] / len(pts))
    out = np.stack([np.interp(targets, s, closed[:, 0]),
                    np.interp(targets, s, closed[:, 1])], axis=-1)
    return torch.as_tensor(out, dtype=mk.dtype, device=mk.device)


# ---------------------------------------------------------------------------
# grid and capacities
# ---------------------------------------------------------------------------

def _along(v, d, N):
    shp = [1] * N
    shp[d] = v.numel()
    return v.reshape(shp)


def _insert(coords, d, value):
    coords = list(coords)
    coords.insert(d, value)
    return coords


def _pad(x, shape):
    flat = []
    for d in reversed(range(x.dim())):
        flat += [0, shape[d] - x.shape[d]]
    return torch.nn.functional.pad(x, flat)


class Problem:
    """The configuration's Frank disk on its grid, in ``dtype``."""

    def __init__(self, config, traffic, device, dtype=torch.float64):
        self.n = int(config["cells"])
        self.L = float(config["length"])
        self.h = self.L / self.n
        self.origin = [float(v) for v in config["origin"]]
        self.centre = [float(v) for v in config["centre"]]
        self.S, self.t0 = float(config["S"]), float(config["t0"])
        self.n_markers = int(config["markers"])
        self.rhoL = float(config["rhoL"])
        self.k = float(config["diffusivity"])
        self.T_inf = undercooling(self.S)
        self.p = int(config["quadrature"]["p"])
        self.q = int(config["quadrature"]["s"])
        self.dt = float(traffic["dt"])
        self.fuse = bool(traffic["stencil_fusion"])
        self.device, self.dtype = device, dtype
        n = self.n
        # node k of axis d lies at origin + (k + 1/2) h: cell i spans
        # nodes i and i + 1; the padded grid has n + 1 slots per axis
        self.node = [torch.as_tensor(
            [o + (k + 0.5) * self.h for k in range(n + 1)],
            dtype=torch.float64).to(dtype=dtype, device=device)
            for o in self.origin]
        idx = torch.arange(n + 1, device=device)
        edge = (idx == 0) | (idx == n - 1)
        real = idx < n
        self.border = ((edge[:, None] | edge[None, :])
                       & real[:, None] & real[None, :])

    # --- the start -----------------------------------------------------------
    def start(self):
        """(markers, T0) of the similarity solution at ``t0``."""
        mk = circle(self.centre, self.S * math.sqrt(self.t0), self.n_markers,
                    self.dtype, self.device)
        C = self.static_centroids(mk)
        r = np.hypot(C[..., 0] - self.centre[0], C[..., 1] - self.centre[1])
        T0 = torch.as_tensor(similarity(r, self.t0, self.S),
                             dtype=self.dtype, device=self.device)
        return mk, T0

    def static_centroids(self, mk):
        """Centroids of the liquid's static cut cells under the polygon
        ``mk`` (box centres for whole cells, 0 on the padding slots), as a
        float64 numpy array of shape (n + 1, n + 1, 2)."""
        N, n = 2, self.n
        lo = [_along(self.node[d][:-1], d, N) for d in range(N)]
        hi = [_along(self.node[d][1:], d, N) for d in range(N)]
        V, moms = box_integrals(lambda x, y: -polyline_sdf(mk, x, y), lo, hi,
                                p=self.p, s=self.q)
        full = (hi[0] - lo[0]) * (hi[1] - lo[1])
        eps = empty_rel(self.dtype)
        cut = (V > eps * full) & (V < (1.0 - eps) * full)
        C = [torch.where(cut, moms[d] / torch.where(cut, V, 1.0),
                         (0.5 * (lo[d] + hi[d])).expand(n, n))
             for d in range(N)]
        shape = (n + 1, n + 1)
        return torch.stack([_pad(c, shape) for c in C], dim=-1
                           ).double().cpu().numpy()

    # --- the slab ------------------------------------------------------------
    def body(self, mk_a, mk_b):
        dt = self.dt

        def phi(x, y, t):
            return -((dt - t) * polyline_sdf(mk_a, x, y)
                     + t * polyline_sdf(mk_b, x, y)) / dt

        return phi

    def capacities(self, mk_a, mk_b):
        """The slab's liquid capacities, as the slab operator reads them:
        ``V`` (space-time volume), ``A`` (the two spatial faces' space-time
        apertures, then ``Va`` and ``Vb``, the time faces: the spatial
        volumes at the slab's start and end), ``B`` and ``W`` (the
        centroid lines and staggered volumes, space-time), each on the
        padded (n + 1)² grid; ``undecided``, the cells within a factor
        ``UNDECIDED`` of a snapping threshold, grown by one cell."""
        N, n = 3, (self.n, self.n, 1)
        mk_a = mk_a.to(dtype=self.dtype, device=self.device)
        mk_b = mk_b.to(dtype=self.dtype, device=self.device)
        phi = self.body(mk_a, mk_b)
        t = torch.as_tensor([0.0, self.dt], dtype=torch.float64).to(
            dtype=self.dtype, device=self.device)
        nodes = self.node + [t]
        lo = [_along(nodes[d][:-1], d, N) for d in range(N)]
        hi = [_along(nodes[d][1:], d, N) for d in range(N)]
        full = (hi[0] - lo[0]) * (hi[1] - lo[1]) * (hi[2] - lo[2])
        full = full.expand(n)
        p, q = self.p, self.q

        # cell volumes: closed form along y, Gauss-Legendre in x and t
        raw, moms = box_integrals(phi, lo, hi, p=p, s=q, inner_axis=1)
        eps = empty_rel(self.dtype)
        empty = raw <= eps * full
        whole = raw >= (1.0 - eps) * full
        cut = ~empty & ~whole
        V = torch.where(empty, 0.0, torch.where(whole, full, raw))
        C = [torch.where(cut, moms[d] / torch.where(cut, V, 1.0),
                         (0.5 * (lo[d] + hi[d])).expand(n)) for d in range(2)]
        rel = raw / full
        near = (((rel >= eps / UNDECIDED) & (rel <= eps * UNDECIDED))
                | ((1.0 - rel >= eps / UNDECIDED)
                   & (1.0 - rel <= eps * UNDECIDED)))

        # faces: a spatial face integrates over (the other axis, t), closed
        # form along t; a time face over (x, y), closed form along y
        A = []
        for d in range(N):
            cross_lo = [lo[i] for i in range(N) if i != d]
            cross_hi = [hi[i] for i in range(N) if i != d]
            face = _along(nodes[d], d, N)
            Ad, _ = box_integrals(lambda *cs, _d=d, _f=face:
                                  phi(*_insert(cs, _d, _f)),
                                  cross_lo, cross_hi, p=p, s=q)
            fshape = tuple(n[i] + 1 if i == d else n[i] for i in range(N))
            A.append(Ad.expand(fshape))

        # centroid lines through the cells' centroids, closed form along t
        B = []
        for d in range(2):
            cross_lo = [lo[i] for i in range(N) if i != d]
            cross_hi = [hi[i] for i in range(N) if i != d]
            Bd, _ = box_integrals(lambda *cs, _d=d, _c=C[d]:
                                  phi(*_insert(cs, _d, _c)),
                                  cross_lo, cross_hi, p=p, s=q)
            B.append(torch.where(empty, 0.0, Bd.expand(n)))

        # staggered volumes between adjacent centroids, closed form along y;
        # slot k lies between cells k - 1 and k, slot 0 stays 0
        W = []
        for d in range(2):
            m = n[d] - 1
            st_lo = [C[d].narrow(d, 0, m) if i == d
                     else lo[i].expand(n).narrow(d, 0, m) for i in range(N)]
            st_hi = [C[d].narrow(d, 1, m) if i == d
                     else hi[i].expand(n).narrow(d, 1, m) for i in range(N)]
            Wd, _ = box_integrals(phi, st_lo, st_hi, p=p, s=q, inner_axis=1)
            pad = [0, 0] * (N - 1 - d) + [1, 0]
            W.append(torch.nn.functional.pad(Wd, pad))

        shape = (self.n + 1, self.n + 1)
        sl = lambda x: _pad(x[..., 0], shape)
        return dict(V=sl(V), A=[sl(A[0]), sl(A[1]),
                                _pad(A[2][..., 0], shape),
                                _pad(A[2][..., 1], shape)],
                    B=[sl(b) for b in B], W=[sl(w) for w in W],
                    undecided=_dilate(sl(near)))

    # --- the reduced slab system ----------------------------------------------
    def operator(self, cap):
        """The reduced slab operator as a scipy CSR matrix on the padded
        grid, flattened row-major, in the capacities' precision."""
        m = self.n + 1
        npdt = np.float32 if cap["V"].dtype != torch.float64 else np.float64
        host = lambda x: x.detach().cpu().to(torch.float64).numpy().ravel(
            ).astype(npdt)
        Va, Vb = host(cap["A"][2]), host(cap["A"][3])
        live = (Va != 0) | (Vb != 0)
        one = np.ones(m, dtype=npdt)
        # D: x[k] - x[k-1] (x[-1] = 0) with the last slot of x read as 0,
        # so slot m-1 holds -x[m-2]; its transpose y[k] - y[k+1] on slots
        # 0..m-2 and 0 on the last
        D1 = sp.diags([np.r_[one[:m - 1], 0.0], -one[:m - 1]], [0, -1],
                      shape=(m, m), format="csr", dtype=npdt)
        Dt1 = D1.T.tocsr()
        eye = sp.identity(m, dtype=npdt, format="csr")
        Ds = [sp.kron(D1, eye, format="csr"), sp.kron(eye, D1, format="csr")]
        Dts = [sp.kron(Dt1, eye, format="csr"),
               sp.kron(eye, Dt1, format="csr")]
        L = sp.diags(Va)
        for d in range(2):
            B = sp.diags(host(cap["B"][d]))
            w = host(cap["W"][d])
            Winv = sp.diags(np.where(w != 0, 1.0 / np.where(w != 0, w, 1.0),
                                     1.0).astype(npdt))
            L = L + self.k * (B @ Dts[d] @ Winv @ Ds[d] @ B)
        keep = live & ~self.border.cpu().numpy().ravel()
        L = sp.diags(keep.astype(npdt)) @ L @ sp.diags(live.astype(npdt)) \
            + sp.diags((~keep).astype(npdt))
        return L.tocsr()

    def rhs(self, cap, Told):
        m = self.n + 1
        Va, Vb = cap["A"][2], cap["A"][3]
        live = (Va != 0) | (Vb != 0)
        b = torch.where(live, Vb * Told.to(Vb.dtype), 0.0)
        b = torch.where(self.border, self.T_inf, b)
        return b.reshape(m * m)

    def solve(self, L, b):
        """``L T = b`` by sparse LU, as a tensor on the padded grid."""
        m = self.n + 1
        x = spla.splu(L.tocsc()).solve(b.detach().cpu().numpy())
        return torch.as_tensor(x.reshape(m, m), device=self.device)

    def residual(self, cap, T):
        """(F, ‖F‖, ρL max|Va - Vb|) of the Stefan condition on a slab
        solved to ``T``."""
        T = T.to(cap["V"].dtype)
        flux = 0.0
        for d in range(2):
            A, B = cap["A"][d], cap["B"][d]
            w = cap["W"][d]
            winv = torch.where(w != 0, 1.0 / torch.where(w != 0, w, 1.0), 1.0)
            qd = winv * _dm(B * T, d)
            flux = flux + _dmt(A * qd, d) - B * _dmt(qd, d)
        dV = cap["A"][2] - cap["A"][3]
        F = self.rhoL * dV - self.k * flux
        if self.fuse:
            F = box3(F)
        return F, float(torch.linalg.norm(F)), \
            self.rhoL * float(dV.abs().max())

    def slab(self, Told, mk_a, mk_b):
        """Everything the check reads of one slab, in float64."""
        cap = self.capacities(mk_a, mk_b)
        L = self.operator(cap)
        T = self.solve(L, self.rhs(cap, Told))
        F, norm, scale = self.residual(cap, T)
        return dict(capacity=cap, L=L, field=T, F=F, norm=norm, scale=scale)

    # --- the plain march (CPU tests) ------------------------------------------
    def volumes(self, mk):
        """The liquid's spatial cell volumes under the polygon ``mk`` by
        exact clipping, on the padded grid: each cell's area less its part
        inside the polygon, which is ``-Σ_seg ∫ clamp(y_seg(x) - y_lo, 0,
        h) dx`` over the segment's stretch across the cell's columns
        (counterclockwise: the upper boundary runs to -x)."""
        n, h = self.n, self.h
        xlo = self.node[0][:-1].reshape(n, 1, 1)
        ylo = self.node[1][:-1].reshape(1, n, 1)
        a, b = mk, torch.roll(mk, -1, dims=0)
        dx = b[:, 0] - a[:, 0]
        slope = (b[:, 1] - a[:, 1]) / torch.where(dx != 0, dx, 1.0)
        xa = torch.clamp(a[:, 0], xlo, xlo + h)
        xb = torch.clamp(b[:, 0], xlo, xlo + h)
        ua = a[:, 1] + slope * (xa - a[:, 0]) - ylo
        ub = a[:, 1] + slope * (xb - a[:, 0]) - ylo

        def G(u):   # ∫_0^u clamp(v, 0, h) dv
            c = torch.clamp(u, 0.0, h)
            return 0.5 * c * c + h * torch.clamp_min(u - h, 0.0)

        du = ub - ua
        mean = torch.where(du != 0, (G(ub) - G(ua)) / torch.where(
            du != 0, du, 1.0), torch.clamp(ua, 0.0, h))
        inside = -(mean * torch.where(dx != 0, xb - xa, 0.0)).sum(-1)
        return _pad(h * h - inside, (n + 1, n + 1))

    def jacobian(self, mk_a, d, nrm):
        """∂F/∂d with the flux frozen, ``-ρL ∂Vb/∂d``, box-filtered, by
        central differences of the exactly clipped cell volumes
        (``stefan.jl:573`` differences polygon clippings alike)."""
        eps = FD_STEP * self.h
        cols = []
        for i in range(d.numel()):
            e = torch.zeros_like(d)
            e[i] = eps
            Vp = self.volumes(mk_a + (d + e)[:, None] * nrm)
            Vm = self.volumes(mk_a + (d - e)[:, None] * nrm)
            col = -self.rhoL * (Vp - Vm) / (2.0 * eps)
            cols.append((box3(col) if self.fuse else col).reshape(-1))
        return torch.stack(cols, dim=-1)

    def march(self, mk, T, steps, traffic, tol):
        """``steps`` backward-Euler steps of the GN/LM front update from
        ``(mk, T)``: returns (marker log, final field, GN iterations a
        step, final ‖F‖ a step)."""
        max_iter, _, _, alpha = traffic["newton_params"]
        lm0, factor, lm_min, lm_max = traffic["lm"]
        window, passes = traffic["smooth_window"], traffic["smooth_passes"]
        max_disp = traffic["max_disp_cells"] * self.h
        d = torch.zeros(mk.shape[0], dtype=self.dtype, device=self.device)
        log, iters, norms = [], [], []
        for k in range(steps):
            d = traffic["extrapolation_factor"] * d if k else d
            nrm = normals(mk)
            lam, rn, it = lm0, math.inf, 0
            while it < int(max_iter) and (it == 0 or rn > tol):
                slab = self.slab(T, mk, mk + d[:, None] * nrm)
                F = slab["F"].reshape(-1)
                J = self.jacobian(mk, d, nrm)
                JTJ = (J.T @ J).cpu().numpy()
                JTF = (J.T @ F).cpu().numpy()
                rn_new = slab["norm"]
                diag = np.maximum(np.diag(JTJ), 1e-10 * np.diag(JTJ).max())
                try:
                    delta = np.linalg.solve(JTJ + lam * np.diag(diag), JTF)
                except np.linalg.LinAlgError:
                    delta = np.zeros_like(JTF)
                delta = np.where(np.isfinite(delta), delta, 0.0)
                d_new = smooth(d - alpha * torch.as_tensor(
                    delta, dtype=d.dtype, device=d.device), window, passes)
                d_new = torch.clamp(d_new, -max_disp, max_disp)
                # λ shrinks after a step that lowered ‖F‖, grows otherwise,
                # from the second iteration on (stefan.jl:875-941)
                if it > 0:
                    lam = (max(lam / factor, lm_min) if rn_new < rn
                           else min(lam * factor, lm_max))
                d, rn = d_new, rn_new
                it += 1
                T_new = slab["field"]
            T = T_new
            mk = resample(mk + d[:, None] * nrm)
            log.append(mk)
            iters.append(it)
            norms.append(rn)
        return torch.stack(log), T, iters, norms


def _dm(x, d):
    """The backward difference x[k] - x[k-1] with x[-1] = 0 and the last
    slot of x read as 0: the last slot holds -x[m-2], the flux through
    the grid's upper border face."""
    m = x.shape[d]
    zlast = torch.nn.functional.pad(x.narrow(d, 0, m - 1), _pads(d, 0, 1))
    return zlast - torch.nn.functional.pad(x, _pads(d, 1, 0)).narrow(d, 0, m)


def _dmt(y, d):
    """y[k] - y[k+1] (y[m] = 0), the last slot zero: the adjoint of
    ``_dm`` on fields whose last slot is zero."""
    m = y.shape[d]
    z = y - torch.nn.functional.pad(y, _pads(d, 0, 1)).narrow(d, 1, m)
    return torch.nn.functional.pad(z.narrow(d, 0, m - 1), _pads(d, 0, 1))


def _pads(d, before, after):
    return [0, 0] * (1 - d) + [before, after]


def box3(F):
    """Each cell's value replaced by the sum over its 3 × 3 neighbourhood,
    zero outside the padded grid."""
    out = F
    for d in range(2):
        m = out.shape[d]
        out = (out + torch.nn.functional.pad(out, _pads(d, 1, 0)).narrow(
            d, 0, m) + torch.nn.functional.pad(out, _pads(d, 0, 1)).narrow(
            d, 1, m))
    return out


def _dilate(mask):
    m = mask.to(torch.uint8)
    out = m
    for d in range(2):
        n = m.shape[d]
        out = (out | torch.nn.functional.pad(m, _pads(d, 1, 0)).narrow(d, 0, n)
               | torch.nn.functional.pad(m, _pads(d, 0, 1)).narrow(d, 1, n))
    return out.bool()


# ---------------------------------------------------------------------------
# the run's answers, and the comparison
# ---------------------------------------------------------------------------

def reference(config, traffic, inputs, device, precision=torch.float64):
    """What the program's run is judged against: ``problem``, the float64
    :class:`Problem` that rebuilds any slab the program hands over; and,
    for the control, one slab computed in ``precision``: the first step's
    slab between the similarity fronts at ``t0`` and ``t0 + dt`` from
    ``T0``, as ``slab`` (its inputs), ``capacity``, ``operator`` (on the
    run's probe) and ``field``."""
    exact = Problem(config, traffic, device)
    mk_a, T0 = exact.start()
    R1 = exact.S * math.sqrt(exact.t0 + exact.dt)
    mk_b = circle(exact.centre, R1, exact.n_markers, torch.float64, device)
    low = Problem(config, traffic, device, precision)
    base = exact.capacities(mk_a, mk_b)
    cap = base
    if precision != torch.float64:
        cap = low.capacities(mk_a, mk_b)
        # the operator and the field start from the float64 capacities
        base = {k: ([a.to(precision) for a in v] if isinstance(v, list)
                    else v.to(precision) if v.is_floating_point() else v)
                for k, v in base.items()}
    L = low.operator(base)
    probe = inputs["probe"].to(device=device, dtype=precision)
    lu_dtype = precision if precision != torch.bfloat16 else torch.float32
    operator = torch.as_tensor(
        L @ probe.reshape(-1).cpu().to(lu_dtype).numpy(), device=device)
    field = low.solve(L, low.rhs(base, T0.to(precision)).to(lu_dtype))
    return dict(problem=exact, probe=inputs["probe"], slab=(T0, mk_a, mk_b),
                capacity=_capacity_answer(cap),
                operator=operator.reshape(probe.shape), field=field)


def _capacity_answer(cap):
    return dict(V=cap["V"], A=list(cap["A"]), B=list(cap["B"]),
                W=list(cap["W"]))


def volume_gap(V, config):
    """|Σ V − V_exact| / V_exact: the first step's slab's space-time liquid
    volume against that of two concentric circles whose radius moves
    linearly in time over the slab, ``dt (L² − π (Ra² + Ra Rb + Rb²) / 3)``,
    with ``dt`` read off a whole cell's measure ``h² dt``; a 256-gon holds
    about 1e-4 less area than its circle.  A reading of the method's
    truncation, not one of the numbers compared."""
    L = float(config["length"])
    h = L / int(config["cells"])
    dt = float(V.double().max()) / (h * h)
    S, t0 = float(config["S"]), float(config["t0"])
    Ra, Rb = S * math.sqrt(t0), S * math.sqrt(t0 + dt)
    exact = dt * (L * L - math.pi * (Ra * Ra + Ra * Rb + Rb * Rb) / 3.0)
    return abs(float(V.double().sum()) - exact) / exact


def compare(prog, ref, config):
    """The numbers that decide ``correct``, each the widest gap in units of
    its own scale.  The reference rebuilds, in float64, the slab that the
    program hands over as ``slab`` (its start temperature and fronts):

    - ``capacity``: the program's capacities of that slab against the
      reference's, volumes over ``h² dt``, spatial apertures and centroid
      lines over ``h dt``, the time faces over ``h²``, on every cell but
      the ``undecided`` ones;
    - ``operator``: the program's slab operator on the probe against the
      reference's sparse matrix, row by row, over the row's own sum of
      |terms|, on the same cells;
    - ``field``: the program's temperature against the reference's LU
      solve of the same slab, over the reference's largest |T|, on live
      cells;

    and, when the program hands over the steps of a whole episode
    (``start``, ``marker_log``) and its ends (``end_radii``):

    - ``front_residual``: for every step, the slab rebuilt between the
      program's fronts before and after it (``Told`` the reference's own
      solve of the step before, from ``T0``), solved by LU; the largest
      ``‖F‖₂ / (ρL max|Va − Vb|)``;
    - ``radius``: the largest, over the episode ends, of
      ``|mean marker radius / (S sqrt(t0 + K dt)) − 1|``, K the steps.
    """
    prob = ref["problem"]
    h, dt = prob.h, prob.dt
    Told, mk_a, mk_b = prog["slab"]
    Told = Told.to(device=prob.device, dtype=torch.float64)
    slab = prob.slab(Told, mk_a, mk_b)
    rc = slab["capacity"]
    keep = ~rc["undecided"]

    def gap(a, b, where=keep):
        diff = (a.to(device=b.device, dtype=b.dtype) - b).abs()
        return float(torch.where(where, diff, 0.0).max())

    pc = prog["capacity"]
    cap = max(gap(pc["V"], rc["V"]) / (h * h * dt),
              max(gap(a, b) / s for a, b, s in zip(
                  pc["A"], rc["A"], (h * dt, h * dt, h * h, h * h))),
              max(gap(a, b) / (h * dt) for a, b in zip(pc["B"], rc["B"])),
              max(gap(a, b) / (h * h * dt) for a, b in zip(pc["W"],
                                                           rc["W"])))
    L = slab["L"]
    y_prog = prog["operator"].reshape(-1).to(torch.float64).cpu().numpy()
    x = ref["probe"].reshape(-1).to(torch.float64).cpu().numpy()
    y_ref = L @ x
    scale = abs(L) @ np.abs(x)
    rows = np.abs(y_prog - y_ref) / np.maximum(scale, np.finfo(float).tiny)
    rows = np.where(keep.cpu().numpy().ravel(), rows, 0.0)
    T = slab["field"]
    live = (rc["A"][2] != 0) | (rc["A"][3] != 0)
    field = gap(prog["field"], T, live) / float(torch.where(
        live, T.abs(), 0.0).max())
    out = dict(capacity=cap, operator=float(rows.max()), field=field)
    if "marker_log" in prog:
        mk, T = prog["start"]
        T = T.to(device=prob.device, dtype=torch.float64)
        worst = 0.0
        for mk_next in prog["marker_log"]:
            step = prob.slab(T, mk, mk_next)
            worst = max(worst, step["norm"] / step["scale"])
            mk, T = mk_next, step["field"]
        out["front_residual"] = worst
    if "end_radii" in prog:
        out["radius"] = max(
            abs(r / (prob.S * math.sqrt(prob.t0 + k * dt)) - 1.0)
            for k, r in prog["end_radii"])
    return out

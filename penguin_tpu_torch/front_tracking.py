"""Marker-based front tracking on fixed-shape tensors (torch).

Counterpart of ``penguin_tpu.front_tracking``: the interface is a closed
polyline of ``n_markers`` points stored as an (n, 2) tensor, and every
geometric query is a batched computation of fixed shape:

- ``polyline_sdf``: signed distance to the polyline (point-segment distances
  + ray-crossing parity for the sign), vectorized over arbitrary query
  batches.
- normals by averaged segment tangents, Menger curvature.
- shape generators (circle/rectangle/ellipse/crystal/n-gon).
- polygon area / centroid by the shoelace formula.
- cut-cell capacities and the volume Jacobian come from the *capacity
  quadrature* applied to the SDF with the marker tensor as a differentiated
  parameter: the volume Jacobian d V_cell / d(marker normal displacement) is
  forward-mode autodiff through the quadrature (``torch.func.jacfwd``).

Every function is out of place and treats the marker tensor as data, so a
front can move between calls without rebuilding anything.  The generators
and ``FrontTracker`` put their tensors on ``device``, by default the CUDA
device (see ``_device``); functions given tensors follow them.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device

__all__ = [
    "FrontTracker",
    "markers_circle",
    "markers_rectangle",
    "markers_ellipse",
    "markers_crystal",
    "markers_ngon",
    "polyline_sdf",
    "polyline_normals",
    "polyline_curvature",
    "polygon_area",
    "polygon_centroid",
    "interface_length",
    "resample_markers",
    "smooth_displacements",
    "compute_volume_jacobian",
    "segment_parameters",
    "segment_cell_intersections",
    "segment_cell_intersection_moments",
    "intercept_jacobian",
    "update_front_with_intercept_displacements",
]


# ---------------------------------------------------------------------------
# shape generators (counterclockwise closed polylines, markers exclude the
# duplicated endpoint; reference front_tracking.jl:91-271)
# ---------------------------------------------------------------------------

def _markers(points, dtype, device):
    return torch.as_tensor(points, dtype=dtype, device=resolve_device(device))


def markers_circle(center, radius, n=64, dtype=torch.float64, device=None):
    th = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    return _markers(np.stack([center[0] + radius * np.cos(th),
                              center[1] + radius * np.sin(th)], axis=-1),
                    dtype, device)


def markers_ellipse(center, rx, ry, n=64, dtype=torch.float64, device=None):
    th = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    return _markers(np.stack([center[0] + rx * np.cos(th),
                              center[1] + ry * np.sin(th)], axis=-1),
                    dtype, device)


def markers_rectangle(lo, hi, n_per_side=16, dtype=torch.float64,
                      device=None):
    xs = np.linspace(lo[0], hi[0], n_per_side, endpoint=False)
    ys = np.linspace(lo[1], hi[1], n_per_side, endpoint=False)
    bottom = np.stack([xs, np.full_like(xs, lo[1])], -1)
    right = np.stack([np.full_like(ys, hi[0]), ys], -1)
    top = np.stack([xs[::-1], np.full_like(xs, hi[1])], -1)
    left = np.stack([np.full_like(ys, lo[0]), ys[::-1]], -1)
    return _markers(np.concatenate([bottom, right, top, left], axis=0),
                    dtype, device)


def markers_ngon(center, radius, n_sides, n=60, phase=0.0,
                 dtype=torch.float64, device=None):
    """Regular ``n_sides``-gon (circumradius ``radius``), ``n`` markers
    distributed uniformly along the PERIMETER with every vertex hit
    exactly when ``n`` is a multiple of ``n_sides``: the faceted-seed case,
    whose corners give the marker chain curvature spikes that smooth shapes
    never produce."""
    m = int(n_sides)
    per_side = max(int(round(n / m)), 1)
    th = 2 * np.pi * np.arange(m) / m + phase
    verts = np.stack([center[0] + radius * np.cos(th),
                      center[1] + radius * np.sin(th)], axis=-1)
    pts = []
    for k in range(m):
        a, b = verts[k], verts[(k + 1) % m]
        lam = np.arange(per_side) / per_side
        pts.append(a[None, :] * (1 - lam[:, None]) + b[None, :] * lam[:, None])
    return _markers(np.concatenate(pts, axis=0), dtype, device)


def markers_crystal(center, radius, n=96, n_lobes=6, amplitude=0.2,
                    dtype=torch.float64, device=None):
    """Perturbed circle r(theta) = R (1 + a cos(k theta))."""
    th = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    r = radius * (1.0 + amplitude * np.cos(n_lobes * th))
    return _markers(
        np.stack([center[0] + r * np.cos(th), center[1] + r * np.sin(th)], -1),
        dtype, device)


# ---------------------------------------------------------------------------
# geometric kernels
# ---------------------------------------------------------------------------

def _segments(markers):
    return markers, torch.roll(markers, -1, dims=0)


# elements of one (points × segments) tile of ``polyline_sdf`` when the
# caller names no chunk: the segment chunk is sized so a tile stays near it.
# On an H100 at 512² points × 512 markers an evaluation takes 17.9 ms (f32)
# with blocks of 32 segments, 12.4 with 64, 11.6 with 128 and 10.7 with all
# 512 at once; 2^26 elements (blocks of 256 there, about ten live tiles of
# 0.27 GB in f32) takes most of that gain
_SDF_TILE = 1 << 26


def polyline_sdf(markers, x, y, chunk=None):
    """Signed distance from query points to the closed polyline.

    Negative inside (fluid).  The distance part is exact; the sign is by
    ray-crossing parity.  Batched over the query shape; O(n_markers) per
    point.

    The segments are visited in blocks of ``chunk`` carrying a running
    (min-distance², crossing-count), so the whole (points × n_markers)
    pairwise array is never held at once.  ``chunk=None`` sizes the block
    so one (points × chunk) tile has about ``_SDF_TILE`` elements, at least
    32 segments.  The result does not depend on the chunk: a minimum and an
    integer count are exact.  (The JAX version pads the last block with
    far-away degenerate segments because its scan needs equal blocks; here
    the last block is simply shorter.)

    Under forward-mode autodiff a tie between the nearest segments of a
    block shares the tangent evenly (``torch.amin``), and a tie between
    blocks halves it (``torch.minimum``), as the JAX reductions do."""
    x = torch.as_tensor(x, device=markers.device)
    y = torch.as_tensor(y, device=markers.device)
    x, y = torch.broadcast_tensors(x, y)
    a, b = _segments(markers)  # (n,2)
    ct = torch.promote_types(x.dtype, a.dtype)
    x, y, a, b = x.to(ct), y.to(ct), a.to(ct), b.to(ct)
    qx, qy = x[..., None], y[..., None]  # (...,1)
    n = a.shape[0]
    if chunk is None:
        chunk = max(32, _SDF_TILE // max(x.numel(), 1))
    chunk = max(1, min(int(chunk), n))
    # the guard epsilon must keep eps² a NORMAL number in the working dtype:
    # the division's tangent forms x·dy/(y·y), and (1e-30)² underflows to 0
    # in f32, turning every tangent into 0/0 = NaN.  sqrt(tiny) squares back
    # to ~tiny, which is normal.
    eps_len = float(np.sqrt(torch.finfo(ct).tiny))

    d2min = torch.full(x.shape, float("inf"), dtype=ct, device=x.device)
    cross = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for k0 in range(0, n, chunk):
        ac, bc = a[k0:k0 + chunk], b[k0:k0 + chunk]
        ax, ay = ac[:, 0], ac[:, 1]
        bx, by = bc[:, 0], bc[:, 1]
        abx, aby = bx - ax, by - ay
        ab2 = abx * abx + aby * aby
        t = ((qx - ax) * abx + (qy - ay) * aby) / torch.clamp_min(ab2, eps_len)
        t = torch.clamp(t, 0.0, 1.0)
        dx = qx - (ax + t * abx)
        dy = qy - (ay + t * aby)
        d2 = dx * dx + dy * dy
        d2min = torch.minimum(d2min, torch.amin(d2, dim=-1))
        cond = (ay <= qy) != (by <= qy)
        dyab = by - ay
        xint = ax + (qy - ay) / torch.where(dyab.abs() > 1e-30, dyab, 1.0) \
            * (bx - ax)
        cross = cross + torch.sum(cond & (qx < xint), dim=-1,
                                  dtype=torch.int32)
    pos = d2min > 0.0
    dist = torch.sqrt(torch.where(pos, d2min, 1.0)) * pos.to(ct)
    inside = cross % 2 == 1
    return torch.where(inside, -dist, dist)


def _norm(v, keepdim=False):
    return torch.linalg.norm(v, dim=-1, keepdim=keepdim)


def polyline_normals(markers):
    """Outward unit normals at markers: average of adjacent segment normals.
    Assumes counterclockwise orientation (fluid inside) -> outward normal of
    segment (dx,dy) is (dy,-dx)."""
    prev = markers - torch.roll(markers, 1, dims=0)
    nxt = torch.roll(markers, -1, dims=0) - markers
    # dtype-aware tiny: 1e-300 flushes to 0 in f32, turning a degenerate
    # (duplicate-marker) segment into a 0/0 NaN
    tiny = torch.finfo(markers.dtype).tiny
    tang = prev / torch.clamp_min(_norm(prev, True), tiny) \
        + nxt / torch.clamp_min(_norm(nxt, True), tiny)
    nrm = torch.stack([tang[:, 1], -tang[:, 0]], dim=-1)
    return nrm / torch.clamp_min(_norm(nrm, True), tiny)


def polyline_curvature(markers):
    """Signed discrete curvature at each marker (Menger curvature of the
    marker triple; positive = convex for counterclockwise markers: a CCW
    circle of radius R gives +1/R).  Feeds the Gibbs-Thomson curvature
    undercooling."""
    prev = torch.roll(markers, 1, dims=0)
    nxt = torch.roll(markers, -1, dims=0)
    e1 = markers - prev
    e2 = nxt - markers
    cross = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    denom = torch.clamp_min(_norm(e1) * _norm(e2) * _norm(nxt - prev), 1e-300)
    return 2.0 * cross / denom


def polygon_area(markers):
    a, b = _segments(markers)
    return 0.5 * torch.sum(a[:, 0] * b[:, 1] - b[:, 0] * a[:, 1])


def polygon_centroid(markers):
    a, b = _segments(markers)
    cross = a[:, 0] * b[:, 1] - b[:, 0] * a[:, 1]
    A = 0.5 * torch.sum(cross)
    cx = torch.sum((a[:, 0] + b[:, 0]) * cross) / (6.0 * A)
    cy = torch.sum((a[:, 1] + b[:, 1]) * cross) / (6.0 * A)
    return torch.stack([cx, cy])


def interface_length(markers):
    a, b = _segments(markers)
    return torch.sum(_norm(b - a))


def resample_markers(markers, n_out=None):
    """Redistribute markers equidistantly along the closed polyline
    (arclength parameterization).  Keeps marker spacing uniform as the
    front deforms."""
    n = markers.shape[0] if n_out is None else n_out
    a = markers
    b = torch.roll(markers, -1, dims=0)
    seg = _norm(b - a)
    cum = torch.cat([seg.new_zeros(1), torch.cumsum(seg, 0)])
    total = cum[-1]
    targets = torch.arange(n, dtype=markers.dtype,
                           device=markers.device) / n * total
    idx = torch.clamp(torch.searchsorted(cum, targets, right=True) - 1, 0,
                      markers.shape[0] - 1)
    t = (targets - cum[idx]) / torch.clamp_min(seg[idx], 1e-300)
    return a[idx] + t[:, None] * (b[idx] - a[idx])


def smooth_displacements(disp, window=3, passes=1):
    """Circular moving-average smoothing of marker displacements.

    ``window`` must be odd: an even window has no centre, and its circular
    padding would change the length."""
    if window % 2 == 0:
        raise ValueError(
            f"smooth_displacements window must be odd, got {window}"
        )
    half = window // 2
    n = disp.shape[0]
    out = disp
    for _ in range(passes):
        padded = torch.cat([out[n - half:], out, out[:half]])
        acc = padded[0:n] * (1.0 / window)
        for k in range(1, window):
            acc = acc + padded[k:k + n] * (1.0 / window)
        out = acc
    return out


def compute_volume_jacobian(mesh, markers, sign=1.0, p=4, s=1,
                            chunk_size=None):
    """d(cell fluid volume)/d(marker normal displacement) by forward-mode
    autodiff through the quadrature.

    Returns a dense tensor of shape (nx+1, ny+1, n_markers).  ``chunk_size``
    bounds how many marker tangents are carried at once (None = all of
    them: memory grows with n_markers × the quadrature's intermediates).
    The SDF runs in segment blocks of 32, the JAX version's block, so a
    query tied between three or more segments splits its tangent alike."""
    from .quadrature import box_integrals
    from .capacity import _pad_cells

    nx, ny = mesh.n
    like = dict(dtype=markers.dtype, device=markers.device)
    nodes_x = torch.as_tensor(np.asarray(mesh.nodes[0]), **like)
    nodes_y = torch.as_tensor(np.asarray(mesh.nodes[1]), **like)
    lox, hix = nodes_x[:-1].reshape(nx, 1), nodes_x[1:].reshape(nx, 1)
    loy, hiy = nodes_y[:-1].reshape(1, ny), nodes_y[1:].reshape(1, ny)
    normals = polyline_normals(markers)

    def volumes(d):
        mk = markers + d[:, None] * normals

        def body(xx, yy):
            return sign * polyline_sdf(mk, xx, yy, chunk=32)

        V, _ = box_integrals(body, [lox, loy], [hix, hiy], p=p, s=s)
        return _pad_cells(V, mesh.np_shape).reshape(-1)

    # jacfwd written out (a vmap of jvp over the identity's rows), because
    # vmap takes the chunk size and jacfwd does not
    n = markers.shape[0]
    d0 = torch.zeros(n, **like)
    J = torch.func.vmap(
        lambda v: torch.func.jvp(volumes, (d0,), (v,))[1],
        chunk_size=chunk_size)(torch.eye(n, **like)).T
    return J.reshape(mesh.np_shape[0], mesh.np_shape[1], markers.shape[0])


# ---------------------------------------------------------------------------
# intercept (segment) parameterization: the Hybrid-LS-style interface
# representation (reference front_tracking.jl:2456-2752)
# ---------------------------------------------------------------------------

def segment_parameters(markers):
    """Per-segment (normals, intercepts, lengths, midpoints) for the closed
    polyline; segment i runs marker i -> i+1 (mod n).  The outward unit
    normal of segment (dx,dy) is (dy,-dx) for counterclockwise markers, the
    orientation resolved from the signed polygon area."""
    a, b = _segments(markers)
    d = b - a
    lengths = _norm(d)
    safe = torch.clamp_min(lengths, 1e-300)
    orient = torch.sign(polygon_area(markers))
    orient = torch.where(orient == 0, 1.0, orient)
    normals = orient * torch.stack([d[:, 1], -d[:, 0]], dim=-1) / safe[:, None]
    up = torch.stack([torch.zeros_like(lengths), torch.ones_like(lengths)],
                     dim=-1)
    normals = torch.where(lengths[:, None] > 1e-15, normals, up)
    intercepts = torch.sum(normals * a, dim=-1)
    midpoints = 0.5 * (a + b)
    return normals, intercepts, lengths, midpoints


def _axis_window(p0, dd, lo, hi):
    """t-interval where ``p0 + t·dd`` lies in [lo, hi]."""
    moving = dd.abs() > 1e-300
    dd_safe = torch.where(moving, dd, 1.0)
    t0 = (lo - p0) / dd_safe
    t1 = (hi - p0) / dd_safe
    inside = (p0 >= lo) & (p0 <= hi)
    inf = float("inf")
    tmin = torch.where(moving, torch.minimum(t0, t1),
                       torch.where(inside, -inf, inf))
    tmax = torch.where(moving, torch.maximum(t0, t1),
                       torch.where(inside, inf, -inf))
    return tmin, tmax


def _segment_cell_windows(mesh, markers):
    """Liang-Barsky windows of every segment against every cell: the
    entering and leaving parameters, shape (nx, ny, n_segments), unclipped,
    and the segment lengths."""
    a, b = _segments(markers)
    d = b - a  # (ns, 2)
    seg_len = _norm(d)

    nx, ny = mesh.n[:2]
    like = dict(dtype=markers.dtype, device=markers.device)
    nodes_x = torch.as_tensor(np.asarray(mesh.nodes[0]), **like)
    nodes_y = torch.as_tensor(np.asarray(mesh.nodes[1]), **like)
    lox, hix = nodes_x[:-1].reshape(nx, 1, 1), nodes_x[1:].reshape(nx, 1, 1)
    loy, hiy = nodes_y[:-1].reshape(1, ny, 1), nodes_y[1:].reshape(1, ny, 1)

    txm, txM = _axis_window(a[None, None, :, 0], d[None, None, :, 0], lox, hix)
    tym, tyM = _axis_window(a[None, None, :, 1], d[None, None, :, 1], loy, hiy)
    return torch.maximum(txm, tym), torch.minimum(txM, tyM), seg_len


def segment_cell_intersections(mesh, markers):
    """Length of each interface segment clipped to each grid cell, shape
    ``(nx, ny, n_segments)``, by Liang-Barsky parametric clipping."""
    t_in, t_out, seg_len = _segment_cell_windows(mesh, markers)
    t_in = torch.clamp_min(t_in, 0.0)
    t_out = torch.clamp_max(t_out, 1.0)
    return torch.clamp_min(t_out - t_in, 0.0) * seg_len[None, None, :]


def segment_cell_intersection_moments(mesh, markers):
    """Zeroth and first parametric moments of each segment∩cell interval:
    ``L0 = ∫ ds`` (the intersection length) and ``L1 = ∫ t ds`` with t the
    segment parameter (0 at the start marker).  L1 weights a *linear* tilt
    of the segment: the exact sensitivity of swept area to moving one
    endpoint (marker i sweeps L1 on its incoming segment i-1 and L0-L1 on
    its outgoing segment i)."""
    t_in, t_out, seg_len = _segment_cell_windows(mesh, markers)
    t_in = torch.clamp(t_in, 0.0, 1.0)
    t_out = torch.clamp(t_out, 0.0, 1.0)
    span = torch.clamp_min(t_out - t_in, 0.0)
    L0 = span * seg_len[None, None, :]
    L1 = torch.where(span > 0, 0.5 * (t_out ** 2 - t_in ** 2), 0.0) \
        * seg_len[None, None, :]
    return L0, L1


def intercept_jacobian(mesh, markers, density=1.0):
    """d V_cell / d delta_I for intercept displacements delta_I along
    segment normals: J[cell, I] = rho · |segment I ∩ cell|.  Returns
    (J(nx,ny,ns), normals, intercepts, lengths)."""
    normals, intercepts, lengths, _ = segment_parameters(markers)
    J = density * segment_cell_intersections(mesh, markers)
    return J, normals, intercepts, lengths


def update_front_with_intercept_displacements(markers, displacements,
                                              normals, lengths):
    """Move each marker by the segment-length-weighted average of its two
    adjacent segments' displacement vectors delta_I n_I."""
    w = torch.clamp_min(lengths, 1e-10)
    vec = displacements[:, None] * normals  # (ns, 2)
    # marker i joins segment i (as start) and segment i-1 (as end)
    w_prev = torch.roll(w, 1)
    v_prev = torch.roll(vec, 1, dims=0)
    avg = (w[:, None] * vec + w_prev[:, None] * v_prev) / (w + w_prev)[:, None]
    return markers + avg


class FrontTracker:
    """Thin stateful wrapper mirroring the reference API; the functional
    kernels above do the work.  Markers given as a tensor keep their device;
    anything else, and the ``create_*`` shapes, go to ``device``, by default
    the CUDA device."""

    def __init__(self, markers=None, dtype=torch.float64, device=None):
        if isinstance(markers, torch.Tensor):
            dtype, device = markers.dtype, markers.device
        self.dtype = dtype
        self.device = resolve_device(device)
        self.markers = None if markers is None else torch.as_tensor(
            markers, dtype=dtype, device=self.device)

    def _like(self):
        return dict(dtype=self.dtype, device=self.device)

    # reference-style mutating constructors
    def create_circle(self, center, radius, n=64):
        self.markers = markers_circle(center, radius, n, **self._like())
        return self

    def create_rectangle(self, lo, hi, n_per_side=16):
        self.markers = markers_rectangle(lo, hi, n_per_side, **self._like())
        return self

    def create_ellipse(self, center, rx, ry, n=64):
        self.markers = markers_ellipse(center, rx, ry, n, **self._like())
        return self

    def create_crystal(self, center, radius, n=96, n_lobes=6, amplitude=0.2):
        self.markers = markers_crystal(center, radius, n, n_lobes, amplitude,
                                       **self._like())
        return self

    def create_ngon(self, center, radius, n_sides, n=60, phase=0.0):
        self.markers = markers_ngon(center, radius, n_sides, n, phase,
                                    **self._like())
        return self

    def sdf(self, x, y):
        return polyline_sdf(self.markers, x, y)

    def normals(self):
        return polyline_normals(self.markers)

    def area(self):
        return float(polygon_area(self.markers))

    def centroid(self):
        return polygon_centroid(self.markers).detach().cpu().numpy()

    def length(self):
        return float(interface_length(self.markers))

    def segment_parameters(self):
        return segment_parameters(self.markers)

    def intercept_jacobian(self, mesh, density=1.0):
        return intercept_jacobian(mesh, self.markers, density)

    def apply_intercept_displacements(self, displacements):
        normals, _, lengths, _ = segment_parameters(self.markers)
        self.markers = update_front_with_intercept_displacements(
            self.markers, displacements, normals, lengths)
        return self

    def body(self):
        """SDF callable for the capacity engine."""
        m = self.markers

        def b(x, y):
            return polyline_sdf(m, x, y)

        return b

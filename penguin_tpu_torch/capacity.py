"""Cut-cell capacity construction (geometric moments) in torch.

Counterpart of ``penguin_tpu.capacity`` on its dense static path: for a
signed-distance ``body`` and a Cartesian mesh it produces the diagonal
"capacities" that parameterize every discrete operator:

- ``V``    : wetted volume per cell                       (0-moment)
- ``A[d]`` : wetted area of the lower face of each cell along axis ``d``
- ``B[d]`` : wetted measure of the plane through the cell centroid with
             coordinate ``d`` fixed
- ``W[d]`` : staggered volumes between adjacent cell centroids
- ``C_om`` : cell centroids, ``C_ga``: interface centroids
- ``Gamma``: interface measure per cell
- ``cell_types``: 1 full / -1 cut / 0 empty
- ``Am``, ``Bm``, ``Vh``: the cut first moments (``cut_moments``)

All tensors live on the padded DOF grid of shape ``(n_1+1, ..., n_N+1)``
(see ``mesh.py``), in the requested dtype on the requested device.  Every
update is out of place, so the build stays differentiable.  Guard constants
and dtype-dependent thresholds are Python scalars, as in the JAX version.

Not ported yet (ROADMAP Queue 1 item 6): the narrow-band engine
(``band_budget``) and the space-time build (``compute_capacity_spacetime``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .quadrature import box_integrals

__all__ = ["Capacity", "compute_capacity", "compute_capacity_spacetime"]


@dataclasses.dataclass
class Capacity:
    A: tuple
    B: tuple
    V: torch.Tensor
    W: tuple
    C_om: torch.Tensor  # shape np_shape + (N,)
    C_ga: torch.Tensor  # shape np_shape + (N,)
    Gamma: torch.Tensor
    cell_types: torch.Tensor  # int8: 0 empty, 1 full, -1 cut
    mesh: object = dataclasses.field(default=None)
    body: object = dataclasses.field(default=None, compare=False)
    # cut first moments (see penguin_tpu.capacity.Capacity): Am[d] wet face
    # centroid, Bm[d] wet centroid-plane centroid (np_shape + (N,) each),
    # Vh[d] wetted volume of the lower half-cell along d
    Am: tuple = None
    Bm: tuple = None
    Vh: tuple = None

    @property
    def ndim(self):
        return len(self.A)

    @property
    def np_shape(self):
        return tuple(self.V.shape)


def _cell_bounds(mesh, dtype, device):
    """Per-dim broadcastable lower/upper cell bounds over the cell grid."""
    N = mesh.ndim
    lo, hi = [], []
    for d in range(N):
        shp = [1] * N
        shp[d] = mesh.n[d]
        nodes = torch.as_tensor(np.asarray(mesh.nodes[d]), dtype=dtype,
                                device=device)
        lo.append(nodes[:-1].reshape(shp))
        hi.append(nodes[1:].reshape(shp))
    return lo, hi


def _pad_axes(arr, widths):
    """Zero-pad ``arr`` by ``widths[d] = (before, after)`` along each axis."""
    flat = []
    for before, after in reversed(widths):
        flat += [before, after]
    return F.pad(arr, flat)


def _pad_cells(arr, np_shape):
    """Embed a cell-grid tensor into the padded DOF grid (zeros elsewhere)."""
    return _pad_axes(arr, [(0, np_shape[d] - arr.shape[d])
                           for d in range(len(np_shape))])


def _insert(coords, d, value):
    coords = list(coords)
    coords.insert(d, value)
    return coords


# Relative volume below which a face adjoining the cell starts to close
# (smoothstep ramp); see penguin_tpu.capacity._face_open_fraction.
_FACE_GATE_REL = 1e-3

# aperture-divergence carrier threshold (relative to the full face measure)
_CARRIER_REL_TOL = 1e-10


def _face_open_fraction(V_cells, full_vol, d, n):
    """Per-face openness in [0, 1] along axis d (n[d]+1 slots): exactly 0
    where an adjacent cell has zero fluid volume, smoothly ramping to 1 as
    that volume reaches ``_FACE_GATE_REL`` of the full cell.  Faces at the
    domain border (slots 0 and n[d]) stay fully open."""
    N = len(n)
    t = torch.clamp(V_cells / (_FACE_GATE_REL * full_vol.expand(n)), 0.0, 1.0)
    g = t * t * (3.0 - 2.0 * t)  # smoothstep
    ones_plane = torch.ones(tuple(1 if i == d else n[i] for i in range(N)),
                            dtype=g.dtype, device=g.device)
    lo_g = torch.cat([ones_plane, g.narrow(d, 0, n[d] - 1), ones_plane],
                     dim=d)                                # cell k-1 at face k
    hi_g = torch.cat([ones_plane, g.narrow(d, 1, n[d] - 1), ones_plane],
                     dim=d)                                # cell k at face k
    return lo_g * hi_g


def _gamma_from_apertures(A, is_empty, is_cut, full_vol, lo, hi, n):
    """Interface measure from the aperture-divergence identity: a cell
    carries interface closure wherever its aperture divergence is nonzero,
    not only where the volume classification says 'cut'.

    Returns ``(is_cut, cell_types, Gamma_cells)``."""
    N = len(n)
    S2 = None
    for d in range(N):
        cells = tuple(slice(0, n[i]) for i in range(N))
        upper = tuple(slice(1, n[d] + 1) if i == d else slice(0, n[i])
                      for i in range(N))
        Sd = A[d][cells] - A[d][upper]
        S2 = Sd * Sd if S2 is None else S2 + Sd * Sd
    face_meas = torch.zeros_like(S2)
    for d in range(N):
        face_meas = torch.maximum(face_meas,
                                  (full_vol / (hi[d] - lo[d])).expand(n))
    carrier = (~is_empty) & (S2 > (_CARRIER_REL_TOL * face_meas) ** 2)
    is_cut = is_cut | carrier
    cell_types = torch.where(is_empty, 0, torch.where(is_cut, -1, 1)
                             ).to(torch.int8)
    Gamma_cells = torch.where(is_cut, torch.sqrt(torch.where(is_cut, S2, 1.0)),
                              0.0)
    return is_cut, cell_types, Gamma_cells


def compute_capacity(body, mesh, p: int = 8, s: int = 2,
                     dtype=torch.float64, device="cpu", band_budget=None,
                     cut_moments="auto") -> Capacity:
    """Compute all cut-cell capacities for ``body`` on ``mesh`` (the dense
    static path of ``penguin_tpu.capacity.compute_capacity``).

    ``body`` must accept ``mesh.ndim`` coordinate tensors (broadcasting) and
    return the signed distance (negative = fluid).  ``cut_moments="auto"``
    builds the cut moments Am/Bm/Vh for N >= 2, as the JAX default does for
    static geometry.  The JAX version's ``params`` and
    ``compute_centroids=False`` have no caller on the static path and are
    left out.
    """
    if band_budget is not None:
        raise NotImplementedError(
            "the narrow-band capacity path (band_budget) is not ported yet: "
            "ROADMAP Queue 1 item 6")
    if cut_moments == "auto":
        cut_moments = mesh.ndim >= 2
    return _capacity_impl(body, mesh, dtype, torch.device(device), p, s,
                          bool(cut_moments))


def compute_capacity_spacetime(*args, **kwargs):
    raise NotImplementedError(
        "space-time capacities are not ported yet: ROADMAP Queue 1 item 6")


def _capacity_impl(body, mesh, dtype, device, p, s, cut_moments):
    n = mesh.n
    N = len(n)
    np_shape = mesh.np_shape
    lo, hi = _cell_bounds(mesh, dtype, device)

    # --- volumes + centroids -------------------------------------------------
    V_cells, moms = box_integrals(body, lo, hi, p=p, s=s)
    full_vol = 1.0
    for d in range(N):
        full_vol = full_vol * (hi[d] - lo[d])
    eps = 1e-10 if dtype.itemsize >= 8 else 2e-5
    is_empty = V_cells <= eps * full_vol
    is_full = V_cells >= (1.0 - eps) * full_vol
    is_cut = (~is_empty) & (~is_full)
    V_cells = torch.where(is_empty, 0.0,
                          torch.where(is_full, full_vol.expand(n), V_cells))

    box_center = [(0.5 * (lo[d] + hi[d])).expand(n) for d in range(N)]
    Vsafe = torch.clamp_min(V_cells, 1e-300)
    C_cells = [torch.where(is_cut, moms[d] / Vsafe, box_center[d])
               for d in range(N)]

    # --- face capacities A[d] (and wet-face centroids Am[d]) -----------------
    # an interior face with fluid on only one side is fluid boundary, not a
    # flux face: the smoothstep gate closes it (see penguin_tpu.capacity)
    do_moms = cut_moments and N >= 2
    # relative measure floor for centroid validity (f32 quadrature noise on
    # near-empty faces is ~1e-7 of the measure scale)
    eps_rel = 1e-12 if dtype.itemsize >= 8 else 1e-5
    tiny = torch.finfo(dtype).tiny
    A, Am = [], []
    for d in range(N):
        shp = [1] * N
        shp[d] = n[d] + 1
        fco = torch.as_tensor(np.asarray(mesh.nodes[d]), dtype=dtype,
                              device=device).reshape(shp)
        fshape = tuple(n[i] + 1 if i == d else n[i] for i in range(N))
        if N == 1:
            Ad = (body(fco) <= 0.0).to(dtype)
        else:
            cross_lo = [lo[i] for i in range(N) if i != d]
            cross_hi = [hi[i] for i in range(N) if i != d]

            def phi_face(*cs, _d=d, _f=fco):
                return body(*_insert(cs, _d, _f))

            Ad, Amoms = box_integrals(phi_face, cross_lo, cross_hi, p=p, s=s)
            if do_moms:
                cross_meas_f = 1.0
                for i in range(N):
                    if i != d:
                        cross_meas_f = cross_meas_f * (hi[i] - lo[i])
                eps_m = eps_rel * cross_meas_f
                Asafe = torch.clamp_min(Ad, tiny)
                comps, ci = [], 0
                for i in range(N):
                    if i == d:
                        comps.append(fco.expand(fshape))
                    else:
                        fc = 0.5 * (cross_lo[ci] + cross_hi[ci])
                        cen = torch.where(Ad > eps_m, Amoms[ci] / Asafe, fc)
                        cen = torch.clamp(cen, cross_lo[ci], cross_hi[ci])
                        comps.append(cen.expand(fshape))
                        ci += 1
                Am.append(torch.stack(
                    [_pad_cells(c, np_shape) for c in comps], dim=-1))
            Ad = Ad.expand(fshape)
        Ad = Ad * _face_open_fraction(V_cells, full_vol, d, n)
        A.append(_pad_cells(Ad, np_shape))

    # --- centroid-line capacities B[d] (and their centroids Bm[d]) -----------
    B, Bm = [], []
    for d in range(N):
        ccoord = C_cells[d]
        if N == 1:
            Bd = torch.where(is_empty, 0.0, (body(ccoord) <= 0.0).to(dtype))
        else:
            cross_lo = [lo[i] for i in range(N) if i != d]
            cross_hi = [hi[i] for i in range(N) if i != d]

            def phi_line(*cs, _d=d, _c=ccoord):
                return body(*_insert(cs, _d, _c))

            Bd, Bmoms = box_integrals(phi_line, cross_lo, cross_hi, p=p, s=s)
            if do_moms:
                cross_meas_f = 1.0
                for i in range(N):
                    if i != d:
                        cross_meas_f = cross_meas_f * (hi[i] - lo[i])
                eps_m = eps_rel * cross_meas_f
                Bsafe = torch.clamp_min(Bd, tiny)
                comps, ci = [], 0
                for i in range(N):
                    if i == d:
                        comps.append(ccoord.expand(n))
                    else:
                        cen = torch.where(Bd > eps_m, Bmoms[ci] / Bsafe,
                                          box_center[i])
                        cen = torch.clamp(cen, cross_lo[ci], cross_hi[ci])
                        comps.append(cen.expand(n))
                        ci += 1
                Bm.append(torch.stack(
                    [_pad_cells(c, np_shape) for c in comps], dim=-1))
            Bd = torch.where(is_empty, 0.0, Bd)
        B.append(_pad_cells(Bd.expand(n), np_shape))

    # --- lower-half-cell volumes Vh[d] (cut-moment builds only) -------------
    Vh = []
    if do_moms:
        for d in range(N):
            h_lo = [lo[i].expand(n) for i in range(N)]
            h_hi = [C_cells[d] if i == d else hi[i].expand(n)
                    for i in range(N)]
            Vh_d, _ = box_integrals(body, h_lo, h_hi, p=p, s=s)
            Vh_d = torch.minimum(torch.clamp_min(Vh_d, 0.0), V_cells)
            Vh.append(_pad_cells(Vh_d, np_shape))

    # --- staggered volumes W[d] ---------------------------------------------
    W = []
    for d in range(N):
        if n[d] < 2:
            W.append(torch.zeros(np_shape, dtype=dtype, device=device))
            continue
        st_lo = [C_cells[d].narrow(d, 0, n[d] - 1) if i == d
                 else lo[i].expand(n).narrow(d, 0, n[d] - 1) for i in range(N)]
        st_hi = [C_cells[d].narrow(d, 1, n[d] - 1) if i == d
                 else hi[i].expand(n).narrow(d, 1, n[d] - 1) for i in range(N)]
        Wd, _ = box_integrals(body, st_lo, st_hi, p=p, s=s)
        # faces 1..n_d-1 hold values; faces 0 and n_d stay zero (reference
        # convention, src/capacity.jl:394-430)
        Wd = _pad_axes(Wd, [(1, 0) if i == d else (0, 0) for i in range(N)])
        W.append(_pad_cells(Wd, np_shape))

    # --- interface measure Gamma (divergence identity) -----------------------
    is_cut, cell_types, Gamma_cells = _gamma_from_apertures(
        A, is_empty, is_cut, full_vol, lo, hi, n)

    # --- interface centroids: closest-point projection of cell centers ------
    ctr = box_center
    phi0 = body(*ctr)
    grads = []
    for d in range(N):
        delta = 1e-4 * (hi[d] - lo[d])
        cp = [ctr[i] + delta if i == d else ctr[i] for i in range(N)]
        cm = [ctr[i] - delta if i == d else ctr[i] for i in range(N)]
        grads.append((body(*cp) - body(*cm)) / (2.0 * delta))
    g2 = grads[0] * grads[0]
    for g in grads[1:]:
        g2 = g2 + g * g
    g2 = torch.clamp_min(g2, 1e-300)
    C_ga_cells = [torch.where(is_cut, ctr[d] - phi0 * grads[d] / g2, 0.0)
                  for d in range(N)]

    return Capacity(
        A=tuple(A),
        B=tuple(B),
        V=_pad_cells(V_cells, np_shape),
        W=tuple(W),
        C_om=torch.stack([_pad_cells(C_cells[d].expand(n), np_shape)
                          for d in range(N)], dim=-1),
        C_ga=torch.stack([_pad_cells(C_ga_cells[d], np_shape)
                          for d in range(N)], dim=-1),
        Gamma=_pad_cells(Gamma_cells, np_shape),
        cell_types=_pad_cells(cell_types, np_shape),
        mesh=mesh,
        body=body,
        Am=tuple(Am) if do_moms else None,
        Bm=tuple(Bm) if do_moms else None,
        Vh=tuple(Vh) if do_moms else None,
    )

"""Cut-cell capacity construction (geometric moments) in torch.

Counterpart of ``penguin_tpu.capacity``: for a
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

The static, space-time and narrow-band builds share ``_capacity_impl``: it
takes the node arrays, so a slab is the space nodes plus ``[t0, t1]``.  The
narrow-band engine (``band_budget``) classifies cells and faces from one
nodal pass of the signed distance and runs the quadrature only on the band,
compacted to a buffer of fixed size without a copy to the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ._device import resolve_device
from .diagnostics import span
from .quadrature import box_integrals

__all__ = ["Capacity", "compute_capacity", "compute_capacity_spacetime",
           "compute_cell_volumes", "estimate_band_budget",
           "gamma_half_moments"]


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


def _node_tensors(nodes_list, dtype, device):
    """The node arrays as tensors; an entry that is a tensor already (a
    time slab under differentiation) passes through."""
    return [v.to(dtype=dtype, device=device) if isinstance(v, torch.Tensor)
            else torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
            for v in nodes_list]


def _cell_bounds_from_nodes(nodes, n):
    """Per-dim broadcastable lower/upper cell bounds over the cell grid."""
    N = len(nodes)
    lo, hi = [], []
    for d in range(N):
        shp = [1] * N
        shp[d] = n[d]
        lo.append(nodes[d][:-1].reshape(shp))
        hi.append(nodes[d][1:].reshape(shp))
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


# Narrow-band defaults: cell count above which ``band_budget="auto"`` sizes a
# band, and the Lipschitz safety factor on the SDF margin test.
_BAND_AUTO_MIN_CELLS = 16384
_BAND_DEFAULT_SAFETY = 2.0


def _tree_leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in _tree_leaves(v)]
    return []


def _is_traced(tree):
    """True when a tensor of ``tree`` is inside a ``torch.func`` transform
    (its value cannot be read on the host, so no budget can be sized)."""
    wrapped = getattr(torch._C._functorch, "is_functorch_wrapped_tensor",
                      None)
    return wrapped is not None and any(wrapped(leaf)
                                       for leaf in _tree_leaves(tree))


def _wrap(body, params):
    return body if params is None else (lambda *cs: body(*cs, params))


def _round_budget(count, ncells):
    """Round a band-cell count up to the next power of two (>=1024), so a
    geometry sweep meets few distinct buffer sizes."""
    b = 1024
    while b < count:
        b *= 2
    return min(b, ncells)


def compute_capacity(body, mesh, p: int = 8, s: int = 2,
                     dtype=torch.float64, device=None,
                     compute_centroids: bool = True, params=None,
                     band_budget=None,
                     band_safety: float = _BAND_DEFAULT_SAFETY,
                     cut_moments="auto") -> Capacity:
    """Compute all cut-cell capacities for ``body`` on ``mesh``.

    ``body`` must accept ``mesh.ndim`` coordinate tensors (broadcasting) and
    return the signed distance (negative = fluid), or, when ``params`` is
    given, ``body(*coords, params)`` with ``params`` a tensor or a
    tuple/list/dict of tensors; the build is differentiable in them under
    ``torch.func``.  ``cut_moments="auto"`` builds the cut moments Am/Bm/Vh
    for N >= 2 unless ``params`` is inside a ``torch.func`` transform.  The
    tensors go to ``device``, by default the CUDA device (see ``_device``).

    ``band_budget`` enables the narrow-band path: cells whose corner SDF
    values exceed ``band_safety`` x (half cell diagonal) in magnitude are
    classified full or empty from one nodal SDF pass and quadrature runs
    only on the remaining band, compacted to a buffer of ``band_budget``
    entries.  ``"auto"`` sizes the budget from the geometry (one read on the
    host) and keeps the dense path on small grids or transformed params;
    ``None`` keeps the dense path; an int is used as it is.  Band cells
    beyond the budget keep their corner-sign full/empty value.  Requires
    ``body`` to be an actual signed distance (|grad phi| <= 1, up to
    ``band_safety``).
    """
    device = resolve_device(device)
    if cut_moments == "auto":
        cut_moments = mesh.ndim >= 2 and not _is_traced(params)
    wrapped = _wrap(body, params)
    nodes = [np.asarray(v) for v in mesh.nodes]
    with span("capacity.build"):
        if band_budget == "auto":
            if (mesh.ndim >= 2 and mesh.ncells() >= _BAND_AUTO_MIN_CELLS
                    and not _is_traced(params)):
                count = estimate_band_budget(wrapped, nodes, mesh.n, dtype,
                                             band_safety, spacetime=False,
                                             device=device)
                band_budget = _round_budget(count, mesh.ncells())
            else:
                band_budget = None
        return _capacity_impl(wrapped, nodes, mesh.n, dtype, device, p, s,
                              compute_centroids, mesh_ref=mesh,
                              np_shape=mesh.np_shape,
                              band_budget=band_budget,
                              band_safety=float(band_safety),
                              cut_moments=bool(cut_moments))


def _slab_times(t0, t1, dtype, device):
    """``[t0, t1]`` as one tensor.  A Python number becomes a fill on the
    device, not a copy from the host."""
    def one(t):
        if isinstance(t, torch.Tensor):
            return t.to(dtype=dtype, device=device)
        return torch.full((), float(t), dtype=dtype, device=device)

    return torch.stack([one(t0), one(t1)])


def compute_capacity_spacetime(body, space_mesh, t0, t1, p: int = 8,
                               s: int = 2, dtype=torch.float64, device=None,
                               compute_centroids: bool = True, params=None,
                               band_budget=None,
                               band_safety: float = _BAND_DEFAULT_SAFETY,
                               cut_moments: bool = False) -> Capacity:
    """Space-time capacities on the slab [t0, t1]: the nodes are the space
    nodes plus ``[t0, t1]``, one cell deep in time.  ``t0``/``t1`` may be
    Python floats or 0-d tensors.

    ``body`` takes (x..., t), or (x..., t, params) when ``params`` is given;
    ``params`` may be differentiated through (a front position), so the
    interface can move without rebuilding anything else.

    ``band_budget``: an int enables the narrow-band path (see
    ``compute_capacity``), ``"auto"`` sizes it from this slab.  The margin
    test adds the per-column temporal SDF variation |phi(t1)-phi(t0)|, which
    covers bodies whose motion within the slab is monotone.
    """
    device = resolve_device(device)
    t01 = _slab_times(t0, t1, dtype, device)
    wrapped = _wrap(body, params)
    nodes = [np.asarray(v) for v in space_mesh.nodes] + [t01]
    n = tuple(space_mesh.n) + (1,)
    if band_budget == "auto":
        if (space_mesh.ndim >= 2
                and space_mesh.ncells() >= _BAND_AUTO_MIN_CELLS
                and not _is_traced(params) and not _is_traced(t01)):
            count = estimate_band_budget(wrapped, nodes, n, dtype,
                                         band_safety, spacetime=True,
                                         device=device)
            band_budget = _round_budget(count, space_mesh.ncells())
        else:
            band_budget = None
    return _capacity_impl(wrapped, nodes, n, dtype, device, p, s,
                          compute_centroids, mesh_ref=None, spacetime=True,
                          np_shape=tuple(space_mesh.np_shape) + (2,),
                          band_budget=band_budget,
                          band_safety=float(band_safety),
                          cut_moments=bool(cut_moments))


# ---------------------------------------------------------------------------
# narrow-band machinery
# ---------------------------------------------------------------------------

def _pairwise_reduce(arr, axes, op):
    """Reduce adjacent pairs along each listed axis (node grid -> cell grid:
    per-cell corner min/max without materializing 2^N corner gathers)."""
    for d in axes:
        m = arr.shape[d] - 1
        arr = op(arr.narrow(d, 0, m), arr.narrow(d, 1, m))
    return arr


def _band_masks(phi_nodes, n, lo, hi, spacetime, safety):
    """Classify cells and faces from one nodal SDF pass.

    A box is *far* when every corner SDF value clears a margin of
    ``safety`` x (half the box's spatial diagonal): by the SDF Lipschitz
    bound |grad phi| <= 1 the interface then cannot enter the box.  For
    space-time slabs, phi is sampled at both time levels and the per-column
    temporal variation |phi(t1)-phi(t0)| is added to the margin (exact for
    bodies linear in t, e.g. interpolated marker fronts).

    Returns (cell_band, cell_far_full, [(face_band, face_far_full)]_d).
    """
    N = len(n)
    time_axis = N - 1 if spacetime else None
    h2 = [(hi[d] - lo[d]) ** 2 for d in range(N)]
    if spacetime:
        nt = phi_nodes.shape[time_axis] - 1
        dphi = torch.abs(phi_nodes.narrow(time_axis, 1, nt)
                         - phi_nodes.narrow(time_axis, 0, nt))
        dphi = torch.amax(dphi, dim=time_axis)

    def margins(varying):
        m2 = None
        for d in varying:
            if d != time_axis:
                m2 = h2[d] if m2 is None else m2 + h2[d]
        m = 0.0 if m2 is None else 0.5 * safety * torch.sqrt(m2)
        if spacetime and time_axis in varying:
            dp = _pairwise_reduce(
                dphi, [d for d in varying if d != time_axis], torch.maximum)
            m = m + 0.5 * safety * dp[..., None]
        return m

    cmin = _pairwise_reduce(phi_nodes, range(N), torch.minimum)
    cmax = _pairwise_reduce(phi_nodes, range(N), torch.maximum)
    mc = margins(list(range(N)))
    cell_band = (cmin <= mc) & (cmax >= -mc)
    cell_full = cmax < -mc

    faces = []
    for d in range(N):
        cross = [i for i in range(N) if i != d]
        fmin = _pairwise_reduce(phi_nodes, cross, torch.minimum)
        fmax = _pairwise_reduce(phi_nodes, cross, torch.maximum)
        mf = margins(cross)
        fshape = tuple(n[i] + 1 if i == d else n[i] for i in range(N))
        faces.append((((fmin <= mf) & (fmax >= -mf)).expand(fshape),
                      (fmax < -mf).expand(fshape)))
    return cell_band, cell_full, faces


def _nodal_phi(body, nodes, n):
    N = len(n)
    coords = []
    for d in range(N):
        shp = [1] * N
        shp[d] = n[d] + 1
        coords.append(nodes[d].reshape(shp))
    return body(*coords).expand(tuple(nd + 1 for nd in n))


def estimate_band_budget(body, nodes_list, n, dtype, safety,
                         spacetime=False, device=None) -> int:
    """Count the narrow-band work items (max over cells, faces, staggered
    volumes) for ``body`` on the given node grid.  Used to size
    ``band_budget``; for moving geometry multiply by a growth factor.  The
    count is read on the host: one wait for the device."""
    n = tuple(n)
    N = len(n)
    nodes = _node_tensors(nodes_list, dtype, resolve_device(device))
    lo, hi = _cell_bounds_from_nodes(nodes, n)
    phi_nodes = _nodal_phi(body, nodes, n).detach()
    band, _, faces = _band_masks(phi_nodes, n, lo, hi, spacetime,
                                 float(safety))
    counts = [band.sum()]
    for d in range(N):
        counts.append(faces[d][0].sum())
        if n[d] >= 2:
            counts.append((band.narrow(d, 0, n[d] - 1)
                           | band.narrow(d, 1, n[d] - 1)).sum())
    return int(torch.stack(counts).max())


def _compact(mask, budget, total):
    """Static-size compaction: the flat indices of the first ``budget`` True
    entries in order, padded with the sentinel ``total`` (a dummy slot);
    plus clipped gather indices.  A prefix sum places each True entry, so
    the shape never depends on the data and nothing is read on the host."""
    flat = mask.reshape(-1)
    pos = torch.cumsum(flat, 0) - 1
    slot = torch.where(flat & (pos < budget), pos, budget)
    idx = torch.full((budget + 1,), total, dtype=torch.int64,
                     device=flat.device)
    idx = idx.scatter(0, slot, torch.arange(total, device=flat.device))
    idx = idx[:budget]
    return idx, torch.clamp_max(idx, total - 1)


def _scatter_flat(init, idx, values, shape):
    """Scatter compacted values back over an initialized flat tensor, out of
    place (one dummy slot at the end absorbs the sentinel writes)."""
    total = init.numel()
    out = torch.cat([init.reshape(-1), init.new_zeros(1)])
    return out.scatter(0, idx, values.to(init.dtype))[:total].reshape(shape)


def _gather_cells(arr, shape, gidx):
    return arr.expand(shape).reshape(-1)[gidx]


def _prod(seq):
    out = 1
    for v in seq:
        out = out * v
    return out


def _capacity_impl(body, nodes_list, n, dtype, device, p, s,
                   compute_centroids, mesh_ref, spacetime=False,
                   np_shape=None, band_budget=None,
                   band_safety=_BAND_DEFAULT_SAFETY, cut_moments=False):
    n = tuple(n)
    N = len(n)
    if np_shape is None:
        np_shape = tuple(nd + 1 for nd in n)
    nodes = _node_tensors(nodes_list, dtype, device)
    if band_budget is not None and N >= 2:
        return _capacity_impl_band(body, nodes, n, dtype, device, p, s,
                                   compute_centroids, mesh_ref, spacetime,
                                   np_shape, int(band_budget),
                                   float(band_safety),
                                   cut_moments=cut_moments)
    lo, hi = _cell_bounds_from_nodes(nodes, n)
    # For space-time slabs the interface crossing lives in space, so the
    # closed-form axis of the full-box integrals is the last *spatial* axis.
    vol_inner = N - 2 if (spacetime and N >= 2) else None

    # --- volumes + centroids -------------------------------------------------
    with span("capacity.volumes"):
        V_cells, moms = box_integrals(body, lo, hi, p=p, s=s,
                                      inner_axis=vol_inner)
        full_vol = 1.0
        for d in range(N):
            full_vol = full_vol * (hi[d] - lo[d])
        eps = 1e-10 if dtype.itemsize >= 8 else 2e-5
        is_empty = V_cells <= eps * full_vol
        is_full = V_cells >= (1.0 - eps) * full_vol
        is_cut = (~is_empty) & (~is_full)
        V_cells = torch.where(
            is_empty, 0.0, torch.where(is_full, full_vol.expand(n), V_cells))

        box_center = [(0.5 * (lo[d] + hi[d])).expand(n) for d in range(N)]
        Vsafe = torch.clamp_min(V_cells, 1e-300)
        C_cells = [torch.where(is_cut, moms[d] / Vsafe, box_center[d])
                   for d in range(N)]

    # --- face capacities A[d] (and wet-face centroids Am[d]) -----------------
    with span("capacity.faces"):
        # an interior face with fluid on only one side is fluid boundary, not a
        # flux face: the smoothstep gate closes it (see penguin_tpu.capacity).
        # Space-time slabs carry moments on the SPATIAL axes only: the time
        # faces have e_a·n = 0 for every spatial a, so they drop out of the
        # half-box divergence identity behind gamma_half_moments.
        n_mom = (N - 1) if spacetime else N
        do_moms = cut_moments and n_mom >= 2
        # relative measure floor for centroid validity (f32 quadrature noise on
        # near-empty faces is ~1e-7 of the measure scale)
        eps_rel = 1e-12 if dtype.itemsize >= 8 else 1e-5
        tiny = torch.finfo(dtype).tiny
        A, Am = [], []
        for d in range(N):
            shp = [1] * N
            shp[d] = n[d] + 1
            fco = nodes[d].reshape(shp)
            fshape = tuple(n[i] + 1 if i == d else n[i] for i in range(N))
            if N == 1:
                Ad = (body(fco) <= 0.0).to(dtype)
            else:
                cross_lo = [lo[i] for i in range(N) if i != d]
                cross_hi = [hi[i] for i in range(N) if i != d]

                def phi_face(*cs, _d=d, _f=fco):
                    return body(*_insert(cs, _d, _f))

                # slab spatial faces keep the default TIME closed form: the
                # moving solvers interpolate the body linearly in t, so the
                # crossing-time root is exact
                Ad, Amoms = box_integrals(phi_face, cross_lo, cross_hi,
                                          p=p, s=s)
                if do_moms and d < n_mom:
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
                            cen = torch.where(Ad > eps_m,
                                              Amoms[ci] / Asafe, fc)
                            cen = torch.clamp(cen, cross_lo[ci], cross_hi[ci])
                            comps.append(cen.expand(fshape))
                            ci += 1
                    Am.append(torch.stack(
                        [_pad_cells(c, np_shape) for c in comps], dim=-1))
                Ad = Ad.expand(fshape)
            if not spacetime:
                # static builds only: the moving solvers handle near-front
                # slivers of a slab by their own aperture-gated disconnection
                Ad = Ad * _face_open_fraction(V_cells, full_vol, d, n)
            A.append(_pad_cells(Ad, np_shape))

    # --- centroid-line capacities B[d] (and their centroids Bm[d]) -----------
    with span("capacity.lines"):
        B, Bm = [], []
        for d in range(N):
            ccoord = C_cells[d]
            if N == 1:
                Bd = torch.where(is_empty, 0.0,
                                 (body(ccoord) <= 0.0).to(dtype))
            else:
                cross_lo = [lo[i] for i in range(N) if i != d]
                cross_hi = [hi[i] for i in range(N) if i != d]

                def phi_line(*cs, _d=d, _c=ccoord):
                    return body(*_insert(cs, _d, _c))

                Bd, Bmoms = box_integrals(phi_line, cross_lo, cross_hi,
                                          p=p, s=s)
                if do_moms and d < n_mom:
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
    with span("capacity.half_volumes"):
        Vh = []
        if do_moms:
            for d in range(n_mom):
                h_lo = [lo[i].expand(n) for i in range(N)]
                h_hi = [C_cells[d] if i == d else hi[i].expand(n)
                        for i in range(N)]
                Vh_d, _ = box_integrals(body, h_lo, h_hi, p=p, s=s,
                                        inner_axis=vol_inner)
                Vh_d = torch.minimum(torch.clamp_min(Vh_d, 0.0), V_cells)
                Vh.append(_pad_cells(Vh_d, np_shape))

    # --- staggered volumes W[d] ---------------------------------------------
    with span("capacity.staggered"):
        W = []
        for d in range(N):
            if n[d] < 2:
                W.append(torch.zeros(np_shape, dtype=dtype, device=device))
                continue
            st_lo = [C_cells[d].narrow(d, 0, n[d] - 1) if i == d
                     else lo[i].expand(n).narrow(d, 0, n[d] - 1)
                     for i in range(N)]
            st_hi = [C_cells[d].narrow(d, 1, n[d] - 1) if i == d
                     else hi[i].expand(n).narrow(d, 1, n[d] - 1)
                     for i in range(N)]
            Wd, _ = box_integrals(body, st_lo, st_hi, p=p, s=s,
                                  inner_axis=vol_inner)
            # faces 1..n_d-1 hold values; faces 0 and n_d stay zero
            # (reference convention, src/capacity.jl:394-430)
            Wd = _pad_axes(Wd, [(1, 0) if i == d else (0, 0)
                                for i in range(N)])
            W.append(_pad_cells(Wd, np_shape))

    # --- interface measure Gamma (divergence identity) -----------------------
    with span("capacity.interface"):
        is_cut, cell_types, Gamma_cells = _gamma_from_apertures(
            A, is_empty, is_cut, full_vol, lo, hi, n)

        # --- interface centroids: closest-point projection of cell centers
        if compute_centroids:
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
            C_ga_cells = [torch.where(is_cut, ctr[d] - phi0 * grads[d] / g2,
                                      0.0) for d in range(N)]
        else:
            C_ga_cells = [torch.zeros(n, dtype=dtype, device=device)
                          for _ in range(N)]

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
        mesh=mesh_ref,
        body=body,
        Am=tuple(Am) if do_moms else None,
        Bm=tuple(Bm) if do_moms else None,
        Vh=tuple(Vh) if do_moms else None,
    )


def _capacity_impl_band(body, nodes, n, dtype, device, p, s,
                        compute_centroids, mesh_ref, spacetime, np_shape,
                        budget, safety, cut_moments=False):
    """Narrow-band capacity pipeline: one nodal SDF pass classifies every
    cell/face; quadrature runs only on the band, compacted into a buffer of
    ``budget`` entries, so the cost scales with the interface length instead
    of the grid volume.  Budget overflow degrades gracefully: excess band
    cells keep their corner-sign full/empty value."""
    N = len(n)
    ncells = _prod(n)
    lo, hi = _cell_bounds_from_nodes(nodes, n)
    vol_inner = N - 2 if (spacetime and N >= 2) else None

    # detached: the nodal pass only *classifies*.  Capacity values are
    # continuous across band-membership flips, so its tangents are exactly
    # zero, and the masks stay plain tensors under torch.func transforms.
    phi_nodes = _nodal_phi(body, nodes, n).detach()
    band, far_full, face_masks = _band_masks(phi_nodes, n, lo, hi,
                                             spacetime, safety)

    full_vol = 1.0
    for d in range(N):
        full_vol = full_vol * (hi[d] - lo[d])
    full_vol = full_vol.expand(n)
    box_center = [(0.5 * (lo[d] + hi[d])).expand(n) for d in range(N)]
    zeros_n = torch.zeros(n, dtype=dtype, device=device)

    # --- volumes + first moments on the band --------------------------------
    cidx, cg = _compact(band, budget, ncells)
    glo = [_gather_cells(lo[d], n, cg) for d in range(N)]
    ghi = [_gather_cells(hi[d], n, cg) for d in range(N)]
    vol_b, moms_b = box_integrals(body, glo, ghi, p=p, s=s,
                                  inner_axis=vol_inner)
    V_cells = _scatter_flat(torch.where(far_full, full_vol, 0.0),
                            cidx, vol_b, n)
    moms = [_scatter_flat(zeros_n, cidx, moms_b[d], n) for d in range(N)]

    eps = 1e-10 if dtype.itemsize >= 8 else 2e-5
    is_empty = V_cells <= eps * full_vol
    is_full = V_cells >= (1.0 - eps) * full_vol
    is_cut = (~is_empty) & (~is_full)
    V_cells = torch.where(is_empty, 0.0,
                          torch.where(is_full, full_vol, V_cells))
    Vsafe = torch.clamp_min(V_cells, 1e-300)
    C_cells = [torch.where(is_cut, moms[d] / Vsafe, box_center[d])
               for d in range(N)]

    # --- face capacities A[d] on the face band ------------------------------
    # slab builds: moments on the spatial axes only (see the dense path)
    n_mom = (N - 1) if spacetime else N
    do_moms = cut_moments and n_mom >= 2
    eps_rel = 1e-12 if dtype.itemsize >= 8 else 1e-5
    tiny = torch.finfo(dtype).tiny
    A, Am = [], []
    for d in range(N):
        fband, ffull = face_masks[d]
        fshape = tuple(fband.shape)
        nfaces = _prod(fshape)
        cross = [i for i in range(N) if i != d]
        cross_meas = 1.0
        for i in cross:
            cross_meas = cross_meas * (hi[i] - lo[i])
        cross_meas = cross_meas.expand(fshape)

        fidx, fg = _compact(fband, budget, nfaces)
        shp = [1] * N
        shp[d] = n[d] + 1
        fco_full = nodes[d].reshape(shp).expand(fshape)
        fco = fco_full.reshape(-1)[fg]
        cross_lo = [_gather_cells(lo[i], fshape, fg) for i in cross]
        cross_hi = [_gather_cells(hi[i], fshape, fg) for i in cross]

        def phi_face(*cs, _d=d, _f=fco):
            return body(*_insert(cs, _d, _f))

        Ad_b, Amoms_b = box_integrals(phi_face, cross_lo, cross_hi, p=p, s=s)
        Ad = _scatter_flat(torch.where(ffull, cross_meas, 0.0),
                           fidx, Ad_b, fshape)
        if do_moms and d < n_mom:
            eps_m = eps_rel * cross_meas.reshape(-1)[fg]
            Asafe_b = torch.clamp_min(Ad_b, tiny)
            comps, ci = [], 0
            for i in range(N):
                if i == d:
                    comps.append(_pad_cells(fco_full, np_shape))
                else:
                    fc_full = (0.5 * (lo[i] + hi[i])).expand(fshape)
                    cen_b = torch.where(
                        Ad_b > eps_m, Amoms_b[ci] / Asafe_b,
                        0.5 * (cross_lo[ci] + cross_hi[ci]))
                    cen_b = torch.clamp(cen_b, cross_lo[ci], cross_hi[ci])
                    comps.append(_pad_cells(
                        _scatter_flat(fc_full, fidx, cen_b, fshape),
                        np_shape))
                    ci += 1
            Am.append(torch.stack(comps, dim=-1))
        # boundary-face consistency, static builds only (see the dense path)
        if not spacetime:
            Ad = Ad * _face_open_fraction(V_cells, full_vol, d, n)
        A.append(_pad_cells(Ad, np_shape))

    # --- centroid-line capacities B[d] on the cell band ---------------------
    B, Bm = [], []
    for d in range(N):
        cross = [i for i in range(N) if i != d]
        cross_meas = 1.0
        for i in cross:
            cross_meas = cross_meas * (hi[i] - lo[i])
        cross_meas = cross_meas.expand(n)
        ccoord = C_cells[d].reshape(-1)[cg]
        cross_lo = [_gather_cells(lo[i], n, cg) for i in cross]
        cross_hi = [_gather_cells(hi[i], n, cg) for i in cross]

        def phi_line(*cs, _d=d, _c=ccoord):
            return body(*_insert(cs, _d, _c))

        Bd_b, Bmoms_b = box_integrals(phi_line, cross_lo, cross_hi, p=p, s=s)
        Bd = _scatter_flat(torch.where(far_full, cross_meas, 0.0),
                           cidx, Bd_b, n)
        Bd = torch.where(is_empty, 0.0, Bd)
        B.append(_pad_cells(Bd, np_shape))
        if do_moms and d < n_mom:
            eps_m = eps_rel * cross_meas.reshape(-1)[cg]
            Bsafe_b = torch.clamp_min(Bd_b, tiny)
            comps, ci = [], 0
            for i in range(N):
                if i == d:
                    comps.append(_pad_cells(C_cells[d], np_shape))
                else:
                    cen_b = torch.where(Bd_b > eps_m, Bmoms_b[ci] / Bsafe_b,
                                        0.5 * (cross_lo[ci] + cross_hi[ci]))
                    cen_b = torch.clamp(cen_b, cross_lo[ci], cross_hi[ci])
                    comps.append(_pad_cells(
                        _scatter_flat(box_center[i], cidx, cen_b, n),
                        np_shape))
                    ci += 1
            Bm.append(torch.stack(comps, dim=-1))

    # --- lower-half-cell volumes Vh[d] (cut-moment builds only) -------------
    Vh = []
    if do_moms:
        for d in range(n_mom):
            h_lo = [_gather_cells(lo[i], n, cg) for i in range(N)]
            h_hi = [(C_cells[d].reshape(-1)[cg] if i == d
                     else _gather_cells(hi[i], n, cg)) for i in range(N)]
            Vh_b, _ = box_integrals(body, h_lo, h_hi, p=p, s=s,
                                    inner_axis=vol_inner)
            Vh_d = _scatter_flat(torch.where(far_full, 0.5 * full_vol, 0.0),
                                 cidx, Vh_b, n)
            Vh_d = torch.minimum(torch.clamp_min(Vh_d, 0.0), V_cells)
            Vh.append(_pad_cells(Vh_d, np_shape))

    # --- staggered volumes W[d] (band = either adjacent cell banded) --------
    W = []
    for d in range(N):
        if n[d] < 2:
            W.append(torch.zeros(np_shape, dtype=dtype, device=device))
            continue
        m = n[d] - 1
        wband = band.narrow(d, 0, m) | band.narrow(d, 1, m)
        wfull = far_full.narrow(d, 0, m) & far_full.narrow(d, 1, m)
        wshape = tuple(wband.shape)
        nw = _prod(wshape)
        # far value: exact slab between the two (box-center) centroids
        Cd0 = C_cells[d].narrow(d, 0, m)
        Cd1 = C_cells[d].narrow(d, 1, m)
        cross_meas = 1.0
        for i in range(N):
            if i != d:
                cross_meas = cross_meas * (hi[i] - lo[i]).expand(n).narrow(
                    d, 0, m)
        w_far = (Cd1 - Cd0) * cross_meas

        widx, wg = _compact(wband, budget, nw)
        st_lo = [(Cd0 if i == d else lo[i].expand(n).narrow(d, 0, m)
                  ).reshape(-1)[wg] for i in range(N)]
        st_hi = [(Cd1 if i == d else hi[i].expand(n).narrow(d, 0, m)
                  ).reshape(-1)[wg] for i in range(N)]
        Wd_b, _ = box_integrals(body, st_lo, st_hi, p=p, s=s,
                                inner_axis=vol_inner)
        Wd = _scatter_flat(torch.where(wfull, w_far, 0.0), widx, Wd_b, wshape)
        Wd = _pad_axes(Wd, [(1, 0) if i == d else (0, 0) for i in range(N)])
        W.append(_pad_cells(Wd, np_shape))

    # --- interface measure Gamma (divergence identity, dense & cheap) -------
    is_cut, cell_types, Gamma_cells = _gamma_from_apertures(
        A, is_empty, is_cut, full_vol, lo, hi, n)

    # --- interface centroids: closest-point projection, band only -----------
    if compute_centroids:
        ctr_g = [_gather_cells(box_center[d], n, cg) for d in range(N)]
        dg = [_gather_cells(hi[d] - lo[d], n, cg) for d in range(N)]
        phi0 = body(*ctr_g)
        grads = []
        for d in range(N):
            delta = 1e-4 * dg[d]
            cp = [ctr_g[i] + delta if i == d else ctr_g[i] for i in range(N)]
            cm = [ctr_g[i] - delta if i == d else ctr_g[i] for i in range(N)]
            grads.append((body(*cp) - body(*cm)) / (2.0 * delta))
        g2 = grads[0] * grads[0]
        for g in grads[1:]:
            g2 = g2 + g * g
        g2 = torch.clamp_min(g2, 1e-300)
        C_ga_cells = [
            torch.where(is_cut,
                        _scatter_flat(zeros_n, cidx,
                                      ctr_g[d] - phi0 * grads[d] / g2, n),
                        0.0)
            for d in range(N)]
    else:
        C_ga_cells = [zeros_n for _ in range(N)]

    return Capacity(
        A=tuple(A),
        B=tuple(B),
        V=_pad_cells(V_cells, np_shape),
        W=tuple(W),
        C_om=torch.stack([_pad_cells(C_cells[d], np_shape)
                          for d in range(N)], dim=-1),
        C_ga=torch.stack([_pad_cells(C_ga_cells[d], np_shape)
                          for d in range(N)], dim=-1),
        Gamma=_pad_cells(Gamma_cells, np_shape),
        cell_types=_pad_cells(cell_types, np_shape),
        mesh=mesh_ref,
        body=body,
        Am=tuple(Am) if do_moms else None,
        Bm=tuple(Bm) if do_moms else None,
        Vh=tuple(Vh) if do_moms else None,
    )


# ---------------------------------------------------------------------------
# interface half-strip moments
# ---------------------------------------------------------------------------

def _shift_hi(x, d):
    """y[k] = x[k+1] along axis d, zero in the last slot."""
    widths = [(0, 1) if i == d else (0, 0) for i in range(x.ndim)]
    return _pad_axes(x, widths).narrow(d, 1, x.shape[d])


def _padded_nodes(mesh, a, np_shape, dtype, device):
    """Per-cell lower face coordinate along ``a`` on the padded grid (the
    padding slots repeat the last node), broadcastable over ``np_shape``."""
    nd = mesh.n[a] + 1
    nod = np.zeros(np_shape[a])
    nod[:nd] = np.asarray(mesh.nodes[a])
    nod[nd:] = nod[nd - 1]
    shp = [1] * len(np_shape)
    shp[a] = np_shape[a]
    return torch.as_tensor(nod.reshape(shp), dtype=dtype, device=device)


def gamma_half_moments(capacity):
    """Per-axis, per-half-strip interface moments for the moment-consistent
    cut-flux closure.

    The flux operator's u_gamma coefficients at face k along axis ``a`` are
    ``S_lo(k) = A_a(k) - B_a(k)`` (the lo half of cell k) and
    ``S_hi(k-1) = B_a(k-1) - A_a(k)`` (the hi half of cell k-1): the
    n_a-weighted interface measures by the divergence identity.  The
    matching first moments follow from Gauss with F = x_j e_a over each wet
    half-cell:

    - lo half:  ``int x_j n_a = A·Am_j - B·Bm_j``  (j != a),
                ``int x_a n_a = Vh - C_a·B + node_lo·A``
    - hi half:  ``int x_j n_a = B·Bm_j - A_hi·Am_hi_j``  (j != a),
                ``int x_a n_a = (V-Vh) - node_hi·A_hi + C_a·B``

    Returns a list over axes ``a`` of ``(S_lo, X_lo, S_hi, X_hi)`` with
    ``S_*`` the signed measures (np_shape) and ``X_*`` the centroids
    ``M/S`` (np_shape + (N,)); where |S| is below a tolerance the centroid
    falls back to ``C_ga`` so any ``g(X) - g(C_ga)`` correction vanishes.
    Requires a ``cut_moments=True`` capacity build.
    """
    if capacity.Bm is None:
        raise ValueError("gamma_half_moments needs a cut_moments=True build")
    N = capacity.ndim
    mesh = capacity.mesh
    np_shape = capacity.np_shape
    V = capacity.V
    dt_, dev = V.dtype, V.device
    C_ga = capacity.C_ga
    h_all = [float(hv) for hv in mesh.h]
    out = []
    for a in range(N):
        A_a = capacity.A[a]
        B_a = capacity.B[a]
        A_hi = _shift_hi(A_a, a)
        C_a = capacity.C_om[..., a]
        Vh = capacity.Vh[a]
        Vhi = V - Vh
        node_lo = _padded_nodes(mesh, a, np_shape, dt_, dev)
        node_hi = _shift_hi(node_lo.expand(np_shape), a)
        S_lo = A_a - B_a
        S_hi = B_a - A_hi
        # tolerance: a tiny fraction of the full cross-face measure
        face_meas = 1.0
        for i in range(N):
            if i != a:
                face_meas *= h_all[i]
        tol = (1e-7 if dt_.itemsize >= 8 else 1e-4) * face_meas
        X_lo, X_hi = [], []
        for j in range(N):
            if j == a:
                M_lo = Vh - C_a * B_a + node_lo * A_a
                M_hi = Vhi - node_hi * A_hi + C_a * B_a
            else:
                AAm = A_a * capacity.Am[a][..., j]
                BBm = B_a * capacity.Bm[a][..., j]
                M_lo = AAm - BBm
                M_hi = BBm - _shift_hi(AAm, a)
            S_lo_safe = torch.where(S_lo.abs() > tol, S_lo, 1.0)
            S_hi_safe = torch.where(S_hi.abs() > tol, S_hi, 1.0)
            # clamp to the cell box along j: an interface centroid lives
            # inside its cell; f32 moment noise divided by small |S| can
            # land far outside and blow up the g(X) evaluation
            clo = _padded_nodes(mesh, j, np_shape, dt_, dev)
            chi = clo + h_all[j]
            X_lo.append(torch.clamp(
                torch.where(S_lo.abs() > tol, M_lo / S_lo_safe,
                            C_ga[..., j]), clo, chi))
            X_hi.append(torch.clamp(
                torch.where(S_hi.abs() > tol, M_hi / S_hi_safe,
                            C_ga[..., j]), clo, chi))
        out.append((S_lo, torch.stack(X_lo, dim=-1),
                    S_hi, torch.stack(X_hi, dim=-1)))
    return out


def compute_cell_volumes(body, mesh, p: int = 4, s: int = 1,
                         dtype=torch.float64, device=None, params=None,
                         band_budget=None,
                         band_safety: float = _BAND_DEFAULT_SAFETY):
    """Cut-cell wetted volumes only (padded cell grid): the lean path for
    volume Jacobians (``torch.func.jacfwd`` with respect to ``params``), so
    the primal stays minimal.  ``band_budget`` as in ``compute_capacity``,
    an int or None."""
    device = resolve_device(device)
    n = tuple(mesh.n)
    N = len(n)
    nodes = _node_tensors([np.asarray(v) for v in mesh.nodes], dtype, device)
    wrapped = _wrap(body, params)
    lo, hi = _cell_bounds_from_nodes(nodes, n)
    if band_budget is None or N < 2:
        V, _ = box_integrals(wrapped, lo, hi, p=p, s=s)
        return _pad_cells(V.expand(n), mesh.np_shape)
    ncells = _prod(n)
    phi_nodes = _nodal_phi(wrapped, nodes, n).detach()
    h2 = (hi[0] - lo[0]) ** 2
    for d in range(1, N):
        h2 = h2 + (hi[d] - lo[d]) ** 2
    margin = 0.5 * float(band_safety) * torch.sqrt(h2.expand(n))
    cmin = _pairwise_reduce(phi_nodes, range(N), torch.minimum)
    cmax = _pairwise_reduce(phi_nodes, range(N), torch.maximum)
    band = (cmin <= margin) & (cmax >= -margin)
    far_full = cmax < -margin
    full_vol = 1.0
    for d in range(N):
        full_vol = full_vol * (hi[d] - lo[d])
    cidx, cg = _compact(band, int(band_budget), ncells)
    glo = [_gather_cells(lo[d], n, cg) for d in range(N)]
    ghi = [_gather_cells(hi[d], n, cg) for d in range(N)]
    vol_b, _ = box_integrals(wrapped, glo, ghi, p=p, s=s)
    V = _scatter_flat(torch.where(far_full, full_vol.expand(n), 0.0),
                      cidx, vol_b, n)
    return _pad_cells(V, mesh.np_shape)

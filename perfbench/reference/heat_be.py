"""Plain reference for the backward-Euler heat cells, in plain PyTorch.

From a configuration (mesh, body, boundary values, tolerance), a traffic mix
(time step, episode length) and a run's inputs (the body centre, the initial
field ``T0`` and the probe, all made by ``perfbench/traffic.py``) it works
out, by default in float64:

- the cut-cell capacities ``V``, ``A[d]``, ``B[d]``, ``W[d]`` of the body on
  the mesh, with the dense quadrature of ``quadrature.py`` (a frozen copy);
- the heat operator in its composed form, never folded to a stencil::

      L x = V x + dt k Σ_d B_d D_dᵀ (W_d⁻¹ D_d (B_d x))   on active cells,
      L x = x                                            elsewhere,

  with ``D_d`` the backward difference whose last slot is zero;
- ``episode_steps`` backward-Euler steps from ``T0``::

      L T⁺ = V T − dt k Σ_d B_d D_dᵀ W_d⁻¹ (A_d D_d T_γ − D_d (B_d T_γ))

  with ``T_γ`` the interface value on cut cells and 0 elsewhere, the border
  cells held at the border value, each step solved by Jacobi-CG to a
  relative residual of ``TIGHTER`` times the configuration's ``cg_tol``,
  so that the reference's own stopping error lies far below the program's.

It imports nothing of the program and takes nothing the program made.
``precision=CONTROL[dtype]`` gives the control: each stage computed with
every tensor in the precision below the configuration's (float32 for
float64) from the float64 result of the stage before it
(the capacities from the mesh, the operator from the float64 capacities,
the steps from that operator), each step's CG run to the configuration's
tolerance or the traffic's ``cg_maxiter``, whichever comes first.

The grid follows the mesh convention the program's users see: ``n`` cells
of width ``h = L/n`` per axis, cell ``i`` spanning ``x0 + (i+0.5)h`` to
``x0 + (i+1.5)h``, on an array of ``n+1`` slots whose last slot is padding;
face ``k`` is the lower face of cell ``k``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.quadrature import box_integrals

TIGHTER = 1e-3        # the float64 solve stops at this share of cg_tol
CG_CHECK = 16         # iterations between two reads of the residual
CG_CAP = 20000        # iterations per step before the reference gives up

FACE_GATE_REL = 1e-3  # relative volume at which a face starts to close
CARRIER_REL = 1e-10   # aperture-divergence threshold of an interface cell
SLIVER = 1e-2         # a capacity below this share of its full measure
                      # amplifies the rounding of its quadrature

# the control's precision: the nearest below the configuration's
CONTROL = {torch.float64: torch.float32, torch.float32: torch.bfloat16}


def empty_rel(dtype):
    """The share of a full cell below which a cell counts as empty: part of
    the method as the configuration's dtype defines it."""
    return 1e-10 if dtype == torch.float64 else 2e-5


# ---------------------------------------------------------------------------
# grid and body
# ---------------------------------------------------------------------------

def sdf(config, centre):
    """Signed distance to the configuration's sphere (circle in 2D) about
    ``centre``: negative inside, where the fluid is."""
    radius = float(config["radius"])

    def phi(*xs):
        r2 = sum((x - c) ** 2 for x, c in zip(xs, centre))
        return torch.sqrt(r2) - radius

    return phi


def grid_nodes(config, dtype, device):
    n, length = int(config["cells"]), float(config["length"])
    h = length / n
    node = np.asarray([(k + 0.5) * h for k in range(n + 1)], dtype=np.float64)
    return [torch.as_tensor(node, dtype=dtype, device=device)
            for _ in range(int(config["ndim"]))]


def _pad_to(x, shape):
    flat = []
    for d in reversed(range(x.dim())):
        flat += [0, shape[d] - x.shape[d]]
    return F.pad(x, flat)


def _along(v, d, N):
    shp = [1] * N
    shp[d] = v.numel()
    return v.reshape(shp)


def _insert(coords, d, value):
    coords = list(coords)
    coords.insert(d, value)
    return coords


# ---------------------------------------------------------------------------
# capacities: the dense static build
# ---------------------------------------------------------------------------

def capacities(phi, nodes, p, s, eps):
    """``dict(V, A, B, W, cut)`` on the padded grid, in ``nodes``' dtype;
    a cell is empty below ``eps`` of its full volume.  ``cut`` marks the
    cells that carry an interface."""
    N = len(nodes)
    n = tuple(v.numel() - 1 for v in nodes)
    shape = tuple(k + 1 for k in n)
    dtype = nodes[0].dtype
    lo = [_along(nodes[d][:-1], d, N) for d in range(N)]
    hi = [_along(nodes[d][1:], d, N) for d in range(N)]
    full = math.prod(hi[d] - lo[d] for d in range(N))

    V, moms = box_integrals(phi, lo, hi, p=p, s=s)
    empty = V <= eps * full
    whole = V >= (1.0 - eps) * full
    cut = ~empty & ~whole
    raw = V
    V = torch.where(empty, 0.0, torch.where(whole, full.expand(n), V))
    centre = [(0.5 * (lo[d] + hi[d])).expand(n) for d in range(N)]
    C = [torch.where(cut, moms[d] / torch.clamp_min(V, 1e-300), centre[d])
         for d in range(N)]

    # the gate closes a face as an adjoining cell's volume goes to zero
    t = torch.clamp(V / (FACE_GATE_REL * full.expand(n)), 0.0, 1.0)
    gate = t * t * (3.0 - 2.0 * t)

    A = []
    for d in range(N):
        cross_lo = [lo[i] for i in range(N) if i != d]
        cross_hi = [hi[i] for i in range(N) if i != d]
        face = _along(nodes[d], d, N)
        Ad, _ = box_integrals(lambda *cs, _d=d, _f=face:
                              phi(*_insert(cs, _d, _f)),
                              cross_lo, cross_hi, p=p, s=s)
        fshape = tuple(n[i] + 1 if i == d else n[i] for i in range(N))
        one = torch.ones(tuple(1 if i == d else n[i] for i in range(N)),
                         dtype=dtype, device=V.device)
        below = torch.cat([one, gate.narrow(d, 0, n[d] - 1), one], dim=d)
        above = torch.cat([one, gate.narrow(d, 1, n[d] - 1), one], dim=d)
        A.append(_pad_to(Ad.expand(fshape) * below * above, shape))

    B = []
    for d in range(N):
        cross_lo = [lo[i] for i in range(N) if i != d]
        cross_hi = [hi[i] for i in range(N) if i != d]
        Bd, _ = box_integrals(lambda *cs, _d=d, _c=C[d]:
                              phi(*_insert(cs, _d, _c)),
                              cross_lo, cross_hi, p=p, s=s)
        B.append(_pad_to(torch.where(empty, 0.0, Bd).expand(n), shape))

    W = []
    for d in range(N):
        m = n[d] - 1
        st_lo = [C[d].narrow(d, 0, m) if i == d
                 else lo[i].expand(n).narrow(d, 0, m) for i in range(N)]
        st_hi = [C[d].narrow(d, 1, m) if i == d
                 else hi[i].expand(n).narrow(d, 1, m) for i in range(N)]
        Wd, _ = box_integrals(phi, st_lo, st_hi, p=p, s=s)
        # staggered volume k lies between cells k-1 and k: slot 0 stays 0
        W.append(_pad_to(F.pad(Wd, [0, 0] * (N - 1 - d) + [1, 0]), shape))

    # interface cells: wherever the apertures do not balance
    S2 = 0.0
    face_meas = torch.zeros(n, dtype=dtype, device=V.device)
    cells = tuple(slice(0, k) for k in n)
    for d in range(N):
        upper = tuple(slice(1, n[d] + 1) if i == d else slice(0, n[i])
                      for i in range(N))
        S2 = S2 + (A[d][cells] - A[d][upper]) ** 2
        face_meas = torch.maximum(face_meas,
                                  (full / (hi[d] - lo[d])).expand(n))
    cut = cut | (~empty & (S2 > (CARRIER_REL * face_meas) ** 2))
    return dict(V=_pad_to(V, shape), A=A, B=B, W=W, cut=_pad_to(cut, shape),
                raw=_pad_to(raw, shape))


# ---------------------------------------------------------------------------
# the heat operator in composed form
# ---------------------------------------------------------------------------

def _zlast(x, d):
    return F.pad(x.narrow(d, 0, x.shape[d] - 1),
                 [0, 0] * (x.dim() - 1 - d) + [0, 1])


def _prev(x, d):
    """y[k] = x[k-1], y[0] = 0."""
    return F.pad(x, [0, 0] * (x.dim() - 1 - d) + [1, 0]).narrow(
        d, 0, x.shape[d])


def _next(x, d):
    """y[k] = x[k+1], y[last] = 0."""
    return F.pad(x, [0, 0] * (x.dim() - 1 - d) + [0, 1]).narrow(
        d, 1, x.shape[d])


def D(x, d):
    """Backward difference, last slot zero."""
    return _zlast(x, d) - _prev(x, d)


def Dt(q, d):
    """Transpose of ``D``."""
    return _zlast(q - _next(q, d), d)


def border_mask(n, N, device):
    """The outermost real cells along each axis (the padding slot is not a
    border cell)."""
    shape = (n + 1,) * N
    idx = torch.arange(n + 1, device=device)
    edge = torch.zeros(shape, dtype=torch.bool, device=device)
    real = torch.ones(shape, dtype=torch.bool, device=device)
    for d in range(N):
        edge = edge | _along((idx == 0) | (idx == n - 1), d, N)
        real = real & _along(idx < n, d, N)
    return edge & real


class HeatOperator:
    """``L`` and the constant right-hand side of one backward-Euler step."""

    def __init__(self, cap, config, dt):
        N = int(config["ndim"])
        n = int(config["cells"])
        k = float(config["diffusivity"])
        self.N, self.dt, self.k = N, dt, k
        self.V, self.B = cap["V"], cap["B"]
        self.Winv = [torch.where(w != 0.0, 1.0 / torch.where(w != 0.0, w, 1.0),
                                 1.0) for w in cap["W"]]
        border = border_mask(n, N, self.V.device)
        touched = self.V != 0.0
        for b in self.B:
            touched = touched | (b != 0.0)
        self.active = touched & ~border
        self.Va = torch.where(self.active, self.V, 0.0)
        Tg = torch.where(cap["cut"], float(config["interface_value"]), 0.0
                         ).to(self.V.dtype)
        h = 0.0
        for d in range(N):
            A, B = cap["A"][d], self.B[d]
            h = h + B * Dt(self.Winv[d] * (A * D(Tg, d) - D(B * Tg, d)), d)
        rhs = torch.where(self.active, -dt * k * h, 0.0)
        self.rhs = torch.where(border, float(config["border_value"]), rhs)
        diag = self.V
        for d in range(N):
            B, Wi = self.B[d], self.Winv[d]
            diag = diag + dt * k * _zlast(B * B * (Wi + _next(Wi, d)), d)
        diag = torch.where(self.active, diag, 1.0)
        self.dinv = 1.0 / torch.where(diag == 0.0, 1.0, diag)

    def apply(self, x):
        y = 0.0
        for d in range(self.N):
            y = y + self.B[d] * Dt(self.Winv[d] * D(self.B[d] * x, d), d)
        return torch.where(self.active, self.V * x + self.dt * self.k * y, x)

    def apply_abs(self, x):
        """Σ |term| of each row: the scale a row's rounding is measured
        against."""
        ax = x.abs()
        y = 0.0
        for d in range(self.N):
            Bx = self.B[d] * ax
            g = self.Winv[d] * (_zlast(Bx, d) + _prev(Bx, d))
            y = y + self.B[d] * _zlast(g + _next(g, d), d)
        return torch.where(self.active, self.V * ax + self.dt * self.k * y,
                           ax)

    def cg(self, b, x, tol, maxiter=CG_CAP, strict=True):
        """Jacobi-preconditioned CG to ``|r| <= tol |b|``; with ``strict``
        raises when ``maxiter`` comes first, else returns the iterate."""
        dot = lambda u, v: torch.dot(u.reshape(-1), v.reshape(-1))
        r = b - self.apply(x)
        z = self.dinv * r
        p = z
        rz = dot(r, z)
        bound = tol * tol * max(float(dot(b, b)), 1e-300)
        for it in range(maxiter):
            if it % CG_CHECK == 0 and float(dot(r, r)) <= bound:
                return x
            Ap = self.apply(p)
            alpha = rz / dot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            z = self.dinv * r
            rz_new = dot(r, z)
            p = z + (rz_new / rz) * p
            rz = rz_new
        if not strict or float(dot(r, r)) <= bound:
            return x
        raise RuntimeError(f"reference CG did not reach {tol:g} in "
                           f"{maxiter} iterations")


# ---------------------------------------------------------------------------
# the run's answers, and the comparison
# ---------------------------------------------------------------------------

def reference(config, traffic, inputs, device, precision=torch.float64):
    """The answers the program's run is judged against: ``capacity``
    (V, A, B, W), ``operator`` (L on the probe), ``scale`` (|L| on |probe|,
    row by row), ``field`` (T after one episode), ``active`` and ``op``
    (the operator, to weigh the field's gap)."""
    exact = precision == torch.float64
    tol = float(config["cg_tol"]) * (TIGHTER if exact else 1.0)
    maxiter = CG_CAP if exact else int(traffic["cg_maxiter"])
    quad = config["quadrature"]
    build = lambda dtype: capacities(
        sdf(config, inputs["centre"]), grid_nodes(config, dtype, device),
        int(quad["p"]), int(quad["s"]),
        empty_rel(getattr(torch, config["dtype"])))
    cap = build(torch.float64)
    answer = cap
    if not exact:
        # each stage of the control starts from the float64 stage before
        # it, so that it reads its own stage's rounding
        answer = build(precision)
        cap = dict(V=cap["V"].to(precision), cut=cap["cut"], raw=cap["raw"],
                   **{k: [a.to(precision) for a in cap[k]]
                      for k in ("A", "B", "W")})
    h = float(config["length"]) / int(config["cells"])
    op = HeatOperator(cap, config, float(traffic["dt_h2"]) * h * h)

    probe = inputs["probe"].to(device=device, dtype=precision)
    T = inputs["T0"].to(device=device, dtype=precision)
    for _ in range(int(traffic["episode_steps"])):
        T = op.cg(op.Va * T + op.rhs, T, tol, maxiter, strict=exact)
    return dict(capacity=dict(V=answer["V"], A=answer["A"], B=answer["B"],
                              W=answer["W"], raw=answer["raw"]),
                operator=op.apply(probe), scale=op.apply_abs(probe),
                field=T, active=op.active, op=op)


def volume_gap(V, config):
    """|Σ V − |Ω|| / |Ω|: the capacities' total volume against the exact
    measure of the disk or ball, a reading that shares nothing with the
    quadrature.  It reads the method's truncation error, which is the same
    in any precision, so no control can give it an upper reading and it is
    not one of the numbers compared."""
    N, radius = int(config["ndim"]), float(config["radius"])
    exact = math.pi * radius ** 2 if N == 2 else 4.0 / 3.0 * math.pi * radius ** 3
    return abs(float(V.double().sum()) - exact) / exact


def _dilate(mask):
    """``mask`` grown by one cell along every axis."""
    m = mask.to(torch.uint8)
    out = m
    for d in range(m.dim()):
        out = out | _prev(m, d) | _next(m, d)
    return out.bool()


def compared(ref, config):
    """Which entries the comparison reads, by rules on the reference's own
    capacities (never on the program's):

    - ``capacity``: every cell and face but those within one cell of a cell
      whose volume lies within a factor 4 of the empty threshold, where
      rounding may classify it either way;
    - ``operator``: active rows of whole cells, whose V and every B and W
      they touch are the full measure, and whose neighbours' are too: the
      rows where the operator's error is the matvec's own and not the
      capacity build's;
    - ``residual``: active rows that no sliver touches: a cell whose V, or
      a nonzero B or W of it or of its faces, is below ``SLIVER`` of the
      full measure, or a neighbour of one;
    - ``field``: active cells of at least ``SLIVER`` of a full volume and
      away from an undecided cell.
    """
    N = int(config["ndim"])
    h = float(config["length"]) / int(config["cells"])
    cap = ref["capacity"]
    V, raw = cap["V"].double(), cap["raw"].double()
    eps = empty_rel(getattr(torch, config["dtype"]))
    undecided = _dilate((raw >= eps / 4 * h ** N) & (raw <= eps * 4 * h ** N))
    tiny = lambda x, full: (x != 0) & (x.double() < SLIVER * full)
    short = lambda x, full: x.double() < (1.0 - 1e-9) * full
    sliver = tiny(V, h ** N)
    cut = short(V, h ** N)
    for d in range(N):
        B, W = cap["B"][d], cap["W"][d]
        sliver = (sliver | tiny(B, h ** (N - 1)) | tiny(W, h ** N)
                  | tiny(_next(W, d), h ** N))
        cut = (cut | short(B, h ** (N - 1)) | short(W, h ** N)
               | short(_next(W, d), h ** N))
    active = ref["active"]
    return dict(capacity=~undecided,
                operator=active & ~_dilate(cut),
                residual=active & ~_dilate(sliver),
                field=active & (V >= SLIVER * h ** N) & ~undecided)


def compare(prog, ref, config):
    """The numbers that decide ``correct``, each a widest gap in units of
    its own scale, over the entries ``compared`` selects:

    - ``capacity``: V and W against the full cell, A and B against the full
      face, the largest over all four;
    - ``operator``: the program's matvec against the reference's apply,
      row by row, over the row's own sum of |terms|, on whole rows;
    - ``field``: T at the end of every whole episode of the window, over
      the reference's largest |T| on active cells.  The program hands over
      ``fields``, the elementwise least and greatest of those end fields,
      so every episode is judged and none has to repeat another bit for
      bit;
    - ``field_residual``: the reference's operator on the field's gap,
      over the largest row of |L| |T|: the residual the program's fields
      leave in the reference's last step.  It weighs the gap by its
      roughness, so the smooth error a CG tolerance leaves reads small and
      rounding noise, or one wrong cell, reads large.
    """
    N = int(config["ndim"])
    h = float(config["length"]) / int(config["cells"])
    keep = compared(ref, config)

    def gap(a, b, where):
        diff = (a.to(b.dtype) - b).abs()
        return float(torch.where(where, diff, 0.0).max())

    pc, rc = prog["capacity"], ref["capacity"]
    on = keep["capacity"]
    cap = gap(pc["V"], rc["V"], on) / h ** N
    for key, scale in (("A", h ** (N - 1)), ("B", h ** (N - 1)),
                       ("W", h ** N)):
        for a, b in zip(pc[key], rc[key]):
            cap = max(cap, gap(a, b, on) / scale)
    y = ref["operator"]
    rows = (prog["operator"].to(y.dtype) - y).abs() / torch.clamp_min(
        ref["scale"], torch.finfo(y.dtype).tiny)
    T = ref["field"]
    t_scale = float(torch.where(ref["active"], T.abs(), 0.0).max())
    op = ref["op"]
    r_scale = float(torch.where(keep["residual"], op.apply_abs(T), 0.0).max())
    field = resid = 0.0
    for Tp in prog["fields"]:
        diff = torch.where(keep["field"], Tp.to(T.dtype) - T, 0.0)
        field = max(field, gap(Tp, T, keep["field"]) / t_scale)
        resid = max(resid, float(torch.where(
            keep["residual"], op.apply(diff).abs(), 0.0).max()) / r_scale)
    return dict(capacity=cap,
                operator=float(torch.where(keep["operator"], rows, 0.0).max()),
                field=field, field_residual=resid)

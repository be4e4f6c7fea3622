"""Cut-cell quadrature for the plain reference: a frozen copy.

The dense scheme of the port's ``quadrature.py`` as it stood when the
benchmark was written (three SDF samples and a quadratic fit along the last
axis, tensor Gauss-Legendre on the others).  It is copied, not imported, so
that the reference shares no code with the program it judges: a later edit
of the port's quadrature cannot move the yardstick with it.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["segment_fraction", "box_integrals", "gl_rule"]


def gl_rule(p: int, s: int = 1):
    """Composite Gauss-Legendre rule on [0, 1]: ``s`` panels of ``p`` points.

    Returns (nodes, weights) as numpy float64 arrays of length ``p*s`` with
    ``sum(weights) == 1``.
    """
    x, w = np.polynomial.legendre.leggauss(p)
    x = 0.5 * (x + 1.0)  # -> [0, 1]
    w = 0.5 * w
    nodes = np.concatenate([(k + x) / s for k in range(s)])
    weights = np.concatenate([w / s for _ in range(s)])
    return nodes, weights


def segment_fraction(pa, pm, pb):
    """Wetted fraction of the set {phi < 0} on a unit segment.

    ``pa, pm, pb`` are SDF samples at t = 0, 1/2, 1.  A quadratic
    ``q(t) = c2 t^2 + c1 t + c0`` is fitted through them; the measure and
    first moment of ``{q < 0} ∩ [0,1]`` are returned:

    Returns
    -------
    frac : tensor  —  ∫ 1{q<0} dt  over [0,1]
    tmom : tensor  —  ∫ t 1{q<0} dt over [0,1]
    """
    pa, pm, pb = torch.broadcast_tensors(pa, pm, pb)
    c2 = 2.0 * (pa - 2.0 * pm + pb)
    c1 = -3.0 * pa + 4.0 * pm - pb
    c0 = pa

    scale = torch.maximum(torch.maximum(torch.abs(pa), torch.abs(pb)),
                          torch.abs(pm))
    scale = torch.clamp_min(scale, 1e-300)
    is_quad = torch.abs(c2) > 1e-12 * scale
    is_lin = torch.abs(c1) > 1e-12 * scale

    # quadratic roots (stable split form); every guarded branch is sanitized
    # before the selecting `where` so gradients through the unselected
    # branch stay finite
    disc = c1 * c1 - 4.0 * c2 * c0
    disc_ok = disc > 0.0
    sq = torch.where(disc_ok, torch.sqrt(torch.where(disc_ok, disc, 1.0)), 0.0)
    # q = c2 t^2 + c1 t + c0
    qq = -0.5 * (c1 + torch.sign(c1) * sq)
    qq = torch.where(torch.abs(qq) > 1e-300, qq, 1.0)
    c2_safe = torch.where(is_quad, c2, 1.0)
    rq1 = qq / c2_safe
    rq2 = c0 / qq
    r_lo_q = torch.minimum(rq1, rq2)
    r_hi_q = torch.maximum(rq1, rq2)
    has_quad_roots = is_quad & disc_ok

    c1_safe = torch.where(is_lin, c1, 1.0)
    r_lin = -c0 / c1_safe

    BIG = 2.0  # any knot > 1 behaves as "no crossing inside [0,1]"
    r_lo = torch.where(has_quad_roots, r_lo_q,
                       torch.where(~is_quad & is_lin, r_lin, BIG))
    r_hi = torch.where(has_quad_roots, r_hi_q, BIG)

    k1 = torch.clamp(r_lo, 0.0, 1.0)
    k2 = torch.clamp(r_hi, 0.0, 1.0)
    k2 = torch.maximum(k1, k2)

    def q(t):
        return (c2 * t + c1) * t + c0

    frac = torch.zeros_like(pa)
    tmom = torch.zeros_like(pa)
    for (s0, s1) in ((torch.zeros_like(k1), k1), (k1, k2),
                     (k2, torch.ones_like(k2))):
        mid = 0.5 * (s0 + s1)
        wet = q(mid) < 0.0
        length = s1 - s0
        frac = frac + torch.where(wet, length, 0.0)
        tmom = tmom + torch.where(wet, 0.5 * (s1 * s1 - s0 * s0), 0.0)
    return frac, tmom


def box_integrals(phi, lo, hi, p: int = 8, s: int = 2, inner_axis=None):
    """Volume and first moments of {phi < 0} over axis-aligned boxes.

    Parameters
    ----------
    phi : callable of M coordinate tensors -> SDF values (broadcasting)
    lo, hi : sequences of M tensors with a common batch shape B (bounds per
        box), all of one dtype and device
    p, s : Gauss-Legendre points per panel / number of panels for outer axes
    inner_axis : which axis gets the exact closed-form crossing treatment
        (default: last).

    Returns
    -------
    vol : tensor of shape B          —  ∫ 1{phi<0} dV
    moments : list of M tensors (B)  —  ∫ x_d 1{phi<0} dV
    """
    M = len(lo)
    if inner_axis is not None and inner_axis != M - 1:
        perm = [d for d in range(M) if d != inner_axis] + [inner_axis]
        inv = [perm.index(d) for d in range(M)]

        def phi_perm(*cs):
            return phi(*[cs[inv[d]] for d in range(M)])

        vol, moms = box_integrals(
            phi_perm, [lo[d] for d in perm], [hi[d] for d in perm], p=p, s=s
        )
        return vol, [moms[perm.index(d)] for d in range(M)]
    dlast = hi[-1] - lo[-1]

    if M == 1:
        a, b = lo[0], hi[0]
        midc = 0.5 * (a + b)
        frac, tmom = segment_fraction(phi(a), phi(midc), phi(b))
        vol = dlast * frac
        mom = dlast * (a * frac + dlast * tmom)
        return vol, [mom]

    # batch shape must include broadcasting introduced by phi itself (e.g.
    # a fixed face coordinate with its own axis) — probe once at midpoints
    probe = phi(*[0.5 * (lo[d] + hi[d]) for d in range(M)])
    batch = torch.broadcast_shapes(probe.shape, *[a.shape for a in lo + hi])
    like = dict(dtype=lo[0].dtype, device=lo[0].device)

    # outer tensor-product GL nodes over axes 0..M-2
    nodes, weights = gl_rule(p, s)
    grids = np.meshgrid(*([nodes] * (M - 1)), indexing="ij")
    wgrids = np.meshgrid(*([weights] * (M - 1)), indexing="ij")
    tnodes = np.stack([g.ravel() for g in grids], axis=-1)  # (Q, M-1)
    tweights = np.prod(np.stack([g.ravel() for g in wgrids], axis=-1), axis=-1)

    outer_meas = torch.ones(batch, **like)
    for d in range(M - 1):
        outer_meas = outer_meas * (hi[d] - lo[d])

    vol = torch.zeros(batch, **like)
    moms = [torch.zeros(batch, **like) for _ in range(M)]
    a, b = lo[-1], hi[-1]
    midc = 0.5 * (a + b)
    for t, w in zip(tnodes.tolist(), tweights.tolist()):
        coords = [lo[d] + t[d] * (hi[d] - lo[d]) for d in range(M - 1)]
        pa = phi(*coords, a)
        pm = phi(*coords, midc)
        pb = phi(*coords, b)
        frac, tmom = segment_fraction(pa, pm, pb)
        wedge = w * outer_meas * dlast
        vol = vol + wedge * frac
        for d in range(M - 1):
            moms[d] = moms[d] + wedge * coords[d] * frac
        moms[M - 1] = moms[M - 1] + w * outer_meas * dlast * (
            a * frac + dlast * tmom)
    return vol, moms

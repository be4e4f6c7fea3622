"""Signed-distance-function shape library and combinators (torch).

Counterpart of ``penguin_tpu.geometry``.  A *body* is a callable of exactly
``ndim`` coordinate tensors returning the signed distance (negative inside
the fluid), broadcastable over arbitrary shapes.  The result takes the
coordinates' dtype and device.
"""

from __future__ import annotations

import torch

__all__ = [
    "circle",
    "sphere",
    "interval",
    "halfspace",
    "rectangle",
    "box",
    "ellipse",
    "union",
    "intersection",
    "complement",
    "full_domain",
    "translate_in_time",
]


def full_domain(ndim):
    """Body that marks the whole domain as fluid (reference tests use
    ``(x, y) -> -1.0``)."""

    def body(*coords):
        shape = torch.broadcast_shapes(*[c.shape for c in coords])
        return torch.full(shape, -1.0, dtype=coords[0].dtype,
                          device=coords[0].device)

    return body


def circle(center, radius):
    cx, cy = center

    def body(x, y):
        return torch.sqrt((x - cx) ** 2 + (y - cy) ** 2) - radius

    return body


def sphere(center, radius):
    cx, cy, cz = center

    def body(x, y, z):
        return torch.sqrt((x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2) - radius

    return body


def interval(center, radius):
    """1D 'circle': fluid inside ``|x - center| < radius``."""

    def body(x):
        return torch.abs(x - center) - radius

    return body


def halfspace(dim, position, sign=1.0):
    """Fluid where ``sign * (x_dim - position) < 0``."""

    def body(*coords):
        return sign * (coords[dim] - position)

    return body


def rectangle(lo, hi):
    lx, ly = lo
    hx, hy = hi

    def body(x, y):
        dx = torch.maximum(lx - x, x - hx)
        dy = torch.maximum(ly - y, y - hy)
        return torch.maximum(dx, dy)

    return body


def box(lo, hi):
    def body(*coords):
        coords = torch.broadcast_tensors(*coords)
        d = torch.maximum(
            torch.stack([lo[i] - coords[i] for i in range(len(lo))]),
            torch.stack([coords[i] - hi[i] for i in range(len(hi))]),
        )
        return torch.amax(d, dim=0)

    return body


def ellipse(center, radii):
    cx, cy = center
    rx, ry = radii

    def body(x, y):
        # pseudo-SDF (exact zero level set, approximate distance)
        return torch.sqrt(((x - cx) / rx) ** 2 + ((y - cy) / ry) ** 2) - 1.0

    return body


def union(*bodies):
    def body(*coords):
        vals = [b(*coords) for b in bodies]
        out = vals[0]
        for v in vals[1:]:
            out = torch.minimum(out, v)
        return out

    return body


def intersection(*bodies):
    def body(*coords):
        vals = [b(*coords) for b in bodies]
        out = vals[0]
        for v in vals[1:]:
            out = torch.maximum(out, v)
        return out

    return body


def complement(b):
    def body(*coords):
        return -b(*coords)

    return body


def translate_in_time(body, velocity):
    """Turn a static N-dim body into an (N+1)-dim space-time body that is
    translated rigidly with the given velocity vector; the last coordinate
    is time."""
    velocity = tuple(velocity)

    def st_body(*coords):
        t = coords[-1]
        shifted = [coords[d] - velocity[d] * t for d in range(len(velocity))]
        return body(*shifted)

    return st_body

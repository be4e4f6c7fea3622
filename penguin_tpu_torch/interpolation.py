"""1D interpolators for interface reconstruction from column heights
(torch counterpart of ``penguin_tpu.interpolation``, reference
``src/interpolation.jl``): linear, quadratic and cubic interpolation of a
sampled profile, vectorized over query points.

Tensors keep their device and dtype; arrays that are not tensors go to the
device of the first tensor argument, or else to ``device`` (by default the
CUDA device), as float64.
"""

from __future__ import annotations

import torch

from ._device import resolve_device

__all__ = ["lin_interpol", "quad_interpol", "cubic_interpol"]


def _tensors(xs, ys, xq, device):
    ref = next((a for a in (xs, ys, xq) if isinstance(a, torch.Tensor)), None)
    if ref is None:
        dtype, device = torch.float64, resolve_device(device)
    else:
        dtype, device = ref.dtype, ref.device
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in (xs, ys, xq))


def _locate(xs, xq):
    i = torch.clamp(torch.searchsorted(xs, xq) - 1, 0, xs.shape[0] - 2)
    t = (xq - xs[i]) / (xs[i + 1] - xs[i])
    return i, t


def lin_interpol(xs, ys, xq, device=None):
    """Piecewise-linear interpolation (clamped extrapolation)."""
    xs, ys, xq = _tensors(xs, ys, xq, device)
    i, t = _locate(xs, xq)
    t = torch.clamp(t, 0.0, 1.0)
    return ys[i] * (1 - t) + ys[i + 1] * t


def quad_interpol(xs, ys, xq, device=None):
    """Piecewise-quadratic (3-point Lagrange on the local stencil)."""
    xs, ys, xq = _tensors(xs, ys, xq, device)
    n = xs.shape[0]
    i, _ = _locate(xs, xq)
    i = torch.clamp(i, 0, n - 3)
    x0, x1, x2 = xs[i], xs[i + 1], xs[i + 2]
    y0, y1, y2 = ys[i], ys[i + 1], ys[i + 2]
    L0 = (xq - x1) * (xq - x2) / ((x0 - x1) * (x0 - x2))
    L1 = (xq - x0) * (xq - x2) / ((x1 - x0) * (x1 - x2))
    L2 = (xq - x0) * (xq - x1) / ((x2 - x0) * (x2 - x1))
    return y0 * L0 + y1 * L1 + y2 * L2


def cubic_interpol(xs, ys, xq, device=None):
    """Catmull-Rom cubic (C1) with clamped ends."""
    xs, ys, xq = _tensors(xs, ys, xq, device)
    n = xs.shape[0]
    i, t = _locate(xs, xq)
    t = torch.clamp(t, 0.0, 1.0)
    im1 = torch.clamp(i - 1, 0, n - 1)
    ip2 = torch.clamp(i + 2, 0, n - 1)
    p0, p1, p2, p3 = ys[im1], ys[i], ys[i + 1], ys[ip2]
    return 0.5 * (
        2 * p1
        + (-p0 + p2) * t
        + (2 * p0 - 5 * p1 + 4 * p2 - p3) * t * t
        + (-p0 + 3 * p1 - 3 * p2 + p3) * t * t * t
    )

"""1D front tracking (torch): sorted marker positions partitioning the line
into fluid/solid intervals.  Counterpart of ``penguin_tpu.front_tracking1d``:
parity-based inside test, SDF, and the fluid length, all vectorized.  A
tracker puts its markers on ``device``, by default the CUDA device, unless
they come as a tensor."""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device

__all__ = ["FrontTracker1D", "sdf_1d", "inside_1d"]


def _sorted(markers, like=None):
    if not isinstance(markers, torch.Tensor):
        markers = torch.as_tensor(
            markers, **({} if like is None
                        else dict(dtype=like.dtype, device=like.device)))
    return torch.sort(markers)[0]


def inside_1d(markers, x, first_inside=True):
    """Parity inside-test: regions alternate starting with ``first_inside``
    left of the first marker."""
    markers = _sorted(markers, x)
    count = torch.sum(x[..., None] >= markers, dim=-1)
    odd = count % 2 == 1
    return odd if not first_inside else ~odd


def sdf_1d(markers, x, first_inside=True):
    """Signed distance: negative inside the fluid."""
    markers = _sorted(markers, x)
    d = torch.amin(torch.abs(x[..., None] - markers), dim=-1)
    return torch.where(inside_1d(markers, x, first_inside), -d, d)


class FrontTracker1D:
    def __init__(self, markers=None, first_inside=True, dtype=torch.float64,
                 device=None):
        if isinstance(markers, torch.Tensor):
            dtype, device = markers.dtype, markers.device
        self.dtype = dtype
        self.device = resolve_device(device)
        self.first_inside = first_inside
        self.markers = None
        if markers is not None:
            self.set_markers(markers)

    def set_markers(self, markers):
        self.markers = torch.sort(torch.as_tensor(
            markers, dtype=self.dtype, device=self.device))[0]
        return self

    def _query(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def sdf(self, x):
        return sdf_1d(self.markers, self._query(x), self.first_inside)

    def inside(self, x):
        return inside_1d(self.markers, self._query(x), self.first_inside)

    def body(self):
        m = self.markers
        fi = self.first_inside

        def b(x):
            return sdf_1d(m, x, fi)

        return b

    def fluid_length(self, domain):
        """Total fluid measure inside [a, b]."""
        a, b = domain
        pts = np.concatenate([[a], self.markers.detach().cpu().numpy(), [b]])
        pts = np.clip(pts, a, b)
        lengths = np.diff(pts)
        inside0 = self.first_inside
        seg_inside = [inside0 ^ (i % 2 == 1) for i in range(len(lengths))]
        return float(sum(l for l, s in zip(lengths, seg_inside) if s))

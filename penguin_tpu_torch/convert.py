"""Carry a capacity across from the JAX package as numpy arrays.

``capacity_from_numpy`` builds the port's :class:`Capacity` from the numpy
arrays of a ``penguin_tpu`` capacity (``{name: np.asarray(...)}``, tuples
for the per-axis fields), so the port's solvers can run on exactly the
geometry the JAX package computed; ``capacity_to_numpy`` goes the other way.
This module imports no JAX: the caller converts the JAX arrays with
``np.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .capacity import Capacity

__all__ = ["CAPACITY_FIELDS", "capacity_from_numpy", "capacity_to_numpy"]

# data fields of a Capacity; the per-axis ones are tuples
CAPACITY_FIELDS = ("A", "B", "V", "W", "C_om", "C_ga", "Gamma", "cell_types",
                   "Am", "Bm", "Vh")
_PER_AXIS = ("A", "B", "W", "Am", "Bm", "Vh")


def capacity_from_numpy(fields, mesh, device=None, dtype=torch.float64):
    """Port :class:`Capacity` from a mapping of field name -> numpy array
    (or tuple of arrays for the per-axis fields).  ``cell_types`` becomes
    int8, every other field ``dtype``; missing cut-moment fields stay None.
    The tensors go to ``device``, by default the CUDA device."""
    device = resolve_device(device)

    def conv(name, a):
        kind = torch.int8 if name == "cell_types" else dtype
        return torch.as_tensor(np.array(a), device=device).to(kind)

    out = {}
    for name in CAPACITY_FIELDS:
        value = fields.get(name)
        if value is None:
            out[name] = None
        elif name in _PER_AXIS:
            out[name] = tuple(conv(name, a) for a in value)
        else:
            out[name] = conv(name, value)
    return Capacity(mesh=mesh, **out)


def capacity_to_numpy(capacity):
    """Mapping of field name -> numpy array(s) of a port capacity."""

    def conv(t):
        return t.detach().cpu().numpy()

    out = {}
    for name in CAPACITY_FIELDS:
        value = getattr(capacity, name)
        if value is None:
            out[name] = None
        elif name in _PER_AXIS:
            out[name] = tuple(conv(a) for a in value)
        else:
            out[name] = conv(value)
    return out

"""Carry a capacity across from the JAX package as numpy arrays.

``capacity_from_numpy`` builds the port's :class:`Capacity` from the numpy
arrays of a ``penguin_tpu`` capacity (``{name: np.asarray(...)}``, tuples
for the per-axis fields), so the port's solvers can run on exactly the
geometry the JAX package computed; ``capacity_to_numpy`` goes the other way.
A space-time slab capacity goes across the same way: its fields carry one
more trailing axis (the two time slots), its cut moments are present or
None, and its ``mesh`` is None.  ``markers_from_numpy`` and
``markers_to_numpy`` carry a front's (n, 2) marker array, and
``state_from_numpy`` and ``state_to_numpy`` a solver state: the tuple of
fields of a saddle-point state ``(uω_0, uγ_0, ..., uω_{N-1}, uγ_{N-1}, p)``
(or of any solver's state tuple).  This module
imports no JAX: the caller converts the JAX arrays with ``np.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .capacity import Capacity

__all__ = ["CAPACITY_FIELDS", "capacity_from_numpy", "capacity_to_numpy",
           "markers_from_numpy", "markers_to_numpy", "state_from_numpy",
           "state_to_numpy"]

# data fields of a Capacity; the per-axis ones are tuples
CAPACITY_FIELDS = ("A", "B", "V", "W", "C_om", "C_ga", "Gamma", "cell_types",
                   "Am", "Bm", "Vh")
_PER_AXIS = ("A", "B", "W", "Am", "Bm", "Vh")


def capacity_from_numpy(fields, mesh=None, device=None, dtype=torch.float64):
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


def markers_from_numpy(markers, device=None, dtype=torch.float64):
    """A front's (n, 2) marker array as a tensor on ``device``, by default
    the CUDA device."""
    return torch.as_tensor(np.array(markers), device=resolve_device(device)
                           ).to(dtype)


def markers_to_numpy(markers):
    return markers.detach().cpu().numpy()


def state_from_numpy(fields, device=None, dtype=torch.float64):
    """A solver state (a sequence of numpy arrays, e.g. a Stokes state
    ``(uω_0, uγ_0, ..., p)``) as a tuple of tensors on ``device``, by
    default the CUDA device."""
    device = resolve_device(device)
    return tuple(torch.as_tensor(np.array(a), device=device).to(dtype)
                 for a in fields)


def state_to_numpy(state):
    """The tuple of numpy arrays of a port solver state."""
    return tuple(t.detach().cpu().numpy() for t in state)

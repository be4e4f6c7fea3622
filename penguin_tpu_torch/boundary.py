"""Boundary- and interface-condition vocabulary.

Counterpart of ``penguin_tpu.boundary``; mirrors Penguin.jl's condition
types (``src/boundary.jl``): values may be floats or callables.  Callables
are vectorized torch functions called as ``g(x, y, z)`` (coordinates padded
with zeros beyond the mesh dimension) or ``g(x, y, z, t)`` when a time is
supplied.  A callable may return a Python number; the result is always a
tensor of the coordinates' dtype and device.
"""

from __future__ import annotations

import dataclasses
import inspect

import torch

__all__ = [
    "Dirichlet", "Neumann", "Robin", "Periodic", "Symmetry", "Outflow",
    "Traction", "GibbsThomson", "ScalarJump", "FluxJump",
    "BorderConditions", "InterfaceConditions", "eval_condition_value",
]


@dataclasses.dataclass(frozen=True)
class Dirichlet:
    """T = g on the boundary."""

    value: object = 0.0


@dataclasses.dataclass(frozen=True)
class Neumann:
    """∇T·n = g."""

    value: object = 0.0


@dataclasses.dataclass(frozen=True)
class Robin:
    """α T + β ∇T·n = g."""

    alpha: object
    beta: object
    value: object


@dataclasses.dataclass(frozen=True)
class Periodic:
    pass


@dataclasses.dataclass(frozen=True)
class Symmetry:
    pass


@dataclasses.dataclass(frozen=True)
class Outflow:
    pressure: object = None


@dataclasses.dataclass(frozen=True)
class Traction:
    value: object = 0.0


@dataclasses.dataclass
class GibbsThomson:
    """Interface condition g = Tm - eps_v * v_gamma (reference
    src/boundary.jl:147-158); ``v_gamma`` is the interface velocity field
    updated by the Stefan solvers."""

    Tm: float
    eps_k: float
    eps_v: float
    v_gamma: object = None  # DOF-grid array, filled by moving solvers

    @property
    def value(self):
        return self.Tm


@dataclasses.dataclass(frozen=True)
class ScalarJump:
    """[[α T]] = α₂ T2γ - α₁ T1γ = g  (reference convention: the assembled
    jump row is  α₁ T1γ - α₂ T2γ = g, src/solver/diffusion.jl:129-131)."""

    alpha1: object
    alpha2: object
    value: object


@dataclasses.dataclass(frozen=True)
class FluxJump:
    """[[β ∇T·n]] = g: assembled as β₁ flux₁ + β₂ flux₂ = Γ₂ g."""

    beta1: object
    beta2: object
    value: object


@dataclasses.dataclass(frozen=True)
class BorderConditions:
    """Dict keyed by :left/:right/:top/:bottom/:forward/:backward.

    NOTE on key semantics — the two solver families inherit the
    reference's two *different* conventions:

    * SCALAR solvers (diffusion/advdiff/Darcy/Stefan; parity with
      src/solver.jl:379-409): in 2D 'left'/'right' select the *second*
      axis (y) extremes and 'bottom'/'top' the *first* axis (x); in 1D
      'bottom'/'top' are the two ends; 'backward'/'forward' the third
      axis.
    * STOKES/NAVIER-STOKES velocity borders (parity with the reference's
      staggered examples): 'left'/'right' are the *first* axis (x) ends
      and 'bottom'/'top' the second (y) — the everyday reading.

    For scalar problems driven along x (channels, head drops), put the
    inlet/outlet data on 'bottom'/'top'; see examples/2D/graetz_channel.py
    and examples/2D/darcy_unsteady.py.
    """

    borders: tuple  # tuple of (key, condition) pairs

    def __init__(self, borders):
        if isinstance(borders, dict):
            borders = tuple(sorted(borders.items(), key=lambda kv: kv[0]))
        object.__setattr__(self, "borders", tuple(borders))

    def get(self, key):
        for k, v in self.borders:
            if k == key:
                return v
        return None


@dataclasses.dataclass(frozen=True)
class InterfaceConditions:
    scalar: object  # ScalarJump
    flux: object  # FluxJump


def _ncall(fn):
    try:
        return len(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        return None


def _call_condition(value, coords, t):
    coords = list(coords)
    nargs = _ncall(value)
    padded = coords + [torch.zeros_like(coords[0])] * max(0, 3 - len(coords))
    if nargs is not None:
        if t is not None and nargs == len(coords) + 1:
            return value(*coords, t)
        if nargs == len(coords):
            return value(*coords)
        if t is not None and nargs == 4:
            return value(*padded[:3], t)
        if nargs == 3:
            return value(*padded[:3])
    if t is not None:
        return value(*padded[:3], t)
    return value(*padded[:3])


def eval_condition_value(value, coords, t=None):
    """Evaluate a BC value (constant or callable) on coordinate tensors.

    ``coords``: sequence of N coordinate tensors; padded with zeros up to 3
    spatial slots. Callables may take (x,y,z), (x,y,z,t), or exactly N args.
    The result has the broadcast shape of ``coords`` and ``coords[0]``'s
    dtype and device, whatever the callable returned (e.g. a Python float).
    """
    ref = coords[0]
    shape = torch.broadcast_shapes(*[c.shape for c in coords])
    out = value if not callable(value) else _call_condition(value, coords, t)
    out = torch.as_tensor(out, dtype=ref.dtype, device=ref.device)
    return torch.broadcast_to(out, shape)

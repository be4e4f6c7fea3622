"""Cartesian meshes (numpy; the PyTorch port's copy of ``penguin_tpu.mesh``,
which cannot be imported here without pulling in JAX).

Grid convention (kept compatible with Penguin.jl, ``src/mesh.jl:41-79``):

For a dimension with ``n`` cells over ``[x0, x0 + L]`` with spacing ``h = L/n``:

- ``centers[j] = x0 + j*h``           for ``j = 0..n-1``   (length ``n``)
- ``nodes[k]   = x0 + (k + 0.5)*h``   for ``k = 0..n``     (length ``n+1``)

Integration cell ``i`` (``i = 0..n-1``) spans ``[nodes[i], nodes[i+1]]``.
Every per-cell field (capacities, unknowns) lives on a padded array of
shape ``(n1+1, ..., nN+1)`` whose last slot along each axis is inert
zero-capacity padding — this mirrors the reference's ``(n+1)^N`` DOF layout.

Per-axis *faces* are indexed ``k = 0..n`` with face ``k`` at coordinate
``nodes[k]`` (the lower face of cell ``k``); face ``n`` is the top face of
the last cell, so face arrays have no padding along their own axis.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Mesh", "SpaceTimeMesh"]


class Mesh:
    """Uniform Cartesian mesh in N dimensions.

    Parameters mirror the reference constructor
    (``Mesh((nx, ny), (lx, ly), (x0, y0))``).
    """

    def __init__(self, n, domain_size, x0=None, pad=None):
        n = tuple(int(v) for v in n)
        L = tuple(float(v) for v in domain_size)
        if x0 is None:
            x0 = (0.0,) * len(n)
        x0 = tuple(float(v) for v in x0)
        if not (len(n) == len(L) == len(x0)):
            raise ValueError("n, domain_size and x0 must have equal length")
        if pad is None:
            pad = (1,) * len(n)
        pad = tuple(int(v) for v in pad)
        if len(pad) != len(n) or any(v < 1 for v in pad):
            raise ValueError("pad must give >= 1 inert DOF slots per axis")
        self.pad = pad
        self.n = n
        self.domain_size = L
        self.x0 = x0
        self.ndim = len(n)
        self.h = tuple(L[d] / n[d] for d in range(self.ndim))
        self.centers = tuple(
            np.asarray([x0[d] + j * self.h[d] for j in range(n[d])], dtype=np.float64)
            for d in range(self.ndim)
        )
        self.nodes = tuple(
            np.asarray(
                [x0[d] + (k + 0.5) * self.h[d] for k in range(n[d] + 1)],
                dtype=np.float64,
            )
            for d in range(self.ndim)
        )

    # number of DOF slots per axis: n + pad (cells 0..n-1 plus >= 1 inert
    # padding slots; pad > 1 makes the DOF shape divisible by a device grid)
    @property
    def np_shape(self):
        return tuple(nd + pd for nd, pd in zip(self.n, self.pad))

    # number of integration cells per axis
    @property
    def cells_shape(self):
        return self.n

    def ncells(self):
        """Total number of cells (reference ``nC``: prod of center counts)."""
        out = 1
        for nd in self.n:
            out *= nd
        return out

    def __repr__(self):
        return f"Mesh(n={self.n}, L={self.domain_size}, x0={self.x0})"

    # value-based hashing so meshes can key caches and compare by value
    def _key(self):
        return (self.n, self.domain_size, self.x0, self.pad)

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())


class SpaceTimeMesh:
    """Space mesh extruded with a time axis (reference ``SpaceTimeMesh``,
    Penguin.jl ``src/mesh.jl:129-144``).

    The time axis contributes ``len(times) - 1`` cells whose bounds are the
    raw time points; DOF slots along time = ``len(times)``.
    """

    def __init__(self, space_mesh: Mesh, times):
        times = np.asarray(times, dtype=np.float64)
        if times.ndim != 1 or times.size < 2:
            raise ValueError("times must be a 1D array with at least 2 entries")
        self.space = space_mesh
        self.times = times
        self.ndim = space_mesh.ndim + 1
        self.n = space_mesh.n + (times.size - 1,)
        self.nodes = space_mesh.nodes + (times,)
        tcenters = 0.5 * (times[1:] + times[:-1])
        self.centers = space_mesh.centers + (tcenters,)
        # spacing along time may be nonuniform; keep min for CFL-style uses
        self.h = space_mesh.h + (float(np.min(np.diff(times))),)
        self.pad = space_mesh.pad + (1,)

    @property
    def np_shape(self):
        return tuple(nd + pd for nd, pd in zip(self.n, self.pad))

    @property
    def cells_shape(self):
        return self.n

    def ncells(self):
        out = 1
        for nd in self.n:
            out *= nd
        return out

    def __repr__(self):
        return f"SpaceTimeMesh(space={self.space!r}, times={self.times!r})"

    def _key(self):
        return (self.space._key(), tuple(self.times.tolist()))

    def __eq__(self, other):
        return isinstance(other, SpaceTimeMesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

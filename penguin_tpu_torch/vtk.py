"""VTK export (torch): counterpart of ``penguin_tpu.vtk``, a
dependency-free legacy-VTK structured-points writer plus a ParaView
``.pvd`` collection for time series.  Fields may be tensors on any device
or numpy arrays; one field written by either package gives the same
bytes."""

from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["write_vtk", "write_vtk_series"]


def _host(arr):
    """A tensor (on any device) or array as a float64 numpy array."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    return np.asarray(arr, dtype=np.float64)


def _write_legacy_vts(filename, mesh, fields):
    N = mesh.ndim
    dims = [mesh.np_shape[d] for d in range(N)] + [1] * (3 - N)
    origin = list(mesh.x0) + [0.0] * (3 - N)
    spacing = [mesh.h[d] for d in range(N)] + [1.0] * (3 - N)
    npts = dims[0] * dims[1] * dims[2]
    with open(filename, "w") as f:
        f.write("# vtk DataFile Version 3.0\npenguin_tpu output\nASCII\n")
        f.write("DATASET STRUCTURED_POINTS\n")
        f.write(f"DIMENSIONS {dims[0]} {dims[1]} {dims[2]}\n")
        f.write(f"ORIGIN {origin[0]} {origin[1]} {origin[2]}\n")
        f.write(f"SPACING {spacing[0]} {spacing[1]} {spacing[2]}\n")
        f.write(f"POINT_DATA {npts}\n")
        for name, arr in fields.items():
            a = _host(arr)
            f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
            flat = a.ravel(order="F")
            np.savetxt(f, flat, fmt="%.10g")


def write_vtk(basename, mesh, solver, extra_fields=None):
    """Write the solver's current fields to ``basename.vtk`` (vtk.jl:11-159
    dispatches on dimension and phase count; here fields are discovered
    from the state tuple)."""
    x = solver.x
    fields = {}
    if isinstance(x, (tuple, list)):
        names = ["T_omega", "T_gamma", "T2_omega", "T2_gamma"]
        for name, arr in zip(names, x):
            fields[name] = arr
    else:
        fields["T_omega"] = x
    if extra_fields:
        fields.update(extra_fields)
    filename = basename + ".vtk"
    _write_legacy_vts(filename, mesh, fields)
    return filename


def write_vtk_series(basename, mesh, states, times=None):
    """Write one file per state plus a ParaView collection ``basename.pvd``."""
    files = []
    for k, state in enumerate(states):
        fields = {}
        if isinstance(state, (tuple, list)):
            for j, arr in enumerate(state):
                fields[f"field{j}"] = arr
        else:
            fields["field0"] = state
        fn = f"{basename}_{k:04d}.vtk"
        _write_legacy_vts(fn, mesh, fields)
        files.append(fn)
    with open(basename + ".pvd", "w") as f:
        f.write('<?xml version="1.0"?>\n<VTKFile type="Collection" version="0.1">\n')
        f.write("  <Collection>\n")
        for k, fn in enumerate(files):
            t = times[k] if times is not None else k
            f.write(f'    <DataSet timestep="{t}" file="{os.path.basename(fn)}"/>\n')
        f.write("  </Collection>\n</VTKFile>\n")
    return basename + ".pvd"

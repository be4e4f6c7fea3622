"""Package-level checks of the PyTorch port: it imports no JAX, it says
what it has not ported yet, its entry points default to the CUDA device,
its condition values take the requested dtype, and its kernel build is
keyed by the sources."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import penguin_tpu_torch as tpt
from penguin_tpu_torch.boundary import eval_condition_value
from penguin_tpu_torch.kernels import _build

PKG = Path(tpt.__file__).parent


def test_import_leaves_no_jax():
    code = ("import sys, penguin_tpu_torch, penguin_tpu_torch.solvers, "
            "penguin_tpu_torch.kernels, penguin_tpu_torch.linsolve, "
            "penguin_tpu_torch.utils, penguin_tpu_torch.interpolation, "
            "penguin_tpu_torch.convergence; "
            "print(any(m == 'jax' or m.startswith('jax.') "
            "for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PKG.parent, check=True)
    assert out.stdout.strip() == "False", out.stdout + out.stderr


def test_no_jax_import_in_sources():
    pattern = re.compile(r"^\s*(import|from)\s+jax\b", re.MULTILINE)
    for path in PKG.rglob("*.py"):
        assert not pattern.search(path.read_text()), path


def test_unported_paths_raise():
    mesh = tpt.Mesh((6, 6), (2.0, 2.0))
    body = tpt.geometry.circle((1.0, 1.0), 0.6)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpt.compute_capacity(body, mesh, band_budget=1024)
    from penguin_tpu_torch.capacity import compute_capacity_spacetime
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        compute_capacity_spacetime(body, mesh, 0.0, 1.0)


def _entry_points():
    from penguin_tpu_torch import assembly, interpolation, utils
    from penguin_tpu_torch.convert import (capacity_from_numpy,
                                           capacity_to_numpy)
    from penguin_tpu_torch.solvers import diffusion
    mesh = tpt.Mesh((6, 6), (2.0, 2.0))
    body = tpt.geometry.circle((1.0, 1.0), 0.6)
    bc_b = tpt.BorderConditions({"left": tpt.Dirichlet(0.0)})
    fields = capacity_to_numpy(tpt.compute_capacity(body, mesh, device="cpu"))
    return {
        "compute_capacity": lambda: tpt.compute_capacity(body, mesh).V,
        "border_positions": lambda: assembly.border_positions(mesh)[0],
        "BorderBC": lambda: assembly.BorderBC(mesh, bc_b).items[0][-1],
        "border_info": lambda: assembly.border_info(mesh, bc_b).items[0][-1],
        "capacity_from_numpy": lambda: capacity_from_numpy(fields, mesh).V,
        "zero_state_mono": lambda: diffusion.zero_state_mono(mesh)[0],
        "zero_state_diph": lambda: diffusion.zero_state_diph(mesh)[0],
        "initialize_temperature_uniform":
            lambda: utils.initialize_temperature_uniform(mesh, 1.0)[0],
        "initialize_temperature_circle": lambda: utils.
            initialize_temperature_circle(mesh, (1.0, 1.0), 0.5, 1.0)[0],
        "initialize_rotating_velocity_field":
            lambda: utils.initialize_rotating_velocity_field(mesh)[0],
        "lin_interpol": lambda: interpolation.lin_interpol(
            [0.0, 1.0], [0.0, 1.0], [0.5]),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_cuda(name):
    """Called without a device, an entry point that makes tensors puts them
    on the CUDA device; where there is none it raises instead of carrying
    on on the CPU."""
    make = _entry_points()[name]
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_condition_values_take_requested_dtype(dtype):
    """A callable may return a Python float (the bench's source); the value
    still comes back as a tensor of the coordinates' dtype, device and
    shape."""
    x = torch.linspace(0.0, 1.0, 6, dtype=dtype).reshape(2, 3)
    y = torch.zeros_like(x)
    for value, t in ((0.5, None), (lambda x, y, z, t: 0.0, 0.0),
                     (lambda x, y: x + y, None), (lambda x, y, z: 2.0, None)):
        out = eval_condition_value(value, [x, y], t)
        assert isinstance(out, torch.Tensor)
        assert out.dtype == dtype and out.shape == x.shape
        assert out.device == x.device
    np.testing.assert_array_equal(
        eval_condition_value(lambda x, y: x + y, [x, y]).numpy(), x.numpy())


def test_build_key_follows_the_source(tmp_path, monkeypatch):
    """The library name hashes the source, so an edited kernel rebuilds;
    libraries land in the package's _build directory."""
    src = tmp_path / "stencil.cu"
    src.write_text((PKG / "csrc" / "stencil.cu").read_text())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("stencil")
    assert first.parent == PKG / "_build"
    assert first == _build.library_path("stencil")
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.library_path("stencil") != first

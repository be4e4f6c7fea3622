"""Package-level checks of the PyTorch port: it imports no JAX, the
paths that once raised as not ported give results, it exports the JAX
package's public names for what it has ported, its entry points default to
the CUDA device,
its solvers (the Stokes and Navier-Stokes classes among them) follow their
inputs' device,
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
from torch_stefan_cases import one_thread  # noqa: F401  (autouse fixture)

PKG = Path(tpt.__file__).parent


def test_import_leaves_no_jax():
    code = ("import sys, penguin_tpu_torch, penguin_tpu_torch.solvers, "
            "penguin_tpu_torch.kernels, penguin_tpu_torch.linsolve, "
            "penguin_tpu_torch.utils, penguin_tpu_torch.interpolation, "
            "penguin_tpu_torch.convergence, penguin_tpu_torch.front_tracking, "
            "penguin_tpu_torch.front_tracking1d, "
            "penguin_tpu_torch.solvers.moving_diffusion, "
            "penguin_tpu_torch.solvers.stokes, "
            "penguin_tpu_torch.solvers.stokes_diph, "
            "penguin_tpu_torch.solvers.moving_stokes, "
            "penguin_tpu_torch.solvers.navierstokes, "
            "penguin_tpu_torch.solvers.ns_scalar, "
            "penguin_tpu_torch.solvers.streamvort, "
            "penguin_tpu_torch.checkpoint, penguin_tpu_torch.diagnostics, "
            "penguin_tpu_torch.vtk, penguin_tpu_torch.viz, "
            "penguin_tpu_torch.parallel, penguin_tpu_torch.parallel.sharding; "
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
    """The narrow-band and space-time builds raised ``NotImplementedError``
    until they were ported; now they return capacities, and nothing in the
    package raises it any more."""
    mesh = tpt.Mesh((6, 6), (2.0, 2.0))
    body = tpt.geometry.circle((1.0, 1.0), 0.6)
    dense = tpt.compute_capacity(body, mesh, device="cpu")
    band = tpt.compute_capacity(body, mesh, band_budget=1024, device="cpu")
    np.testing.assert_allclose(band.V.numpy(), dense.V.numpy(), atol=1e-12)
    from penguin_tpu_torch.capacity import compute_capacity_spacetime
    slab = compute_capacity_spacetime(lambda x, y, t: body(x, y), mesh, 0.0,
                                      1.0, device="cpu")
    assert slab.V.shape == (7, 7, 2)
    np.testing.assert_allclose(slab.V[..., 0].numpy(), dense.V.numpy(),
                               atol=1e-12)
    for path in PKG.rglob("*.py"):
        assert "NotImplementedError" not in path.read_text(), path


def test_public_names_follow_the_jax_package():
    """Every public name of the JAX package's modules that the port has
    taken over is a public name of the port's module too."""
    import importlib
    for mod in ("capacity", "operators", "front_tracking", "front_tracking1d",
                "solvers.moving_diffusion", "linsolve", "utils",
                "solvers.stefan1d", "solvers.stefan2d",
                "solvers.stefan2d_height", "solvers.concentration",
                "solvers.binary", "solvers.stokes", "solvers.stokes_diph",
                "solvers.moving_stokes", "solvers.navierstokes",
                "solvers.ns_scalar", "solvers.streamvort", "checkpoint",
                "diagnostics", "vtk", "viz", "parallel", "parallel.sharding"):
        j = importlib.import_module("penguin_tpu." + mod)
        t = importlib.import_module("penguin_tpu_torch." + mod)
        missing = [n for n in j.__all__ if not hasattr(t, n)]
        assert not missing, (mod, missing)
        assert set(j.__all__) <= set(t.__all__), mod
    import penguin_tpu
    assert set(penguin_tpu.__all__) <= set(tpt.__all__)
    from penguin_tpu_torch import solvers
    import penguin_tpu.solvers as jsolvers
    for name in ("MovingDiffusionUnsteadyMono", "MovingDiffusionUnsteadyDiph",
                 "MovingAdvDiffusionUnsteadyMono",
                 "MovingAdvDiffusionUnsteadyDiph",
                 "MovingLiquidDiffusionUnsteadyMono",
                 "MovingLiquidDiffusionUnsteadyMonoCoupled",
                 "MovingLiquidDiffusionUnsteadyDiph",
                 "solve_stefan_1d_adaptive", "StefanMono2D",
                 "MovingLiquidDiffusionUnsteadyMono2D",
                 "DiffusionUnsteadyConcentration", "DiffusionUnsteadyBinary",
                 "StokesMono", "PinPressureGauge", "MeanPressureGauge",
                 "StokesDiph", "MovingStokesMono", "NavierStokesMono",
                 "StreamVorticity", "NavierStokesScalarCoupler",
                 "PassiveCoupling", "PicardCoupling"):
        assert name in jsolvers.__all__
        assert name in solvers.__all__ and hasattr(solvers, name)


def _from_checkpoint(load):
    """A one-tensor CPU checkpoint read back by ``load(path)`` in a
    temporary directory."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "ck.npz"
        tpt.save_checkpoint(path, {"x": torch.zeros(3, dtype=torch.float64)})
        return load(path)


class _Bare:
    """A solver with no state and no capacity to follow."""


def _restored(path):
    solver = _Bare()
    tpt.restore_solver(path, solver)
    return solver.x


def _entry_points():
    from penguin_tpu_torch import (assembly, capacity, front_tracking,
                                   front_tracking1d, interpolation, utils)
    from penguin_tpu_torch.convert import (capacity_from_numpy,
                                           capacity_to_numpy,
                                           markers_from_numpy,
                                           state_from_numpy)
    from penguin_tpu_torch.parallel import sharding
    from penguin_tpu_torch.solvers import diffusion, stokes
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
        "compute_capacity_spacetime":
            lambda: capacity.compute_capacity_spacetime(
                lambda x, y, t: body(x, y), mesh, 0.0, 1.0).V,
        "compute_cell_volumes":
            lambda: capacity.compute_cell_volumes(body, mesh),
        "estimate_band_budget": lambda: capacity.estimate_band_budget(
            body, [np.asarray(v) for v in mesh.nodes], mesh.n, torch.float64,
            2.0),
        "markers_circle":
            lambda: front_tracking.markers_circle((1.0, 1.0), 0.5, 8),
        "markers_ellipse":
            lambda: front_tracking.markers_ellipse((1.0, 1.0), 0.5, 0.3, 8),
        "markers_rectangle":
            lambda: front_tracking.markers_rectangle((0., 0.), (1., 1.), 2),
        "markers_ngon":
            lambda: front_tracking.markers_ngon((1.0, 1.0), 0.5, 4, 8),
        "markers_crystal":
            lambda: front_tracking.markers_crystal((1.0, 1.0), 0.5, 12),
        "FrontTracker": lambda: front_tracking.FrontTracker().create_circle(
            (1.0, 1.0), 0.5, 8).markers,
        "FrontTracker1D":
            lambda: front_tracking1d.FrontTracker1D([0.5, 1.5]).markers,
        "markers_from_numpy":
            lambda: markers_from_numpy(np.zeros((4, 2))),
        "state_from_numpy": lambda: state_from_numpy([np.zeros(3)])[0],
        "load_checkpoint": lambda: _from_checkpoint(
            lambda p: tpt.load_checkpoint(p)[0]["x"]),
        "restore_solver": lambda: _from_checkpoint(_restored),
        "VelocityBorder": lambda: stokes.VelocityBorder(
            mesh, tpt.BorderConditions({"left": tpt.Dirichlet(0.0)}),
            0).pos[0],
        # two ranks share the default card
        "dryrun_heat_multichip":
            lambda: sharding.dryrun_heat_multichip(2, grid=(8, 8)),
        "dryrun_stokes_multichip":
            lambda: sharding.dryrun_stokes_multichip(2, grid=(8, 8))[0],
        "dryrun_moving_multichip":
            lambda: sharding.dryrun_moving_multichip(2, grid=(8, 8))[0],
        "dryrun_ns_multichip":
            lambda: sharding.dryrun_ns_multichip(2, grid=(8, 4))[0],
        "dryrun_ns_picard_multichip":
            lambda: sharding.dryrun_ns_picard_multichip(2, grid=(8, 4))[0][0],
        "dryrun_stefan_multichip":
            lambda: sharding.dryrun_stefan_multichip(2, grid=(8, 8), nm=8)[1],
        "dryrun_multichip": lambda: sharding.dryrun_multichip(2)["heat"],
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


def _phase_change_runs():
    """One short solve of each phase-change and species class on CPU
    tensors: name -> callable returning the tensors it produced."""
    from penguin_tpu_torch.front_tracking import FrontTracker
    from penguin_tpu_torch.solvers import (binary, concentration, stefan1d,
                                           stefan2d, stefan2d_height)
    like = dict(dtype=torch.float64, device="cpu")
    ph = tpt.Phase(None, None, lambda x, y, z, t: 0.0, 1.0)
    ic = tpt.InterfaceConditions(tpt.ScalarJump(1.0, 1.0, 0.0),
                                 tpt.FluxJump(1.0, 1.0, 1.0))
    d0 = tpt.Dirichlet(0.0)
    m1 = tpt.Mesh((8,), (2.0,), (0.0,))
    bc1 = tpt.BorderConditions({"bottom": tpt.Dirichlet(1.0), "top": d0})
    z1 = torch.zeros(m1.np_shape, **like)
    m2 = tpt.Mesh((8, 8), (8.0, 8.0), (0.0, 0.0))
    bc2 = tpt.BorderConditions({k: tpt.Dirichlet(-0.3)
                                for k in ("left", "right", "top", "bottom")})
    z2 = torch.zeros(m2.np_shape, **like)
    mh = tpt.Mesh((4, 8), (0.6, 2.0), (0.0, 0.0))
    zh = torch.zeros(mh.np_shape, **like)
    bch = tpt.BorderConditions({"left": tpt.Dirichlet(1.0), "right": d0})
    one = (1, 1e-9, 1e-9, 1.0)

    def mono1d(cls):
        s = getattr(stefan1d, cls)(ph, bc1, d0, 1e-3, (z1 + 0.5, z1), m1)
        s.solve(0.55, 0.0, 5e-4, ic, newton_params=one)
        return s.x

    def adaptive():
        s = stefan1d.MovingLiquidDiffusionUnsteadyMono(
            ph, bc1, d0, 1e-3, (z1 + 0.5, z1), m1)
        stefan1d.solve_stefan_1d_adaptive(s, 0.55, 0.0, 1e-3, ic,
                                          newton_params=one)
        return s.x

    def diph1d():
        s = stefan1d.MovingLiquidDiffusionUnsteadyDiph(
            ph, ph, bc1, ic, 1e-3, (z1 + 0.5, z1, z1, z1), m1)
        s.solve(0.55, 0.0, 5e-4, newton_params=one)
        return s.x

    def mono2d(kind):
        front = FrontTracker(**like).create_circle((4.0, 4.0), 1.5, n=8)
        s = stefan2d.StefanMono2D(ph, bc2, d0, 0.02, (z2 - 0.1, z2), m2)
        if kind == "geom":
            s.solve_geom(front, 0.0, 0.01, ic, newton_params=one,
                         interior_fluid=False)
        else:
            s.solve(front, 0.0, 0.01, ic, newton_params=one,
                    interior_fluid=False, jac=kind)
        return s.x + (s.markers, front.markers)

    def diph2d():
        front = FrontTracker(**like).create_circle((4.0, 4.0), 1.5, n=8)
        s = stefan2d.StefanDiph2D(ph, ph, bc2, ic, 0.02, (z2, z2, z2 - 0.1,
                                                          z2), m2)
        s.solve(front, 0.0, 0.01, newton_params=one, latent_sign=-1.0,
                jac="intercept")
        return s.x + (s.markers,)

    def height(cls):
        h0 = torch.full((4,), 0.3, **like)
        if cls == "mono":
            s = stefan2d_height.MovingLiquidDiffusionUnsteadyMono2D(
                ph, bch, d0, 1e-3, (zh + 0.5, zh), mh)
            s.solve(h0, 0.0, 5e-4, ic, newton_params=one)
        else:
            s = stefan2d_height.MovingLiquidDiffusionUnsteadyDiph2D(
                ph, ph, bch, ic, 1e-3, (zh + 0.5, zh, zh, zh), mh)
            s.solve(h0, 0.0, 5e-4, newton_params=one)
        return s.x

    def species(kind):
        body = (lambda x, t: x - 1.1, lambda x, t: 1.1 - x)
        if kind == "concentration":
            s = concentration.DiffusionUnsteadyConcentration(
                ph, ph, bc1, ic, 1e-3, (z1, z1, z1 + 1, z1 + 1), m1)
        else:
            s = binary.DiffusionUnsteadyBinary(ph, ph, ph, ph, bc1, bc1, 1e-3,
                                               (z1,) * 8, m1, Tm=0.1,
                                               m_liq=-0.5, k_part=0.6)
        s.solve(*body, 0.0, 5e-4)
        return s.x

    return {
        "MovingLiquidDiffusionUnsteadyMono":
            lambda: mono1d("MovingLiquidDiffusionUnsteadyMono"),
        "MovingLiquidDiffusionUnsteadyMonoCoupled":
            lambda: mono1d("MovingLiquidDiffusionUnsteadyMonoCoupled"),
        "MovingLiquidDiffusionUnsteadyDiph": diph1d,
        "solve_stefan_1d_adaptive": adaptive,
        "StefanMono2D.solve-intercept": lambda: mono2d("intercept"),
        "StefanMono2D.solve-autodiff": lambda: mono2d("autodiff"),
        "StefanMono2D.solve_geom": lambda: mono2d("geom"),
        "StefanDiph2D": diph2d,
        "MovingLiquidDiffusionUnsteadyMono2D": lambda: height("mono"),
        "MovingLiquidDiffusionUnsteadyDiph2D": lambda: height("diph"),
        "DiffusionUnsteadyConcentration": lambda: species("concentration"),
        "DiffusionUnsteadyBinary": lambda: species("binary"),
    }


@pytest.mark.parametrize("name", sorted(_phase_change_runs()))
def test_phase_change_solvers_follow_their_inputs(name, monkeypatch):
    """Each Stefan and species class, given CPU tensors (state and
    markers), computes on the CPU and returns CPU tensors; with the default
    device made to fail, no path of the solve asks for it."""
    from penguin_tpu_torch import _device

    def no_default():
        raise AssertionError("a solve asked for the default device")

    monkeypatch.setattr(_device, "default_device", no_default)
    for t in _phase_change_runs()[name]():
        assert t.device.type == "cpu" and t.dtype == torch.float64, name
        assert torch.isfinite(t).all(), name


def _lid_walls():
    lid = tpt.BorderConditions({"top": tpt.Dirichlet(1.0),
                                "bottom": tpt.Dirichlet(0.0),
                                "left": tpt.Dirichlet(0.0),
                                "right": tpt.Dirichlet(0.0)})
    walls = tpt.BorderConditions({k: tpt.Dirichlet(0.0) for k in
                                  ("top", "bottom", "left", "right")})
    return lid, walls


def _small_fluid(body, n=6):
    """A staggered fluid of ``body`` on CPU capacities, n² cells."""
    mesh_p = tpt.Mesh((n, n), (1.0, 1.0))
    meshes_u = (tpt.Mesh((n, n), (1.0, 1.0), (-0.5 / n, 0.0)),
                tpt.Mesh((n, n), (1.0, 1.0), (0.0, -0.5 / n)))
    caps = [tpt.compute_capacity(body, m, p=2, s=1, device="cpu")
            for m in meshes_u + (mesh_p,)]
    ops = [tpt.make_diffusion_ops(c) for c in caps]
    return tpt.Fluid(mesh_u=meshes_u, mesh_p=mesh_p,
                     capacity_u=tuple(caps[:2]), operator_u=tuple(ops[:2]),
                     capacity_p=caps[2], operator_p=ops[2], mu=1.0,
                     rho=1.0, f_u=lambda x, y, z: 0.0,
                     f_p=lambda x, y, z: 0.0)


def _stokes_runs():
    """One short solve of each Stokes class on CPU capacities: name ->
    callable returning the tensors it produced."""
    from penguin_tpu_torch.solvers import (MovingStokesMono, StokesDiph,
                                           StokesMono)
    lid, walls = _lid_walls()
    fluid = _small_fluid
    circle = tpt.geometry.circle((0.5, 0.5), 0.3)
    full = tpt.geometry.full_domain(2)

    def mono(method):
        s = StokesMono(fluid(circle), (lid, walls))
        if method == "schur_gmres":
            s.solve(method=method, maxiter=5)
        else:
            s.solve_unsteady(0.1, 0.2, scheme="BE", method=method, maxiter=5)
        M = s.make_block_preconditioner(schur="dct_cg", mom="cg_dst")
        return s.x + M(s.x) + s.interface_force_traced(s.x)

    def diph():
        ic = tpt.InterfaceConditions(tpt.ScalarJump(1.0, 1.0, 0.0),
                                     tpt.FluxJump(1.0, 1.0, 0.0))
        s = StokesDiph(fluid(tpt.geometry.halfspace(1, 0.51)),
                       fluid(tpt.geometry.halfspace(1, 0.51, -1.0)),
                       (walls, walls), (lid, walls), ic)
        return s.solve()

    def moving(method):
        s = MovingStokesMono(fluid(full), (lid, walls))
        s.solve(lambda x, y, tau, params: full(x, y), 0.1, 0.0, 0.1,
                method=method, maxiter=5)
        return s.x

    return {
        "StokesMono.solve-schur_gmres": lambda: mono("schur_gmres"),
        "StokesMono.solve_unsteady-pbicgstab": lambda: mono("pbicgstab"),
        "StokesDiph": diph,
        "MovingStokesMono.solve-lstsq": lambda: moving("lstsq"),
        "MovingStokesMono.solve-fgmres": lambda: moving("fgmres"),
    }


@pytest.mark.parametrize("name", sorted(_stokes_runs()))
def test_stokes_solvers_follow_their_capacities(name, monkeypatch):
    """Each Stokes class on CPU capacities computes on the CPU and returns
    finite CPU tensors; with the default device made to fail, no path of
    the set-up, the preconditioner or the solve asks for it."""
    from penguin_tpu_torch import _device

    def no_default():
        raise AssertionError("a solve asked for the default device")

    monkeypatch.setattr(_device, "default_device", no_default)
    for t in _stokes_runs()[name]():
        assert t.device.type == "cpu" and t.dtype == torch.float64, name
        assert torch.isfinite(t).all(), name


def _ns_runs():
    """One short run of each Navier-Stokes class and path on CPU
    capacities: name -> callable returning the tensors it produced."""
    from penguin_tpu_torch.solvers import (NavierStokesMono,
                                           NavierStokesScalarCoupler,
                                           PicardCoupling, StreamVorticity)
    from penguin_tpu_torch.solvers.ns_scalar import MonolithicCoupling
    lid, walls = _lid_walls()
    circle = tpt.geometry.circle((0.5, 0.5), 0.3)

    def ns():
        return NavierStokesMono(_small_fluid(tpt.geometry.complement(
            circle)), (lid, walls))

    def unsteady(method):
        s = ns()
        rec = s.make_control_volume_recorder((0.1, 0.9, 0.1, 0.9))
        probe = s.make_pressure_probe([(0.5, 0.1)])
        s.solve_unsteady(0.1, 0.2, method=method, maxiter=5,
                         record=lambda x: rec(x) + (probe(x),))
        return s.x + s.conv_prev_out + tuple(torch.as_tensor(v) for v in
                                             s.record_log)

    def picard(method):
        s = ns()
        s.solve_unsteady_picard(0.1, 0.1, picard_iters=2, method=method,
                                maxiter=5)
        return s.x

    def steady(which):
        s = ns()
        if which == "newton":
            s.solve_steady_newton(max_iter=2, picard_warmup=1)
        elif which == "jfnk":
            s.solve_steady_newton_krylov(max_iter=2, lin_maxiter=5,
                                         picard_warmup=1)
        elif which == "marching":
            s.solve_steady_marching(0.1, t_max=0.2, chunk=0.1,
                                    method="fgmres", maxiter=5)
        else:
            s.solve_steady(max_iter=2, method="pbicgstab")
        return s.x

    def streamvort():
        cap = tpt.compute_capacity(circle, tpt.Mesh((6, 6), (1.0, 1.0)),
                                   p=2, s=1, device="cpu")
        w0 = torch.ones_like(cap.V)
        sv = StreamVorticity(cap, 0.1, 0.1, tpt.make_diffusion_ops(cap),
                             omega0=(w0, w0))
        sv.run(1)
        return sv.omega + sv.psi + sv.velocity

    def coupler(strategy, fast=False):
        fl = _small_fluid(tpt.geometry.full_domain(2))
        c = NavierStokesScalarCoupler(
            NavierStokesMono(fl, (walls, walls)), fl.capacity_p,
            fl.operator_p, 0.1, lambda x, y, z, t: 0.0,
            tpt.BorderConditions({"left": tpt.Dirichlet(1.0)}),
            tpt.Dirichlet(0.0), strategy=strategy, beta=1.0)
        if fast:
            c.run_fast(0.1, 0.1, maxiter=5, method="pgmres")
        else:
            c.step(0.1)
        return c.x + c.T

    return {
        "NavierStokesMono.solve_unsteady-direct":
            lambda: unsteady("direct"),
        "NavierStokesMono.solve_unsteady-fgmres":
            lambda: unsteady("fgmres"),
        "NavierStokesMono.solve_unsteady-gmres": lambda: unsteady("gmres"),
        "NavierStokesMono.solve_unsteady_picard-lstsq":
            lambda: picard("lstsq"),
        "NavierStokesMono.solve_unsteady_picard-fgmres":
            lambda: picard("fgmres"),
        "NavierStokesMono.solve_steady-pbicgstab": lambda: steady("picard"),
        "NavierStokesMono.solve_steady_newton": lambda: steady("newton"),
        "NavierStokesMono.solve_steady_newton_krylov":
            lambda: steady("jfnk"),
        "NavierStokesMono.solve_steady_marching": lambda: steady("marching"),
        "StreamVorticity": streamvort,
        "NavierStokesScalarCoupler.step-picard":
            lambda: coupler(PicardCoupling(maxiter=2)),
        "NavierStokesScalarCoupler.step-monolithic":
            lambda: coupler(MonolithicCoupling(maxiter=2)),
        "NavierStokesScalarCoupler.run_fast":
            lambda: coupler(PicardCoupling(), fast=True),
    }


@pytest.mark.parametrize("name", sorted(_ns_runs()))
def test_navier_stokes_solvers_follow_their_capacities(name, monkeypatch):
    """Each Navier-Stokes class and path on CPU capacities computes on the
    CPU and returns finite CPU tensors; with the default device made to
    fail, no path of the set-up, the diagnostics or the solve asks for
    it."""
    from penguin_tpu_torch import _device

    def no_default():
        raise AssertionError("a solve asked for the default device")

    monkeypatch.setattr(_device, "default_device", no_default)
    for t in _ns_runs()[name]():
        assert t.device.type == "cpu" and t.dtype == torch.float64, name
        assert torch.isfinite(t).all(), name


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

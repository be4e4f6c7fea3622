"""The port's StokesMono on the gates of tests/test_stokes.py (all eight),
the Symmetry half channel of tests/test_advdiff_darcy.py and the 3D
hydrostatic box of tests/test_stokes3d_vmap.py, each also against the JAX
package's solution of the same case (CPU, f64, 1e-9 of scale); and a JAX
state carried into the port and back through ``convert``."""

import numpy as np
import pytest
import torch

import penguin_tpu as jpt
import penguin_tpu_torch as tpt
from penguin_tpu.solvers import stokes as js
from penguin_tpu_torch.solvers import stokes as ts
from penguin_tpu_torch.solvers.stokes import (PinPressureGauge, StokesMono,
                                              stokes_divergence)

import torch_stokes_cases as C
from torch_stefan_cases import one_thread  # noqa: F401  (autouse fixture)

PKGS = ((jpt, js), (tpt, ts))


def both(make, method):
    """Solve the case ``make(pkg, module)`` in both packages; returns the
    port's solver after holding its state against JAX's."""
    out = [make(pkg, mod) for pkg, mod in PKGS]
    for s in out:
        s.solve(method=method)
    C.close(out[1].x, out[0].x, 1e-9)
    return out[1]


def residual(s):
    return max(float((a - b).abs().max())
               for a, b in zip(s.apply_steady(s.x), s.rhs_steady()))


def _fluid_1d(pkg, nx=64, Lx=1.0):
    mesh_p = pkg.Mesh((nx,), (Lx,), (0.0,))
    mesh_u = pkg.Mesh((nx,), (Lx,), (-0.5 * Lx / nx,))
    body = pkg.geometry.full_domain(1)
    cap_u = pkg.compute_capacity(body, mesh_u, **C.kw(pkg))
    cap_p = pkg.compute_capacity(body, mesh_p, **C.kw(pkg))
    return pkg.Fluid(
        mesh_u=(mesh_u,), mesh_p=mesh_p, capacity_u=(cap_u,),
        operator_u=(pkg.make_diffusion_ops(cap_u),), capacity_p=cap_p,
        operator_p=pkg.make_diffusion_ops(cap_p), mu=1.0, rho=1.0,
        f_u=lambda x, y, z: 1.0, f_p=lambda x, y, z: 0.0)


def test_poiseuille_1d_residual():
    """1D: u ≡ 0 with a pressure ramp balancing the body force; the gate
    is the discrete residual."""
    def make(pkg, mod):
        bc = pkg.BorderConditions({"bottom": pkg.Dirichlet(0.0),
                                   "top": pkg.Dirichlet(0.0)})
        return mod.StokesMono(_fluid_1d(pkg), (bc,), mod.PinPressureGauge(),
                              pkg.Dirichlet(0.0))

    s = both(make, "direct")
    assert s.cut_flux == "centroid"
    assert residual(s) <= 1e-10
    assert s.velocity(0).abs().max() < 1e-10


def test_hydrostatic_balance_2d_exact():
    """Closed box, constant body force, no-slip walls: u vanishes and the
    interior pressure gradient balances the force exactly."""
    n, L = 16, 1.0
    h = L / n

    def make(pkg, mod):
        fl = C.fluid(pkg, None, n, L, f_u=lambda x, y, z: 1.0)
        bc = C.walls(pkg)
        return mod.StokesMono(fl, (bc, bc), mod.MeanPressureGauge(),
                              pkg.Dirichlet(0.0))

    s = both(make, "lstsq")
    for d in range(2):
        assert s.velocity(d)[:n, :n].abs().max() < 1e-9
    p = s.pressure.numpy()
    dp = p[1: n - 1, 1: n - 1] - p[0: n - 2, 1: n - 1]
    np.testing.assert_allclose(dp, -h, atol=1e-9)
    assert abs(float((s.mean_w * s.pressure).sum())) < 1e-9


def test_lid_driven_stokes_2d():
    n = 16

    def make(pkg, mod):
        bc_ux, bc_uy = C.lid_bcs(pkg)
        return mod.StokesMono(C.fluid(pkg, None, n), (bc_ux, bc_uy),
                              mod.PinPressureGauge(), pkg.Dirichlet(0.0))

    s = both(make, "lstsq")
    ux, uy = s.velocity(0).numpy(), s.velocity(1).numpy()
    assert np.abs(ux[:, n - 1] - 1.0).max() < 1e-9
    assert 0.0 < np.abs(ux[:, : n - 1]).max() < 1.0
    assert 0.0 < np.abs(uy).max() < 1.0
    div = stokes_divergence(s.fluid, [s.x[0], s.x[2]],
                            [s.x[1], s.x[3]]).numpy().copy()
    div[s.pin_idx] = 0.0
    assert np.abs(div[:n, :n]).max() < 1e-9


def test_traction_cut_bc():
    """Traction cut condition on an embedded circle: the solve is finite
    and the traction rows hold (residual)."""
    def make(pkg, mod):
        circle = pkg.geometry.circle((2.0, 2.0), 1.2)
        fl = C.fluid(pkg, circle, 16, L=4.0, p=6, s=1,
                     f_u=lambda x, y, z: 1.0)
        bc = C.walls(pkg)
        return mod.StokesMono(fl, (bc, bc), mod.PinPressureGauge(),
                              pkg.boundary.Traction(0.75))

    s = both(make, "lstsq")
    assert s.traction and s.cut_flux == "centroid"
    assert residual(s) < 1e-7
    for d in range(2):
        assert torch.isfinite(s.velocity(d)).all()


def test_periodic_channel_poiseuille():
    """Streamwise-periodic channel driven by a body force: the exact
    parabola through the discrete walls, x-independent."""
    n, L = 16, 1.0

    def make(pkg, mod):
        fl = C.fluid(pkg, None, n, L, periodic=(True, False),
                     f_u=(lambda x, y, z: 1.0, lambda x, y, z: 0.0))
        wall, perio = pkg.Dirichlet(0.0), pkg.Periodic()
        bc = pkg.BorderConditions({"left": perio, "right": perio,
                                   "bottom": wall, "top": wall})
        return mod.StokesMono(fl, (bc, bc), mod.PinPressureGauge(),
                              pkg.Dirichlet(0.0))

    s = both(make, "lstsq")
    ux = s.velocity(0).numpy()[:n, :n]
    y = s.fluid.capacity_u[0].C_om[..., 1].numpy()[:n, :n]
    h = L / n
    assert np.abs(ux - (y - h) * (L - y) / 2.0).max() < 1e-10
    assert np.abs(ux - ux.mean(axis=0, keepdims=True)).max() < 1e-10


def _inflow_case(pkg, mod, outflow, gauge=None, n=16):
    wall = pkg.Dirichlet(0.0)
    inflow = pkg.Dirichlet(lambda x, y, z: y * (1.0 - y))
    bc_ux = pkg.BorderConditions({"left": inflow, "right": outflow,
                                  "bottom": wall, "top": wall})
    bc_uy = pkg.BorderConditions({"left": wall, "right": outflow,
                                  "bottom": wall, "top": wall})
    return mod.StokesMono(C.fluid(pkg, None, n), (bc_ux, bc_uy),
                          gauge or mod.PinPressureGauge(), pkg.Dirichlet(0.0))


def test_outflow_channel_mass_conservation():
    """Parabolic inflow and an Outflow exit: the flux through every
    interior column equals the inflow."""
    n = 16
    s = both(lambda pkg, mod: _inflow_case(pkg, mod, pkg.Outflow()), "lstsq")
    ux = s.velocity(0).numpy()[:n, :n]
    assert np.isfinite(ux).all()
    q = ux.sum(axis=1)
    ref = q[1]
    assert ref > 0.05
    assert np.abs(q[1:n] - ref).max() / ref < 1e-9
    assert np.abs(ux[-1, 1:-1] - ux[-2, 1:-1]).max() < 1e-3


def test_mean_pressure_gauge_hydrostatic():
    """MeanPressureGauge: no flow, volume-weighted zero-mean pressure and
    a unit hydrostatic gradient."""
    n, L = 12, 1.0

    def make(pkg, mod):
        fl = C.fluid(pkg, None, n, L,
                     f_u=(lambda x, y, z: 0.0, lambda x, y, z: -1.0))
        bc = C.walls(pkg)
        return mod.StokesMono(fl, (bc, bc), mod.MeanPressureGauge(),
                              pkg.Dirichlet(0.0))

    s = both(make, "lstsq")
    for d in range(2):
        assert s.velocity(d).abs().max() < 1e-9
    p = s.x[-1].numpy()[:n, :n]
    V = s.fluid.capacity_p.V.numpy()[:n, :n]
    assert abs((p * V).sum() / V.sum()) < 1e-9
    grad = np.diff(p[n // 2])[:-1] / (L / n)
    assert np.allclose(np.abs(grad), 1.0, atol=1e-8)


def test_outflow_prescribed_pressure_sets_level():
    """Outflow(pressure): the same velocity as Outflow() and the outlet
    plane at -p_ref (the state stores -p_physical)."""
    n, p_ref = 16, 2.5
    s_ref = both(lambda pkg, mod: _inflow_case(pkg, mod, pkg.Outflow(p_ref)),
                 "lstsq")
    s_free = both(lambda pkg, mod: _inflow_case(pkg, mod, pkg.Outflow()),
                  "lstsq")
    for d in range(2):
        du = (s_free.velocity(d) - s_ref.velocity(d))[:n, :n].abs().max()
        assert du < 1e-8
    p = s_ref.pressure.numpy()
    pin = s_ref.outflow_p_mask.numpy()
    assert pin.sum() >= n - 2
    np.testing.assert_allclose(p[pin], -p_ref, atol=1e-9)
    act = s_ref.p_active.numpy()
    diff = (s_ref.pressure - s_free.pressure).numpy()[act]
    assert np.abs(diff - diff.mean()).max() < 1e-7


def test_outflow_pressure_callable_and_regions():
    """A callable outflow pressure and two disconnected fluid regions: the
    outlet plane carries -p(y), the region without an outlet gets its own
    level pin (scipy's labelling), in both packages alike."""
    n = 16

    def make(pkg, mod):
        m = C.xp(pkg)

        def body(x, y):
            # a solid ring around a fluid disk: two fluid regions
            r = m.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2)
            return 0.08 - m.abs(r - 0.25)

        wall = pkg.Dirichlet(0.0)
        out = pkg.Outflow(lambda x, y, z: 0.5 + y)
        inflow = pkg.Dirichlet(lambda x, y, z: y * (1.0 - y))
        bc_ux = pkg.BorderConditions({"left": inflow, "right": out,
                                      "bottom": wall, "top": wall})
        bc_uy = pkg.BorderConditions({"left": wall, "right": out,
                                      "bottom": wall, "top": wall})
        return mod.StokesMono(C.fluid(pkg, body, n), (bc_ux, bc_uy),
                              mod.PinPressureGauge(), pkg.Dirichlet(0.0))

    sj, st = (make(pkg, mod) for pkg, mod in PKGS)
    np.testing.assert_array_equal(st.outflow_p_mask.numpy(),
                                  np.asarray(sj.outflow_p_mask))
    np.testing.assert_array_equal(st.p_active.numpy(),
                                  np.asarray(sj.p_active))
    C.close((st.outflow_p_vals,), (sj.outflow_p_vals,), 1e-14)
    assert st.pin_mask is None and st.mean_w is None
    C.close(st.rhs_steady(), sj.rhs_steady(), 1e-12)
    for s in (sj, st):
        s.solve(method="lstsq")
    C.close(st.x, sj.x, 1e-9)
    assert residual(st) < 1e-8


def test_stokes_symmetry_half_channel():
    """Half channel with a Symmetry top: zero shear at the symmetry plane,
    a monotone x-invariant half-Poiseuille profile, no vertical flow."""
    n = 16

    def make(pkg, mod):
        fl = C.fluid(pkg, None, n, periodic=(True, False),
                     f_u=(lambda x, y, z: 1.0, lambda x, y, z: 0.0))
        wall, sym, perio = pkg.Dirichlet(0.0), pkg.Symmetry(), pkg.Periodic()
        bc = pkg.BorderConditions({"left": perio, "right": perio,
                                   "bottom": wall, "top": sym})
        return mod.StokesMono(fl, (bc, bc), mod.PinPressureGauge(),
                              pkg.Dirichlet(0.0))

    s = both(make, "lstsq")
    ux = s.velocity(0).numpy()[:n, :n]
    col = ux[n // 2]
    assert abs(col[-1] - col[-2]) < 1e-10
    assert np.all(np.diff(col[:-1]) > -1e-12)
    assert np.abs(ux - ux.mean(axis=0, keepdims=True)).max() < 1e-9
    assert s.velocity(1)[:n, :n].abs().max() < 1e-9


@pytest.mark.slow
def test_stokes_3d_hydrostatic():
    """3D closed box with a constant force: u = 0 and dp = -h."""
    n, L = 8, 1.0

    def make(pkg, mod):
        fl = C.fluid(pkg, None, n, L, ndim=3, f_u=lambda x, y, z: 1.0)
        bc = C.walls(pkg, keys=("left", "right", "bottom", "top",
                                "backward", "forward"))
        return mod.StokesMono(fl, (bc, bc, bc), mod.PinPressureGauge(),
                              pkg.Dirichlet(0.0))

    s = both(make, "lstsq")
    for d in range(3):
        assert s.velocity(d)[:n, :n, :n].abs().max() < 1e-8
    p = s.pressure.numpy()
    dp = p[1:n - 1, 1:n - 1, 1:n - 1] - p[0:n - 2, 1:n - 1, 1:n - 1]
    np.testing.assert_allclose(dp, -L / n, atol=1e-8)


def test_state_carries_across_packages():
    """A JAX solution goes into the port (``state_from_numpy``) and is a
    solution there too; the port's state comes back as numpy arrays."""
    from penguin_tpu_torch.convert import state_from_numpy, state_to_numpy
    bx, by = C.lid_bcs(jpt)
    sj = js.StokesMono(C.fluid(jpt, None, 12), (bx, by), None,
                       jpt.Dirichlet(0.0))
    sj.solve(method="direct")
    bx, by = C.lid_bcs(tpt)
    st = StokesMono(C.fluid(tpt, None, 12), (bx, by), PinPressureGauge(),
                    tpt.Dirichlet(0.0))
    st.x = state_from_numpy([np.asarray(a) for a in sj.x], device="cpu")
    assert all(a.dtype == torch.float64 for a in st.x)
    assert residual(st) < 1e-10
    back = state_to_numpy(st.x)
    for a, b in zip(back, sj.x):
        np.testing.assert_array_equal(a, np.asarray(b))

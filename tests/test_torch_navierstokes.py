"""The port's NavierStokesMono against the JAX package on the CPU in f64
(the port on the JAX capacities), then the JAX package's Navier-Stokes
gates (tests/test_navierstokes.py) on the port.

Parity, on a lid cavity and a channel with an Outflow border on either
side, both around a cut obstacle at 10²-16²:

- the convection operators (``conv_bulk`` with the one-sided outlet rows,
  ``conv_K``, ``conv_vectors``), the Picard applies, the nonlinear
  residual and the unsteady rhs with the AB2 term: 1e-12 of scale;
- the steady Picard (``lstsq``) and dense Newton solves, the direct AB2
  steps with their ``record`` and convection carry, the implicit-Picard
  ``lstsq`` steps and the pseudo-time march: 1e-9 of scale with equal
  counts;
- the Krylov paths (``pbicgstab``, ``pgmres``, ``fgmres``): the port's
  step solves its own system to 10x the tolerance (true residual), and
  lands within 1e-6 of JAX's step.

A callable ρ raises in the port where the JAX package silently uses 1
(a known deviation)."""

import numpy as np
import pytest
import torch

import penguin_tpu as jpt
import penguin_tpu_torch as tpt
from penguin_tpu_torch.solvers.navierstokes import NavierStokesMono
from penguin_tpu_torch.solvers.stokes import PinPressureGauge, StokesMono

import torch_ns_cases as NS
import torch_stokes_cases as C
from torch_stefan_cases import one_thread  # noqa: F401  (autouse fixture)

DT = 0.02


@pytest.fixture(scope="module")
def cavity():
    return NS.pair(NS.cut_cavity)


@pytest.fixture(scope="module", params=["right", "left"])
def channel(request):
    return NS.pair(NS.channel, outlet=request.param)


def test_convection_operators_match_jax(channel):
    """conv_bulk (one-sided rows on the outlet plane), conv_K,
    conv_vectors, the steady and unsteady Picard applies, the nonlinear
    residual and the unsteady rhs with the AB2 term, on seeded states:
    1e-12 of scale."""
    sj, st = channel
    xj, xt = C.seeded_pair(sj, 3)
    yj, yt = C.seeded_pair(sj, 4)
    N = 2
    for d in range(N):
        C.close((st.conv_bulk(d, xt[0:2 * N:2], yt[2 * d]),),
                (sj.conv_bulk(d, xj[0:2 * N:2], yj[2 * d]),), 1e-12)
        C.close((st.conv_K(d, xt[1:2 * N:2]),), (sj.conv_K(d, xj[1:2 * N:2]),),
                1e-12)
    C.close(st.conv_vectors(xt), sj.conv_vectors(xj), 1e-12)
    C.close(st.make_picard_apply(xt)(yt), sj.make_picard_apply(xj)(yj),
            1e-12)
    bj, bt = sj.rhs_steady(), st.rhs_steady()
    C.close(bt, bj, 1e-12)
    C.close(st.nonlinear_residual(xt, bt), sj.nonlinear_residual(xj, bj),
            1e-12)
    # the unsteady rhs with the AB2 extrapolated convection on it
    cj = [1.5 * a - 0.5 * b for a, b in zip(sj.conv_vectors(xj),
                                             sj.conv_vectors(yj))]
    ct = [1.5 * a - 0.5 * b for a, b in zip(st.conv_vectors(xt),
                                             st.conv_vectors(yt))]
    C.close(st.make_unsteady_rhs(DT, 0.5)(xt, 0.1, 0.1 + DT,
                                          extra_mom=tuple(-c for c in ct)),
            sj.make_unsteady_rhs(DT, 0.5)(xj, 0.1, 0.1 + DT,
                                          extra_mom=tuple(-c for c in cj)),
            1e-12)


def test_steady_picard_and_newton_match_jax(cavity):
    """Three lstsq Picard sweeps, then dense Newton from there, on the cut
    cavity: 1e-9 of scale, the same number of iterations, and the same
    residual histories."""
    sj, st = cavity
    sj.solve_steady(max_iter=3, tol=1e-12)
    st.solve_steady(max_iter=3, tol=1e-12)
    C.close(st.x, sj.x, 1e-9)
    np.testing.assert_allclose(st.residual_history, sj.residual_history,
                               rtol=1e-9)
    sj.solve_steady_newton(max_iter=5, tol=1e-11, picard_warmup=0, x0=sj.x)
    st.solve_steady_newton(max_iter=5, tol=1e-11, picard_warmup=0, x0=st.x)
    C.close(st.x, sj.x, 1e-9)
    assert len(st.residual_history) == len(sj.residual_history)
    # |R| to 1e-6, down to the round-off floor (1e-12 absolute)
    np.testing.assert_allclose(st.residual_history, sj.residual_history,
                               rtol=1e-6, atol=1e-12)
    assert st.residual_history[-1] < 1e-11


def test_unsteady_direct_record_and_carry_match_jax(cavity):
    """Three AB2/CN steps by the reused LU with the interface force
    recorded each step, then two more from the carried convection
    (``conv_prev``): states, carries and record logs to 1e-9 of scale."""
    sj, st = cavity
    outs = []
    for s in (sj, st):
        s.solve_unsteady(DT, 3 * DT, scheme="CN", method="direct",
                         record=lambda x, s=s: s.interface_force_traced(x))
        first = (s.x, s.conv_prev_out, s.record_log)
        s.solve_unsteady(DT, 5 * DT, scheme="CN", method="direct", x0=s.x,
                         t_start=3 * DT, conv_prev=s.conv_prev_out)
        outs.append(first + (s.x, s.conv_prev_out))
    (xj, cj, rj, xj2, cj2), (xt, ct, rt, xt2, ct2) = outs
    for got, want in ((xt, xj), (ct, cj), (xt2, xj2), (ct2, cj2)):
        C.close(got, want, 1e-9)
    assert isinstance(rt, tuple) and rt[0].shape == (3,)
    np.testing.assert_allclose(np.array(rt), np.array(rj), rtol=1e-9,
                               atol=1e-12)


@pytest.mark.parametrize("method", ["pbicgstab", "pgmres", "fgmres"])
def test_unsteady_krylov_step_solves_its_system(cavity, method):
    """One AB1/CN step from a smooth state: the port's step solves its own
    system to 10x the tolerance, and lands within 1e-6 of the JAX step
    (these saddle-point Krylov paths spread round-off; counts are not
    compared)."""
    sj, st = cavity
    tol = 1e-10
    x0t = NS.smooth_state(st, 5)
    x0j = NS.smooth_state(sj, 5)
    st.solve_unsteady(DT, DT, scheme="CN", method=method, x0=x0t, tol=tol)
    conv = st.conv_vectors(x0t)
    b = st.make_unsteady_rhs(DT, 0.5)(x0t, 0.0, DT,
                                      extra_mom=tuple(-c for c in conv))
    rel = NS.residual_relres(st.make_unsteady_apply(DT, 0.5), b, st.x)
    assert rel <= 10 * tol, rel
    assert st.krylov_iters.shape == (1,) and st.krylov_relres.shape == (1,)
    assert st.krylov_relres[0] <= tol
    sj.solve_unsteady(DT, DT, scheme="CN", method=method, x0=x0j, tol=tol)
    C.close(st.x, sj.x, 1e-6)


def test_unsteady_picard_matches_jax(cavity):
    """Implicit-Picard CN steps: the lstsq host loop (one step, two
    sweeps) to 1e-9 of scale; one fgmres sweep solves its linearised
    system to 10x the tolerance and lands within 1e-6 of JAX's."""
    sj, st = cavity
    x0j, x0t = NS.smooth_state(sj, 6), NS.smooth_state(st, 6)
    sj.solve_unsteady_picard(DT, DT, scheme="CN", picard_iters=2, x0=x0j)
    st.solve_unsteady_picard(DT, DT, scheme="CN", picard_iters=2, x0=x0t)
    C.close(st.x, sj.x, 1e-9)
    tol = 1e-10
    sj.solve_unsteady_picard(DT, DT, scheme="CN", picard_iters=1,
                             method="fgmres", tol=tol, maxiter=200, x0=x0j)
    st.solve_unsteady_picard(DT, DT, scheme="CN", picard_iters=1,
                             method="fgmres", tol=tol, maxiter=200, x0=x0t)
    conv = st.conv_vectors(x0t)
    b = st.make_unsteady_rhs(DT, 0.5)(x0t, 0.0, DT,
                                      extra_mom=tuple(-0.5 * c for c in conv))
    rel = NS.residual_relres(st._picard_rows(x0t, DT, 0.5), b, st.x)
    assert rel <= 10 * tol, rel
    assert st.krylov_relres[0] <= tol
    C.close(st.x, sj.x, 1e-6)


def test_steady_marching_matches_jax(cavity):
    """Pseudo-time continuation in two chunks of two direct CN steps:
    1e-9 of scale, with the same rate history."""
    sj, st = cavity
    for s in (sj, st):
        s.solve_steady_marching(DT, t_max=4 * DT, chunk=2 * DT, tol=0.0,
                                method="direct")
    C.close(st.x, sj.x, 1e-9)
    np.testing.assert_allclose(st.residual_history, sj.residual_history,
                               rtol=1e-9)


def test_callable_density_raises(cavity):
    """Known deviation: the JAX package's convection silently takes a
    callable ρ as 1 (its steady Picard apply equals the ρ = 1 one); the
    port raises instead."""
    import dataclasses
    sj, st = cavity
    fl_j = dataclasses.replace(sj.fluid, rho=lambda x, y, z: 3.0)
    sj_c = NS.ns_class(jpt)(fl_j, sj.bc_u, None, jpt.Dirichlet(0.0))
    xj, _ = C.seeded_pair(sj, 7)
    C.close(sj_c.make_picard_apply(xj)(xj), sj.make_picard_apply(xj)(xj),
            0.0)
    fl_t = dataclasses.replace(st.fluid, rho=lambda x, y, z: 3.0)
    st_c = NavierStokesMono(fl_t, st.bc_u, None, tpt.Dirichlet(0.0))
    with pytest.raises(ValueError, match="callable rho"):
        st_c.make_picard_apply(st.zero_state())
    with pytest.raises(ValueError, match="callable rho"):
        st_c.solve_unsteady(DT, DT, method="direct")


# ---------------------------------------------------------------------------
# the JAX package's Navier-Stokes gates on the port
# ---------------------------------------------------------------------------

def _tg_fluid(n, L=2 * np.pi, mu=1.0):
    fl = C.fluid(tpt, None, n, L=L, mu=mu)
    return fl, fl.mesh_u


def _tg_exact(nu):
    def u(x, y, t):
        return -np.cos(x) * np.sin(y) * np.exp(-2 * nu * t)

    def v(x, y, t):
        return np.sin(x) * np.cos(y) * np.exp(-2 * nu * t)

    return u, v


def _tg_bcs(nu):
    keys = ("left", "right", "bottom", "top")
    bc_ux = tpt.BorderConditions({k: tpt.Dirichlet(
        lambda x, y, z, t: torch.cos(x) * torch.sin(y)
        * (-np.exp(-2 * nu * t))) for k in keys})
    bc_uy = tpt.BorderConditions({k: tpt.Dirichlet(
        lambda x, y, z, t: torch.sin(x) * torch.cos(y)
        * np.exp(-2 * nu * t)) for k in keys})
    return bc_ux, bc_uy


def _tg_error(n, dt=2e-3, t_end=0.05, nu=1.0):
    fluid, (mesh_ux, mesh_uy) = _tg_fluid(n, mu=nu)
    ue, ve = _tg_exact(nu)
    solver = NavierStokesMono(fluid, _tg_bcs(nu), PinPressureGauge(),
                              tpt.Dirichlet(0.0))
    hx, hy = mesh_ux.h
    Xux, Yux = np.meshgrid(np.asarray(mesh_ux.nodes[0]) + 0.5 * hx,
                           np.asarray(mesh_ux.nodes[1]) + 0.5 * hy,
                           indexing="ij")
    Xuy, Yuy = np.meshgrid(np.asarray(mesh_uy.nodes[0]) + 0.5 * hx,
                           np.asarray(mesh_uy.nodes[1]) + 0.5 * hy,
                           indexing="ij")
    uw0 = torch.as_tensor(ue(Xux, Yux, 0.0))
    vw0 = torch.as_tensor(ve(Xuy, Yuy, 0.0))
    x0 = (uw0, uw0, vw0, vw0, torch.zeros_like(fluid.capacity_p.V))
    solver.solve_unsteady(dt, t_end, scheme="CN", method="direct", x0=x0)
    t_f = int(np.ceil(t_end / dt - 1e-12)) * dt
    uxf = solver.velocity(0).numpy()
    return np.abs(uxf[1:n, 1:n] - ue(Xux, Yux, t_f)[1:n, 1:n]).max()


@pytest.mark.slow
def test_taylor_green_accuracy_and_convergence():
    e16 = _tg_error(16)
    e32 = _tg_error(32)
    assert e16 < 0.05, e16
    assert e32 < e16 / 2.5, (e16, e32)


def _lid_cavity(n, Re=100.0):
    fl = C.fluid(tpt, None, n, L=1.0, mu=1.0 / Re)
    noslip, lid = tpt.Dirichlet(0.0), tpt.Dirichlet(1.0)
    bc_ux = tpt.BorderConditions({"left": noslip, "right": noslip,
                                  "bottom": noslip, "top": lid})
    return NavierStokesMono(fl, (bc_ux, C.walls(tpt)), PinPressureGauge(),
                            tpt.Dirichlet(0.0))


@pytest.mark.slow
def test_lid_cavity_steady_picard_re100():
    n = 24
    solver = _lid_cavity(n)
    solver.solve_steady(max_iter=40, tol=1e-9, method="lstsq")
    center = solver.velocity(0).numpy()[n // 2, :n]
    assert -0.30 < center.min() < -0.12, center.min()
    assert abs(center[n - 1] - 1.0) < 1e-8


@pytest.mark.slow
def test_lid_cavity_newton_matches_picard():
    n = 16
    s1 = _lid_cavity(n)
    s1.solve_steady(max_iter=40, tol=1e-10, method="lstsq")
    s2 = _lid_cavity(n)
    s2.solve_steady_newton(max_iter=10, tol=1e-11, picard_warmup=2)
    assert s2.residual_history[-1] < 1e-11
    for d in range(2):
        a = s1.velocity(d).numpy()[:n, :n]
        b = s2.velocity(d).numpy()[:n, :n]
        assert np.abs(a - b).max() < 1e-6


@pytest.mark.slow
def test_unsteady_picard_matches_ab2_small_dt():
    n, nu = 12, 1.0
    fluid, (mesh_ux, mesh_uy) = _tg_fluid(n, mu=nu)
    ue, ve = _tg_exact(nu)
    Xux, Yux = np.meshgrid(np.asarray(mesh_ux.nodes[0]),
                           np.asarray(mesh_ux.nodes[1]), indexing="ij")
    Xuy, Yuy = np.meshgrid(np.asarray(mesh_uy.nodes[0]),
                           np.asarray(mesh_uy.nodes[1]), indexing="ij")
    u0 = torch.as_tensor(ue(Xux, Yux, 0.0))
    v0 = torch.as_tensor(ve(Xuy, Yuy, 0.0))
    x0 = (u0, u0, v0, v0, torch.zeros_like(fluid.capacity_p.V))
    dt, t_end = 1e-3, 5e-3
    s1 = NavierStokesMono(fluid, _tg_bcs(nu), PinPressureGauge(),
                          tpt.Dirichlet(0.0))
    s1.solve_unsteady(dt, t_end, scheme="BE", method="direct", x0=x0)
    s2 = NavierStokesMono(fluid, _tg_bcs(nu), PinPressureGauge(),
                          tpt.Dirichlet(0.0))
    s2.solve_unsteady_picard(dt, t_end, scheme="BE", picard_iters=4, x0=x0)
    a = s1.velocity(0).numpy()[:n, :n]
    b = s2.velocity(0).numpy()[:n, :n]
    assert np.abs(a - b).max() < 2e-3


@pytest.mark.slow
def test_steady_marching_matches_picard():
    n = 16
    ref = _lid_cavity(n)
    ref.solve_steady(max_iter=40, tol=1e-10, method="lstsq")
    u_ref = ref.velocity(0).numpy()
    march = _lid_cavity(n)
    march.solve_steady_marching(dt=2e-2, t_max=40.0, chunk=4.0, tol=2e-4,
                                lin_tol=1e-10)
    u_m = march.velocity(0).numpy()
    assert np.isfinite(u_m).all()
    assert np.abs(u_m - u_ref).max() < 2e-2, np.abs(u_m - u_ref).max()


@pytest.mark.slow
def test_cylinder_drag_diagnostics():
    def solve_drag(mu):
        fl = C.fluid(tpt, tpt.geometry.complement(
            tpt.geometry.circle((2.01, 2.01), 0.5)), 24, L=4.0, mu=mu)
        s = StokesMono(fl, (C.walls(tpt, 1.0), C.walls(tpt)),
                       PinPressureGauge(), tpt.Dirichlet(0.0))
        s.solve(method="lstsq")
        return s.force_diagnostics()

    Fx1, Fy1 = solve_drag(1.0)
    Fx2, Fy2 = solve_drag(2.0)
    assert Fx1 > 0, Fx1
    assert abs(Fy1) < 0.05 * abs(Fx1)
    assert abs(Fx2 / Fx1 - 2.0) < 0.05, Fx2 / Fx1


def _lid_right(n=12):
    fl = C.fluid(tpt, None, n, L=1.0, mu=1e-2)
    lid = tpt.Dirichlet(lambda x, y, t=0.0: 1.0)
    noslip = tpt.Dirichlet(0.0)
    bc_ux = tpt.BorderConditions({"left": noslip, "right": lid,
                                  "bottom": noslip, "top": noslip})
    return NavierStokesMono(fl, (bc_ux, C.walls(tpt)), PinPressureGauge(),
                            tpt.Dirichlet(0.0))


def test_unsteady_picard_fgmres_matches_dense():
    """The fgmres implicit-Picard path (DCT-CG Schur M) reproduces the
    lstsq host loop."""
    dt = 0.02
    a = _lid_right()
    xa = a.solve_unsteady_picard(dt, 3 * dt, scheme="BE", picard_iters=3,
                                 picard_tol=0.0, method="lstsq")
    b = _lid_right()
    xb = b.solve_unsteady_picard(dt, 3 * dt, scheme="BE", picard_iters=3,
                                 method="fgmres", tol=1e-12, maxiter=400)
    for p, q in zip(xa, xb):
        assert (p - q).abs().max().item() < 1e-8
    assert (b.krylov_relres < 1e-10).all()


def test_outflow_convection_transparent_both_sides():
    """Plug flow through an own-axis Outflow outlet has zero convective
    divergence on the outlet plane, on both sides."""
    n = 12
    fluid, (mesh_ux, mesh_uy) = _tg_fluid(n, L=1.0)
    wall = tpt.Dirichlet(0.0)

    def conv_at_outlet(out_key, in_key, sgn):
        bc_ux = tpt.BorderConditions({out_key: tpt.Outflow(),
                                      in_key: tpt.Dirichlet(sgn),
                                      "bottom": wall, "top": wall})
        bc_uy = tpt.BorderConditions({out_key: tpt.Outflow(), in_key: wall,
                                      "bottom": wall, "top": wall})
        s = NavierStokesMono(fluid, (bc_ux, bc_uy), PinPressureGauge(),
                             tpt.Dirichlet(0.0))
        uwx = torch.full(mesh_ux.np_shape, float(sgn), dtype=torch.float64)
        uwy = torch.zeros(mesh_uy.np_shape, dtype=torch.float64)
        conv = s.conv_bulk(0, (uwx, uwy), uwx).numpy()
        plane = 0 if out_key == "left" else mesh_ux.n[0] - 1
        return conv[plane, 1:-1]

    np.testing.assert_allclose(conv_at_outlet("right", "left", +1.0), 0.0,
                               atol=1e-12)
    np.testing.assert_allclose(conv_at_outlet("left", "right", -1.0), 0.0,
                               atol=1e-12)


def test_chunked_ab2_conv_carry_exact():
    """Two chunks of four fgmres CN steps with ``conv_prev`` carried
    across reproduce the single eight-step run bit for bit."""
    nx, ny = 32, 16
    Lx, Ly = 2.2, 0.41

    def make():
        fl = C.fluid(tpt, tpt.geometry.complement(
            tpt.geometry.circle((0.2, 0.2), 0.05)), (nx, ny), L=(Lx, Ly),
            mu=1e-3)

        def inflow(x, y, z=0.0, t=None):
            xi = y / Ly
            return 0.3 * 4 * xi * (1 - xi)

        ns_ = tpt.Dirichlet(0.0)
        bc_ux = tpt.BorderConditions(
            {"left": tpt.Dirichlet(inflow), "right": tpt.Outflow(),
             "bottom": ns_, "top": ns_})
        return NavierStokesMono(fl, (bc_ux, C.walls(tpt)),
                                PinPressureGauge(), tpt.Dirichlet(0.0))

    dt = 0.005
    s1 = make()
    x_full = s1.solve_unsteady(dt, 8 * dt, scheme="CN", method="fgmres",
                               tol=1e-10, maxiter=120)
    s2 = make()
    x, cp = None, None
    for k0 in (0, 4):
        x = s2.solve_unsteady(dt, (k0 + 4) * dt, scheme="CN",
                              method="fgmres", tol=1e-10, maxiter=120,
                              x0=x, t_start=k0 * dt, conv_prev=cp)
        cp = s2.conv_prev_out
    for a, b in zip(x, x_full):
        assert torch.equal(a, b)


def _dfg_forces(s, x=None):
    """DFG 2D-1's control-volume Cd and LSQ-probe ΔP of ``s``'s state (or
    of ``x``), as benchmarks/dfg_cylinder_steady.py reads them."""
    pa, pb = s.pressure_probe([(0.15, 0.2), (0.25, 0.2)], x=x)
    fx = s.control_volume_force((0.10, 0.32, 0.08, 0.32), x=x)[0]
    return fx / (0.5 * 0.2 ** 2 * 0.1), pa - pb


@pytest.mark.slow
def test_dfg_f32_stalls_match_jax():
    """The DFG channel at 256 × 128 in f32 (the card's rows), JAX with x64
    off.  2D-1 by JFNK: the inner fgmres hits its 800 cap from the fourth
    Newton step on in both packages, and the residuals agree within 3x
    each step, and the port's control-volume Cd and LSQ ΔP of JAX's last
    state equal JAX's.  2D-2 by CN implicit Picard from rest: both
    packages' fgmres stall at their 120 iterations with relres between
    1e-5 and 1e-3 (a reference behaviour in f32, not a port fault)."""
    import jax
    import jax.numpy as jnp
    with jax.enable_x64(False):
        sj = NS.dfg(jpt, (256, 128), jnp.float32, 0.3)
        sj.solve_steady_newton_krylov(max_iter=5, tol=1e-10, lin_maxiter=800,
                                      restart=100)
        pj = NS.dfg(jpt, (256, 128), jnp.float32, 1.5, ramp=1.0)
        pj.solve_unsteady_picard(0.002, 0.002, scheme="CN", picard_iters=2,
                                 method="fgmres", tol=1e-6, maxiter=120)
        hj, ij = list(sj.residual_history), list(sj.newton_lin_iters)
        fj = _dfg_forces(sj)
        xj = tuple(torch.as_tensor(np.array(a)) for a in sj.x)
        pj_its, pj_rel = int(pj.krylov_iters[0]), float(pj.krylov_relres[0])
    st = NS.dfg(tpt, (256, 128), torch.float32, 0.3)
    st.solve_steady_newton_krylov(max_iter=5, tol=1e-10, lin_maxiter=800,
                                  restart=100)
    ht, it = st.residual_history, st.newton_lin_iters
    assert ij[3] == it[3] == 800, (ij, it)
    assert max(ij[:3] + it[:3]) < 100, (ij, it)
    ratios = [a / b for a, b in zip(ht, hj)]
    assert all(1 / 3 < r < 3 for r in ratios), (ht, hj)
    # the force of one state is the same function in both packages (to
    # f32 rounding)
    np.testing.assert_allclose(_dfg_forces(st, xj), fj, rtol=1e-6)
    pt_ = NS.dfg(tpt, (256, 128), torch.float32, 1.5, ramp=1.0)
    pt_.solve_unsteady_picard(0.002, 0.002, scheme="CN", picard_iters=2,
                              method="fgmres", tol=1e-6, maxiter=120)
    its, rel = int(pt_.krylov_iters[0]), float(pt_.krylov_relres[0])
    assert pj_its == its == 120, (pj_its, its)
    assert 1e-5 < pj_rel < 1e-3 and 1e-5 < rel < 1e-3, (pj_rel, rel)


@pytest.mark.slow
def test_dfg_cut_force_matches_jax():
    """DFG 2D-1 at 256 × 128 by JFNK cut at |R| < 2.5e-3, as the card's
    row is (three Newton steps of 3, 11 and 20 fgmres iterations in each
    package): in f64 the port's control-volume Cd and LSQ ΔP agree with
    JAX's to 0.1%, and in f32 to 2% (f32 round-off moves the unconverged
    pressure of an inexact Newton iterate by ~1%; chip_smoke.py gates the
    card's f32 Cd and ΔP against JAX's f64 ones at 2%)."""
    import jax.numpy as jnp
    kw = dict(max_iter=25, tol=2.5e-3, lin_maxiter=800, restart=100)
    sj = NS.dfg(jpt, (256, 128), jnp.float64, 0.3)
    sj.solve_steady_newton_krylov(**kw)
    fj = _dfg_forces(sj)
    for dtype, rtol in ((torch.float64, 1e-3), (torch.float32, 2e-2)):
        st = NS.dfg(tpt, (256, 128), dtype, 0.3)
        st.solve_steady_newton_krylov(**kw)
        assert st.newton_lin_iters == list(sj.newton_lin_iters) == [3, 11,
                                                                    20]
        np.testing.assert_allclose(_dfg_forces(st), fj, rtol=rtol)

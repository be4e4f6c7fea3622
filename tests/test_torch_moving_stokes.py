"""The port's MovingStokesMono against the JAX package on the CPU in f64,
on a disk translating at U through a 16² box (the case of
tests/test_cut_moments.py:259): the slab system's apply and rhs to 1e-12 of
scale for both cut fluxes and both schemes, one slab solved by ``lstsq``
and ``pgmres`` to 1e-9 (``pgmres`` with the JAX package's row-norm estimate
carried across: the two packages draw their probes from different
generators) and by ``fgmres`` within the JAX package's own spread;
then the JAX gates on the port: the rigid translation satisfies every
active row exactly, and a static body reproduces StokesMono's unsteady
θ-scheme (slow in the JAX suite, slow here)."""

import numpy as np
import pytest
import torch

import penguin_tpu as jpt
import penguin_tpu_torch as tpt
from penguin_tpu.solvers.moving_stokes import MovingStokesMono as JMoving
from penguin_tpu_torch.solvers import moving_stokes as tms
from penguin_tpu_torch.solvers.moving_stokes import MovingStokesMono as TMoving

import torch_stokes_cases as C
from torch_stefan_cases import one_thread  # noqa: F401  (autouse fixture)

N, L, U, R = 16, 2.0, 0.7, 0.4
T0, DT = 0.1, 0.05


def translating_disk(pkg, M, cut_flux="auto", carry=None):
    """A fluid disk of radius R moving at (U, 0): the solver and its slab
    body ``body_st(x, y, tau, params)``."""
    m = C.xp(pkg)

    def body0(x, y):
        return m.sqrt((x - 0.8) ** 2 + (y - 1.0) ** 2) - R

    def body_st(x, y, tau, params):
        t = params[0] + tau
        return m.sqrt((x - 0.8 - U * t) ** 2 + (y - 1.0) ** 2) - R

    fl = C.fluid(pkg, body0, N, L=L, mu=0.5)
    if carry is not None:
        fl = C.carry_fluid(carry, fl)
    bc_ux = C.walls(pkg, U)
    bc_uy = C.walls(pkg, 0.0)
    s = M(fl, (bc_ux, bc_uy), None, (pkg.Dirichlet(U), pkg.Dirichlet(0.0)),
          cut_flux=cut_flux)
    return s, body_st


@pytest.fixture(scope="module", params=["moment", "centroid"])
def pair(request):
    sj, bj = translating_disk(jpt, JMoving, request.param)
    st, bt = translating_disk(tpt, TMoving, request.param, sj.fluid)
    return sj, st, bj, bt


@pytest.mark.parametrize("scheme", ["BE", "CN"])
def test_slab_system_matches_jax(pair, scheme):
    sj, st, bj, bt = pair
    theta = 0.5 if scheme == "CN" else 1.0
    xj, xt = C.seeded_pair(sj, 4)
    pj, pt_ = C.seeded_pair(sj, 5)
    aj, rj = sj._slab_system(bj, T0, DT, theta, scheme, 4, 1, pj, T0 + DT)
    at, rt = st._slab_system(bt, T0, DT, theta, scheme, 4, 1, pt_, T0 + DT)
    C.close(at(xt), aj(xj), 1e-12)
    C.close(rt(), rj(), 1e-12)
    np.testing.assert_array_equal(st.pin_mask.numpy(),
                                  np.asarray(sj.pin_mask))


def _x0(sj):
    """The exact rigid motion u = uγ = (U, 0), p = 0 as the start."""
    x0 = list(sj.zero_state())
    x0[0] = x0[0] + U
    x0[1] = x0[1] + U
    return tuple(x0), tuple(torch.as_tensor(np.array(a)) for a in x0)


def test_one_slab_lstsq_matches_jax(pair):
    sj, st, bj, bt = pair
    x0j, x0t = _x0(sj)
    sj.solve(bj, DT, T0, T0 + DT, x0=x0j, method="lstsq")
    st.solve(bt, DT, T0, T0 + DT, x0=x0t, method="lstsq")
    C.close(st.x, sj.x, 1e-9)
    assert torch.isfinite(st.velocity(0)).all()
    assert st.pressure is st.x[4]


def test_one_slab_fgmres_within_the_reference_spread(pair):
    """``fgmres`` with the static block-Schur/DCT preconditioner: the slab
    system's sliver rows make the iterate ill-determined (JAX's own result
    moves by ~1e-4 of scale when its start moves by a relative 1e-15), so
    the port is held within 10× of that spread, and to its tolerance in the
    true residual."""
    sj, st, bj, bt = pair
    x0j, x0t = _x0(sj)
    x0p = tuple(a * (1 + 1e-15) for a in x0j)
    xs = []
    for start in (x0j, x0p):
        sj.solve(bj, DT, T0, T0 + DT, x0=start, method="fgmres", tol=1e-10)
        xs.append(sj.x)
    st.solve(bt, DT, T0, T0 + DT, x0=x0t, method="fgmres", tol=1e-10)
    spread = C.close(xs[1], xs[0], 1.0)
    C.close(st.x, xs[0], 10 * max(spread, 1e-12))
    at, rt = st._slab_system(bt, T0, DT, 1.0, "BE", 4, 1, x0t, T0 + DT)
    b = rt()
    res = sum(float(((a - r) ** 2).sum()) for a, r in zip(at(st.x), b))
    assert res ** 0.5 <= 1e-10 * sum(float((r ** 2).sum()) for r in b) ** 0.5


def test_one_slab_pgmres_matches_jax(pair, monkeypatch):
    """``pgmres`` with JAX's row-norm estimate of the same slab."""
    from penguin_tpu.linsolve import row_norm_equilibrator as j_equil
    sj, st, bj, bt = pair
    x0j, x0t = _x0(sj)
    aj, rj = sj._slab_system(bj, T0, DT, 1.0, "BE", 4, 1, x0j, T0 + DT)
    minv = tuple(torch.as_tensor(np.array(a)) for a in j_equil(aj, rj()))
    monkeypatch.setattr(tms, "row_norm_equilibrator", lambda *a: minv)
    sj.solve(bj, DT, T0, T0 + DT, x0=x0j, method="pgmres", tol=1e-12)
    st.solve(bt, DT, T0, T0 + DT, x0=x0t, method="pgmres", tol=1e-12)
    C.close(st.x, sj.x, 1e-9)


@pytest.mark.parametrize("flux", ["moment", "centroid"])
def test_moving_stokes_moment_rigid_translation_row_exact(flux):
    """The state u = U, p = 0 satisfies every active row of the slab system
    exactly for both cut fluxes (the corrections vanish on constants)."""
    from penguin_tpu_torch.assembly import _col_G_nz
    from penguin_tpu_torch.capacity import compute_capacity_spacetime
    from penguin_tpu_torch.solvers.moving_diffusion import slice_spacetime
    s, body_st = translating_disk(tpt, TMoving, flux)
    xe = list(s.zero_state())
    xe[0] = torch.full_like(xe[0], U)
    xe[1] = torch.full_like(xe[1], U)
    xe = tuple(xe)
    dt = 0.05
    apply_fn, rhs_fn = s._slab_system(body_st, 0.0, dt, 1.0, "BE", 4, 1, xe,
                                      dt)
    res = [a - b for a, b in zip(apply_fn(xe), rhs_fn())]
    for k, mesh_k in ((0, s.fluid.mesh_u[0]), (2, s.fluid.mesh_u[1])):
        cap_k = compute_capacity_spacetime(body_st, mesh_k, 0.0, dt, p=4,
                                           s=1, params=(0.0,), device="cpu")
        ops_k, Va, Vb, *_ = slice_spacetime(cap_k)
        act = _col_G_nz(ops_k) | (Va != 0) | (Vb != 0)
        assert res[k].abs()[act].max() < 1e-10, (flux, k)
    assert res[4].abs().max() < 1e-10, flux


@pytest.mark.slow
def test_moving_stokes_static_body_matches_unsteady():
    """A static (full-domain) body on 12²: the slab solve of the lid cavity
    equals StokesMono's unsteady BE steps to 1e-6."""
    from penguin_tpu_torch.solvers.stokes import StokesMono
    n = 12
    fl = C.fluid(tpt, None, n)
    bc_ux, bc_uy = C.lid_bcs(tpt)
    dt, t_end = 0.02, 0.06
    ref = StokesMono(fl, (bc_ux, bc_uy), None, tpt.Dirichlet(0.0))
    ref.solve_unsteady(dt, t_end, scheme="BE", method="direct")
    full = tpt.geometry.full_domain(2)
    mov = TMoving(fl, (bc_ux, bc_uy), None, tpt.Dirichlet(0.0))
    mov.solve(lambda x, y, tau, params: full(x, y), dt, 0.0, t_end,
              scheme="BE", p=4, s=1)
    for d in range(2):
        a = mov.velocity(d)[:n, :n]
        b = ref.velocity(d)[:n, :n]
        assert (a - b).abs().max() < 1e-6, d


def _galilean(pkg, n, M, carry=None):
    """benchmarks/moving_couette_galilean.py's annulus translating at U0 =
    0.5 (moment cut flux): the solver, its slab body, the exact start and
    dt (0.1 cells of wall travel per slab)."""
    m = C.xp(pkg)
    ri, ro, om, u0 = C.RI, C.RO, C.OM, 0.5
    a = -om * ri ** 2 / (ro ** 2 - ri ** 2)
    b = om * ri ** 2 * ro ** 2 / (ro ** 2 - ri ** 2)

    def split(x, y, t):
        dx = x - C.CENTER[0] - u0 * t
        dy = y - C.CENTER[1]
        r2 = dx * dx + dy * dy
        return dx, dy, (torch.clamp_min(r2, 1e-12) if C.is_torch(pkg)
                        else m.maximum(r2, 1e-12))

    def u_exact(comp, x, y, t):
        dx, dy, r2 = split(x, y, t)
        w = a + b / r2
        return -w * dy + u0 if comp == 0 else w * dx

    def f_body(comp, x, y, t):
        dx, dy, r2 = split(x, y, t)
        ddx = (2.0 * b * dx * dy / (r2 * r2) if comp == 0
               else a + b / r2 - 2.0 * b * dx * dx / (r2 * r2))
        return -u0 * ddx

    def body_st(x, y, tau, params):
        t = params[0] + tau
        r = m.sqrt((x - C.CENTER[0] - u0 * t) ** 2 + (y - C.CENTER[1]) ** 2)
        return m.maximum(ri - r, r - ro)

    fl = C.fluid(pkg, C.annulus(pkg), n, L=4.0, cut_moments=False,
                 f_u=(lambda x, y, z, t=0.0: f_body(0, x, y, t),
                      lambda x, y, z, t=0.0: f_body(1, x, y, t)))
    if carry is not None:
        fl = C.carry_fluid(carry, fl)
    bc = tuple(pkg.BorderConditions({k: pkg.Dirichlet(
        lambda x, y, z, t=0.0, c=c: u_exact(c, x, y, t))
        for k in ("left", "right", "bottom", "top")}) for c in (0, 1))
    cut = tuple(pkg.Dirichlet(lambda x, y, z, t=0.0, c=c: u_exact(c, x, y, t))
                for c in (0, 1))
    s = M(fl, bc, None, cut, cut_flux="moment")
    x0 = list(s.zero_state())
    for k in (0, 1):
        Ck = fl.capacity_u[k].C_om
        x0[2 * k] = x0[2 * k + 1] = u_exact(k, Ck[..., 0], Ck[..., 1], 0.0)
    return s, body_st, tuple(x0), 0.1 * (4.0 / n) / u0


@pytest.mark.slow
def test_galilean_fgmres_stall_matches_jax():
    """The first Galilean slab at 32² in f64 by fgmres with the static
    block-Schur/DCT M (tol 1e-10, 2000 iterations): both packages stall at
    the cap, with relres within a factor of 2 of each other (a reference
    behaviour, not a port fault)."""
    from penguin_tpu.linsolve import fgmres as j_fgmres
    from penguin_tpu.solvers.stokes import StokesMono as JStokes
    n, tol, maxiter = 32, 1e-10, 2000
    sj, bj, x0j, dt = _galilean(jpt, n, JMoving)
    st, bt, _, _ = _galilean(tpt, n, TMoving, carry=sj.fluid)
    x0t = tuple(torch.as_tensor(np.array(a)) for a in x0j)
    ref = JStokes(sj.fluid, sj.bc_u, None, sj.bc_cut, cut_flux="centroid")
    M = ref.make_block_preconditioner(dt=dt, theta=1.0, schur="dct_cg",
                                      schur_cg_iters=8)
    apply_fn, rhs_fn = sj._slab_system(bj, 0.0, dt, 1.0, "BE", 4, 1, x0j, dt)
    _, its_j, rel_j = j_fgmres(apply_fn, rhs_fn(), x0j, Minv=M, tol=tol,
                               maxiter=maxiter, restart=60)
    st.solve(bt, dt, 0.0, dt, x0=x0t, method="fgmres", tol=tol,
             maxiter=maxiter)
    its_t, rel_t = int(st.krylov_iters[0]), float(st.krylov_relres[0])
    assert int(its_j) >= maxiter and its_t >= maxiter, (its_j, its_t)
    assert float(rel_j) > tol and rel_t > tol, (rel_j, rel_t)
    assert 0.5 <= rel_t / float(rel_j) <= 2.0, (rel_t, float(rel_j))

"""The port's Jacobian-free Newton-Krylov steady solver
(``solve_steady_newton_krylov``: ``torch.func.jvp`` of the residual under
block-Schur-preconditioned Krylov) against the JAX package on the CPU in
f64, then the JAX package's JFNK and block-preconditioner gates
(tests/test_ns_jfnk.py) on the port.

JFNK is held by its true (nonlinear) residual: on the 10² cut cavity each
inner solver drives |R| below 10x the tolerance in the port as in JAX,
the first Newton steps (before the inner Krylov's round-off spread
matters) give the same residuals to 1e-6, and the two solutions agree
to 1e-6 of scale."""

import numpy as np
import pytest
import torch

import penguin_tpu_torch as tpt
from penguin_tpu_torch.solvers.navierstokes import NavierStokesMono
from penguin_tpu_torch.solvers.stokes import PinPressureGauge, StokesMono

import torch_ns_cases as NS
import torch_stokes_cases as C
from torch_stefan_cases import one_thread  # noqa: F401  (autouse fixture)


@pytest.fixture(scope="module")
def cavity():
    return NS.pair(NS.cut_cavity)


@pytest.mark.parametrize("inner,warmup", [("fgmres", 0), ("pgmres", 0),
                                          ("pbicgstab", 1)])
def test_jfnk_matches_jax(cavity, inner, warmup):
    sj, st = cavity
    tol = 1e-9
    for s in (sj, st):
        s.solve_steady_newton_krylov(max_iter=10, tol=tol, inner=inner,
                                     picard_warmup=warmup)
    hj, ht = sj.residual_history, st.residual_history
    assert min(hj) < 10 * tol, hj
    assert min(ht) < 10 * tol, ht
    np.testing.assert_allclose(ht[:3], hj[:3], rtol=1e-6)
    assert st.newton_lin_iters[:2] == sj.newton_lin_iters[:2]
    C.close(st.x, sj.x, 1e-6)
    # the returned state is the best iterate: its residual is the least
    b = st.rhs_steady()
    r = st.nonlinear_residual(st.x, b)
    rn = float(torch.sqrt(sum(torch.sum(a * a) for a in r)))
    assert rn == pytest.approx(min(ht), rel=1e-9)


def _kovasznay(n, Re=40.0):
    lam = Re / 2 - np.sqrt(Re**2 / 4 + 4 * np.pi**2)
    Lx, Ly, x0, y0 = 1.0, 1.0, -0.5, 0.0
    mesh_p = tpt.Mesh((n, n), (Lx, Ly), (x0, y0))
    d = Lx / n
    mesh_ux = tpt.Mesh((n, n), (Lx, Ly), (x0 - 0.5 * d, y0))
    mesh_uy = tpt.Mesh((n, n), (Lx, Ly), (x0, y0 - 0.5 * d))
    body = tpt.geometry.full_domain(2)
    caps = [tpt.compute_capacity(body, m, p=4, s=1, device="cpu")
            for m in (mesh_ux, mesh_uy, mesh_p)]
    fluid = tpt.Fluid(
        mesh_u=(mesh_ux, mesh_uy), mesh_p=mesh_p,
        capacity_u=(caps[0], caps[1]),
        operator_u=(tpt.make_diffusion_ops(caps[0]),
                    tpt.make_diffusion_ops(caps[1])),
        capacity_p=caps[2], operator_p=tpt.make_diffusion_ops(caps[2]),
        mu=1.0 / Re, rho=1.0,
        f_u=lambda x, y, z: 0.0, f_p=lambda x, y, z: 0.0)

    def ue(x, y):
        return 1 - torch.exp(lam * x) * torch.cos(2 * np.pi * y)

    def ve(x, y):
        return lam / (2 * np.pi) * torch.exp(lam * x) * torch.sin(
            2 * np.pi * y)

    keys = ("left", "right", "bottom", "top")
    bc_ux = tpt.BorderConditions({k: tpt.Dirichlet(lambda x, y, z: ue(x, y))
                                  for k in keys})
    bc_uy = tpt.BorderConditions({k: tpt.Dirichlet(lambda x, y, z: ve(x, y))
                                  for k in keys})
    solver = NavierStokesMono(fluid, (bc_ux, bc_uy), PinPressureGauge(),
                              tpt.Dirichlet(0.0))
    return solver, caps, mesh_ux, ue


def test_jfnk_kovasznay_converges():
    n = 32
    solver, caps, mesh_ux, ue = _kovasznay(n)
    solver.solve_steady_newton_krylov(max_iter=12, tol=1e-8)
    hist = solver.residual_history
    assert hist[-1] < 1e-6 or min(hist) < 1e-6
    # superlinear: at least one contraction by 10x between consecutive iters
    ratios = [hist[k + 1] / hist[k] for k in range(min(4, len(hist) - 1))]
    assert min(ratios) < 0.15, hist
    hx, hy = mesh_ux.h
    X, Y = np.meshgrid(np.asarray(mesh_ux.nodes[0]) + 0.5 * hx,
                       np.asarray(mesh_ux.nodes[1]) + 0.5 * hy,
                       indexing="ij")
    uex = ue(torch.as_tensor(X), torch.as_tensor(Y)).numpy()
    err = solver.velocity(0).numpy()[1:n, 1:n] - uex[1:n, 1:n]
    V = caps[0].V.numpy()[1:n, 1:n]
    l2 = float(np.sqrt((err**2 * V).sum() / V.sum()))
    assert l2 < 2e-2


def test_mom_cg_solves_viscous_block():
    """The momentum inner-CG option of the block preconditioner reduces
    the masked viscous-block residual well below one Jacobi sweep."""
    solver, caps, mesh_ux, ue = _kovasznay(32)
    M = solver.make_block_preconditioner(dt=None, theta=1.0,
                                         schur="dct_cg", mom="cg",
                                         mom_cg_iters=8)
    d = 0
    idm = torch.where(solver.u_active[d], 1.0, 0.0).double()
    for item in solver.borders[d].items:
        idm = torch.where(item[5], 0.0, idm)
    act = idm > 0.5

    def Aop(um):
        um = torch.where(act, um, 0.0)
        y = solver._visc(d, um, torch.zeros_like(um))
        return torch.where(act, y, 0.0)

    rng = np.random.RandomState(0)
    bm = torch.where(act, torch.as_tensor(
        rng.randn(*solver.zero_state()[0].shape)), 0.0)
    x = M.mom_solve(d, bm)
    nb = float(torch.linalg.vector_norm(bm))
    res = float(torch.linalg.vector_norm(Aop(torch.where(act, x, 0.0)) - bm))
    assert np.isfinite(res)
    assert res < 0.3 * nb, (res, nb)


def test_block_preconditioned_unsteady_matches_direct():
    """Stokes unsteady: block-Schur BiCGStab equals the dense LU to the
    solver tolerance, with bounded iterations.  The JAX test's bounds (320
    on the cold step, 40 after) hold for the JAX package's exact bits only:
    its own counts move to 400 and 208 when μ moves by 1e-15.  The port's
    counts are held to that spread, measured here."""
    import penguin_tpu as jpt
    from penguin_tpu.solvers.stokes import StokesMono as JStokes
    n = 20

    def run(pkg, S, method, mu=1.0, tol=1e-11):
        fl = C.fluid(pkg, None, n, L=1.0, p=8, s=2, mu=mu,
                     f_u=lambda x, y, z: 1.0)
        bc = C.walls(pkg)
        s = S(fl, (bc, bc), PinPressureGauge() if pkg is tpt else None,
              pkg.Dirichlet(0.0))
        s.solve_unsteady(1e-2, 0.05, scheme="CN", method=method, tol=tol)
        return s

    s1 = run(tpt, StokesMono, "direct")
    s2 = run(tpt, StokesMono, "pbicgstab")
    for a, b in zip(s1.x, s2.x):
        assert (a - b).abs().max().item() < 1e-7
    assert s2.krylov_relres.max() < 1e-10
    spread = [run(jpt, JStokes, "pbicgstab", mu=mu).krylov_iters
              for mu in (1.0, 1.0 + 1e-15)]
    cold = max(k[0] for k in spread)
    warm = max(k[1:].max() for k in spread)
    assert s2.krylov_iters[0] <= max(cold, 320), (s2.krylov_iters, spread)
    assert s2.krylov_iters[1:].max() <= max(warm, 40), (s2.krylov_iters,
                                                        spread)

"""The port's scalar diffusion solvers: the reference CI gates of
docs/BENCHMARKS.md:10-12 run inside the port, each solver class against the
JAX package's on the same case (capacity carried across from JAX) with
direct, cg, bicgstab and pgmres, and FastHeatBE against the general solver
inside the port (f64, CPU)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.special import erfc

import penguin_tpu as jpt
from penguin_tpu.solvers import diffusion as jd
import penguin_tpu_torch as tpt
from penguin_tpu_torch.convert import CAPACITY_FIELDS, capacity_from_numpy
from penguin_tpu_torch.solvers import FastHeatBE, diffusion as td
from torch_stefan_cases import one_thread  # noqa: F401  (autouse fixture)

CPU = "cpu"
KEYS = ("left", "right", "top", "bottom")


# ---------------------------------------------------------------------------
# the reference CI gates, inside the port
# ---------------------------------------------------------------------------

def test_poisson_2d_gate():
    """Mirror of tests/test_diffusion_steady.py:39: 2D Poisson in a circle
    at n=40, weighted L2 error below 1e-2."""
    mesh = tpt.Mesh((40, 40), (4.0, 4.0), (0.0, 0.0))
    cap = tpt.compute_capacity(tpt.geometry.circle((2.0, 2.0), 1.0), mesh,
                               device=CPU)
    bc1 = tpt.Dirichlet(1.0)
    phase = tpt.Phase(cap, tpt.make_diffusion_ops(cap), lambda x, y, z: 4.0,
                      1.0)
    solver = td.DiffusionSteadyMono(
        phase, tpt.BorderConditions({k: bc1 for k in KEYS}),
        tpt.Dirichlet(0.0))
    solver.solve(method="direct")
    _, _, glob, *_ = tpt.check_convergence(
        lambda x, y: 1.0 - (x - 2.0) ** 2 - (y - 2.0) ** 2, solver, cap, 2,
        False, verbose=False)
    assert glob < 1e-2, glob


def _henry(nx, scheme, t_end=0.5, He=0.5, lx=8.0, xint=4.0):
    """The diphasic Henry-jump problem of tests/test_diffusion_unsteady.py:31
    built in the port."""
    mesh = tpt.Mesh((nx,), (lx,), (0.0,))
    cap1 = tpt.compute_capacity(tpt.geometry.halfspace(0, xint), mesh,
                                device=CPU)
    cap2 = tpt.compute_capacity(tpt.geometry.halfspace(0, xint, -1.0), mesh,
                                device=CPU)
    bc_b = tpt.BorderConditions({"top": tpt.Dirichlet(1.0),
                                 "bottom": tpt.Dirichlet(0.0)})
    ic = tpt.InterfaceConditions(tpt.ScalarJump(1.0, He, 0.0),
                                 tpt.FluxJump(1.0, 1.0, 0.0))
    ph1 = tpt.Phase(cap1, tpt.make_diffusion_ops(cap1),
                    lambda x, y, z, t: 0.0, 1.0)
    ph2 = tpt.Phase(cap2, tpt.make_diffusion_ops(cap2),
                    lambda x, y, z, t: 0.0, 1.0)
    z = torch.zeros(mesh.np_shape, dtype=torch.float64)
    o = torch.ones(mesh.np_shape, dtype=torch.float64)
    solver = td.DiffusionUnsteadyDiph(ph1, ph2, bc_b, ic, 0.5 * (lx / nx) ** 2,
                                      (z, z, o, o), scheme)
    solver.solve(t_end, method="direct")

    def T1(x):
        return -He / (1 + He) * (erfc((x - xint) / (2 * np.sqrt(t_end))) - 2)

    def T2(x):
        return -He / (1 + He) * erfc((x - xint) / (2 * np.sqrt(t_end))) + 1

    return tpt.check_convergence_diph(T1, T2, solver, cap1, cap2, 2, False,
                                      verbose=False)


def test_henry_erfc_1d_gate():
    """Mirror of tests/test_diffusion_unsteady.py:70: global L2 below 1e-2
    in each phase, cut cells below 5e-2."""
    _, _, glob, full, cut, _ = _henry(100, "BE")
    assert max(glob) < 1e-2, glob
    assert full[0] < 1e-2 and full[1] < 1e-2
    assert cut[0] < 5e-2 and cut[1] < 5e-2


def test_diph_cn_order_gate():
    """Mirror of tests/test_diffusion_unsteady.py:81: the CN mesh-refinement
    order over nx 40 -> 160 lies in (0.9, 2.2) for each phase and the max."""
    errs = [_henry(nx, "CN")[2] for nx in (40, 80, 160)]
    for i in range(3):
        order = np.log(errs[-1][i] / errs[0][i]) / np.log(40 / 160)
        assert 0.9 < order < 2.2, (i, order)


# ---------------------------------------------------------------------------
# each solver class against JAX on the same case
# ---------------------------------------------------------------------------

def _fields(jcap):
    out = {}
    for name in CAPACITY_FIELDS:
        v = getattr(jcap, name)
        out[name] = None if v is None else (
            tuple(np.asarray(a) for a in v) if isinstance(v, tuple)
            else np.asarray(v))
    return out


N, L = 20, 4.0


@pytest.fixture(scope="module")
def caps():
    """Inside and outside of a cut circle, JAX capacities and the port's
    copies of them."""
    body = jpt.geometry.circle((2.03, 1.96), 1.05)
    out = []
    for b in (body, lambda x, y: -body(x, y)):
        jcap = jpt.compute_capacity(b, jpt.Mesh((N, N), (L, L)))
        out.append((jcap, capacity_from_numpy(
            _fields(jcap), tpt.Mesh((N, N), (L, L)), device=CPU)))
    return out


def _zeros(pkg, k):
    z = (jnp.zeros if pkg is jpt else
         lambda s: torch.zeros(s, dtype=torch.float64))((N + 1, N + 1))
    return (z,) * k


def _mono(pkg, mod, cap, kind, method, tol):
    """Build and solve one mono case; returns (x, states)."""
    ops = pkg.make_diffusion_ops(cap)
    h = L / N
    if kind == "steady":
        bc_b = pkg.BorderConditions({k: pkg.Dirichlet(1.0) for k in KEYS})
        phase = pkg.Phase(cap, ops, lambda x, y, z: 4.0, 1.0)
        s = mod.DiffusionSteadyMono(phase, bc_b, pkg.Dirichlet(0.0))
        s.solve(method=method, tol=tol)
        return s.x, s.states
    if kind == "bench":
        # the FastHeatBE system: zero borders, interface Dirichlet 1
        bc_b = pkg.BorderConditions({k: pkg.Dirichlet(0.0) for k in KEYS})
        phase = pkg.Phase(cap, ops, lambda x, y, z, t: 0.0, 1.0)
        s = mod.DiffusionUnsteadyMono(phase, bc_b, pkg.Dirichlet(1.0),
                                      0.25 * h * h, _zeros(pkg, 2), "BE")
        s.solve(2.5 * 0.25 * h * h, method=method, tol=tol)
        return s.x, s.states
    # BE: time-dependent border and source from t=0; CN: a Neumann border
    # and a Robin interface, resumed at t_start without the initial solve
    borders = {k: pkg.Dirichlet(lambda x, y, z, t: 0.1 * x * t) for k in KEYS}
    if kind == "CN":
        borders["right"] = pkg.Neumann(0.2)
    phase = pkg.Phase(cap, ops, lambda x, y, z, t: 1.0 + x * t, 1.0)
    bc_i = pkg.Dirichlet(1.0) if kind == "BE" else pkg.Robin(1.0, 0.5, 0.3)
    s = mod.DiffusionUnsteadyMono(phase, pkg.BorderConditions(borders), bc_i,
                                  0.5 * h * h, _zeros(pkg, 2), kind)
    kw = dict(t_start=0.1, initial_solve=False) if kind == "CN" else {}
    s.solve(2.5 * 0.5 * h * h, method=method, tol=tol, **kw)
    return s.x, s.states


def _diph(pkg, mod, cap1, cap2, kind, method, tol):
    o1, o2 = pkg.make_diffusion_ops(cap1), pkg.make_diffusion_ops(cap2)
    bc_b = pkg.BorderConditions({k: pkg.Dirichlet(1.0) for k in KEYS})
    ic = pkg.InterfaceConditions(pkg.ScalarJump(1.0, 0.5, 0.0),
                                 pkg.FluxJump(1.0, 2.0, 0.0))
    if kind == "steady":
        ph1 = pkg.Phase(cap1, o1, lambda x, y, z: 1.0, 1.0)
        ph2 = pkg.Phase(cap2, o2, lambda x, y, z: 0.0, 2.0)
        s = mod.DiffusionSteadyDiph(ph1, ph2, bc_b, ic)
        s.solve(method=method, tol=tol)
        return s.x, s.states
    ph1 = pkg.Phase(cap1, o1, lambda x, y, z, t: 1.0, 1.0)
    ph2 = pkg.Phase(cap2, o2, lambda x, y, z, t: 0.0, 2.0)
    s = mod.DiffusionUnsteadyDiph(ph1, ph2, bc_b, ic, 0.01, _zeros(pkg, 4),
                                  "CN")
    s.solve(0.03, method=method, tol=tol, keep_states=True)
    return s.x, s.states


# (system, kind, method, tol).  Each Krylov case converges to the direct
# answer in both packages; the tolerance is set so that the two iterates,
# whose rounding differs, agree to 1e-9 (a solve to relres 1e-12 leaves
# cond·1e-12 of slack).  Left out on purpose: BiCGStab on the diph jump
# systems (it stalls there in both packages, see pgmres' docstring), and
# pgmres on the Neumann case: the row-norm estimate of a Neumann row
# (x_i - x_j)/h is 0 when all 8 probes agree on i and j, and the
# resulting 1e30 row weight ends the solve after one step in either
# package, with other probes giving another answer.
CASES = [("mono", "steady", m, 1e-12) for m in ("direct", "bicgstab",
                                                 "pgmres")] + \
    [("mono", "BE", m, 1e-12) for m in ("direct", "bicgstab", "pgmres")] + \
    [("mono", "bench", "cg", 1e-12)] + \
    [("mono", "CN", m, 1e-14) for m in ("direct", "bicgstab")] + \
    [("diph", "steady", m, 1e-14) for m in ("direct", "bicgstab")] + \
    [("diph", "CN", m, 1e-14) for m in ("direct", "pgmres")]


@pytest.mark.parametrize("system,kind,method,tol", CASES,
                         ids=["-".join(c[:3]) for c in CASES])
def test_solver_class_matches_jax(caps, system, kind, method, tol):
    """Every output field, and every kept state, to 1e-9 of its scale.
    The mono steady and BE cases run outside the circle, where the borders
    are fluid; the others inside it."""
    (jc1, tc1), (jc2, tc2) = caps
    if system == "mono":
        jc, tc = (jc2, tc2) if kind in ("steady", "BE") else (jc1, tc1)
        jx, jst = _mono(jpt, jd, jc, kind, method, tol)
        tx, tst = _mono(tpt, td, tc, kind, method, tol)
    else:
        jx, jst = _diph(jpt, jd, jc1, jc2, kind, method, tol)
        tx, tst = _diph(tpt, td, tc1, tc2, kind, method, tol)
    assert len(tst) == len(jst)
    for k, (jstate, tstate) in enumerate(zip(jst + [jx], tst + [tx])):
        for i, (a, b) in enumerate(zip(jstate, tstate)):
            a = np.asarray(a)
            err = np.abs(b.numpy() - a).max() / max(np.abs(a).max(), 1.0)
            assert err <= 1e-9, (k, i, err)


def test_inhomogeneous_border_krylov_matches_direct():
    """Mirror of tests/test_diffusion_unsteady.py:101: preconditioned
    bicgstab and cg on the unsteady mono system with a NON-zero border
    Dirichlet match the dense solve."""
    mesh = tpt.Mesh((16, 16), (1.0, 1.0), (0.0, 0.0))
    cap = tpt.compute_capacity(tpt.geometry.full_domain(2), mesh, device=CPU)
    phase = tpt.Phase(cap, tpt.make_diffusion_ops(cap),
                      lambda x, y, z, t: 0.0, 0.5)
    bc_b = tpt.BorderConditions({
        "left": tpt.Dirichlet(1.0), "right": tpt.Dirichlet(0.0),
        "bottom": tpt.Dirichlet(0.0), "top": tpt.Dirichlet(0.0)})

    def run(method):
        s = td.DiffusionUnsteadyMono(phase, bc_b, tpt.Dirichlet(0.0), 2e-3,
                                     td.zero_state_mono(mesh, device=CPU),
                                     "BE")
        s.solve(0.02, method=method, tol=1e-12)
        return s.x_omega

    p_direct = run("direct")
    p_bicg = run("bicgstab")
    assert bool(torch.isfinite(p_bicg).all())
    torch.testing.assert_close(p_bicg, p_direct, rtol=0, atol=1e-8)


@pytest.mark.parametrize("n", [32], ids=["32"])
def test_fast_heat_matches_general(n):
    """Gate 3, tests/test_heat_fast.py:13 inside the port: FastHeatBE (the
    eliminated, stencil-collapsed CG) reproduces the general masked block
    solver's direct solve to 1e-9 on active cells over 8 BE applications."""
    L = 4.0
    mesh = tpt.Mesh((n, n), (L, L), (0.0, 0.0))
    cap = tpt.compute_capacity(tpt.geometry.circle((2.01, 2.01), 1.0), mesh,
                               device=CPU)
    ops = tpt.make_diffusion_ops(cap)
    bc, f = tpt.Dirichlet(1.0), (lambda x, y, z, t: 0.0)
    bc_b = tpt.BorderConditions({k: tpt.Dirichlet(0.0) for k in KEYS})
    dt = 0.25 * (L / n) ** 2
    solver = td.DiffusionUnsteadyMono(tpt.Phase(cap, ops, f, 1.0), bc_b, bc,
                                      dt, td.zero_state_mono(mesh, device=CPU),
                                      "BE")
    solver.solve(6.5 * dt, method="direct")   # 1 + ceil(6.5) = 8 solves
    fast = FastHeatBE(cap, ops, 1.0, f, bc, bc_b, dt, cg_tol=1e-13,
                      cg_maxiter=500)
    Tf = fast.run(torch.zeros(mesh.np_shape, dtype=torch.float64), 8)
    err = (Tf - solver.x_omega)[fast.active].abs().max().item()
    assert err < 1e-9, err

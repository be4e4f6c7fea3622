"""The port's StokesMono solves and force diagnostics against the JAX
package on the CPU in f64, on the Taylor-Couette annulus of
benchmarks/couette_cylinder.py at 16² (the port on the JAX capacities):
direct, ``schur_gmres`` and the unsteady ``direct``/``pgmres`` solves to
1e-9 of scale with equal Krylov counts; forces to 1e-12.  BiCGStab spreads
round-off on this saddle point: the JAX package's own result moves by
~1e-7 when its input moves by 1e-15, so the BiCGStab paths are held to
that spread.  Then the Couette (``tests/test_cut_moments.py:138``) and
ghost-row (``tests/test_ghost_cut_rows.py``) gates on the port."""

import numpy as np
import pytest
import torch

import penguin_tpu as jpt
import penguin_tpu_torch as tpt
from penguin_tpu.solvers.stokes import StokesMono as JStokes
from penguin_tpu_torch.solvers.stokes import StokesMono as TStokes

import torch_stokes_cases as C
from torch_stefan_cases import one_thread  # noqa: F401  (autouse fixture)


@pytest.fixture(scope="module")
def pair():
    sj = C.couette_solver(jpt, JStokes, 16)
    st = C.couette_solver(tpt, TStokes, 16, carry=sj.fluid)
    return sj, st


def _carry(x):
    return tuple(torch.as_tensor(np.array(a)) for a in x)


@pytest.mark.parametrize("method", ["direct", "schur_gmres"])
def test_steady_solve_matches_jax(pair, method):
    sj, st = pair
    sj.solve(method=method, tol=1e-10)
    st.solve(method=method, tol=1e-10)
    C.close(st.x, sj.x, 1e-9)
    if method == "schur_gmres":
        assert st.krylov_iters == sj.krylov_iters
        assert st.krylov_relres <= 1e-10
        assert abs(st.krylov_relres - sj.krylov_relres) <= 1e-3 * 1e-10


def test_unsteady_direct_and_pgmres_match_jax(pair):
    """Three CN steps from half the steady solution, by one reused LU and
    by the preconditioned JAX-batched GMRES."""
    sj, st = pair
    sj.solve(method="direct")
    x0 = tuple(0.5 * a for a in sj.x)
    for method in ("direct", "pgmres"):
        xj = sj.solve_unsteady(0.05, 0.15, scheme="CN", method=method, x0=x0)
        xt = st.solve_unsteady(0.05, 0.15, scheme="CN", method=method,
                               x0=_carry(x0))
        C.close(xt, xj, 1e-9)


def test_bicgstab_paths_within_the_reference_spread(pair):
    """``schur_bicgstab`` and the unsteady ``pbicgstab``: every step's
    relres ≤ tol, and the port within 10× of how far JAX's own result moves
    when its start moves by a relative 1e-15."""
    sj, st = pair
    sj.solve(method="direct")
    x0 = tuple(0.5 * a for a in sj.x)
    x0p = tuple(a * (1 + 1e-15) for a in x0)
    runs = []
    for s, start in ((sj, x0), (sj, x0p), (st, _carry(x0))):
        s.solve(method="schur_bicgstab", tol=1e-10, x0=start)
        steady = s.x
        s.solve_unsteady(0.05, 0.15, scheme="CN", method="pbicgstab",
                         x0=start, tol=1e-10)
        runs.append((steady, s.x, s.krylov_relres))
    assert np.all(runs[2][2] <= 1e-10)
    for k in (0, 1):
        spread = C.close(runs[1][k], runs[0][k], 1.0)
        C.close(runs[2][k], runs[0][k], 10 * max(spread, 1e-12))


def test_forces_match_jax(pair):
    """The force diagnostics on one state (JAX's direct solution carried
    across): domain sum and interface traction with their parts, the
    traced form, and the drag/lift coefficients."""
    sj, st = pair
    sj.solve(method="direct")
    st.x = _carry(sj.x)
    for parts in (False, True):
        got = np.array(st.force_diagnostics(parts=parts)).ravel()
        want = np.array(sj.force_diagnostics(parts=parts)).ravel()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
        got = np.array(st.interface_force(parts=parts)).ravel()
        want = np.array(sj.interface_force(parts=parts)).ravel()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    traced = st.interface_force_traced(st.x)
    assert all(isinstance(v, torch.Tensor) and v.ndim == 0 for v in traced)
    for only in (False, True):
        np.testing.assert_allclose(
            st.drag_lift_coefficients(u_ref=2.0, l_ref=0.5,
                                      interface_only=only),
            sj.drag_lift_coefficients(u_ref=2.0, l_ref=0.5,
                                      interface_only=only),
            rtol=1e-12, atol=1e-14)


def test_couette_moment_beats_centroid():
    """n = 32 Taylor-Couette on the port: the moment cut flux's profile
    error is below 0.006 and below 1.05× the centroid scheme's."""
    errs = {}
    for mode in ("centroid", "moment"):
        s = C.couette_solver(tpt, TStokes, 32, cut_flux=mode,
                             cut_moments=True)
        s.solve(tol=1e-8)
        errs[mode] = C.couette_error(s, 32)
    assert errs["moment"] < 0.006, errs
    assert errs["moment"] < 1.05 * errs["centroid"], errs


def test_ghost_cut_rows_regular_and_bounded():
    """Ghost cut rows at 48²: a regular system (schur_gmres converges), an
    error within 3.5× the centre rows' (+1e-3), and the replaced rows hold
    at the solution."""
    s_c = C.couette_solver(tpt, TStokes, 48)
    s_c.solve(tol=1e-8)
    s_g = C.couette_solver(tpt, TStokes, 48, cut_row="ghost")
    s_g.solve(tol=1e-8)
    e_center, e_ghost = C.couette_error(s_c, 48), C.couette_error(s_g, 48)
    n_ghost = sum(0 if g is None else g["cwall"].numel() for g in s_g._ghost)
    assert n_ghost > 0
    assert s_g.krylov_relres <= 1e-8
    assert np.isfinite(e_ghost)
    assert e_ghost < 3.5 * e_center + 1e-3, (e_ghost, e_center)
    y = s_g.apply_steady(s_g.x)
    b = s_g.rhs_steady()
    for d in range(2):
        g = s_g._ghost[d]
        if g is None:
            continue
        r = (y[2 * d].reshape(-1)[g["gpos"]]
             - b[2 * d].reshape(-1)[g["gpos"]])
        assert r.abs().max() < 1e-6

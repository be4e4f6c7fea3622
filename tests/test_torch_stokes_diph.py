"""The port's StokesDiph against the JAX package on the CPU in f64: the
two-layer Couette of tests/test_stokes_diph.py (the port on the JAX
capacities) through apply and rhs to 1e-12 of scale and the lstsq solve
to 1e-9; the JAX file's gate (slow there, slow here) on the
port alone."""

import numpy as np
import pytest
import torch

import penguin_tpu as jpt
import penguin_tpu_torch as tpt
from penguin_tpu.solvers.stokes_diph import StokesDiph as JDiph
from penguin_tpu_torch.solvers.stokes_diph import StokesDiph as TDiph

import torch_stokes_cases as C
from torch_stefan_cases import one_thread  # noqa: F401  (autouse fixture)

YINT = 0.5 + 0.011          # the interface, off the grid lines
MU1, MU2 = 1.0, 0.25


def two_layer(pkg, S, n, carry=None, L=1.0):
    """Lower fluid y < YINT (μ1) under upper fluid (μ2), lid at 1; the
    borders carry the exact piecewise-linear profile."""
    bodies = (pkg.geometry.halfspace(1, YINT),
              pkg.geometry.halfspace(1, YINT, -1.0))
    fls = []
    for k, (body, mu) in enumerate(zip(bodies, (MU1, MU2))):
        fl = C.fluid(pkg, body, n, L, mu=mu, p=6, s=1)
        if carry is not None:
            fl = C.carry_fluid(carry[k], fl)
        fls.append(fl)
    noslip = pkg.Dirichlet(0.0)
    lid = pkg.Dirichlet(1.0)
    tau = 1.0 / (YINT / MU1 + (L - YINT) / MU2)
    prof1 = pkg.Dirichlet(lambda x, y, z: tau * y / MU1)
    prof2 = pkg.Dirichlet(lambda x, y, z: tau * YINT / MU1
                          + tau * (y - YINT) / MU2)
    bc_a = (pkg.BorderConditions({"left": prof1, "right": prof1,
                                  "bottom": noslip}),
            pkg.BorderConditions({"left": noslip, "right": noslip,
                                  "bottom": noslip}))
    bc_b = (pkg.BorderConditions({"left": prof2, "right": prof2,
                                  "top": lid}),
            pkg.BorderConditions({"left": noslip, "right": noslip,
                                  "top": noslip}))
    ic = pkg.InterfaceConditions(pkg.ScalarJump(1.0, 1.0, 0.0),
                                 pkg.FluxJump(1.0, 1.0, 0.0))
    return S(fls[0], fls[1], bc_a, bc_b, ic), tau


@pytest.fixture(scope="module")
def pair():
    sj, _ = two_layer(jpt, JDiph, 12)
    st, _ = two_layer(tpt, TDiph, 12, carry=(sj.a.fluid, sj.b_.fluid))
    return sj, st


def test_apply_and_rhs_match_jax(pair):
    sj, st = pair
    shapes = [tuple(a.shape) for a in sj.zero_state()]
    xj = C.random_state(jpt, shapes, 5)
    xt = C.random_state(tpt, shapes, 5)
    assert len(st.zero_state()) == 10
    C.close(st.apply(xt), sj.apply(xj), 1e-12)
    C.close(st.rhs(), sj.rhs(), 1e-12)


def test_lstsq_solve_matches_jax(pair):
    sj, st = pair
    sj.solve()
    st.solve()
    C.close(st.x, sj.x, 1e-9)
    for phase in (0, 1):
        assert st.velocity(phase, 0) is st.x[5 * phase]
        assert st.pressure(phase) is st.x[5 * phase + 4]


def test_direct_solve_raises_on_the_singular_system(pair):
    """The two-layer system is singular after the zero-row fix: JAX's
    ``method="direct"`` returns NaN in nine of its ten fields, the port's
    ``torch.linalg.solve`` says so (``lstsq`` is the class default)."""
    sj, st = pair
    xj = sj.solve(method="direct")
    assert not all(np.isfinite(np.asarray(a)).all() for a in xj)
    with pytest.raises(torch.linalg.LinAlgError, match="singular"):
        st.solve(method="direct")


@pytest.mark.slow
def test_two_layer_couette():
    """The JAX file's gate at its 16²: volume-weighted L2 of each phase's
    profile < 0.12 over interior full cells, interface velocity continuity
    to 1e-6."""
    n = 16
    solver, tau = two_layer(tpt, TDiph, n)
    solver.solve(method="lstsq")
    fa, fb = solver.a.fluid, solver.b_.fluid
    ys = np.asarray(fa.mesh_u[0].nodes[1])
    u_exact1 = tau * ys / MU1
    u_exact2 = tau * YINT / MU1 + tau * (ys - YINT) / MU2

    def l2(u, ue, fl):
        full = fl.capacity_u[0].cell_types.numpy() == 1
        full[0, :] = full[-1, :] = full[:, 0] = full[:, -1] = False
        V = fl.capacity_u[0].V.numpy()
        e = (u.numpy() - ue[None, :])[full]
        w = V[full]
        return np.sqrt((e**2 * w).sum() / w.sum())

    assert l2(solver.velocity(0, 0), u_exact1, fa) < 0.12
    assert l2(solver.velocity(1, 0), u_exact2, fb) < 0.12
    ug1 = solver.velocity(0, 0, gamma=True).numpy()
    ug2 = solver.velocity(1, 0, gamma=True).numpy()
    cut1 = fa.capacity_u[0].cell_types.numpy() == -1
    cut1[0, :] = cut1[n - 1, :] = cut1[-1, :] = False
    assert np.abs(ug1[cut1] - ug2[cut1]).max() < 1e-6
    assert torch.isfinite(solver.pressure(1)).all()

"""The port's 1D Stefan solvers against the JAX package on the CPU in f64,
and the gates of tests/test_stefan1d.py on the port alone.

Each package gets the same seeded or analytic inputs as numpy arrays.
Tolerances: 1e-14 of scale for the learning-rate steps, 1e-12 for one slab
residual, 1e-10 for the fronts of whole runs with equal Newton counts, and
1e-12 for the minimum-norm least-squares solve against numpy's."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.special import erf

import penguin_tpu as jpt
from penguin_tpu.capacity import compute_capacity_spacetime as j_slab
from penguin_tpu.solvers import moving_diffusion as jmd
from penguin_tpu.solvers import stefan1d as js
import penguin_tpu_torch as tpt
from penguin_tpu_torch.linsolve import _lstsq_min_norm
from penguin_tpu_torch.solvers import stefan1d as ts

from torch_stefan_cases import one_thread  # noqa: F401  (autouse fixture)

T0, K_DIFF, LX = 1.0, 1.0, 2.0
LAM = js.find_lambda_stefan(1.0)
STRATEGIES = ("fixed", "adagrad", "rmsprop", "nadam", "bb",
              "barzilai_borwein", "secant")


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _close(got, want, tol):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want, dtype=np.float64)
    assert g.shape == w.shape
    assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1.0), \
        np.abs(g - w).max()


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_lr_step_matches_jax(strategy):
    """Each learning-rate strategy over five iterations from seeded
    residuals, with its state carried, in f64 and in f32 (where the BB
    guard's 1e-300 rounds to 0 in both packages); the step after a repeated
    residual (dg = 0) takes the guarded branch."""
    rng = np.random.default_rng(5)
    res = rng.standard_normal(5) * 1e-2
    res[3] = res[2]
    for np_dt, t_dt, tol in ((np.float64, torch.float64, 1e-14),
                             (np.float32, torch.float32, 1e-6)):
        jst, tst = None, None
        jx, tx = jnp.asarray(0.3, np_dt), _t(0.3, t_dt)
        jpx, tpx = jx, tx
        jpg, tpg = jnp.asarray(0.0, np_dt), _t(0.0, t_dt)
        for it in range(5):
            r = res[it]
            jstep, jst = js._lr_step(strategy, 0.7, jnp.asarray(r, np_dt),
                                     jx, jpx, jpg, it, jst)
            tstep, tst = ts._lr_step(strategy, 0.7, _t(r, t_dt), tx, tpx, tpg,
                                     it, tst)
            assert tstep.dtype == t_dt
            _close(tstep, jstep, tol)
            for a, b in zip(tst, jst):
                _close(a, b, tol)
            jpx, jx, jpg = jx, jx + jstep, jnp.asarray(r, np_dt)
            tpx, tx, tpg = tx, tx + tstep, _t(r, t_dt)


def _analytic_state(pkg, nx, t_start, xf0, two_phase=False):
    """Mesh and the similarity solution's temperatures at the centroids of
    the JAX package's capacity, as numpy arrays shared by both packages."""
    jm = jpt.Mesh((nx,), (LX,), (0.0,))
    C = np.asarray(jpt.compute_capacity(jpt.geometry.halfspace(0, xf0),
                                        jm).C_om[..., 0])
    mesh = pkg.Mesh((nx,), (LX,), (0.0,))
    if not two_phase:
        Tw = np.maximum(T0 - T0 / erf(LAM) * erf(
            C / (2 * np.sqrt(K_DIFF * t_start))), 0.0)
        return mesh, (Tw, np.zeros_like(Tw))
    lam2 = js.find_lambda_stefan_two_phase(1.0, 0.2)
    T1 = np.where(C <= xf0, 1.0 * (1 - erf(C / (2 * np.sqrt(t_start)))
                                   / erf(lam2)), 0.0)
    from scipy.special import erfc
    T2 = np.where(C >= xf0, -0.2 * (1 - erfc(C / (2 * np.sqrt(t_start)))
                                    / erfc(lam2)), 0.0)
    z = np.zeros_like(T1)
    return mesh, (T1, z, T2, z)


def _mono_solver(pkg, mod, nx, dt, t_start,
                 cls="MovingLiquidDiffusionUnsteadyMono", bc_i=None):
    xf0 = js.stefan_interface_position(t_start, K_DIFF, LAM)
    mesh, state = _analytic_state(pkg, nx, t_start, xf0)
    arr = jnp.asarray if pkg is jpt else _t
    phase = pkg.Phase(None, None, lambda x, y, z, t: 0.0, K_DIFF)
    bc_b = pkg.BorderConditions({"bottom": pkg.Dirichlet(T0),
                                 "top": pkg.Dirichlet(0.0)})
    s = getattr(mod, cls)(phase, bc_b, bc_i or pkg.Dirichlet(0.0), dt,
                          tuple(arr(a) for a in state), mesh, "BE")
    ic = pkg.InterfaceConditions(pkg.ScalarJump(1.0, 1.0, 0.0),
                                 pkg.FluxJump(1.0, 1.0, 1.0))
    return s, xf0, ic


def test_slab_residual_matches_jax():
    """One slab of the one-phase solver (build, direct solve, interface
    flux, Stefan residual) at a front moved by half a cell, against the
    JAX package's functions composed as its solver composes them."""
    nx, dt, t = 24, 2e-3, 0.05
    js_, xf0, jic = _mono_solver(jpt, js, nx, dt, t)
    ts_, _, tic = _mono_solver(tpt, ts, nx, dt, t)
    xf_b = xf0 + 0.5 * LX / nx
    cap = j_slab(js._interp_body_1d, js_.mesh, 0.0, dt, p=6, s=1,
                 params=(jnp.asarray(xf0), jnp.asarray(xf_b), dt))
    apply_fn, rhs_fn = jmd.build_moving_mono_system(
        cap, 1.0, js_.phase.source, js_.bc_i, js_.border, t, dt, "BE")
    jT = jmd._direct_solve(apply_fn, rhs_fn(js_.u0))
    jflux, jVa, jVb = js.interface_flux_1d(cap, 1.0, jT[0], jT[1])
    jres = jnp.sum(jVa) - jnp.sum(jVb) - jflux / 1.0
    tT, tres = ts_._mono_slab_solve(t, dt, 1.0, 6, 1)(
        ts_.u0, _t(xf0), _t(xf_b))
    for a, b in zip(tT, jT):
        _close(a, b, 1e-12)
    _close(tres, jres, 1e-12)
    assert abs(float(jres)) > 1e-4      # a front off its balance


@pytest.mark.parametrize("cls,strategy", [
    ("MovingLiquidDiffusionUnsteadyMono", "fixed"),
    ("MovingLiquidDiffusionUnsteadyMono", "secant"),
    ("MovingLiquidDiffusionUnsteadyMonoCoupled", None),
])
def test_mono_classes_match_jax(cls, strategy):
    """3 steps at nx = 24: fronts to 1e-10, equal Newton counts, the
    Newton residuals and the final state."""
    out = []
    for pkg, mod in ((jpt, js), (tpt, ts)):
        s, xf0, ic = _mono_solver(pkg, mod, 24, 2e-3, 0.05, cls)
        kw = ({"newton_params": (30, 1e-9, 1e-9, 1.0)} if strategy is None
              else {"newton_params": (100, 1e-10, 1e-10, 1.0),
                    "lr_strategy": strategy})
        s.solve(xf0, 0.05, 0.05 + 1.5 * 2e-3, ic, **kw)
        out.append(s)
    j, t = out
    assert len(t.xf_log) == 3
    _close(t.xf_log, j.xf_log, 1e-10)
    np.testing.assert_array_equal(t.newton_iters, j.newton_iters)
    assert t.xf == pytest.approx(j.xf, abs=1e-10)
    assert t.newton_errs.max() < (1e-8 if strategy is None else 1e-9)
    for a, b in zip(t.x, j.x):
        _close(a, b, 1e-9)


def test_diph_class_matches_jax():
    """The two-phase solver over 3 steps at nx = 24 (the Neumann problem of
    tests/test_stefan1d_diph.py)."""
    lam2 = js.find_lambda_stefan_two_phase(1.0, 0.2)
    t_start, dt = 0.05, 1e-3
    xf0 = 2 * lam2 * np.sqrt(t_start)
    out = []
    for pkg, mod in ((jpt, js), (tpt, ts)):
        mesh, state = _analytic_state(pkg, 24, t_start, xf0, two_phase=True)
        arr = jnp.asarray if pkg is jpt else _t
        ph = pkg.Phase(None, None, lambda x, y, z, t: 0.0, 1.0)
        bc_b = pkg.BorderConditions({"bottom": pkg.Dirichlet(1.0),
                                     "top": pkg.Dirichlet(-0.2)})
        ic = pkg.InterfaceConditions(pkg.ScalarJump(1.0, 1.0, 0.0),
                                     pkg.FluxJump(1.0, 1.0, 1.0))
        s = mod.MovingLiquidDiffusionUnsteadyDiph(
            ph, ph, bc_b, ic, dt, tuple(arr(a) for a in state), mesh, "BE")
        s.solve(xf0, t_start, t_start + 1.5 * dt,
                newton_params=(200, 1e-10, 1e-10, 1.0))
        out.append(s)
    j, t = out
    _close(t.xf_log, j.xf_log, 1e-10)
    np.testing.assert_array_equal(t.newton_iters, j.newton_iters)
    for a, b in zip(t.x, j.x):
        _close(a, b, 1e-9)
    assert t.xf > xf0


def test_adaptive_driver_matches_jax():
    """``solve_stefan_1d_adaptive`` over a short span: the same number of
    adapted steps, the same front and end time, and ``t_final == t_end``."""
    out = []
    for pkg, mod in ((jpt, js), (tpt, ts)):
        s, xf0, ic = _mono_solver(pkg, mod, 24, 5e-4, 0.05)
        mod.solve_stefan_1d_adaptive(
            s, xf0, 0.05, 0.054, ic, newton_params=(100, 1e-10, 1e-10, 1.0),
            cfl_target=0.4, dt_min=1e-5, dt_max=5e-3, max_steps=300)
        out.append(s)
    j, t = out
    assert t.n_steps == j.n_steps
    assert t.t_final == pytest.approx(j.t_final, abs=1e-14)
    assert abs(t.t_final - 0.054) < 1e-9
    assert t.xf == pytest.approx(j.xf, abs=1e-10)
    for a, b in zip(t.x, j.x):
        _close(a, b, 1e-9)


@pytest.mark.parametrize("m", [8, 9])
def test_min_norm_lstsq_on_rank_deficient_jacobian(m):
    """The coupled Newton's solve on the singular structure it meets: the
    3-cell fusion block (tridiagonal [1 1 1], singular when 3 divides
    m + 1) beside identity rows of inactive cells and a random coupling.
    Equal to ``numpy.linalg.lstsq`` (and JAX's) with the default cut-off."""
    rng = np.random.default_rng(m)
    tri = np.eye(m) + np.eye(m, k=1) + np.eye(m, k=-1)
    J = np.zeros((2 * m, 2 * m))
    J[:m, :m] = tri
    J[:m, m:] = 0.3 * rng.standard_normal((m, m)) @ np.diag(
        rng.random(m) < 0.5)
    J[m:, m:] = np.eye(m)
    J[m + 2, :] = 0.0                      # a zero row as well
    b = rng.standard_normal(2 * m)
    rank = np.linalg.matrix_rank(J)
    assert rank < 2 * m
    rcond = np.finfo(np.float64).eps * max(J.shape)
    got = _lstsq_min_norm(_t(J), _t(b), rcond).numpy()
    want = np.linalg.lstsq(J, b, rcond=None)[0]
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    np.testing.assert_allclose(
        got, np.asarray(jnp.linalg.lstsq(jnp.asarray(J), jnp.asarray(b))[0]),
        atol=1e-12, rtol=0)


# ---------------------------------------------------------------------------
# the gates of tests/test_stefan1d.py on the port alone
# ---------------------------------------------------------------------------

def test_port_lr_strategies_agree():
    """Fixed and Barzilai-Borwein steps converge to the same front."""
    fronts = {}
    for strat in ("fixed", "bb"):
        s, xf0, ic = _mono_solver(tpt, ts, 48, 2e-3, 0.05)
        s.solve(xf0, 0.05, 0.05 + 3.5 * 2e-3, ic,
                newton_params=(100, 1e-10, 1e-10, 1.0), lr_strategy=strat)
        fronts[strat] = s.xf
    assert abs(fronts["fixed"] - fronts["bb"]) < 1e-6


def test_port_adaptive_dt_reaches_t_end():
    s, xf0, ic = _mono_solver(tpt, ts, 48, 5e-4, 0.05)
    ts.solve_stefan_1d_adaptive(s, xf0, 0.05, 0.08, ic,
                                newton_params=(100, 1e-10, 1e-10, 1.0),
                                cfl_target=0.4, dt_min=1e-5, dt_max=5e-3,
                                max_steps=300)
    assert abs(s.t_final - 0.08) < 1e-9
    xf_exact = js.stefan_interface_position(0.08, K_DIFF, LAM)
    assert abs(s.xf - xf_exact) < 0.03, (s.xf, xf_exact)


def test_port_coupled_newton_tracks_analytic():
    s, xf0, ic = _mono_solver(tpt, ts, 48, 2e-3, 0.05,
                              "MovingLiquidDiffusionUnsteadyMonoCoupled")
    s.solve(xf0, 0.05, 0.08, ic, newton_params=(30, 1e-9, 1e-9, 1.0))
    t_eff = 0.05 + len(s.xf_log) * 2e-3
    s_exact = js.stefan_interface_position(t_eff, K_DIFF, LAM)
    assert s.xf > xf0 + 0.005
    assert abs(s.xf - s_exact) < 0.03, (s.xf, s_exact)
    assert s.newton_errs.max() < 1e-6, s.newton_errs.max()


def test_port_front_tracks_analytic():
    """tests/test_stefan1d.py's gate at its size: 51 steps at nx = 64."""
    s, xf0, ic = _mono_solver(tpt, ts, 64, 1e-3, 0.05)
    s.solve(xf0, 0.05, 0.1, ic, newton_params=(200, 1e-10, 1e-10, 1.0))
    t_eff = 0.05 + len(s.xf_log) * 1e-3
    s_exact = js.stefan_interface_position(t_eff, K_DIFF, LAM)
    assert s.xf > xf0 + 0.01
    assert np.all(np.diff(s.xf_log) > -1e-10)
    assert abs(s.xf - s_exact) < 0.02, (s.xf, s_exact)
    assert s.newton_errs.max() < 1e-8


@pytest.mark.slow
def test_port_two_phase_neumann():
    """tests/test_stefan1d_diph.py's gate at its size."""
    lam2 = js.find_lambda_stefan_two_phase(1.0, 0.2)
    t_start, dt = 0.05, 1e-3
    xf0 = 2 * lam2 * np.sqrt(t_start)
    mesh, state = _analytic_state(tpt, 64, t_start, xf0, two_phase=True)
    ph = tpt.Phase(None, None, lambda x, y, z, t: 0.0, 1.0)
    s = ts.MovingLiquidDiffusionUnsteadyDiph(
        ph, ph, tpt.BorderConditions({"bottom": tpt.Dirichlet(1.0),
                                      "top": tpt.Dirichlet(-0.2)}),
        tpt.InterfaceConditions(tpt.ScalarJump(1.0, 1.0, 0.0),
                                tpt.FluxJump(1.0, 1.0, 1.0)),
        dt, tuple(_t(a) for a in state), mesh, "BE")
    s.solve(xf0, t_start, 0.09, newton_params=(200, 1e-10, 1e-10, 1.0))
    xf_exact = 2 * lam2 * np.sqrt(t_start + len(s.xf_log) * dt)
    assert s.xf > xf0 + 0.005
    assert abs(s.xf - xf_exact) < 0.02, (s.xf, xf_exact)
    assert s.newton_errs.max() < 1e-8

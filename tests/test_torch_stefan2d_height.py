"""The port's height-function Stefan solvers against the JAX package on the
CPU in f64, and the gates of tests/test_stefan2d_height.py on the port
alone.

A flat front driven from the hot wall at y = 0 (the 1D similarity solution
column by column) on a 6 × 24 mesh over 2 steps.  The port's classes are
compared with their fixed-point loop composed from the JAX package's
functions (its ``_height_body``, slab build, slab solve and flux), one
jitted iteration per call, rather than with the JAX classes, whose whole
scan takes a compile of its own.  Tolerances: 1e-13 for the body, 1e-10 of
scale for heights and fields, with equal iteration counts."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import erf

import penguin_tpu as jpt
from penguin_tpu.assembly import border_info as j_border_info
from penguin_tpu.capacity import compute_capacity_spacetime as j_slab
from penguin_tpu.solvers import moving_diffusion as jmd
from penguin_tpu.solvers import stefan2d_height as jh
from penguin_tpu.solvers.stefan1d import (find_lambda_stefan,
                                          stefan_interface_position)
import penguin_tpu_torch as tpt
from penguin_tpu_torch.solvers import stefan2d_height as th

from torch_stefan_cases import one_thread  # noqa: F401  (autouse fixture)

LAM = find_lambda_stefan(1.0)
T_START, DT = 0.05, 2e-3
LX, LY = 0.6, 2.0


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _close(got, want, tol):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want, dtype=np.float64)
    assert g.shape == w.shape
    assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1.0), \
        np.abs(g - w).max()


def flat_front(nx, ny):
    """(initial height, the similarity temperature on the centroids of the
    JAX capacity) as numpy arrays."""
    hf0 = stefan_interface_position(T_START, 1.0, LAM)
    mesh = jpt.Mesh((nx, ny), (LX, LY), (0.0, 0.0))
    C = np.asarray(jpt.compute_capacity(jpt.geometry.halfspace(1, hf0), mesh,
                                        p=4, s=1).C_om)
    Tw = np.maximum(1.0 - 1.0 / erf(LAM) * erf(
        C[..., 1] / (2 * np.sqrt(T_START))), 0.0)
    return hf0, Tw


def height_solver(pkg, mod, kind, nx, ny, arr):
    hf0, Tw = flat_front(nx, ny)
    z = np.zeros_like(Tw)
    mesh = pkg.Mesh((nx, ny), (LX, LY), (0.0, 0.0))
    bc_b = pkg.BorderConditions({"left": pkg.Dirichlet(1.0),
                                 "right": pkg.Dirichlet(0.0)})
    ph = pkg.Phase(None, None, lambda x, y, z, t: 0.0, 1.0)
    ic = pkg.InterfaceConditions(pkg.ScalarJump(1.0, 1.0, 0.0),
                                 pkg.FluxJump(1.0, 1.0, 1.0))
    if kind == "diph":
        s = mod.MovingLiquidDiffusionUnsteadyDiph2D(
            ph, ph, bc_b, ic, DT, tuple(arr(a) for a in (Tw, z, z, z)), mesh,
            "BE")
    else:
        bc_i = (pkg.GibbsThomson(0.0, 0.0, 0.1) if kind == "gibbs"
                else pkg.Dirichlet(0.0))
        s = mod.MovingLiquidDiffusionUnsteadyMono2D(
            ph, bc_b, bc_i, DT, (arr(Tw), arr(z)), mesh, "BE")
    return s, ic, arr(np.full(nx, hf0))


def test_height_body_matches_jax():
    rng = np.random.default_rng(7)
    xs_cols = np.linspace(0.05, 0.55, 6)
    ha, hb = 0.3 + 0.02 * rng.standard_normal((2, 6))
    x = rng.uniform(-0.1, 0.7, (5, 1, 3))        # clamped extrapolation too
    y = rng.uniform(0.0, 2.0, (1, 4, 3))
    tau = rng.uniform(0.0, DT, (5, 4, 1))
    for sign in (1.0, -1.0):
        got = th._height_body(_t(x), _t(y), _t(tau),
                              (_t(xs_cols), _t(ha), _t(hb), DT, sign))
        want = jh._height_body(jnp.asarray(x), jnp.asarray(y),
                               jnp.asarray(tau),
                               (jnp.asarray(xs_cols), jnp.asarray(ha),
                                jnp.asarray(hb), DT, sign))
        _close(got, want, 1e-13)


def _jax_height_run(s, kind, h0, ic, K, newton_params):
    """The JAX classes' fixed-point loop (stefan2d_height.py:82-139,
    193-240) composed from the JAX package's functions, one jitted
    iteration."""
    mesh, nx, dx = s.mesh, s.mesh.n[0], s.mesh.h[0]
    max_iter, tol, _, alpha = newton_params
    nodes = np.asarray(mesh.nodes[0])
    xs_cols = jnp.asarray(0.5 * (nodes[:-1] + nodes[1:]))
    col = lambda a: a[:nx, :].sum(axis=1)  # noqa: E731
    src = lambda x, y, z, t: 0.0  # noqa: E731

    def one(Xold, h_a, h_b, v_g, t):
        caps = [j_slab(jh._height_body, mesh, 0.0, DT, p=4, s=1,
                       params=(xs_cols, h_a, h_b, DT, sg))
                for sg in ((1.0, -1.0) if kind == "diph" else (1.0,))]
        if kind == "diph":
            b1, b2 = (j_border_info(mesh, s.bc_b,
                                    phase_mask=c.cell_types[..., 0] != 0)
                      for c in caps)
            X, _, _ = jmd.solve_moving_diph_stef_step(
                caps[0], caps[1], 1.0, 1.0, src, src, ic, b1, b2, Xold, t,
                DT, "BE", tol=1e-9, maxiter=800)
            s1, s2 = (jmd.slice_spacetime(c) for c in caps)
            flux = (s1[0].HT(s1[0].flux(X[0], X[1]))
                    + s2[0].HT(s2[0].flux(X[2], X[3])))
            Va, Vb = s1[1], s1[2]
        else:
            g = s.bc_i.Tm - s.bc_i.eps_v * v_g if kind == "gibbs" else None
            X, _, _ = jmd.solve_moving_mono_step(
                caps[0], 1.0, src, s.bc_i, s.border, Xold, t, DT, "BE",
                tol=1e-9, maxiter=800, g_override=g)
            ops, Va, Vb, _, _, _ = jmd.slice_spacetime(caps[0])
            flux = ops.HT(ops.flux(X[0], X[1]))
            if kind == "gibbs":
                v_g = jnp.abs(flux) / (1.0 * DT)
        res = col(Va) - col(Vb) - col(flux) / 1.0
        return X, h_b + alpha * res / dx, v_g, jnp.linalg.norm(res)

    one = jax.jit(one)
    X, h = s.u0, h0
    hs, errs, iters = [], [], []
    for k in range(K + 1):
        Xold, h_start = X, h
        v_g, err, it = jnp.zeros_like(Xold[0]), math.inf, 0
        while it < max_iter and err > tol:
            X, h, v_g, e = one(Xold, h_start, h, v_g, 0.0 + k * DT)
            err, it = float(e), it + 1
        hs.append(np.asarray(h))
        errs.append(err)
        iters.append(it)
    return X, np.stack(hs), np.asarray(errs), np.asarray(iters)


@pytest.mark.parametrize("kind", ["mono", "gibbs", "diph"])
def test_height_classes_match_jax(kind):
    """2 steps at 6 × 24: heights, iteration counts, fixed-point residuals
    and fields; ``gibbs`` feeds the kinetic interface value eps_v |v| with
    GibbsThomson(0, 0, 0.1)."""
    newton_params = (60, 1e-9, 1e-9, 1.0)
    js_, jic, jh0 = height_solver(jpt, jh, kind, 6, 24, jnp.asarray)
    jX, jlog, jerrs, jits = _jax_height_run(js_, kind, jh0, jic, 1,
                                            newton_params)
    s, ic, h0 = height_solver(tpt, th, kind, 6, 24, _t)
    args = (h0, 0.0, 0.5 * DT) + (() if kind == "diph" else (ic,))
    s.solve(*args, newton_params=newton_params)
    assert s.height_log.shape == (2, 6)
    np.testing.assert_array_equal(s.newton_iters, jits)
    _close(s.height_log, jlog, 1e-10)
    _close(s.heights, jlog[-1], 1e-10)
    _close(s.newton_errs, jerrs, 1e-10)
    assert s.newton_errs.max() < 1e-9
    for a, b in zip(s.x, jX):
        _close(a, b, 1e-10)
    assert s.heights.mean() > float(h0[0])


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["mono", "diph"])
def test_port_height_function_flat_front(kind):
    """tests/test_stefan2d_height.py's gates at its size (12 × 48, 15
    steps)."""
    s, ic, h0 = height_solver(tpt, th, kind, 12, 48, _t)
    t_end = 0.08 - T_START - DT / 2
    args = (h0, 0.0, t_end) + (() if kind == "diph" else (ic,))
    s.solve(*args, newton_params=(60, 1e-9, 1e-9, 1.0))
    h_exact = stefan_interface_position(
        T_START + s.height_log.shape[0] * DT, 1.0, LAM)
    assert np.all(np.diff(s.height_log.mean(axis=1)) > -1e-10)
    assert abs(s.heights.mean() - h_exact) < 0.03, (s.heights.mean(),
                                                    h_exact)
    assert s.heights.std() < 5e-3
    if kind == "diph":
        assert float(s.x[2].abs().max()) < 1e-6

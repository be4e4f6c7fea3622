"""Whole ``StefanMono2D.solve`` runs of the port against the JAX package on
the CPU in f64, and the kinetic Gibbs-Thomson gate of
tests/test_stefan2d.py on the port alone.

The Frank disk (``torch_stefan_cases``) at 16² with 16 markers over 2
steps, from the same numpy markers and temperatures in both packages.
Tolerance 1e-8 of scale for markers, logs and fields, with equal GN and
Krylov counts."""

import numpy as np
import pytest
import torch

import penguin_tpu as jpt
from penguin_tpu.solvers import stefan2d as js
import penguin_tpu_torch as tpt
from penguin_tpu_torch.solvers import stefan2d as ts

from torch_stefan_cases import DT, N, S, _close, _mean_radius, mono_solver
from torch_stefan_cases import one_thread  # noqa: F401  (autouse fixture)


@pytest.mark.parametrize("gibbs", [False, True])
def test_solve_intercept_matches_jax(gibbs):
    """``StefanMono2D.solve`` with the intercept Jacobian over 2 steps at
    16²: markers, marker log, residual logs and NaN-padded history, GN and
    Krylov counts, the final field; with Gibbs-Thomson (eps_k = 0.1,
    eps_v = 0.2) and the captured residual fields."""
    out = []
    for pkg, mod in ((jpt, js), (tpt, ts)):
        bc = pkg.GibbsThomson(0.0, 0.1, 0.2) if gibbs else pkg.Dirichlet(0.0)
        s, front, ic = mono_solver(pkg, mod, bc)
        s.solve(front, 0.0, 0.5 * DT, ic, newton_params=(4, 1e-4, 1e-6, 1.0),
                interior_fluid=False, method="auto", jac="intercept",
                capture_residual_field=gibbs)
        out.append((s, front))
    (j, jf), (t, tf) = out
    assert t.marker_log.shape == (2, N, 2)
    np.testing.assert_array_equal(t.iters_log, j.iters_log)
    np.testing.assert_array_equal(t.krylov_iters, j.krylov_iters)
    _close(t.markers, j.markers, 1e-8)
    _close(tf.markers, jf.markers, 1e-8)
    _close(t.marker_log, j.marker_log, 1e-8)
    _close(t.residual_log, j.residual_log, 1e-8)
    _close(t.residual_hist, j.residual_hist, 1e-8)
    for a, b in zip(t.x, j.x):
        _close(a, b, 1e-8)
    if gibbs:
        _close(t.residual_fields, j.residual_fields, 1e-8)
    else:
        assert t.residual_fields is None


def test_port_kinetic_undercooling_slows_growth():
    """tests/test_stefan2d.py's kinetic Gibbs-Thomson gate, at 16² over 2
    steps of at most 5 GN iterations: eps_v > 0 undercools the solidifying
    front, so the disk grows, and more slowly than with eps_v = 0."""
    radii = {}
    for eps_v in (0.0, 0.2):
        s, front, ic = mono_solver(tpt, ts, tpt.GibbsThomson(0.0, 0.0, eps_v))
        s.solve(front, 0.0, 0.5 * DT, ic, newton_params=(5, 1e-4, 1e-6, 1.0),
                interior_fluid=False, method="pbicgstab", jac="intercept")
        assert torch.isfinite(s.markers).all()
        radii[eps_v] = _mean_radius(s.markers)
    assert radii[0.2] < radii[0.0] - 1e-5, radii
    assert radii[0.2] > S

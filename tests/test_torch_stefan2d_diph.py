"""Whole ``StefanDiph2D.solve`` and ``StefanMono2D.solve_geom`` runs of the
port against the JAX package on the CPU in f64, and the gates of
tests/test_stefan2d_diph.py and of the geometric update in
tests/test_stefan2d.py on the port alone.

The Frank disk (``torch_stefan_cases``) at 16² with 16 markers over 2
steps, from the same numpy markers and temperatures in both packages.
Tolerance 1e-8 of scale for markers, logs and fields, with equal GN
counts."""

import numpy as np
import pytest

import penguin_tpu as jpt
from penguin_tpu.solvers import stefan2d as js
import penguin_tpu_torch as tpt
from penguin_tpu_torch.solvers import stefan2d as ts

from torch_stefan_cases import (CENTER, DT, N, S, _close, _mean_radius,
                                diph_solver, mono_solver)
from torch_stefan_cases import one_thread  # noqa: F401  (autouse fixture)


def _same_run(j, t, jf, tf):
    assert t.marker_log.shape == (2, N, 2)
    np.testing.assert_array_equal(t.iters_log, j.iters_log)
    _close(t.markers, j.markers, 1e-8)
    _close(tf.markers, jf.markers, 1e-8)
    _close(t.marker_log, j.marker_log, 1e-8)
    _close(t.residual_log, j.residual_log, 1e-8)
    for a, b in zip(t.x, j.x):
        _close(a, b, 1e-8)


def test_diph_matches_jax():
    """The solid disk (phase 1, releasing latent heat: ``latent_sign=-1``)
    against the liquid, intercept Jacobian, without stencil fusion as in
    tests/test_stefan2d_diph.py."""
    out = []
    for pkg, mod in ((jpt, js), (tpt, ts)):
        s, front = diph_solver(pkg, mod)
        s.solve(front, 0.0, 0.5 * DT, newton_params=(3, 1e-4, 1e-6, 1.0),
                interior_phase1=True, latent_sign=-1.0,
                enable_stencil_fusion=False, extrapolation_factor=0.5,
                jac="intercept")
        out.append((s, front))
    (j, jf), (t, tf) = out
    _same_run(j, t, jf, tf)
    assert _mean_radius(t.markers) > S


def test_solve_geom_matches_jax():
    """The geometric front update (no Jacobian) at 6 iterations a step."""
    out = []
    for pkg, mod in ((jpt, js), (tpt, ts)):
        s, front, ic = mono_solver(pkg, mod, pkg.Dirichlet(0.0))
        s.solve_geom(front, 0.0, 0.5 * DT, ic,
                     newton_params=(6, 1e-6, 1e-6, 0.8),
                     interior_fluid=False, method="bicgstab")
        out.append((s, front))
    (j, jf), (t, tf) = out
    _same_run(j, t, jf, tf)
    assert _mean_radius(t.markers) > S


# ---------------------------------------------------------------------------
# the JAX suite's slow gates, at their sizes, on the port alone
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_port_frank_disk_diphasic():
    """tests/test_stefan2d_diph.py's gates with the intercept Jacobian at
    32².  Its autodiff case (48², 48 markers) is not mirrored: there the LM
    system is near-singular, so the markers' sawtooth content lies in its
    null space and is set by rounding.  The port follows JAX to 1e-11 for a
    step, then drifts along that mode (6e-5 after two steps, 9e-3 after
    three) at equal GN residuals (1e-8) and mean radius (1e-9), and ends
    with std/mean 0.034 against the gate's 0.02, which JAX's run meets
    (ROADMAP Queue 3)."""
    s, front = diph_solver(tpt, ts, n=32)
    s.solve(front, 0.0, 0.1 - DT / 2, newton_params=(12, 1e-4, 1e-6, 1.0),
            interior_phase1=True, latent_sign=-1.0,
            enable_stencil_fusion=False, smooth_window=5, smooth_passes=1,
            extrapolation_factor=0.5, jac="intercept")
    mk = s.markers.numpy()
    radii = np.sqrt(((mk - np.asarray(CENTER)) ** 2).sum(1))
    R_exact = S * np.sqrt(1.0 + len(s.residual_log) * DT)
    assert radii.mean() > S + 0.02
    assert radii.std() / radii.mean() < 0.02
    assert abs(radii.mean() - R_exact) / R_exact < 0.03, (radii.mean(),
                                                          R_exact)
    assert s.residual_log[-1] < 0.05


@pytest.mark.slow
def test_port_frank_disk_geometric_update():
    s, front, ic = mono_solver(tpt, ts, tpt.Dirichlet(0.0), n=32)
    s.solve_geom(front, 0.0, 0.1 - DT / 2, ic, interior_fluid=False,
                 method="bicgstab")
    mk = s.markers.numpy()
    radii = np.sqrt(((mk - np.asarray(CENTER)) ** 2).sum(1))
    R_exact = S * np.sqrt(1.0 + len(s.residual_log) * DT)
    assert radii.mean() > S + 0.01
    assert radii.std() / radii.mean() < 0.01
    assert abs(radii.mean() - R_exact) / R_exact < 0.02, (radii.mean(),
                                                          R_exact)

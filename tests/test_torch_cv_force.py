"""The port's control-volume force (host, scipy ``map_coordinates``), its
on-device recorder and the least-squares pressure probe against the JAX
package on the CPU in f64, then the JAX package's gates
(tests/test_cv_force.py) on the port.

The diagnostics are functions of a state: they are compared on a seeded
smooth state of the 24² cylinder (the port on the JAX capacities), to
1e-12 of scale, with no solve.  Only the box-insensitivity gate needs a
steady state, which the port's own JFNK provides.  A callable μ raises in
the port where the JAX package silently uses 1 (a known deviation)."""

import dataclasses

import numpy as np
import pytest
import torch

import penguin_tpu as jpt
import penguin_tpu_torch as tpt

import torch_ns_cases as NS
from torch_stefan_cases import one_thread  # noqa: F401  (autouse fixture)

BOX = (1.2, 2.8, 1.2, 2.8)
BOX2 = (1.0, 3.0, 1.0, 3.0)
POINTS = [(1.73, 2.41), (2.52, 2.01), (0.5, 0.5), (1.49, 2.0)]


@pytest.fixture(scope="module")
def pair():
    sj, st = NS.pair(NS.cylinder)
    return sj, st, NS.smooth_state(sj, 11), NS.smooth_state(st, 11)


def _close(got, want, tol):
    got, want = np.asarray(got, float), np.asarray(want, float)
    scale = max(float(np.abs(want).max()), 1.0)
    assert np.abs(got - want).max() <= tol * scale, (got, want)


def test_cv_force_and_probe_match_jax(pair):
    """Host force on two boxes, the recorder's (Fs, M), the host and
    on-device probes and the probe weights: 1e-12 of scale."""
    sj, st, xj, xt = pair
    for box in (BOX, BOX2):
        _close(st.control_volume_force(box, x=xt),
               sj.control_volume_force(box, x=xj), 1e-12)
        _close([float(v) for v in st.make_control_volume_recorder(box)(xt)],
               [float(v) for v in sj.make_control_volume_recorder(box)(xj)],
               1e-12)
    _close(st.pressure_probe(POINTS, x=xt), sj.pressure_probe(POINTS, x=xj),
           1e-12)
    _close(st.make_pressure_probe(POINTS)(xt).numpy(),
           np.asarray(sj.make_pressure_probe(POINTS)(xj)), 1e-12)
    (ij, wj), (it, wt) = sj._probe_weights(POINTS), st._probe_weights(POINTS)
    for a, b, c, d in zip(it, ij, wt, wj):
        np.testing.assert_array_equal(a, b)
        _close(c, d, 1e-12)


def test_cv_recorder_matches_host_steady(pair):
    """The recorder's surface integral agrees with the host
    control_volume_force on the same box (the same bilinear sampling,
    gradient stencil and trapezoid rule); the box momentum is finite and
    of the expected magnitude."""
    _, s, _, x = pair
    Fx_h, Fy_h = s.control_volume_force(BOX, x=x)
    cvf = s.make_control_volume_recorder(BOX)
    Fsx, Fsy, Mx, My = (float(v) for v in cvf(x))
    assert abs(Fsx - Fx_h) < 1e-8 * max(1.0, abs(Fx_h)), (Fsx, Fx_h)
    assert abs(Fsy - Fy_h) < 1e-8 * max(1.0, abs(Fy_h)), (Fsy, Fy_h)
    assert np.isfinite([Mx, My]).all()
    assert abs(Mx) < 1.6 * 1.6 * 1.5


def test_cv_recorder_box_insensitive():
    """Steady state (the port's JFNK, to |R| < 1e-4: the two boxes then
    agree to 0.7%): the surface integral is box-independent to
    discretisation error."""
    s = NS.cylinder(tpt)
    s.solve_steady_newton_krylov(max_iter=12, tol=1e-4)
    f1 = s.control_volume_force(BOX)
    f2 = s.control_volume_force(BOX2)
    assert abs(f1[0] - f2[0]) < 0.08 * abs(f1[0]), (f1, f2)


def test_pressure_probe_linear_field_exact(pair):
    """A linear pressure field is reproduced exactly (to lstsq round-off)
    at arbitrary probe points; the on-device probe agrees with the host
    one."""
    _, s, _, _ = pair
    pc = s.fluid.capacity_p.C_om.numpy()
    p_lin = 2.0 + 3.0 * pc[..., 0] + 4.0 * pc[..., 1]
    x = list(s.zero_state())
    x[2 * s.N] = torch.as_tensor(-p_lin)  # state stores -p_phys
    pts = [(1.73, 2.41), (2.52, 2.01), (0.5, 0.5)]
    got = s.pressure_probe(pts, x=tuple(x))
    for (px, py), v in zip(pts, got):
        assert abs(v - (2.0 + 3.0 * px + 4.0 * py)) < 1e-9, (px, py, v)
    traced = s.make_pressure_probe(pts)(tuple(x))
    np.testing.assert_allclose(traced.numpy(), got, rtol=1e-12)


def test_callable_viscosity_raises(pair):
    """Known deviation: the JAX package's control-volume force silently
    takes a callable μ as 1; the port raises instead."""
    sj, st, xj, xt = pair
    fl_j = dataclasses.replace(sj.fluid, mu=lambda x, y, z: 0.7)
    s_one = NS.ns_class(jpt)(dataclasses.replace(sj.fluid, mu=1.0),
                             sj.bc_u, None, jpt.Dirichlet(0.0))
    s_call = NS.ns_class(jpt)(fl_j, sj.bc_u, None, jpt.Dirichlet(0.0))
    assert s_call.control_volume_force(BOX, x=xj) == \
        s_one.control_volume_force(BOX, x=xj)
    fl_t = dataclasses.replace(st.fluid, mu=lambda x, y, z: 0.7)
    s_t = NS.ns_class(tpt)(fl_t, st.bc_u, None, tpt.Dirichlet(0.0))
    with pytest.raises(ValueError, match="callable mu"):
        s_t.control_volume_force(BOX, x=xt)
    with pytest.raises(ValueError, match="callable mu"):
        s_t.make_control_volume_recorder(BOX)

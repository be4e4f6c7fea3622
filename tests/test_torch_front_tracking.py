"""The port's front tracking (2D markers and 1D) against the JAX package
on the CPU in f64, and the geometric gates of tests/test_front_tracking.py
on the port alone.  Marker arrays come from the generators (numpy under
both packages) or from a numpy seed."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import penguin_tpu as jpt
from penguin_tpu import front_tracking as jft
from penguin_tpu import front_tracking1d as jft1
import penguin_tpu_torch as tpt
from penguin_tpu_torch import front_tracking as tft
from penguin_tpu_torch import front_tracking1d as tft1
from penguin_tpu_torch.capacity import compute_capacity_spacetime
from torch_stefan_cases import one_thread  # noqa: F401  (autouse fixture)

CPU = dict(device="cpu")


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _close(got, want, tol=1e-12):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1.0)


def _wobbly(n=40, seed=5):
    """A star-shaped closed polyline with seeded radial noise (CCW)."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    r = 1.0 + 0.15 * rng.standard_normal(n).cumsum() / np.sqrt(n)
    r = np.clip(r, 0.6, 1.4)
    return np.stack([2.0 + r * np.cos(th), 2.1 + r * np.sin(th)], -1)


# ---------------------------------------------------------------------------
# parity with JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("markers_circle", ((1.0, 2.0), 0.5, 48)),
    ("markers_ellipse", ((1.0, 2.0), 0.5, 0.3, 48)),
    ("markers_rectangle", ((0.5, 0.25), (1.5, 2.0), 9)),
    ("markers_ngon", ((1.0, -0.5), 2.0, 10, 60, 0.2)),
    ("markers_crystal", ((0.0, 0.0), 1.0, 96, 6, 0.2)),
])
def test_marker_generators_match_jax(name, args):
    got = getattr(tft, name)(*args, **CPU)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(getattr(jft, name)(*args)))


@pytest.mark.parametrize("n,chunk", [(40, 32), (40, None), (64, 7), (33, 64)])
def test_polyline_sdf_matches_jax(n, chunk):
    """Signed distance on a seeded cloud of points inside, outside and on
    the markers; 1e-12.  The chunk changes nothing: 40 markers against
    JAX's padded blocks of 32, one block, ragged blocks of 7."""
    mk = _wobbly(n)
    rng = np.random.default_rng(n)
    x = rng.uniform(0.0, 4.0, (50, 7))
    y = rng.uniform(0.0, 4.0, (50, 7))
    x[0, :5], y[0, :5] = mk[:5, 0], mk[:5, 1]       # exactly on markers
    want = np.asarray(jft.polyline_sdf(jnp.asarray(mk), x, y))
    got = tft.polyline_sdf(_t(mk), _t(x), _t(y), chunk=chunk)
    _close(got, want)
    assert (np.sign(got.numpy()) == np.sign(want)).all()
    # broadcasting queries and f32 queries against f64 markers
    gb = tft.polyline_sdf(_t(mk), _t(x[:, :1]), _t(y[:1, :]))
    assert gb.shape == (50, 7)
    g32 = tft.polyline_sdf(_t(mk), _t(x).float(), _t(y).float())
    assert g32.dtype == torch.float64


def test_polyline_sdf_f32_guards():
    """f32 markers: finite values and finite forward-mode tangents (the
    guards sqrt(tiny) and 1e-30 keep 0/0 out), also with a duplicated
    marker (a zero-length segment)."""
    mk = _wobbly(24).astype(np.float32)
    mk[3] = mk[2]
    x = torch.linspace(0.5, 3.5, 9, dtype=torch.float32)[:, None]
    y = torch.linspace(0.5, 3.5, 9, dtype=torch.float32)[None, :]
    m = torch.as_tensor(mk)
    out, tang = torch.func.jvp(lambda q: tft.polyline_sdf(q, x, y), (m,),
                               (torch.ones_like(m),))
    assert out.dtype == torch.float32
    assert torch.isfinite(out).all() and torch.isfinite(tang).all()
    want = np.asarray(jft.polyline_sdf(jnp.asarray(mk), x.numpy(), y.numpy()))
    # f32 formulas in both: round-off of a distance of O(1)
    np.testing.assert_allclose(out.numpy(), want, atol=2e-6)


def test_polyline_api_matches_jax():
    """normals, curvature, area, centroid, length, resampling, smoothing,
    segment parameters and the intercept update; 1e-12 each."""
    mk = _wobbly(40)
    jm, tm = jnp.asarray(mk), _t(mk)
    _close(tft.polyline_normals(tm), jft.polyline_normals(jm))
    _close(tft.polyline_curvature(tm), jft.polyline_curvature(jm))
    _close(tft.polygon_area(tm), jft.polygon_area(jm))
    _close(tft.polygon_centroid(tm), jft.polygon_centroid(jm))
    _close(tft.interface_length(tm), jft.interface_length(jm))
    _close(tft.resample_markers(tm), jft.resample_markers(jm))
    _close(tft.resample_markers(tm, 25), jft.resample_markers(jm, 25))
    rng = np.random.default_rng(9)
    disp = rng.standard_normal(40)
    for window, passes in ((3, 1), (5, 2)):
        _close(tft.smooth_displacements(_t(disp), window, passes),
               jft.smooth_displacements(jnp.asarray(disp), window, passes))
    with pytest.raises(ValueError, match="odd"):
        tft.smooth_displacements(_t(disp), 4)
    jp, tp = jft.segment_parameters(jm), tft.segment_parameters(tm)
    for a, b in zip(tp, jp):
        _close(a, b)
    # clockwise markers flip the orientation in both
    for a, b in zip(tft.segment_parameters(_t(mk[::-1].copy())),
                    jft.segment_parameters(jnp.asarray(mk[::-1].copy()))):
        _close(a, b)
    d = rng.standard_normal(40) * 0.01
    _close(tft.update_front_with_intercept_displacements(
        tm, _t(d), tp[0], tp[2]),
        jft.update_front_with_intercept_displacements(
            jm, jnp.asarray(d), jp[0], jp[2]))


def test_segment_cell_intersections_match_jax():
    """Clipped lengths, their first moments and the intercept Jacobian on a
    16² mesh; 1e-12.  One marker sits exactly on a grid node and one
    segment runs along a grid line."""
    mk = _wobbly(30)
    mk[4] = (2.5, 3.0)
    mk[10], mk[11] = (1.3, 2.75), (1.1, 2.75)
    jmesh = jpt.Mesh((16, 16), (4.0, 4.0))
    tmesh = tpt.Mesh((16, 16), (4.0, 4.0))
    jm, tm = jnp.asarray(mk), _t(mk)
    _close(tft.segment_cell_intersections(tmesh, tm),
           jft.segment_cell_intersections(jmesh, jm))
    for a, b in zip(tft.segment_cell_intersection_moments(tmesh, tm),
                    jft.segment_cell_intersection_moments(jmesh, jm)):
        _close(a, b)
    for a, b in zip(tft.intercept_jacobian(tmesh, tm, 2.0),
                    jft.intercept_jacobian(jmesh, jm, 2.0)):
        _close(a, b)


@pytest.mark.parametrize("chunk_size", [None, 8])
def test_volume_jacobian_matches_jax(chunk_size):
    """``compute_volume_jacobian`` (``torch.func.jacfwd``) against JAX's
    ``jacfwd`` at 12² with 24 markers: 1e-9 of the largest entry, finite
    everywhere.  A query nearest to a shared vertex ties two segments:
    ``amin`` and ``minimum`` split the tangent as JAX's reductions do.
    ``chunk_size`` bounds the tangents carried at once and changes
    nothing."""
    jmesh = jpt.Mesh((12, 12), (4.0, 4.0))
    tmesh = tpt.Mesh((12, 12), (4.0, 4.0))
    mk = np.asarray(jft.markers_circle((2.0, 2.0), 1.0, 24))
    J = np.asarray(jft.compute_volume_jacobian(jmesh, jnp.asarray(mk)))
    T = tft.compute_volume_jacobian(tmesh, _t(mk), chunk_size=chunk_size)
    assert T.shape == (13, 13, 24) == J.shape
    assert torch.isfinite(T).all()
    assert np.abs(T.numpy() - J).max() <= 1e-9 * np.abs(J).max()
    assert np.abs(J).max() > 0.05


def test_front_tracker_1d_matches_jax():
    mk = np.array([2.3, 0.7, 3.1])
    x = np.linspace(0.0, 4.0, 33)
    for first_inside in (True, False):
        _close(tft1.sdf_1d(_t(mk), _t(x), first_inside),
               jft1.sdf_1d(jnp.asarray(mk), jnp.asarray(x), first_inside))
        np.testing.assert_array_equal(
            tft1.inside_1d(_t(mk), _t(x), first_inside).numpy(),
            np.asarray(jft1.inside_1d(jnp.asarray(mk), jnp.asarray(x),
                                      first_inside)))
        jt = jft1.FrontTracker1D(mk, first_inside)
        tt = tft1.FrontTracker1D(mk, first_inside, **CPU)
        np.testing.assert_array_equal(tt.markers.numpy(),
                                      np.asarray(jt.markers))
        _close(tt.sdf(x), jt.sdf(x))
        _close(tt.body()(_t(x)), jt.body()(jnp.asarray(x)))
        np.testing.assert_array_equal(tt.inside(x).numpy(),
                                      np.asarray(jt.inside(x)))
        assert tt.fluid_length((0.0, 4.0)) == jt.fluid_length((0.0, 4.0))
    assert tft1.FrontTracker1D(**CPU).set_markers([3.0, 1.0]).markers[0] == 1.0


# ---------------------------------------------------------------------------
# the gates of tests/test_front_tracking.py, on the port
# ---------------------------------------------------------------------------

def test_circle_markers_geometry():
    m = tft.markers_circle((1.0, 2.0), 0.5, n=256, **CPU)
    assert abs(float(tft.polygon_area(m)) - np.pi * 0.25) < 1e-3
    np.testing.assert_allclose(tft.polygon_centroid(m).numpy(), [1.0, 2.0],
                               atol=1e-12)
    assert abs(float(tft.interface_length(m)) - np.pi) < 1e-3
    ft = tft.FrontTracker(**CPU).create_circle((1.0, 2.0), 0.5, n=256)
    assert abs(ft.area() - np.pi * 0.25) < 1e-3
    assert abs(ft.length() - np.pi) < 1e-3
    np.testing.assert_allclose(ft.centroid(), [1.0, 2.0], atol=1e-12)


def test_sdf_circle():
    m = tft.markers_circle((0.0, 0.0), 1.0, n=512, **CPU)
    xs = np.array([0.0, 0.5, 0.99, 1.01, 2.0, -1.5])
    d = tft.polyline_sdf(m, xs, np.zeros_like(xs)).numpy()
    np.testing.assert_allclose(d, np.abs(xs) - 1.0, atol=2e-4)


def test_normals_outward():
    m = tft.markers_circle((0.0, 0.0), 1.0, n=128, **CPU)
    n = tft.polyline_normals(m).numpy()
    radial = m.numpy() / np.linalg.norm(m.numpy(), axis=-1, keepdims=True)
    assert np.abs(n - radial).max() < 1e-3
    k = tft.polyline_curvature(m).numpy()
    np.testing.assert_allclose(k, 1.0, rtol=1e-3)


def test_capacity_from_front_matches_levelset():
    """Capacities from the marker SDF vs the analytic circle SDF."""
    mesh = tpt.Mesh((24, 24), (4.0, 4.0))
    ft = tft.FrontTracker(**CPU).create_circle((2.0, 2.0), 1.0, n=256)
    cap_ft = tpt.compute_capacity(ft.body(), mesh, **CPU)
    cap_ls = tpt.compute_capacity(tpt.geometry.circle((2.0, 2.0), 1.0), mesh,
                                  **CPU)
    V1, V2 = cap_ft.V.numpy(), cap_ls.V.numpy()
    assert abs(V1.sum() - V2.sum()) / V2.sum() < 5e-3
    assert np.abs(V1 - V2).max() < 0.05 * V2.max()
    G1, G2 = cap_ft.Gamma.numpy(), cap_ls.Gamma.numpy()
    assert abs(G1.sum() - G2.sum()) / G2.sum() < 2e-2


def test_sdf_differentiated_markers():
    """Markers as differentiated params through the slab quadrature (the
    basis of a front moving under Newton): the area and its gradient with
    respect to the marker positions, against JAX's (1e-9)."""
    mesh = tpt.Mesh((16, 16), (4.0, 4.0))
    jmesh = jpt.Mesh((16, 16), (4.0, 4.0))

    def area_of(markers):
        body = lambda x, y, t, mk: tft.polyline_sdf(mk, x, y, chunk=32)
        cap = compute_capacity_spacetime(body, mesh, 0.0, 1.0, p=4, s=1,
                                         params=markers, **CPU)
        return torch.sum(cap.V)

    def jarea_of(markers):
        from penguin_tpu.capacity import compute_capacity_spacetime as jst
        body = lambda x, y, t, mk: jft.polyline_sdf(mk, x, y)
        return jnp.sum(jst(body, jmesh, 0.0, 1.0, p=4, s=1,
                           params=markers).V)

    m = tft.markers_circle((2.0, 2.0), 1.0, n=64, **CPU)
    assert abs(float(area_of(m)) - np.pi) < 2e-2
    g = torch.func.grad(area_of)(m).numpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    jg = np.asarray(jax.jit(jax.grad(jarea_of))(jnp.asarray(m.numpy())))
    assert np.abs(g - jg).max() <= 1e-9 * np.abs(jg).max()


def test_segment_parameters_circle():
    c = (2.0, 3.0)
    mk = tft.markers_circle(c, 1.0, n=64, **CPU)
    normals, intercepts, lengths, mids = (
        a.numpy() for a in tft.segment_parameters(mk))
    out = mids - np.asarray(c)
    dots = (normals * out / np.linalg.norm(out, axis=1, keepdims=True)).sum(1)
    assert dots.min() > 0.99
    assert abs(lengths.sum() - 2 * np.pi) < 0.02
    assert np.allclose(intercepts, (normals * mk.numpy()).sum(1))


def test_segment_cell_intersections_cover_segments():
    mesh = tpt.Mesh((16, 16), (4.0, 4.0))
    mk = tft.markers_circle((2.0, 2.0), 1.2, n=48, **CPU)
    L = tft.segment_cell_intersections(mesh, mk)
    seg_len = np.linalg.norm((torch.roll(mk, -1, 0) - mk).numpy(), axis=1)
    assert np.allclose(L.sum((0, 1)).numpy(), seg_len, atol=1e-12)
    L0, L1 = tft.segment_cell_intersection_moments(mesh, mk)
    assert np.allclose(L0.numpy(), L.numpy(), atol=1e-12)
    assert np.allclose(L1.sum((0, 1)).numpy(), 0.5 * seg_len, atol=1e-12)


def test_intercept_jacobian_predicts_volume_change():
    mesh = tpt.Mesh((24, 24), (4.0, 4.0))
    mk = tft.markers_circle((2.0, 2.0), 1.0, n=96, **CPU)
    J, normals, intercepts, lengths = tft.intercept_jacobian(mesh, mk)
    delta = 1e-4
    dA_pred = float(J.sum()) * delta
    mk2 = tft.update_front_with_intercept_displacements(
        mk, torch.full_like(lengths, delta), normals, lengths)
    dA = float(tft.polygon_area(mk2) - tft.polygon_area(mk))
    assert abs(dA - dA_pred) / abs(dA) < 5e-3, (dA, dA_pred)


def test_apply_intercept_displacements_grows_circle():
    ft = tft.FrontTracker(**CPU).create_circle((0.0, 0.0), 1.0, n=64)
    ft.apply_intercept_displacements(torch.full((64,), 0.05,
                                                dtype=torch.float64))
    r = np.linalg.norm(ft.markers.numpy(), axis=1)
    assert abs(r.mean() - 1.05) < 2e-3
    assert r.std() < 1e-3


def test_markers_ngon_geometry():
    mk = tft.markers_ngon((1.0, -0.5), 2.0, n_sides=10, n=60, **CPU)
    assert mk.shape == (60, 2)
    r = torch.sqrt((mk[:, 0] - 1.0) ** 2 + (mk[:, 1] + 0.5) ** 2).numpy()
    assert np.allclose(r[::6], 2.0, atol=1e-12)
    assert (r <= 2.0 + 1e-12).all()
    assert (r >= 2.0 * np.cos(np.pi / 10) - 1e-12).all()
    exact = 0.5 * 10 * 2.0 ** 2 * np.sin(2 * np.pi / 10)
    assert abs(float(tft.polygon_area(mk)) - exact) < 1e-10 * exact


def test_front_tracker_follows_its_markers():
    """Every ``create_*`` keeps the tracker's dtype and device; a tracker
    given a tensor follows it."""
    ft = tft.FrontTracker(dtype=torch.float32, **CPU)
    for make in (lambda: ft.create_circle((0., 0.), 1.0, 8),
                 lambda: ft.create_rectangle((0., 0.), (1., 1.), 3),
                 lambda: ft.create_ellipse((0., 0.), 1.0, 0.5, 8),
                 lambda: ft.create_crystal((0., 0.), 1.0, 12),
                 lambda: ft.create_ngon((0., 0.), 1.0, 4, 8)):
        assert make().markers.dtype == torch.float32
    assert ft.sdf(0.0, 0.0).item() < 0 < ft.sdf(3.0, 0.0).item()
    assert ft.normals().shape == ft.markers.shape
    assert len(ft.segment_parameters()) == 4
    J = ft.intercept_jacobian(tpt.Mesh((4, 4), (4.0, 4.0), (-2.0, -2.0)))[0]
    assert J.shape == (4, 4, 8)
    given = tft.FrontTracker(torch.zeros(5, 2, dtype=torch.float32))
    assert given.dtype == torch.float32 and given.device.type == "cpu"

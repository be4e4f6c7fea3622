"""Parity of the port's space-time and narrow-band capacity builds, its cut
moments and its volume Jacobians with the JAX package, on the CPU in f64.

Bodies are analytic, written once per package; marker fronts come from the
packages' own generators (numpy under both).  The band engine is also held
against the port's own dense build, as tests/test_capacity_band.py holds
the JAX one."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import penguin_tpu as jpt
from penguin_tpu import capacity as jcapmod
from penguin_tpu import front_tracking as jft
from penguin_tpu import utils as ju
from penguin_tpu.solvers.moving_diffusion import \
    spatial_capacity_from_slab as j_slab_view
import penguin_tpu_torch as tpt
from penguin_tpu_torch import capacity as tcapmod
from penguin_tpu_torch import front_tracking as tft
from penguin_tpu_torch import utils as tu
from penguin_tpu_torch.convert import (capacity_from_numpy,
                                       capacity_to_numpy, markers_from_numpy,
                                       markers_to_numpy)
from penguin_tpu_torch.solvers.moving_diffusion import \
    spatial_capacity_from_slab as t_slab_view

from test_torch_quadrature_capacity import (F64_TOL, _jax_fields,
                                            compare_capacity)
from torch_stefan_cases import one_thread  # noqa: F401  (autouse fixture)

CPU = dict(device="cpu")
N = 24


def _meshes(n=N, L=4.0):
    return jpt.Mesh((n, n), (L, L)), tpt.Mesh((n, n), (L, L))


def _moving_disk():
    """A unit disk translating along x at speed 0.8, (x, y, t)."""
    return (lambda x, y, t: jnp.sqrt((x - 1.9 - 0.8 * t) ** 2
                                     + (y - 2.05) ** 2) - 1.0,
            lambda x, y, t: torch.sqrt((x - 1.9 - 0.8 * t) ** 2
                                       + (y - 2.05) ** 2) - 1.0)


def _marker_slab_bodies():
    """Linear-in-time interpolation of two marker SDFs over the slab
    [0, dt]: the body the front-tracking solvers feed the slab build."""
    def jbody(x, y, t, params):
        mk_a, mk_b, dt = params
        return ((dt - t) * jft.polyline_sdf(mk_a, x, y)
                + t * jft.polyline_sdf(mk_b, x, y)) / dt

    def tbody(x, y, t, params):
        mk_a, mk_b, dt = params
        return ((dt - t) * tft.polyline_sdf(mk_a, x, y, chunk=32)
                + t * tft.polyline_sdf(mk_b, x, y, chunk=32)) / dt

    return jbody, tbody


# ---------------------------------------------------------------------------
# space-time slabs against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"cut_moments": True}, {"band_budget": 1024},
    {"band_budget": 1024, "cut_moments": True}, {"band_budget": 64},
    {"compute_centroids": False},
], ids=["dense", "dense_moments", "band", "band_moments", "band_overflow",
        "no_centroids"])
def test_spacetime_slab_matches_jax(kw):
    """Every field of a slab capacity of the translating disk, dense and
    band, with and without cut moments, and with a budget far too small
    (64 < the ~200 band cells, so the overflow falls back to corner signs
    in both packages alike).  1e-11 of each field's scale, cell types
    exactly: same formulas, same order, f64."""
    jm, tm = _meshes()
    jb, tb = _moving_disk()
    jc = jcapmod.compute_capacity_spacetime(jb, jm, 0.1, 0.15, p=4, s=1, **kw)
    tc = tcapmod.compute_capacity_spacetime(tb, tm, 0.1, 0.15, p=4, s=1,
                                            **kw, **CPU)
    assert tc.V.shape == (N + 1, N + 1, 2) and tc.mesh is None
    compare_capacity(jc, tc, F64_TOL)


def test_spacetime_times_float_or_tensor():
    """``t0``/``t1`` as Python floats or as 0-d tensors: the same slab, bit
    for bit."""
    _, tm = _meshes()
    _, tb = _moving_disk()
    a = tcapmod.compute_capacity_spacetime(tb, tm, 0.1, 0.15, p=4, s=1, **CPU)
    b = tcapmod.compute_capacity_spacetime(
        tb, tm, torch.tensor(0.1, dtype=torch.float64),
        torch.tensor(0.15, dtype=torch.float64), p=4, s=1, **CPU)
    fa, fb = capacity_to_numpy(a), capacity_to_numpy(b)
    for name in ("V", "Gamma", "C_om", "C_ga", "cell_types"):
        np.testing.assert_array_equal(fa[name], fb[name])
    for name in ("A", "B", "W"):
        for x, y in zip(fa[name], fb[name]):
            np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def marker_slabs():
    """The slab of a 32-marker circle growing by 2% over dt, dense and
    band, in both packages."""
    jm, tm = _meshes()
    jbody, tbody = _marker_slab_bodies()
    mk = np.asarray(jft.markers_circle((2.0, 2.0), 1.0, 32))
    dt = 0.01
    jp = (jnp.asarray(mk), jnp.asarray(2.0 + (mk - 2.0) * 1.02), dt)
    tp = (markers_from_numpy(mk, **CPU),
          markers_from_numpy(2.0 + (mk - 2.0) * 1.02, **CPU), dt)
    out = {}
    for name, bb in (("dense", None), ("band", 1024)):
        out[name] = (
            jcapmod.compute_capacity_spacetime(jbody, jm, 0.0, dt, p=4, s=1,
                                               params=jp, band_budget=bb),
            tcapmod.compute_capacity_spacetime(tbody, tm, 0.0, dt, p=4, s=1,
                                               params=tp, band_budget=bb,
                                               **CPU))
    return out


@pytest.mark.parametrize("which", ["dense", "band"])
def test_marker_slab_matches_jax(marker_slabs, which):
    """A slab whose body is a marker front (``params`` a tuple of two
    marker tensors and a float), field by field, 1e-11 of scale."""
    jc, tc = marker_slabs[which]
    compare_capacity(jc, tc, F64_TOL)


def _assert_caps_equal(cd, cb, tol=1e-10):
    """tests/test_capacity_band.py's comparison, on port capacities."""
    fd, fb = capacity_to_numpy(cd), capacity_to_numpy(cb)
    for name in ("V", "Gamma", "C_om", "C_ga"):
        np.testing.assert_allclose(fd[name], fb[name], atol=tol, err_msg=name)
    np.testing.assert_array_equal(fd["cell_types"], fb["cell_types"])
    for fam in ("A", "B", "W"):
        for d, (x, y) in enumerate(zip(fd[fam], fb[fam])):
            np.testing.assert_allclose(x, y, atol=tol, err_msg=f"{fam}[{d}]")


def test_band_matches_dense_spacetime_markers(marker_slabs):
    _assert_caps_equal(marker_slabs["dense"][1], marker_slabs["band"][1])


# ---------------------------------------------------------------------------
# the band engine against the port's own dense build
# ---------------------------------------------------------------------------

def _tcircle(c, r):
    return lambda x, y: torch.sqrt((x - c[0]) ** 2 + (y - c[1]) ** 2) - r


def test_band_matches_dense_2d_circle():
    mesh = tpt.Mesh((64, 64), (1.0, 1.0))
    body = _tcircle((0.5, 0.53), 0.27)
    cd = tpt.compute_capacity(body, mesh, band_budget=None, **CPU)
    cb = tpt.compute_capacity(body, mesh, band_budget=1024, **CPU)
    _assert_caps_equal(cd, cb)
    # cut moments too (tests/test_cut_moments.py, band against dense)
    cut = (cd.cell_types == -1).numpy()
    for d in range(2):
        np.testing.assert_allclose(cd.Vh[d].numpy()[cut],
                                   cb.Vh[d].numpy()[cut], atol=1e-10)
        np.testing.assert_allclose(cd.Bm[d].numpy()[cut],
                                   cb.Bm[d].numpy()[cut], atol=1e-8)


def test_band_matches_dense_3d_sphere():
    mesh = tpt.Mesh((16, 16, 16), (1.0, 1.0, 1.0))
    body = lambda x, y, z: torch.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2
                                      + (z - 0.5) ** 2) - 0.3
    cd = tpt.compute_capacity(body, mesh, p=4, s=1, band_budget=None, **CPU)
    cb = tpt.compute_capacity(body, mesh, p=4, s=1, band_budget=4096, **CPU)
    _assert_caps_equal(cd, cb)


def test_band_budget_overflow_degrades_gracefully():
    """With a budget far too small, far-field cells are still exact and
    the result stays finite: overflowed band cells fall back to their
    corner-sign classification.  The same build in JAX gives the same
    fields, so the truncation keeps the first cells in order."""
    mesh = tpt.Mesh((64, 64), (1.0, 1.0))
    cb = tpt.compute_capacity(_tcircle((0.5, 0.5), 0.3), mesh, band_budget=32,
                              **CPU)
    V = cb.V.numpy()
    assert np.isfinite(V).all()
    assert abs(V.sum() - np.pi * 0.09) < 0.15
    assert V.sum() > 0.1
    jc = jpt.compute_capacity(
        lambda x, y: jnp.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2) - 0.3,
        jpt.Mesh((64, 64), (1.0, 1.0)), band_budget=32)
    compare_capacity(jc, cb, F64_TOL)


def test_estimate_band_budget_counts():
    mesh = tpt.Mesh((64, 64), (1.0, 1.0))
    nodes = [np.asarray(v) for v in mesh.nodes]
    n = tcapmod.estimate_band_budget(_tcircle((0.5, 0.5), 0.3), nodes, mesh.n,
                                     torch.float64, 2.0, **CPU)
    assert 200 < n < 2000
    jn = jcapmod.estimate_band_budget(
        lambda x, y: jnp.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2) - 0.3,
        nodes, mesh.n, jnp.dtype("float64"), 2.0)
    assert n == jn
    assert tcapmod._round_budget(n, mesh.ncells()) == \
        jcapmod._round_budget(jn, mesh.ncells())


def test_band_auto_budget():
    """``band_budget="auto"``: dense below 16384 cells, a band above, and
    the band build equals the dense one."""
    body = _tcircle((0.5, 0.52), 0.3)
    small = tpt.Mesh((24, 24), (1.0, 1.0))
    a = tpt.compute_capacity(body, small, p=4, s=1, band_budget="auto", **CPU)
    b = tpt.compute_capacity(body, small, p=4, s=1, **CPU)
    assert torch.equal(a.V, b.V)
    big = tpt.Mesh((128, 128), (1.0, 1.0))
    _assert_caps_equal(
        tpt.compute_capacity(body, big, p=4, s=1, **CPU),
        tpt.compute_capacity(body, big, p=4, s=1, band_budget="auto", **CPU))
    st = lambda x, y, t: body(x - 0.1 * t, y)
    _assert_caps_equal(
        tcapmod.compute_capacity_spacetime(st, big, 0.0, 0.01, p=4, s=1,
                                           **CPU),
        tcapmod.compute_capacity_spacetime(st, big, 0.0, 0.01, p=4, s=1,
                                           band_budget="auto", **CPU))


def test_band_volume_gradient_matches_dense():
    """Autodiff through the compacted quadrature: d(total volume)/d(radius)
    agrees with the dense path (rtol 1e-10), with JAX's (1e-10) and is near
    the circumference."""
    mesh = tpt.Mesh((64, 64), (1.0, 1.0))

    def vol(c, bb):
        return torch.sum(tcapmod.compute_cell_volumes(
            lambda x, y, cc: torch.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2) - cc,
            mesh, params=c, band_budget=bb, **CPU))

    r = torch.tensor(0.3, dtype=torch.float64)
    gd = float(torch.func.grad(lambda c: vol(c, None))(r))
    gb = float(torch.func.grad(lambda c: vol(c, 1024))(r))
    assert np.isclose(gd, gb, rtol=1e-10)
    assert np.isclose(gb, 2 * np.pi * 0.3, rtol=0.15)
    jmesh = jpt.Mesh((64, 64), (1.0, 1.0))
    jg = jax.grad(lambda c: jnp.sum(jcapmod.compute_cell_volumes(
        lambda x, y, cc: jnp.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2) - cc,
        jmesh, params=c, band_budget=1024)))(0.3)
    assert np.isclose(gb, float(jg), rtol=1e-10)


@pytest.mark.parametrize("bb", [None, 1024], ids=["dense", "band"])
def test_cell_volume_jacobian_matches_jax(bb):
    """``torch.func.jacfwd`` of ``compute_cell_volumes`` with respect to
    ``params`` = (centre x, centre y, radius) against ``jax.jacfwd``:
    1e-9 of the largest entry.  In the band build the mask comes from the
    detached nodal pass, so it is no batched tensor under the transform."""
    jm, tm = _meshes()

    def jv(c):
        return jcapmod.compute_cell_volumes(
            lambda x, y, cc: jnp.sqrt((x - cc[0]) ** 2 + (y - cc[1]) ** 2)
            - cc[2], jm, params=c, band_budget=bb)

    def tv(c):
        return tcapmod.compute_cell_volumes(
            lambda x, y, cc: torch.sqrt((x - cc[0]) ** 2 + (y - cc[1]) ** 2)
            - cc[2], tm, params=c, band_budget=bb, **CPU)

    c0 = [2.03, 1.98, 1.0]
    J = np.asarray(jax.jacfwd(jv)(jnp.asarray(c0)))
    T = torch.func.jacfwd(tv)(torch.tensor(c0, dtype=torch.float64)).numpy()
    assert T.shape == J.shape == (N + 1, N + 1, 3)
    assert np.abs(T - J).max() <= 1e-9 * np.abs(J).max()
    assert np.abs(J).max() > 0.1


def test_compute_capacity_params_tree_matches_jax():
    """``compute_capacity(params=...)`` with a dict of tensors, dense and
    band, against JAX with the same dict."""
    jm, tm = _meshes()
    jb = lambda x, y, q: jnp.sqrt((x - q["c"][0]) ** 2
                                  + (y - q["c"][1]) ** 2) - q["r"]
    tb = lambda x, y, q: torch.sqrt((x - q["c"][0]) ** 2
                                    + (y - q["c"][1]) ** 2) - q["r"]
    jq = {"c": jnp.asarray([2.0, 2.1]), "r": jnp.asarray(1.1)}
    tq = {"c": torch.tensor([2.0, 2.1], dtype=torch.float64),
          "r": torch.tensor(1.1, dtype=torch.float64)}
    for bb in (None, 1024):
        compare_capacity(
            jpt.compute_capacity(jb, jm, p=4, s=1, params=jq, band_budget=bb),
            tpt.compute_capacity(tb, tm, p=4, s=1, params=tq, band_budget=bb,
                                 **CPU), F64_TOL)


# ---------------------------------------------------------------------------
# cut moments: gamma_half_moments, the slab view, moment_consistent_W
# ---------------------------------------------------------------------------

def _compare_ghm(jg, tg, tol=1e-11):
    assert len(jg) == len(tg)
    for ja, ta in zip(jg, tg):
        for a, b in zip(ja, ta):
            a = np.asarray(a)
            assert np.abs(a - b.numpy()).max() <= tol * max(np.abs(a).max(),
                                                           1.0)


@pytest.fixture(scope="module")
def moment_slabs():
    """A static capacity with cut moments and the spatial view of a
    ``cut_moments=True`` slab of the translating disk, both packages."""
    jm, tm = _meshes(16, 2.0)
    jb = jpt.geometry.circle((1.0, 1.0), 0.62)
    tb = tpt.geometry.circle((1.0, 1.0), 0.62)
    jst = lambda x, y, t: jb(x - 0.3 * t, y)
    tst = lambda x, y, t: tb(x - 0.3 * t, y)
    jc = jpt.compute_capacity(jb, jm, p=4, s=2, cut_moments=True)
    tc = tpt.compute_capacity(tb, tm, p=4, s=2, cut_moments=True, **CPU)
    jslab = jcapmod.compute_capacity_spacetime(jst, jm, 0.0, 0.37, p=4, s=2,
                                               cut_moments=True)
    tslab = tcapmod.compute_capacity_spacetime(tst, tm, 0.0, 0.37, p=4, s=2,
                                               cut_moments=True, **CPU)
    return jc, tc, j_slab_view(jslab, jm), t_slab_view(tslab, tm), jm, tm


def test_gamma_half_moments_match_jax(moment_slabs):
    """Static build and slab view: S and X of every axis and half, 1e-11."""
    jc, tc, jv, tv, _, _ = moment_slabs
    _compare_ghm(jcapmod.gamma_half_moments(jc),
                 tcapmod.gamma_half_moments(tc))
    _compare_ghm(jcapmod.gamma_half_moments(jv),
                 tcapmod.gamma_half_moments(tv))
    with pytest.raises(ValueError, match="cut_moments"):
        tcapmod.gamma_half_moments(tpt.compute_capacity(
            tpt.geometry.circle((1.0, 1.0), 0.62), tpt.Mesh((8, 8), (2., 2.)),
            cut_moments=False, **CPU))


def test_slab_view_matches_jax_and_static(moment_slabs):
    """``spatial_capacity_from_slab`` field by field against JAX, and for a
    STATIC body the slab's volumes are dt x the static ones (the gate of
    tests/test_cut_moments.py's slab test, volumes and half volumes)."""
    jc, tc, jv, tv, jm, tm = moment_slabs
    compare_capacity(jv, tv, F64_TOL)
    assert tv.mesh is tm and tv.Am[0].shape == tc.Am[0].shape
    body = tpt.geometry.circle((1.0, 1.0), 0.62)
    dt = 0.37
    slab = tcapmod.compute_capacity_spacetime(
        lambda x, y, t: body(x, y), tm, 0.0, dt, p=4, s=2, cut_moments=True,
        **CPU)
    sp = t_slab_view(slab, tm)
    np.testing.assert_allclose(sp.V.numpy(), dt * tc.V.numpy(),
                               atol=1e-10 * dt)
    for d in range(2):
        np.testing.assert_allclose(sp.Vh[d].numpy(), dt * tc.Vh[d].numpy(),
                                   atol=1e-10 * dt)
    with pytest.raises(ValueError, match="cut_moments=True"):
        t_slab_view(tcapmod.compute_capacity_spacetime(
            lambda x, y, t: body(x, y), tm, 0.0, dt, p=4, s=1, **CPU), tm)


def test_moment_consistent_W_on_port_builds(moment_slabs):
    """``utils.moment_consistent_W`` on a capacity the port built with cut
    moments and on a slab view, against JAX on its own builds (1e-11 of
    scale); a fully wet mesh keeps its W."""
    jc, tc, jv, tv, _, _ = moment_slabs
    compare_capacity(ju.moment_consistent_W(jc), tu.moment_consistent_W(tc),
                     F64_TOL)
    compare_capacity(ju.moment_consistent_W(jv), tu.moment_consistent_W(tv),
                     F64_TOL)
    mesh = tpt.Mesh((8, 8), (1.0, 1.0))
    cap = tpt.compute_capacity(tpt.geometry.full_domain(2), mesh, p=4, s=1,
                               **CPU)
    cap2 = tu.moment_consistent_W(cap)
    for d in range(2):
        np.testing.assert_allclose(cap2.W[d].numpy(), cap.W[d].numpy(),
                                   atol=1e-12)


def test_moment_consistent_W_linear_flux_exactness():
    """tests/test_moment_w.py's inclined plane: with the rebuilt W the flux
    of a field linear along each axis is exact (1e-9) at every interior
    slot that carries the corrected arm."""
    mesh = tpt.Mesh((24, 24), (1.0, 1.0))
    s = 1.0 / np.hypot(0.4, 1.0)
    cap = tpt.compute_capacity(lambda x, y: -((y - 0.3 - 0.4 * x) * s), mesh,
                               p=6, s=2, **CPU)
    ops = tpt.make_diffusion_ops(cap)
    cap2 = tu.moment_consistent_W(cap, ops)
    ops2 = tpt.make_diffusion_ops(cap2)
    for d in range(2):
        u_o, u_g = cap.C_om[..., d], cap.C_ga[..., d]
        q = ops2.grad(u_o, u_g)[d].numpy()
        arm = (ops.grad(u_o, u_g)[d] * cap.W[d]).numpy()
        W = cap.W[d].numpy()
        idx = np.broadcast_to(np.arange(W.shape[d]).reshape(
            tuple(-1 if i == d else 1 for i in range(W.ndim))), W.shape)
        sel = (arm > 1e-10) & (W > 1e-10) & (idx > 0) & (idx < mesh.n[d])
        assert np.abs(q - 1.0)[sel].max() < 1e-9


# ---------------------------------------------------------------------------
# carrying a slab and a front across
# ---------------------------------------------------------------------------

def test_convert_carries_slab_and_markers(marker_slabs):
    """A JAX slab capacity (one more trailing axis, mesh None, cut moments
    None) and a marker array cross into the port and back unchanged."""
    jc, _ = marker_slabs["dense"]
    cap = capacity_from_numpy(_jax_fields(jc), **CPU)
    assert cap.mesh is None and cap.Am is None
    assert cap.V.shape == (N + 1, N + 1, 2) and cap.ndim == 3
    assert cap.cell_types.dtype == torch.int8
    back = capacity_to_numpy(cap)
    np.testing.assert_array_equal(back["A"][2], np.asarray(jc.A[2]))
    mk = np.asarray(jft.markers_circle((2.0, 2.0), 1.0, 32))
    t = markers_from_numpy(mk, **CPU)
    assert t.dtype == torch.float64 and t.shape == (32, 2)
    np.testing.assert_array_equal(markers_to_numpy(t), mk)

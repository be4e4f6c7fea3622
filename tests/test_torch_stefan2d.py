"""The parts of one GN iteration of the port's 2D marker Stefan solver
against the JAX package on the CPU in f64, and gates of
tests/test_stefan2d.py and tests/test_f32_robustness.py on the port alone.

The Frank disk (``torch_stefan_cases``) at 16² with 16 markers: both
packages start from the same numpy markers and temperatures.  Compared as
functions: the bodies, the box filter, the band budgets, the cell volumes,
one slab residual with and without Gibbs-Thomson, both volume Jacobians
(dense and narrow band) and the LM update; whole solves are compared in
test_torch_stefan2d_solve.py and test_torch_stefan2d_diph.py.
Tolerances: 1e-12 of scale for bodies, filter, volumes, one residual and
the LM update; 1e-9 for the Jacobians."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import penguin_tpu as jpt
from penguin_tpu.assembly import border_info as j_border_info
from penguin_tpu.capacity import compute_capacity_spacetime as j_slab
from penguin_tpu.front_tracking import (polyline_normals as j_normals,
                                        segment_cell_intersection_moments
                                        as j_moments)
from penguin_tpu.solvers import moving_diffusion as jmd
from penguin_tpu.solvers import stefan2d as js
import penguin_tpu_torch as tpt
from penguin_tpu_torch.front_tracking import markers_circle, polyline_normals
from penguin_tpu_torch.solvers import stefan2d as ts

from torch_stefan_cases import (CENTER, DT, L, N, S, T_INF, _close,
                                _mean_radius, _t, frank_state, mono_solver)
from torch_stefan_cases import one_thread  # noqa: F401  (autouse fixture)


@pytest.fixture(scope="module")
def disk():
    mk, Tw = frank_state()
    d = 0.2 * (L / N) * np.cos(3 * np.linspace(0, 2 * np.pi, N,
                                               endpoint=False))
    return dict(jm=jpt.Mesh((N, N), (L, L), (0.0, 0.0)),
                tm=tpt.Mesh((N, N), (L, L), (0.0, 0.0)), mk=mk, Tw=Tw, d=d)


def test_bodies_match_jax(disk):
    """The space-time and spatial marker bodies at seeded points, both
    signs, against the JAX bodies."""
    rng = np.random.default_rng(1)
    x, y = rng.uniform(2.0, 6.0, (2, 40))
    tt = rng.uniform(0.0, DT, 40)
    mk_a = disk["mk"]
    mk_b = mk_a * 1.03 - 0.12
    for sign in (1.0, -1.0):
        got = ts._st_marker_body(_t(x), _t(y), _t(tt),
                                 (_t(mk_a), _t(mk_b), DT, sign))
        want = js._st_marker_body(jnp.asarray(x), jnp.asarray(y),
                                  jnp.asarray(tt), (jnp.asarray(mk_a),
                                                    jnp.asarray(mk_b), DT,
                                                    sign))
        _close(got, want, 1e-13)
    _close(ts._sp_vol_body_pos(_t(x), _t(y), _t(mk_b)),
           js._sp_vol_body_pos(jnp.asarray(x), jnp.asarray(y),
                               jnp.asarray(mk_b)), 1e-13)
    _close(ts._sp_vol_body_neg(_t(x), _t(y), _t(mk_b)),
           js._sp_vol_body_neg(jnp.asarray(x), jnp.asarray(y),
                               jnp.asarray(mk_b)), 1e-13)


@pytest.mark.parametrize("shape", [(17, 17), (9, 13, 4)])
def test_box3_filter_matches_jax(shape):
    """On a grid and on a stack of grids (the intercept Jacobian's trailing
    marker axis, which JAX maps with ``vmap``)."""
    a = np.random.default_rng(2).standard_normal(shape)
    want = (js._box3_filter(jnp.asarray(a)) if len(shape) == 2 else
            jax.vmap(js._box3_filter, in_axes=2, out_axes=2)(jnp.asarray(a)))
    got = ts._box3_filter(_t(a))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-14)


def test_band_budgets_match_jax():
    """``_auto_band_budget`` on fronts of several sizes and meshes, its
    pass-through of ints and None, and ``_sticky_band_budget`` over a
    growing then shrinking front."""
    class Holder:
        pass

    jh, th = Holder(), Holder()
    for n, r, nm in ((16, 1.0, 16), (64, 1.0, 64), (256, 1.3, 256),
                     (256, 3.5, 256), (512, 0.7, 128)):
        mesh = tpt.Mesh((n, n), (L, L), (0.0, 0.0))
        jmesh = jpt.Mesh((n, n), (L, L), (0.0, 0.0))
        mk = markers_circle(CENTER, r, nm, device="cpu")
        want = js._auto_band_budget(jnp.asarray(mk.numpy()), jmesh, DT, -1.0,
                                    "auto")
        assert ts._auto_band_budget(mk, mesh, DT, -1.0, "auto") == want
        for v in (None, 4096):
            assert ts._auto_band_budget(mk, mesh, DT, -1.0, v) == v
    mesh = tpt.Mesh((128, 128), (L, L), (0.0, 0.0))
    jmesh = jpt.Mesh((128, 128), (L, L), (0.0, 0.0))
    for r in (1.0, 2.0, 1.0, 3.0):
        mk = markers_circle(CENTER, r, 64, device="cpu")
        got = ts._sticky_band_budget(th, mk, mesh, DT, 1.0, "auto")
        want = js._sticky_band_budget(jh, jnp.asarray(mk.numpy()), jmesh,
                                      DT, 1.0, "auto")
        assert got == want == th._band_budget


@pytest.mark.parametrize("band", [False, True])
def test_spatial_volumes_match_jax(disk, band):
    budget = ts._auto_band_budget(_t(disk["mk"]), disk["tm"], DT, -1.0,
                                  "auto") if band else None
    for sign in (1.0, -1.0):
        got = ts._spatial_volumes(_t(disk["mk"]), disk["tm"], sign, 4, 1,
                                  budget)
        want = js._spatial_volumes(jnp.asarray(disk["mk"]), disk["jm"], sign,
                                   4, 1, budget)
        _close(got, want, 1e-12)


def _j_slab_residual(disk, bc_i, sign=-1.0):
    """One GN residual composed from the JAX package's functions as its
    StefanMono2D composes them (stefan2d.py:236-297)."""
    mk_a = jnp.asarray(disk["mk"])
    normals = j_normals(mk_a)
    mk_b = mk_a + jnp.asarray(disk["d"])[:, None] * normals
    budget = js._auto_band_budget(mk_a, disk["jm"], DT, sign, "auto")
    cap = j_slab(js._st_marker_body, disk["jm"], 0.0, DT, p=4, s=1,
                 params=(mk_a, mk_b, DT, sign), band_budget=budget)
    g = None
    if isinstance(bc_i, jpt.GibbsThomson):
        _, Va_, Vb_, G0_, _, Cg_ = jmd.slice_spacetime(cap)
        v_r = (Vb_ - Va_) / jnp.where(G0_ > 0, G0_, 1.0)
        v_r = jnp.clip(jnp.where(G0_ > 0, v_r, 0.0), -0.999, 0.999)
        g = bc_i.Tm + bc_i.eps_v * v_r / jnp.sqrt(1.0 - v_r * v_r)
        from penguin_tpu.front_tracking import polyline_curvature
        kap_m = -sign * polyline_curvature(mk_b)
        d2 = jnp.sum((Cg_[..., None, :] - mk_b[None, None, :, :]) ** 2, -1)
        kap = jnp.where(G0_ > 0, kap_m[jnp.argmin(d2, axis=-1)], 0.0)
        g = g - bc_i.eps_k * kap
    bc_b = jpt.BorderConditions({k: jpt.Dirichlet(float(T_INF))
                                 for k in ("left", "right", "top", "bottom")})
    u0 = (jnp.asarray(disk["Tw"]), jnp.zeros(disk["Tw"].shape))
    T, klv, _ = jmd.solve_moving_mono_step(
        cap, 1.0, lambda x, y, z, t: 0.0, bc_i,
        j_border_info(disk["jm"], bc_b), u0, 0.0, DT, "BE",
        tol=1e-9, maxiter=400, g_override=g, method="auto")
    ops, Va, Vb, _, _, _ = jmd.slice_spacetime(cap)
    F = 1.0 * (Va - Vb) - ops.HT(ops.flux(T[0], T[1]))
    return js._box3_filter(F), T, int(klv)


@pytest.mark.parametrize("gibbs", [False, True])
def test_gn_residual_matches_jax(disk, gibbs):
    """One slab residual F = ρL (Va - Vb) - flux, box-filtered, at a front
    displaced by a seeded d, with the band budget the solver sizes; with
    Gibbs-Thomson (curvature and kinetic terms) the interface value too."""
    bc = {p: (p.GibbsThomson(0.0, 0.1, 0.2) if gibbs else p.Dirichlet(0.0))
          for p in (jpt, tpt)}
    jF, jT, jk = _j_slab_residual(disk, bc[jpt])
    s, front, _ = mono_solver(tpt, ts, bc[tpt])
    mk_a = front.markers
    budget = ts._auto_band_budget(mk_a, s.mesh, DT, -1.0, "auto")
    slab = s._slab_solver(-1.0, budget, 4, 1, "auto", 1e-9, 400,
                          gibbs=gibbs)
    mk_b = mk_a + _t(disk["d"])[:, None] * polyline_normals(mk_a)
    T, flux, Va, Vb, klv = slab(s.u0, mk_a, mk_b, 0.0)
    _close(ts._box3_filter(1.0 * (Va - Vb) - flux), jF, 1e-12)
    for a, b in zip(T, jT):
        _close(a, b, 1e-12)
    assert klv == jk


@pytest.mark.parametrize("jac,band", [("autodiff", False),
                                      ("autodiff", True),
                                      ("intercept", False)])
def test_volume_jacobians_match_jax(disk, jac, band):
    """∂F/∂d of both Jacobians at a displaced front, box-filtered, against
    ``jax.jacfwd`` of the JAX volume residual (dense and narrow band) and
    the JAX intercept Jacobian; to 1e-9 of scale."""
    sign, rhoL = -1.0, 1.0
    mk_a, d = disk["mk"], disk["d"]
    budget = (ts._auto_band_budget(_t(mk_a), disk["tm"], DT, sign, "auto")
              if band else None)
    jmk = jnp.asarray(mk_a)
    jn = j_normals(jmk)
    if jac == "autodiff":
        def vol_residual(dd):
            Vb = js._spatial_volumes(jmk + dd[:, None] * jn, disk["jm"], sign,
                                     4, 1, budget)
            return js._box3_filter(-rhoL * Vb).ravel()

        want = jax.jacfwd(vol_residual)(jnp.asarray(d))
    else:
        L0, L1 = j_moments(disk["jm"], jmk + jnp.asarray(d)[:, None] * jn)
        Jm = jnp.pad(jnp.roll(L1, 1, axis=2) + (L0 - L1),
                     [(0, 1), (0, 1), (0, 0)])
        want = jax.vmap(js._box3_filter, in_axes=2, out_axes=2)(
            -rhoL * sign * Jm).reshape(-1, N)
    fn = ts._jacobian_fn(jac, disk["tm"], sign, -rhoL, True, 4, 1, budget)
    tmk = _t(mk_a)
    got = fn(_t(d), tmk, polyline_normals(tmk))
    assert got.shape == ((N + 1) ** 2, N)
    _close(got, want, 1e-9)
    assert float(np.abs(np.asarray(want)).max()) > 1e-3


def test_lm_step_matches_jax():
    """The damped normal-equations update, smoothing and clipping
    (stefan2d.py:350-361) on a seeded J and F, and its non-finite guard on
    a singular system."""
    rng = np.random.default_rng(4)
    J = rng.standard_normal((60, 12))
    F = rng.standard_normal(60)
    d = 0.01 * rng.standard_normal(12)
    for Jx in (J, np.zeros_like(J)):
        jJ, jF, jd = jnp.asarray(Jx), jnp.asarray(F), jnp.asarray(d)
        JTJ = jJ.T @ jJ
        diag = jnp.maximum(jnp.diagonal(JTJ), 1e-10 * jnp.max(
            jnp.diagonal(JTJ)))
        delta = jnp.linalg.solve(JTJ + 1e-2 * jnp.diag(diag), jJ.T @ jF)
        delta = jnp.where(jnp.isfinite(delta), delta, 0.0)
        from penguin_tpu.front_tracking import smooth_displacements
        want = jnp.clip(smooth_displacements(jd - 0.8 * delta, 5, 1),
                        -0.125, 0.125)
        got = ts._lm_step(_t(Jx), _t(F), _t(d), _t(1e-2), 0.8, 5, 1, 0.125)
        _close(got, want, 1e-12)


# ---------------------------------------------------------------------------
# gates on the port alone
# ---------------------------------------------------------------------------

def test_port_gn_moves_in_f32():
    """tests/test_f32_robustness.py's f32 gate, at 16² with 16 markers, 3
    steps of 3 GN iterations: in pure f32 with the autodiff Jacobian the
    front must move (the regression it guards against froze it at the
    initial radius with zero GN updates) and stay finite.  The f32 autodiff
    GN on this coarse disk does not converge in either package, so the
    radius is not held to the similarity solution; the intercept leg is.

    Subnormal f32 tangents (from the SDF's sqrt(tiny) guard) are slow on an
    x86 CPU, so the run flushes them to zero, as XLA's CPU backend does for
    the JAX package; this run's numbers are the same either way."""
    torch.set_flush_denormal(True)
    try:
        for jac in ("autodiff", "intercept"):
            s, front, ic = mono_solver(tpt, ts, tpt.Dirichlet(0.0),
                                       dtype=torch.float32)
            s.solve(front, 0.0, 1.5 * DT, ic,
                    newton_params=(3, 1e-4, 1e-6, 1.0),
                    interior_fluid=False, method="auto", jac=jac)
            assert s.markers.dtype == torch.float32
            assert s.x[0].dtype == torch.float32
            assert np.isfinite(s.residual_log).all(), s.residual_log
            assert torch.isfinite(s.markers).all()
            moved = np.abs(s.marker_log[-1] - s.marker_log[0]).max()
            assert moved > 1e-3, moved
            R_end = _mean_radius(s.markers)
            if jac == "intercept":
                assert 1.01 < R_end < 1.10, R_end
    finally:
        torch.set_flush_denormal(False)


@pytest.mark.slow
@pytest.mark.parametrize("jac", ["autodiff", "intercept"])
def test_port_frank_disk_growth(jac):
    """tests/test_stefan2d.py's Frank-disk gates at their size (32², 32
    markers, 5 steps)."""
    s, front, ic = mono_solver(tpt, ts, tpt.Dirichlet(0.0), n=32)
    s.solve(front, 0.0, 0.1 - DT / 2, ic, newton_params=(12, 1e-4, 1e-6, 1.0),
            interior_fluid=False, method="bicgstab", jac=jac)
    R_exact = S * np.sqrt(1.0 + len(s.residual_log) * DT)
    R = _mean_radius(s.markers)
    mk = s.markers.numpy()
    radii = np.sqrt(((mk - np.asarray(CENTER)) ** 2).sum(1))
    assert R > S + 0.01
    assert radii.std() / R < (0.03 if jac == "autodiff" else 0.02)
    assert abs(R - R_exact) / R_exact < (0.05 if jac == "autodiff"
                                         else 0.02), (R, R_exact)


@pytest.mark.slow
def test_port_gibbs_thomson_curvature_slows_growth():
    """tests/test_stefan2d.py's curvature gate at its size."""
    radii = {}
    for eps_k in (0.0, 0.1):
        s, front, ic = mono_solver(tpt, ts, tpt.GibbsThomson(0.0, eps_k, 0.0),
                                   n=32)
        s.solve(front, 0.0, 0.06 - DT / 2, ic,
                newton_params=(10, 1e-4, 1e-6, 1.0), interior_fluid=False,
                method="bicgstab", jac="intercept")
        radii[eps_k] = _mean_radius(s.markers)
    assert radii[0.1] < radii[0.0] - 1e-4, radii
    assert radii[0.1] > S

"""The port's prescribed-motion diffusion solvers against the JAX package
on the CPU in f64, and the gates of tests/test_moving_diffusion.py on the
port alone.

Each package builds its own slabs from an analytic body written once per
package; random states come from numpy seeds.  Tolerances: 1e-12 of scale
for slicing, weights and each system's apply/rhs/diagonal, 1e-9 for solves
and whole runs, activity masks and Krylov counts exactly.  The default
``pgmres`` of the diphasic solvers draws its row-norm probes from each
package's own generator, so those paths are compared through
``method="direct"`` and ``"pbicgstab"`` (Jacobi, no probes), and the port's
``pgmres`` is held against its own direct solve."""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import penguin_tpu as jpt
from penguin_tpu.capacity import compute_capacity_spacetime as j_slab
from penguin_tpu.solvers import moving_diffusion as jmd
import penguin_tpu_torch as tpt
from penguin_tpu_torch.capacity import compute_capacity_spacetime as t_slab
from penguin_tpu_torch.solvers import (DiffusionUnsteadyDiph,
                                       DiffusionUnsteadyMono)
from penguin_tpu_torch.solvers import moving_diffusion as tmd
from torch_stefan_cases import one_thread  # noqa: F401  (autouse fixture)

CPU = dict(device="cpu")
N = 16
T0, DT = 0.1, 0.05


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _close(got, want, tol):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, dtype=np.float64)
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1.0), \
            np.abs(g - w).max()


def _masks_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# analytic bodies, once per package: a unit disk drifting along x (fluid
# inside) and its complement
def _jdisk(x, y, t):
    return jnp.sqrt((x - 1.9 - 0.8 * t) ** 2 + (y - 2.05) ** 2) - 1.0


def _tdisk(x, y, t):
    return torch.sqrt((x - 1.9 - 0.8 * t) ** 2 + (y - 2.05) ** 2) - 1.0


def _jf(x, y, z, t):
    return jnp.sin(x) * jnp.cos(t) + 0.3 * y


def _tf(x, y, z, t):                 # t reaches the port as a Python float
    return torch.sin(x) * math.cos(t) + 0.3 * y


def _jg(x, y, z, t):
    return 1.0 + 0.5 * x * jnp.sin(t)


def _tg(x, y, z, t):
    return 1.0 + 0.5 * x * math.sin(t)


def _borders(pkg):
    return pkg.BorderConditions({"left": pkg.Dirichlet(0.0),
                                 "right": pkg.Dirichlet(0.5),
                                 "top": pkg.Neumann(0.0),
                                 "bottom": pkg.Dirichlet(lambda x, y: 0.1 * y)})


@pytest.fixture(scope="module")
def slabs():
    """One slab [T0, T0+DT] of the drifting disk and of its complement, in
    both packages, with their meshes, borders and seeded random states."""
    jm = jpt.Mesh((N, N), (4.0, 4.0))
    tm = tpt.Mesh((N, N), (4.0, 4.0))
    jc1 = j_slab(_jdisk, jm, T0, T0 + DT, p=4, s=1)
    jc2 = j_slab(lambda x, y, t: -_jdisk(x, y, t), jm, T0, T0 + DT, p=4, s=1)
    tc1 = t_slab(_tdisk, tm, T0, T0 + DT, p=4, s=1, **CPU)
    tc2 = t_slab(lambda x, y, t: -_tdisk(x, y, t), tm, T0, T0 + DT, p=4, s=1,
                 **CPU)
    rng = np.random.default_rng(11)
    state = rng.standard_normal((4,) + jm.np_shape)
    vel = 0.3 * rng.standard_normal((3,) + jm.np_shape)
    from penguin_tpu.assembly import border_info as jbi
    from penguin_tpu_torch.assembly import border_info as tbi
    return dict(
        jm=jm, tm=tm, jc1=jc1, jc2=jc2, tc1=tc1, tc2=tc2,
        jx=tuple(jnp.asarray(a) for a in state),
        tx=tuple(_t(a) for a in state),
        ju=(jnp.asarray(vel[0]), jnp.asarray(vel[1])), jug=jnp.asarray(vel[2]),
        tu=(_t(vel[0]), _t(vel[1])), tug=_t(vel[2]),
        jb=jbi(jm, _borders(jpt)), tb=tbi(tm, _borders(tpt), **CPU),
        jic=jpt.InterfaceConditions(jpt.ScalarJump(1.0, 0.5, _jg),
                                    jpt.FluxJump(1.0, 2.0, 0.3)),
        tic=tpt.InterfaceConditions(tpt.ScalarJump(1.0, 0.5, _tg),
                                    tpt.FluxJump(1.0, 2.0, 0.3)),
    )


# ---------------------------------------------------------------------------
# slicing, weights, masks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clamp", [0.0, 1e-4, 0.04])
def test_slice_spacetime_matches_jax(slabs, clamp):
    """Operators' data, Va/Vb, Gamma and the centroids of a slab, without
    the sliver clamp, with the 1e-4 of the ``build_*`` functions, and with a clamp large
    enough (0.04: cells under 20% of a full one) to disconnect cells of
    this slab; the disconnected set is equal."""
    for jc, tc in ((slabs["jc1"], slabs["tc1"]), (slabs["jc2"], slabs["tc2"])):
        jo, *jrest = jmd.slice_spacetime(jc, clamp)
        to, *trest = tmd.slice_spacetime(tc, clamp)
        _close(trest, jrest, 1e-12)
        for f in ("A", "B", "Wdag"):
            _close(getattr(to, f), getattr(jo, f), 1e-12)
        _close(to.V, jo.V, 1e-12)
        np.testing.assert_array_equal((trest[0] != 0).numpy(),
                                      np.asarray(jrest[0] != 0))
    if clamp == 0.04:
        plain = tmd.slice_spacetime(slabs["tc1"])[1]
        clamped = tmd.slice_spacetime(slabs["tc1"], clamp)[1]
        assert int(((plain != 0) & (clamped == 0)).sum()) > 0


@pytest.mark.parametrize("scheme", ["BE", "CN"])
def test_psi_weights_and_masks_match_jax(slabs, scheme):
    """psi+/psi-, the convection weights and the activity masks for a
    Dirichlet, a Neumann and a Robin closure: exact equality (they are
    built from comparisons with 0 of capacities that agree where they are
    exactly 0)."""
    jo, jVa, jVb, jG, _, _ = jmd.slice_spacetime(slabs["jc1"])
    to, tVa, tVb, tG, _, _ = tmd.slice_spacetime(slabs["tc1"])
    for g, w in zip(tmd.psi_weights(scheme, tVb, tVa),
                    jmd.psi_weights(scheme, jVb, jVa)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert g.dtype == torch.float64
    for g, w in zip(tmd.psi_conv_weights(tVb, tVa),
                    jmd.psi_conv_weights(jVb, jVa)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # fresh and dead cells both occur in this slab
    assert int(((tVa == 0) != (tVb == 0)).sum()) > 0
    for ia, ib in ((1.0, 0.0), (0.0, 1.0), (2.0, 0.5)):
        _masks_equal(tmd.moving_masks(to, tVa, tVb, tG, ia, ib),
                     jmd.moving_masks(jo, jVa, jVb, jG, ia, ib))


# ---------------------------------------------------------------------------
# every system's apply / rhs / diagonal on random states
# ---------------------------------------------------------------------------

def _bc_i(pkg, kind):
    g = _jg if pkg is jpt else _tg
    return {"dirichlet": pkg.Dirichlet(g), "neumann": pkg.Neumann(0.4),
            "robin": pkg.Robin(2.0, 0.5, g)}[kind]


@pytest.mark.parametrize("scheme", ["BE", "CN"])
@pytest.mark.parametrize("kind", ["dirichlet", "neumann", "robin"])
def test_mono_system_matches_jax(slabs, scheme, kind):
    s = slabs
    D = 0.7
    ja, jr = jmd.build_moving_mono_system(s["jc1"], D, _jf, _bc_i(jpt, kind),
                                          s["jb"], T0, DT, scheme)
    ta, tr = tmd.build_moving_mono_system(s["tc1"], D, _tf, _bc_i(tpt, kind),
                                          s["tb"], T0, DT, scheme)
    _close(ta(s["tx"][:2]), ja(s["jx"][:2]), 1e-12)
    _close(tr(s["tx"][:2]), jr(s["jx"][:2]), 1e-12)
    _close(tmd.moving_mono_diag(s["tc1"], D, _bc_i(tpt, kind), s["tb"],
                                scheme),
           jmd.moving_mono_diag(s["jc1"], D, _bc_i(jpt, kind), s["jb"],
                                scheme), 1e-12)


def test_mono_system_variable_D_and_override(slabs):
    """A callable diffusivity and ``g_override`` (the value a front solver
    feeds per iteration)."""
    s = slabs
    jD = lambda x, y, z: 1.0 + 0.2 * x
    go = np.random.default_rng(3).standard_normal(s["jm"].np_shape)
    ja, jr = jmd.build_moving_mono_system(
        s["jc1"], jD, _jf, jpt.Dirichlet(1.0), s["jb"], T0, DT, "BE",
        g_override=jnp.asarray(go))
    ta, tr = tmd.build_moving_mono_system(
        s["tc1"], jD, _tf, tpt.Dirichlet(1.0), s["tb"], T0, DT, "BE",
        g_override=_t(go))
    _close(ta(s["tx"][:2]), ja(s["jx"][:2]), 1e-12)
    _close(tr(s["tx"][:2]), jr(s["jx"][:2]), 1e-12)
    gt = tpt.GibbsThomson(0.5, 0.0, 0.1, v_gamma=_t(go))
    jgt = jpt.GibbsThomson(0.5, 0.0, 0.1, v_gamma=jnp.asarray(go))
    _close(tmd.build_moving_mono_system(s["tc1"], 1.0, _tf, gt, s["tb"], T0,
                                        DT, "BE")[1](s["tx"][:2]),
           jmd.build_moving_mono_system(s["jc1"], 1.0, _jf, jgt, s["jb"], T0,
                                        DT, "BE")[1](s["jx"][:2]), 1e-12)


@pytest.mark.parametrize("scheme", ["BE", "CN"])
def test_advdiff_system_matches_jax(slabs, scheme):
    s = slabs
    ja, jr = jmd.build_moving_advdiff_system(
        s["jc1"], 0.7, _jf, jpt.Dirichlet(_jg), s["jb"], s["ju"], s["jug"],
        T0, DT, scheme)
    ta, tr = tmd.build_moving_advdiff_system(
        s["tc1"], 0.7, _tf, tpt.Dirichlet(_tg), s["tb"], s["tu"], s["tug"],
        T0, DT, scheme)
    _close(ta(s["tx"][:2]), ja(s["jx"][:2]), 1e-12)
    _close(tr(s["tx"][:2]), jr(s["jx"][:2]), 1e-12)


@pytest.mark.parametrize("scheme", ["BE", "CN"])
@pytest.mark.parametrize("which", ["diph", "diph_stef", "advdiff_diph"])
def test_diph_systems_match_jax(slabs, scheme, which):
    s = slabs
    jargs = (s["jc1"], s["jc2"], 1.0, 2.0, _jf, _jf, s["jic"], s["jb"],
             s["jb"])
    targs = (s["tc1"], s["tc2"], 1.0, 2.0, _tf, _tf, s["tic"], s["tb"],
             s["tb"])
    if which == "diph":
        ja, jr = jmd.build_moving_diph_system(*jargs, T0, DT, scheme)
        ta, tr = tmd.build_moving_diph_system(*targs, T0, DT, scheme)
        _close(tmd.moving_diph_diag(s["tc1"], s["tc2"], 1.0, 2.0, s["tic"],
                                    s["tb"], s["tb"], scheme),
               jmd.moving_diph_diag(s["jc1"], s["jc2"], 1.0, 2.0, s["jic"],
                                    s["jb"], s["jb"], scheme), 1e-12)
    elif which == "diph_stef":
        ja, jr = jmd.build_moving_diph_stef_system(*jargs, T0, DT, scheme)
        ta, tr = tmd.build_moving_diph_stef_system(*targs, T0, DT, scheme)
    else:
        ja, jr = jmd.build_moving_advdiff_diph_system(
            *jargs, s["ju"], s["jug"], T0, DT, scheme)
        ta, tr = tmd.build_moving_advdiff_diph_system(
            *targs, s["tu"], s["tug"], T0, DT, scheme)
    _close(ta(s["tx"]), ja(s["jx"]), 1e-12)
    _close(tr(s["tx"]), jr(s["jx"]), 1e-12)


# ---------------------------------------------------------------------------
# slab solves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme,method,kind", [
    ("BE", "auto", "dirichlet"), ("BE", "reduced", "dirichlet"),
    ("CN", "auto", "dirichlet"), ("BE", "auto", "robin"),
    ("BE", "direct", "neumann"), ("CN", "direct", "robin"),
], ids=["be_auto_reduced", "be_reduced_warm", "cn_auto_bicgstab",
        "robin_auto_bicgstab", "neumann_direct", "cn_robin_direct"])
def test_mono_step_matches_jax(slabs, scheme, method, kind):
    """One slab solve: the field to 1e-9, equal iteration counts (Jacobi
    preconditioners are computed, not drawn).  The Krylov tolerance is
    1e-12 so that both iterates sit within 1e-9 of the solution: BiCGStab
    on the Robin system spreads round-off to 5e-8 at tol 1e-10."""
    s = slabs
    kw = dict(tol=1e-12, maxiter=400, method=method)
    jx0 = tuple(0.1 * a for a in s["jx"][:2])
    tx0 = tuple(0.1 * a for a in s["tx"][:2])
    jkw, tkw = dict(kw), dict(kw)
    if method == "reduced":
        jkw["x0"], tkw["x0"] = s["jx"][2:], s["tx"][2:]
    jx, jit, jres = jmd.solve_moving_mono_step(
        s["jc1"], 0.7, _jf, _bc_i(jpt, kind), s["jb"], jx0, T0, DT, scheme,
        **jkw)
    tx, tit, tres = tmd.solve_moving_mono_step(
        s["tc1"], 0.7, _tf, _bc_i(tpt, kind), s["tb"], tx0, T0, DT, scheme,
        **tkw)
    _close(tx, jx, 1e-9)
    assert int(tit) == int(jit)
    if method != "direct":
        assert float(tres) <= 1e-12
        assert int(tit) > 0


def test_mono_step_auto_routing_and_errors(slabs):
    """``auto`` sends a callable D to BiCGStab on the coupled system (its
    count differs from the reduced CG's); the reduced solve refuses a
    closure with a flux part."""
    s = slabs
    x0 = tuple(0.1 * a for a in s["tx"][:2])
    D = lambda x, y, z: 1.0 + 0.0 * x
    a = tmd.solve_moving_mono_step(s["tc1"], D, _tf, tpt.Dirichlet(1.0),
                                   s["tb"], x0, T0, DT, "BE", tol=1e-10)
    b = tmd.solve_moving_mono_step(s["tc1"], 1.0, _tf, tpt.Dirichlet(1.0),
                                   s["tb"], x0, T0, DT, "BE", tol=1e-10)
    _close(a[0][0], b[0][0].numpy(), 1e-7)
    assert a[1] != b[1]
    with pytest.raises(ValueError, match="Dirichlet-type"):
        tmd.solve_moving_mono_step_reduced(s["tc1"], 1.0, _tf,
                                           tpt.Neumann(0.0), s["tb"], x0, T0,
                                           DT)


@pytest.mark.parametrize("method", ["direct", "pbicgstab"])
def test_diph_step_matches_jax(slabs, method):
    s = slabs
    jx0 = tuple(0.1 * a for a in s["jx"])
    tx0 = tuple(0.1 * a for a in s["tx"])
    jx, jit, _ = jmd.solve_moving_diph_step(
        s["jc1"], s["jc2"], 1.0, 2.0, _jf, _jf, s["jic"], s["jb"], s["jb"],
        jx0, T0, DT, "BE", method=method, tol=1e-11, maxiter=600)
    tx, tit, _ = tmd.solve_moving_diph_step(
        s["tc1"], s["tc2"], 1.0, 2.0, _tf, _tf, s["tic"], s["tb"], s["tb"],
        tx0, T0, DT, "BE", method=method, tol=1e-11, maxiter=600)
    # BiCGStab's iterates wander apart in the last digits on this jump
    # system, so its fields agree to the solve's own tolerance
    _close(tx, jx, 1e-9 if method == "direct" else 1e-7)
    if method == "direct":
        assert tit == jit == 0


@pytest.mark.parametrize("scheme,method", [
    ("BE", "auto"), ("CN", "auto"), ("BE", "direct")],
    ids=["be_reduced", "cn_bicgstab", "direct"])
def test_diph_stef_step_matches_jax(slabs, scheme, method):
    s = slabs
    jx0 = tuple(0.1 * a for a in s["jx"])
    tx0 = tuple(0.1 * a for a in s["tx"])
    jx, jit, jres = jmd.solve_moving_diph_stef_step(
        s["jc1"], s["jc2"], 1.0, 2.0, _jf, _jf, s["jic"], s["jb"], s["jb"],
        jx0, T0, DT, scheme, method=method, tol=1e-10)
    tx, tit, tres = tmd.solve_moving_diph_stef_step(
        s["tc1"], s["tc2"], 1.0, 2.0, _tf, _tf, s["tic"], s["tb"], s["tb"],
        tx0, T0, DT, scheme, method=method, tol=1e-10)
    _close(tx, jx, 1e-9)
    assert int(tit) == int(jit)
    if method == "auto" and scheme == "BE":
        # with x0 the reduced solve warm-starts only cells alive at the
        # slab end, from x0's bulk fields
        jw, jwit, _ = jmd.solve_moving_diph_stef_step_reduced(
            s["jc1"], s["jc2"], 1.0, 2.0, _jf, _jf, s["jic"], s["jb"],
            s["jb"], jx0, T0, DT, tol=1e-10, x0=s["jx"])
        tw, twit, _ = tmd.solve_moving_diph_stef_step_reduced(
            s["tc1"], s["tc2"], 1.0, 2.0, _tf, _tf, s["tic"], s["tb"],
            s["tb"], tx0, T0, DT, tol=1e-10, x0=s["tx"])
        _close(tw, jw, 1e-9)
        assert int(twit) == int(jwit)


# ---------------------------------------------------------------------------
# the four classes over 3 slabs
# ---------------------------------------------------------------------------

def _zeros(pkg, mesh, k):
    if pkg is jpt:
        return tuple(jnp.zeros(mesh.np_shape) for _ in range(k))
    return tuple(torch.zeros(mesh.np_shape, dtype=torch.float64)
                 for _ in range(k))


@pytest.mark.parametrize("scheme,method", [("BE", "auto"),
                                           ("CN", "pbicgstab"),
                                           ("BE", "direct")])
def test_mono_class_matches_jax(slabs, scheme, method):
    """``MovingDiffusionUnsteadyMono`` over 1+2 slabs: field 1e-9, equal
    counts on every slab, equal final capacity, kept states."""
    s = slabs
    js = jmd.MovingDiffusionUnsteadyMono(
        jpt.Phase(None, None, _jf, 0.7), _borders(jpt), jpt.Dirichlet(_jg),
        DT, _zeros(jpt, s["jm"], 2), s["jm"], scheme)
    ts = tmd.MovingDiffusionUnsteadyMono(
        tpt.Phase(None, None, _tf, 0.7), _borders(tpt), tpt.Dirichlet(_tg),
        DT, _zeros(tpt, s["tm"], 2), s["tm"], scheme)
    jx = js.solve(_jdisk, T0, T0 + 2 * DT, method=method, p=4, s=1,
                  keep_states=True)
    tx = ts.solve(_tdisk, T0, T0 + 2 * DT, method=method, p=4, s=1,
                  keep_states=True)
    _close(tx, jx, 1e-9)
    np.testing.assert_array_equal(ts.krylov_iters, js.krylov_iters)
    assert ts.krylov_iters.shape == (3,) and len(ts.states) == 3
    np.testing.assert_allclose(ts.krylov_relres, js.krylov_relres,
                               rtol=1e-5, atol=1e-14)
    for a, b in zip(ts.states, js.states):
        _close(a, b, 1e-9)
    _close(ts.capacity_final.A[2], js.capacity_final.A[2], 1e-11)
    _close(ts.x_omega, js.x[0], 1e-9)


def test_diph_class_matches_jax(slabs):
    s = slabs
    u0 = np.random.default_rng(2).standard_normal((4,) + s["jm"].np_shape)
    args = (T0, T0 + 2 * DT)
    js = jmd.MovingDiffusionUnsteadyDiph(
        jpt.Phase(None, None, _jf, 1.0), jpt.Phase(None, None, _jf, 2.0),
        _borders(jpt), s["jic"], DT, tuple(jnp.asarray(a) for a in u0),
        s["jm"], "BE")
    ts = tmd.MovingDiffusionUnsteadyDiph(
        tpt.Phase(None, None, _tf, 1.0), tpt.Phase(None, None, _tf, 2.0),
        _borders(tpt), s["tic"], DT, tuple(_t(a) for a in u0), s["tm"], "BE")
    jx = js.solve(_jdisk, lambda x, y, t: -_jdisk(x, y, t), *args,
                  method="direct", p=4, s=1)
    tx = ts.solve(_tdisk, lambda x, y, t: -_tdisk(x, y, t), *args,
                  method="direct", p=4, s=1)
    _close(tx, jx, 1e-9)
    assert ts.krylov_iters.tolist() == [0, 0, 0]


@pytest.mark.parametrize("method", ["direct", "pbicgstab"])
def test_advdiff_mono_class_matches_jax(slabs, method):
    s = slabs
    js = jmd.MovingAdvDiffusionUnsteadyMono(
        jpt.Phase(None, None, _jf, 0.7), _borders(jpt), jpt.Dirichlet(_jg),
        DT, _zeros(jpt, s["jm"], 2), s["jm"], "BE")
    ts = tmd.MovingAdvDiffusionUnsteadyMono(
        tpt.Phase(None, None, _tf, 0.7), _borders(tpt), tpt.Dirichlet(_tg),
        DT, _zeros(tpt, s["tm"], 2), s["tm"], "BE")
    jx = js.solve(_jdisk, T0, T0 + 2 * DT, s["ju"], s["jug"], method=method,
                  p=4, s=1, tol=1e-11)
    tx = ts.solve(_tdisk, T0, T0 + 2 * DT, s["tu"], s["tug"], method=method,
                  p=4, s=1, tol=1e-11)
    _close(tx, jx, 1e-9 if method == "direct" else 1e-8)
    if method == "direct":
        np.testing.assert_array_equal(ts.krylov_iters, js.krylov_iters)


def test_advdiff_diph_class_matches_jax(slabs):
    s = slabs
    u0 = np.random.default_rng(4).standard_normal((4,) + s["jm"].np_shape)
    js = jmd.MovingAdvDiffusionUnsteadyDiph(
        jpt.Phase(None, None, _jf, 1.0), jpt.Phase(None, None, _jf, 2.0),
        _borders(jpt), s["jic"], DT, tuple(jnp.asarray(a) for a in u0),
        s["jm"], "CN")
    ts = tmd.MovingAdvDiffusionUnsteadyDiph(
        tpt.Phase(None, None, _tf, 1.0), tpt.Phase(None, None, _tf, 2.0),
        _borders(tpt), s["tic"], DT, tuple(_t(a) for a in u0), s["tm"], "CN")
    jx = js.solve(_jdisk, lambda x, y, t: -_jdisk(x, y, t), T0, T0 + 2 * DT,
                  s["ju"], s["jug"], method="direct", p=4, s=1)
    tx = ts.solve(_tdisk, lambda x, y, t: -_tdisk(x, y, t), T0, T0 + 2 * DT,
                  s["tu"], s["tug"], method="direct", p=4, s=1)
    _close(tx, jx, 1e-9)


# ---------------------------------------------------------------------------
# the gates of tests/test_moving_diffusion.py, on the port
# ---------------------------------------------------------------------------

def _z(mesh):
    return torch.zeros(mesh.np_shape, dtype=torch.float64)


def _static_1d(nx, lx):
    mesh = tpt.Mesh((nx,), (lx,), (0.0,))
    body1d = tpt.geometry.interval(2.0, 1.0)
    cap = tpt.compute_capacity(body1d, mesh, **CPU)
    bc_b = tpt.BorderConditions({"left": tpt.Dirichlet(0.0),
                                 "right": tpt.Dirichlet(0.0)})
    phase = tpt.Phase(cap, tpt.make_diffusion_ops(cap),
                      lambda x, y, z, t: 0.0, 1.0)
    return mesh, body1d, cap, bc_b, phase, 0.5 * (lx / nx) ** 2


def test_moving_static_body_matches_static_solver():
    """For a STATIC body the moving scheme reproduces the static unsteady
    solver: the slab capacities carry the dt factors."""
    mesh, body1d, cap, bc_b, phase, dt = _static_1d(40, 4.0)
    z = _z(mesh)
    t_end = 10.5 * dt
    static = DiffusionUnsteadyMono(phase, bc_b, tpt.Dirichlet(1.0), dt,
                                   (z, z), "BE")
    static.solve(t_end, method="direct")
    moving = tmd.MovingDiffusionUnsteadyMono(phase, bc_b, tpt.Dirichlet(1.0),
                                             dt, (z, z), mesh, "BE")
    moving.solve(lambda x, t: body1d(x), 0.0, t_end, method="direct", p=8,
                 s=2)
    sel = (cap.cell_types != 0).numpy()
    assert np.abs(moving.x[0].numpy() - static.x_omega.numpy())[sel].max() \
        < 1e-8


def test_moving_translating_interval_bounded():
    mesh = tpt.Mesh((60,), (6.0,), (0.0,))
    body_st = lambda x, t: torch.abs(x - (1.5 + 1.0 * t)) - 1.0
    bc_b = tpt.BorderConditions({"left": tpt.Dirichlet(0.0),
                                 "right": tpt.Dirichlet(0.0)})
    phase = tpt.Phase(None, None, lambda x, y, z, t: 0.0, 1.0)
    z = _z(mesh)
    solver = tmd.MovingDiffusionUnsteadyMono(phase, bc_b, tpt.Dirichlet(1.0),
                                             0.01, (z, z), mesh, "BE")
    solver.solve(body_st, 0.0, 0.2, method="direct", p=6, s=1)
    Tw = solver.x[0].numpy()
    assert np.isfinite(Tw).all()
    assert Tw.min() > -0.05 and Tw.max() < 1.05
    Va = solver.capacity_final.A[1][..., 0].numpy()
    assert Tw[Va > 1e-10].max() > 0.2


def test_moving_advdiff_zero_velocity_matches_diffusion():
    mesh, body1d, cap, bc_b, phase, dt = _static_1d(32, 4.0)
    body_st = lambda x, t: body1d(x)
    z = _z(mesh)
    t_end = 5.5 * dt
    ref = tmd.MovingDiffusionUnsteadyMono(phase, bc_b, tpt.Dirichlet(1.0), dt,
                                          (z, z), mesh, "BE")
    ref.solve(body_st, 0.0, t_end, method="direct", p=6, s=1)
    adv = tmd.MovingAdvDiffusionUnsteadyMono(phase, bc_b, tpt.Dirichlet(1.0),
                                             dt, (z, z), mesh, "BE")
    adv.solve(body_st, 0.0, t_end, (z,), z, method="direct", p=6, s=1)
    sel = (cap.cell_types != 0).numpy()
    assert np.abs(adv.x[0].numpy() - ref.x[0].numpy())[sel].max() < 1e-10


def _diph_1d(nx, D2, a2):
    mesh = tpt.Mesh((nx,), (8.0,), (0.0,))
    body = tpt.geometry.halfspace(0, 4.0)
    body_c = tpt.geometry.halfspace(0, 4.0, -1.0)
    cap1 = tpt.compute_capacity(body, mesh, **CPU)
    cap2 = tpt.compute_capacity(body_c, mesh, **CPU)
    ph1 = tpt.Phase(cap1, tpt.make_diffusion_ops(cap1),
                    lambda x, y, z, t: 0.0, 1.0)
    ph2 = tpt.Phase(cap2, tpt.make_diffusion_ops(cap2),
                    lambda x, y, z, t: 0.0, D2)
    bc_b = tpt.BorderConditions({"top": tpt.Dirichlet(1.0),
                                 "bottom": tpt.Dirichlet(0.0)})
    ic = tpt.InterfaceConditions(tpt.ScalarJump(1.0, a2, 0.0),
                                 tpt.FluxJump(1.0, 1.0, 0.0))
    z, o = _z(mesh), torch.ones(mesh.np_shape, dtype=torch.float64)
    return (mesh, lambda x, t: body(x), lambda x, t: body_c(x), cap1, cap2,
            ph1, ph2, bc_b, ic, (z, z, o, o), 0.5 * (8.0 / nx) ** 2)


def test_moving_diph_static_body_matches_static_solver():
    (mesh, b_st, bc_st, cap1, cap2, ph1, ph2, bc_b, ic, u0,
     dt) = _diph_1d(40, 1.0, 0.5)
    t_end = 6.5 * dt
    ref = DiffusionUnsteadyDiph(ph1, ph2, bc_b, ic, dt, u0, "BE")
    ref.solve(t_end, method="direct")
    mov = tmd.MovingDiffusionUnsteadyDiph(ph1, ph2, bc_b, ic, dt, u0, mesh,
                                          "BE")
    mov.solve(b_st, bc_st, 0.0, t_end, method="direct", p=8, s=2)
    for i, cap in ((0, cap1), (2, cap2)):
        sel = (cap.cell_types != 0).numpy()
        d = np.abs(mov.x[i].numpy() - ref.x[i].numpy())[sel].max()
        assert d < 1e-7, (i, d)


def test_moving_advdiff_diph_zero_velocity_matches_diffusion():
    (mesh, b_st, bc_st, cap1, cap2, ph1, ph2, bc_b, ic, u0,
     dt) = _diph_1d(32, 2.0, 1.0)
    t_end = 4.5 * dt
    z = _z(mesh)
    ref = tmd.MovingDiffusionUnsteadyDiph(ph1, ph2, bc_b, ic, dt, u0, mesh,
                                          "BE")
    ref.solve(b_st, bc_st, 0.0, t_end, method="direct", p=6, s=1)
    adv = tmd.MovingAdvDiffusionUnsteadyDiph(ph1, ph2, bc_b, ic, dt, u0, mesh,
                                             "BE")
    adv.solve(b_st, bc_st, 0.0, t_end, (z,), (z,), method="direct", p=6, s=1)
    for i, cap in ((0, cap1), (2, cap2)):
        sel = (cap.cell_types != 0).numpy()
        d = np.abs(adv.x[i].numpy() - ref.x[i].numpy())[sel].max()
        assert d < 1e-8, (i, d)


def test_moving_diph_2d_circle_pgmres_matches_direct():
    """2D translating circle, general diphasic slab system: the default
    row-equilibrated GMRES path matches the dense direct solve."""
    mesh = tpt.Mesh((20, 20), (4.0, 4.0))
    body_st = lambda x, y, t: -(torch.sqrt((x - 2.0 - 0.2 * t) ** 2
                                           + (y - 2.0) ** 2) - 1.0)
    body_c_st = lambda x, y, t: -body_st(x, y, t)
    ph1 = tpt.Phase(None, None, lambda x, y, z, t: 0.0, 1.0)
    ph2 = tpt.Phase(None, None, lambda x, y, z, t: 0.0, 2.0)
    bc_b = tpt.BorderConditions({k: tpt.Dirichlet(0.0)
                                 for k in ("left", "right", "top", "bottom")})
    ic = tpt.InterfaceConditions(tpt.ScalarJump(1.0, 1.0, 0.0),
                                 tpt.FluxJump(1.0, 2.0, 0.0))
    z = _z(mesh)
    u0 = (torch.ones_like(z), z, z, z)
    a = tmd.MovingDiffusionUnsteadyDiph(ph1, ph2, bc_b, ic, 0.01, u0, mesh,
                                        "BE")
    a.solve(body_st, body_c_st, 0.0, 0.02, method="direct", p=4, s=1)
    b = tmd.MovingDiffusionUnsteadyDiph(ph1, ph2, bc_b, ic, 0.01, u0, mesh,
                                        "BE")
    b.solve(body_st, body_c_st, 0.0, 0.02, p=4, s=1)
    assert b.krylov_relres.max() < 1e-8
    assert b.krylov_iters.min() > 0
    for i in (0, 2):
        d = np.abs(a.x[i].numpy() - b.x[i].numpy()).max()
        assert d < 1e-6, (i, d)


@pytest.mark.slow
def test_moving_static_body_3d_matches_static_solver():
    """(3+1)D space-time slab: the moving scheme is dimension-generic."""
    n, L = 10, 2.0
    mesh = tpt.Mesh((n, n, n), (L, L, L))
    sphere = tpt.geometry.sphere((1.0, 1.0, 1.0), 0.6)
    cap = tpt.compute_capacity(sphere, mesh, **CPU)
    bc_b = tpt.BorderConditions({k: tpt.Dirichlet(0.0) for k in
                                 ("left", "right", "top", "bottom",
                                  "backward", "forward")})
    phase = tpt.Phase(cap, tpt.make_diffusion_ops(cap),
                      lambda x, y, z, t: 0.0, 1.0)
    zv = _z(mesh)
    dt = 0.5 * (L / n) ** 2
    t_end = 3.5 * dt
    st = DiffusionUnsteadyMono(phase, bc_b, tpt.Dirichlet(1.0), dt, (zv, zv),
                               "BE")
    st.solve(t_end, method="direct")
    mv = tmd.MovingDiffusionUnsteadyMono(phase, bc_b, tpt.Dirichlet(1.0), dt,
                                         (zv, zv), mesh, "BE")
    mv.solve(lambda x, y, z, t: sphere(x, y, z), 0.0, t_end, method="direct",
             p=8, s=2)
    sel = (cap.cell_types != 0).numpy()
    err = np.abs(mv.x[0].numpy() - st.x_omega.numpy())[sel].max()
    assert err < 2e-3, err

"""The port's advection-diffusion and Darcy solvers, small-cell remedies,
convergence norms, initializers and interpolants against the JAX package
(f64, CPU), and the physical gates of tests/test_advdiff_darcy.py inside
the port.  Capacities are carried across from JAX, so both sides see the
same geometry bit for bit."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import penguin_tpu as jpt
from penguin_tpu import utils as ju
from penguin_tpu.interpolation import (cubic_interpol as j_cubic,
                                       lin_interpol as j_lin,
                                       quad_interpol as j_quad)
from penguin_tpu.solvers import advdiff as jad, darcy as jdarcy
import penguin_tpu_torch as tpt
from penguin_tpu_torch import interpolation as ti, utils as tu
from penguin_tpu_torch.convert import (CAPACITY_FIELDS, capacity_from_numpy,
                                       capacity_to_numpy)
from penguin_tpu_torch.solvers import advdiff as tad, darcy as tdarcy
from torch_stefan_cases import one_thread  # noqa: F401  (autouse fixture)

CPU = "cpu"
KEYS = ("left", "right", "top", "bottom")


def _fields(jcap):
    out = {}
    for name in CAPACITY_FIELDS:
        v = getattr(jcap, name)
        out[name] = None if v is None else (
            tuple(np.asarray(a) for a in v) if isinstance(v, tuple)
            else np.asarray(v))
    return out


def _pair(body, n, size, p=8, s=2):
    """A JAX capacity and the port's copy of it."""
    jcap = jpt.compute_capacity(body, jpt.Mesh(n, size), p=p, s=s)
    return jcap, capacity_from_numpy(_fields(jcap), tpt.Mesh(n, size),
                                     device=CPU)


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _rel(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1.0)


# ---------------------------------------------------------------------------
# advection-diffusion
# ---------------------------------------------------------------------------

def _gaussian_1d(pkg, mod, cap, C, arr):
    """tests/test_advdiff_darcy.py:14 in either package: CN, direct.
    ``C``: the cell centroids' x (numpy)."""
    nx, lx, a, D, t0 = 128, 8.0, 1.0, 0.05, 0.25
    mesh = cap.mesh

    def exact(x, t):
        return np.exp(-((x - 2.0 - a * t) ** 2) / (4 * D * (t + t0))) \
            / np.sqrt(4 * np.pi * D * (t + t0))

    conv = pkg.make_convection_ops(cap, (arr(np.full(mesh.np_shape, a)),),
                                   arr(np.zeros(mesh.np_shape)))
    bcd = pkg.Dirichlet(0.0)
    phase = pkg.Phase(cap, conv, lambda x, y, z, t: 0.0, D)
    dt = 0.2 * (lx / nx) / a
    u0 = arr(exact(C, 0.0))
    solver = mod.AdvectionDiffusionUnsteadyMono(
        phase, pkg.BorderConditions({"bottom": bcd, "top": bcd}), bcd, dt,
        (u0, u0), "CN")
    solver.solve(1.0, method="direct")
    n_solves = int(np.ceil(1.0 / dt - 1e-12)) + 1
    ref = exact(C[:nx], n_solves * dt)
    return solver.x, ref


def test_advdiff_travelling_gaussian_1d():
    """The port matches JAX to 1e-9 and passes the gate: RMS error below
    2% of the peak after t = 1 on n = 128."""
    jcap, tcap = _pair(jpt.geometry.full_domain(1), (128,), (8.0,))
    C = np.asarray(jcap.C_om)[..., 0]
    jx, _ = _gaussian_1d(jpt, jad, jcap, C, jnp.asarray)
    tx, ref = _gaussian_1d(tpt, tad, tcap, C, _t)
    for a, b in zip(jx, tx):
        assert _rel(b, a) < 1e-9
    got = tx[0].numpy()[:128]
    err = np.sqrt(np.mean((got - ref) ** 2)) / np.abs(ref).max()
    assert err < 0.02, err


def test_advdiff_2d_solid_body_rotation():
    """tests/test_advdiff_darcy.py:161 at its own size (48²): mass within
    2%, the blob's angle within 0.05 rad, its radius within 0.05; the port
    matches JAX to 1e-9 (bicgstab, CN, 201 solves)."""
    n, L = 48, 2.0
    c = L / 2
    jcap, tcap = _pair(jpt.geometry.full_domain(2), (n, n), (L, L))
    C = np.asarray(jcap.C_om)
    x, y = C[..., 0], C[..., 1]
    V = np.asarray(jcap.V)
    ux, uy = -(y - c), (x - c)
    blob = np.exp(-(((x - c - 0.5) ** 2 + (y - c) ** 2) / 0.02))
    blob[V == 0] = 0.0
    dt, t_end = 2e-3, 0.4

    def run(pkg, mod, cap, arr):
        conv = pkg.make_convection_ops(cap, (arr(ux), arr(uy)),
                                       (arr(0 * ux), arr(0 * uy)))
        bc0 = pkg.Dirichlet(0.0)
        phase = pkg.Phase(cap, conv, lambda x, y, z, t: 0.0, 1e-4)
        s = mod.AdvectionDiffusionUnsteadyMono(
            phase, pkg.BorderConditions({k: bc0 for k in KEYS}), bc0, dt,
            (arr(blob), arr(np.zeros_like(blob))), "CN")
        s.solve(t_end, method="bicgstab")
        return s.x_omega

    jT = np.asarray(run(jpt, jad, jcap, jnp.asarray))
    tT = run(tpt, tad, tcap, _t).numpy()
    assert _rel(tT, jT) < 1e-9
    m0, m1 = float((blob * V).sum()), float((tT * V).sum())
    assert abs(m1 - m0) / m0 < 0.02, (m0, m1)
    cx = float((tT * V * x).sum() / m1) - c
    cy = float((tT * V * y).sum() / m1) - c
    expected = (int(np.ceil(t_end / dt - 1e-12)) + 1) * dt
    assert abs(np.arctan2(cy, cx) - expected) < 0.05
    assert abs(np.hypot(cx, cy) - 0.5) < 0.05


def test_advdiff_steady_and_diph_match_jax():
    """The steady mono class, and the steady and unsteady diph classes
    (CN, whose rhs subtracts only the convective part), against JAX."""
    n, L = 16, 4.0
    inside = jpt.geometry.circle((2.03, 1.97), 1.1)
    (jc1, tc1) = _pair(inside, (n, n), (L, L))
    (jc2, tc2) = _pair(lambda x, y: -inside(x, y), (n, n), (L, L))
    rng = np.random.default_rng(5)
    u = [0.3 * rng.standard_normal((n + 1, n + 1)) for _ in range(2)]
    ug = 0.1 * rng.standard_normal((n + 1, n + 1))

    def run(pkg, mod, c1, c2, arr):
        cv1 = pkg.make_convection_ops(c1, tuple(map(arr, u)), arr(ug))
        cv2 = pkg.make_convection_ops(c2, tuple(map(arr, u)), arr(ug))
        bc_b = pkg.BorderConditions({k: pkg.Dirichlet(1.0) for k in KEYS})
        out = []
        s = mod.AdvectionDiffusionSteadyMono(
            pkg.Phase(c2, cv2, lambda x, y, z: 1.0, 0.5), bc_b,
            pkg.Dirichlet(0.0))
        out.append(s.solve(method="direct"))
        ic = pkg.InterfaceConditions(pkg.ScalarJump(1.0, 0.5, 0.0),
                                     pkg.FluxJump(1.0, 2.0, 0.0))
        s = mod.AdvectionDiffusionSteadyDiph(
            pkg.Phase(c1, cv1, lambda x, y, z: 1.0, 1.0),
            pkg.Phase(c2, cv2, lambda x, y, z: 0.0, 2.0), bc_b, ic)
        out.append(s.solve(method="direct"))
        z = arr(np.zeros((n + 1, n + 1)))
        s = mod.AdvectionDiffusionUnsteadyDiph(
            pkg.Phase(c1, cv1, lambda x, y, z, t: 1.0, 1.0),
            pkg.Phase(c2, cv2, lambda x, y, z, t: 0.0, 2.0), bc_b, ic, 0.01,
            (z, z, z, z), "CN")
        out.append(s.solve(0.03, method="direct"))
        out.append(s.states[0])
        return out

    jout = run(jpt, jad, jc1, jc2, jnp.asarray)
    tout = run(tpt, tad, tc1, tc2, _t)
    for k, (ja_, ta_) in enumerate(zip(jout, tout)):
        for i, (a, b) in enumerate(zip(ja_, ta_)):
            assert _rel(b, a) < 1e-9, (k, i)


# ---------------------------------------------------------------------------
# Darcy
# ---------------------------------------------------------------------------

def _darcy_case(pkg):
    lin = pkg.Dirichlet(lambda x, y, z: 1.0 - x)
    return pkg.BorderConditions({k: lin for k in KEYS})


def test_darcy_linear_pressure():
    """tests/test_advdiff_darcy.py:68: p linear in x gives u_x = 1 on every
    wet face; pressure and velocity match JAX."""
    jcap, tcap = _pair(jpt.geometry.full_domain(2), (32, 8), (1.0, 0.25))
    out = []
    for pkg, mod, cap in ((jpt, jdarcy, jcap), (tpt, tdarcy, tcap)):
        phase = pkg.Phase(cap, pkg.make_diffusion_ops(cap),
                          lambda x, y, z: 0.0, 1.0)
        s = mod.DarcyFlow(phase, _darcy_case(pkg), pkg.Dirichlet(0.0))
        s.solve(method="direct")
        out.append((s.x, mod.solve_darcy_velocity(s, phase)))
    (jx, ju_), (tx, tu_) = out
    for a, b in zip(jx, tx):
        assert _rel(b, a) < 1e-9
    for a, b in zip(ju_, tu_):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-9, equal_nan=True)
    W = tcap.W[0].numpy()
    np.testing.assert_allclose(tu_[0].numpy()[W > 0], 1.0, atol=1e-9)


def test_darcy_unsteady_matches_jax():
    """DarcyFlowUnsteady, BE, 10 steps, against JAX."""
    jcap, tcap = _pair(jpt.geometry.full_domain(2), (16, 4), (1.0, 0.25))
    out = []
    for pkg, mod, cap, arr in ((jpt, jdarcy, jcap, jnp.asarray),
                               (tpt, tdarcy, tcap, _t)):
        phase = pkg.Phase(cap, pkg.make_diffusion_ops(cap),
                          lambda x, y, z, t: 0.0, 1.0)
        z = arr(np.zeros((17, 5)))
        s = mod.DarcyFlowUnsteady(phase, _darcy_case(pkg), pkg.Dirichlet(0.0),
                                  2e-3, (z, z), "BE")
        out.append(s.solve(0.02, method="direct"))
    for a, b in zip(*out):
        assert _rel(b, a) < 1e-9


# ---------------------------------------------------------------------------
# small cells, moment-consistent W
# ---------------------------------------------------------------------------

def _compare_caps(jcap, tcap, tol=1e-13):
    jf, tf = _fields(jcap), capacity_to_numpy(tcap)
    for name in ("V", "Gamma", "cell_types", "C_om", "A", "B", "W"):
        for a, b in zip(*((jf[name], tf[name]) if isinstance(jf[name], tuple)
                          else ((jf[name],), (tf[name],)))):
            np.testing.assert_allclose(b, a, rtol=0,
                                       atol=tol * max(np.abs(a).max(), 1.0),
                                       err_msg=name)


@pytest.mark.parametrize("eps", [0.02, 0.05])
def test_small_cell_remedies_match_jax(eps):
    """The sliver halfspace of tests/test_small_cells.py: the merge picks
    the same targets, conserves what it moves, and both remedies give JAX's
    capacity."""
    n = 20
    jcap, tcap = _pair(jpt.geometry.halfspace(0, 0.725 + eps / n), (n, n),
                       (1.0, 1.0), p=6, s=2)
    tol = 1.5e-1 * float(np.asarray(jcap.V).max())
    jm, jn = ju.clamp_merge_small_cells(jcap, tol)
    tm, tn = tu.clamp_merge_small_cells(tcap, tol)
    assert int(tn) == int(jn) > 0
    _compare_caps(jm, tm)
    np.testing.assert_allclose(float(tm.V.sum()), float(tcap.V.sum()),
                               rtol=1e-12)
    _compare_caps(ju.remove_small_volumes(jcap, tol),
                  tu.remove_small_volumes(tcap, tol))


def test_clamp_merge_ties_and_grazing_circle():
    """A grazing circle, whose slivers sit in corners with two candidate
    neighbours; ties go to the first direction in both packages."""
    n = 24
    jcap, tcap = _pair(jpt.geometry.circle((2.0 + 1e-3, 2.0), 1.0 + 0.51 / 6),
                       (n, n), (4.0, 4.0))
    V = np.asarray(jcap.V)
    tol = 0.1 * V.max()
    assert ((V > 0) & (V < tol)).any()
    jm, jn = ju.clamp_merge_small_cells(jcap, tol)
    tm, tn = tu.clamp_merge_small_cells(tcap, tol)
    assert int(tn) == int(jn)
    _compare_caps(jm, tm)


def test_moment_consistent_w_matches_jax():
    """moment_consistent_W on the inclined wall of tests/test_moment_w.py
    and volume_redefinition in 1D, against JAX."""
    nrm = 1.0 / np.hypot(0.4, 1.0)
    jcap, tcap = _pair(lambda x, y: -(y - 0.3 - 0.4 * x) * nrm, (24, 24),
                       (1.0, 1.0), p=6, s=2)
    _compare_caps(ju.moment_consistent_W(jcap), tu.moment_consistent_W(tcap))
    jc1, tc1 = _pair(lambda x: 0.37 - x, (16,), (1.0,), p=4, s=1)
    j = ju.volume_redefinition(jc1, jpt.make_diffusion_ops(jc1))
    t = tu.volume_redefinition(tc1, tpt.make_diffusion_ops(tc1))
    for a, b in ((j.V, t.V), (j.W[0], t.W[0])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-12)
    _compare_caps(ju.moment_consistent_W(jc1), tu.moment_consistent_W(tc1))


# ---------------------------------------------------------------------------
# convergence norms, initializers, time step, interpolants
# ---------------------------------------------------------------------------

class _Solved:
    def __init__(self, x):
        self.x = x

    @property
    def x_omega(self):
        return self.x[0]

    def phase_view(self, i):
        return _Solved((self.x[2 * i],))


def test_convergence_norms_match_jax():
    n = 20
    inside = jpt.geometry.circle((2.0, 2.0), 1.0)
    jc1, tc1 = _pair(inside, (n, n), (4.0, 4.0))
    jc2, tc2 = _pair(lambda x, y: -inside(x, y), (n, n), (4.0, 4.0))
    rng = np.random.default_rng(3)
    u1, u2 = rng.standard_normal((2, n + 1, n + 1))
    e = rng.standard_normal((n + 1, n + 1))
    mask = rng.random((n + 1, n + 1)) < 0.5
    for p in (1, 2, np.inf):
        assert np.isclose(tpt.lp_norm(_t(e), torch.as_tensor(mask), p, tc1),
                          jpt.lp_norm(jnp.asarray(e), jnp.asarray(mask), p,
                                      jc1), rtol=1e-13, atol=0)

    def ana(x, y):
        return np.sin(x) * y

    for rel in (False, True):
        j = jpt.check_convergence(ana, _Solved((jnp.asarray(u1),)), jc1, 2,
                                  rel, verbose=False)
        t = tpt.check_convergence(ana, _Solved((_t(u1),)), tc1, 2, rel,
                                  verbose=False)
        np.testing.assert_allclose(t[:2], np.asarray(j[:2]), rtol=1e-13)
        np.testing.assert_allclose(t[2:], j[2:], rtol=1e-13)
    j = jpt.check_convergence_diph(
        ana, ana, _Solved((jnp.asarray(u1), None, jnp.asarray(u2))), jc1,
        jc2, 2, False, verbose=False)
    t = tpt.check_convergence_diph(
        ana, ana, _Solved((_t(u1), None, _t(u2))), tc1, tc2, 2, False,
        verbose=False)
    for a, b in zip(j[2:], t[2:]):
        np.testing.assert_allclose(b, a, rtol=1e-13)


def test_initializers_and_adapt_timestep_match_jax():
    jm, tm = jpt.Mesh((16, 12), (1.0, 2.0)), tpt.Mesh((16, 12), (1.0, 2.0))
    pairs = [
        (ju.initialize_temperature_uniform(jm, 2.5),
         tu.initialize_temperature_uniform(tm, 2.5, device=CPU)),
        (ju.initialize_temperature_square(jm, (0.5, 1.0), 0.2, 1.0, 0.1),
         tu.initialize_temperature_square(tm, (0.5, 1.0), 0.2, 1.0, 0.1,
                                          device=CPU)),
        (ju.initialize_temperature_circle(jm, (0.5, 1.0), 0.3, 1.0),
         tu.initialize_temperature_circle(tm, (0.5, 1.0), 0.3, 1.0,
                                          device=CPU)),
        (ju.initialize_temperature_function(jm, lambda x, y: x * y),
         tu.initialize_temperature_function(tm, lambda x, y: x * y,
                                            device=CPU)),
        (ju.initialize_rotating_velocity_field(jm, 2.0),
         tu.initialize_rotating_velocity_field(tm, 2.0, device=CPU)),
        (ju.initialize_poiseuille_velocity_field(jm),
         tu.initialize_poiseuille_velocity_field(tm, device=CPU)),
        (ju.initialize_radial_velocity_field(jm, (0.5, 1.0)),
         tu.initialize_radial_velocity_field(tm, (0.5, 1.0), device=CPU)),
    ]
    for jpair, tpair in pairs:
        for a, b in zip(jpair, tpair):
            assert b.device.type == "cpu" and b.dtype == torch.float64
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for v in ([0.5], [0.0], [30.0]):
        want = ju.adapt_timestep(np.asarray(v), jm, 0.5, 1e-2, 1e-5, 1.0)
        assert tu.adapt_timestep(_t(v), tm, 0.5, 1e-2, 1e-5, 1.0) == want
        assert tu.adapt_timestep(np.asarray(v), tm, 0.5, 1e-2, 1e-5,
                                 1.0) == want


@pytest.mark.parametrize("name", ["lin", "quad", "cubic"])
def test_interpolants_match_jax(name):
    """Seeded samples, queries inside and outside the range; and the gate
    of tests/test_periphery.py:31 (quadratic exact on x²)."""
    jf = {"lin": j_lin, "quad": j_quad, "cubic": j_cubic}[name]
    tf = {"lin": ti.lin_interpol, "quad": ti.quad_interpol,
          "cubic": ti.cubic_interpol}[name]
    rng = np.random.default_rng(11)
    xs = np.sort(rng.random(17)) * 3.0
    ys = rng.standard_normal(17)
    xq = rng.random(40) * 3.4 - 0.2
    want = np.asarray(jf(xs, ys, jnp.asarray(xq)))
    got = tf(_t(xs), _t(ys), _t(xq))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    # numpy inputs follow the explicit device
    np.testing.assert_allclose(tf(xs, ys, xq, device=CPU).numpy(), want,
                               rtol=0, atol=1e-12)
    g = np.linspace(0, 1, 11)
    q = np.asarray([0.05, 0.33, 0.77])
    tol = {"lin": 5e-3, "quad": 1e-10, "cubic": 5e-3}[name]
    np.testing.assert_allclose(tf(g, g ** 2, q, device=CPU).numpy(), q ** 2,
                               atol=tol)

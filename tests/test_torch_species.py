"""The port's species (concentration) and binary-alloy solvers against the
JAX package on the CPU in f64, and the gates of
tests/test_concentration_binary.py on the port alone.

Both systems on one slab of an interface moving through a 1D mesh (their
apply and rhs on seeded states, 1e-12 of scale), whole moving-interface
runs with the dense direct solve (fields to 1e-9 of scale), and the static
interface gates.  The non-direct method is the port's unpreconditioned
BiCGStab, held against its own direct solve: the JAX package's
``jax.scipy`` BiCGStab returns NaN on these systems."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import penguin_tpu as jpt
from penguin_tpu.assembly import border_info as j_border_info
from penguin_tpu.capacity import compute_capacity_spacetime as j_slab
from penguin_tpu.solvers import binary as jb
from penguin_tpu.solvers import concentration as jc
import penguin_tpu_torch as tpt
from penguin_tpu_torch.assembly import border_info as t_border_info
from penguin_tpu_torch.capacity import compute_capacity_spacetime as t_slab
from penguin_tpu_torch.solvers import binary as tb
from penguin_tpu_torch.solvers import concentration as tc

from torch_stefan_cases import one_thread  # noqa: F401  (autouse fixture)

NX, LX, DT = 24, 8.0, 2e-3
TM, M_LIQ, K_PART = 0.1, -0.5, 0.6


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _close(got, want, tol):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w, dtype=np.float64)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1.0), \
            np.abs(g - w).max()


def _body(x, t):
    """Fluid x < 4.1 + 5 t: the interface crosses a cell within the run."""
    return x - 4.1 - 5.0 * t


def _body_c(x, t):
    return -_body(x, t)


def _source(x, y, z, t):
    return 0.3 * x * t


def _problem(pkg):
    ph = pkg.Phase(None, None, _source, 1.0)
    ph2 = pkg.Phase(None, None, lambda x, y, z, t: 0.0, 2.0)
    return dict(
        mesh=pkg.Mesh((NX,), (LX,), (0.0,)), ph=ph, ph2=ph2,
        bc=pkg.BorderConditions({"bottom": pkg.Dirichlet(0.0),
                                 "top": pkg.Dirichlet(1.0)}),
        bcT=pkg.BorderConditions({"bottom": pkg.Dirichlet(-0.5),
                                  "top": pkg.Dirichlet(0.5)}),
        ic=pkg.InterfaceConditions(pkg.ScalarJump(1.0, 1.0, 0.5),
                                   pkg.FluxJump(1.0, 1.0, 0.0)))


@pytest.mark.parametrize("scheme", ["BE", "CN"])
def test_systems_match_jax(scheme):
    """apply and rhs of both systems on the slab [0.01, 0.01 + dt], with
    seeded states and borders restricted to each phase."""
    t = 0.01
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, NX + 1))
    jp, tp = _problem(jpt), _problem(tpt)
    jcaps = [j_slab(b, jp["mesh"], t, t + DT, p=6, s=1)
             for b in (_body, _body_c)]
    tcaps = [t_slab(b, tp["mesh"], t, t + DT, p=6, s=1, device="cpu")
             for b in (_body, _body_c)]
    jbd = [j_border_info(jp["mesh"], jp["bc"],
                         phase_mask=c.cell_types[..., 0] != 0) for c in jcaps]
    tbd = [t_border_info(tp["mesh"], tp["bc"],
                         phase_mask=c.cell_types[..., 0] != 0, device="cpu")
           for c in tcaps]
    ja, jr = jc.build_concentration_system(
        *jcaps, 1.0, 2.0, _source, jp["ph2"].source, 0.5, *jbd, t, DT, scheme)
    ta, tr = tc.build_concentration_system(
        *tcaps, 1.0, 2.0, _source, tp["ph2"].source, 0.5, *tbd, t, DT, scheme)
    jx, tx = tuple(jnp.asarray(a) for a in x[:4]), tuple(_t(a) for a in x[:4])
    _close(ta(tx), ja(jx), 1e-12)
    _close(tr(tx), jr(jx), 1e-12)
    args = (1.0, 2.0, 1.5, 0.5, _source, _source, _source, _source,
            TM, M_LIQ, K_PART, (1.0, 0.7))
    ja, jr = jb.build_binary_system(*jcaps, *jcaps, *args,
                                    tuple(jbd) * 2, t, DT, scheme)
    ta, tr = tb.build_binary_system(*tcaps, *tcaps, *args,
                                    tuple(tbd) * 2, t, DT, scheme)
    jx, tx = tuple(jnp.asarray(a) for a in x), tuple(_t(a) for a in x)
    _close(ta(tx), ja(jx), 1e-12)
    _close(tr(tx), jr(jx), 1e-12)


def _runs(pkg, cmod, bmod, arr, method="direct", nx=NX, t_end=0.01):
    p = _problem(pkg)
    mesh = pkg.Mesh((nx,), (LX,), (0.0,))
    z, o = np.zeros(nx + 1), np.ones(nx + 1)
    c = cmod.DiffusionUnsteadyConcentration(
        p["ph"], p["ph2"], p["bc"], p["ic"], DT,
        tuple(arr(a) for a in (z, z, o, o)), mesh)
    c.solve(_body, _body_c, 0.0, t_end, method=method)
    b = bmod.DiffusionUnsteadyBinary(
        p["ph"], p["ph2"], p["ph"], p["ph2"], p["bcT"], p["bc"], DT,
        tuple(arr(z) for _ in range(8)), mesh, "BE", Tm=TM, m_liq=M_LIQ,
        k_part=K_PART)
    b.solve(_body, _body_c, 0.0, t_end, method=method)
    return c, b


def test_moving_runs_match_jax():
    """6 slabs of each solver with the interface crossing a cell: every
    field to 1e-9 of scale."""
    jcon, jbin = _runs(jpt, jc, jb, jnp.asarray)
    tcon, tbin = _runs(tpt, tc, tb, _t)
    _close(tcon.x, jcon.x, 1e-9)
    _close(tbin.x, jbin.x, 1e-9)
    assert all(torch.isfinite(a).all() for a in tcon.x + tbin.x)


def test_port_bicgstab_matches_direct():
    """The non-direct method against the direct solve on the moving runs,
    on the cells each phase holds in the last slab: a cell a phase never
    reaches has no equation, and keeps its start value under BiCGStab where
    the direct solve's identity row gives it 0."""
    dcon, dbin = _runs(tpt, tc, tb, _t)
    kcon, kbin = _runs(tpt, tc, tb, _t, method="bicgstab")
    mesh = tpt.Mesh((NX,), (LX,), (0.0,))
    live = [t_slab(b, mesh, 0.01, 0.01 + DT, p=6, s=1, device="cpu")
            .V[..., 0] > 0 for b in (_body, _body_c)]
    for d, k, phases in ((dcon, kcon, (0, 0, 1, 1)),
                         (dbin, kbin, (0, 0, 1, 1, 0, 0, 1, 1))):
        for a, b, ph in zip(d.x, k.x, phases):
            _close(torch.where(live[ph], b, 0.0),
                   torch.where(live[ph], a, 0.0), 1e-7)


def test_port_concentration_static_interface():
    """tests/test_concentration_binary.py's static-interface gate: the
    interface rows pin C1γ = C2γ = Cm and each phase relaxes between its
    border value and Cm."""
    mesh = tpt.Mesh((48,), (8.0,), (0.0,))
    ph = tpt.Phase(None, None, lambda x, y, z, t: 0.0, 1.0)
    bc_b = tpt.BorderConditions({"bottom": tpt.Dirichlet(0.0),
                                 "top": tpt.Dirichlet(1.0)})
    ic = tpt.InterfaceConditions(tpt.ScalarJump(1.0, 1.0, 0.5),
                                 tpt.FluxJump(1.0, 1.0, 0.0))
    z = torch.zeros(mesh.np_shape, dtype=torch.float64)
    s = tc.DiffusionUnsteadyConcentration(ph, ph, bc_b, ic, DT,
                                          (z, z, z + 1, z + 1), mesh)
    s.solve(lambda x, t: x - 4.0, lambda x, t: -(x - 4.0), 0.0, 0.05,
            method="direct")
    C1, C1g, C2, C2g = (a.numpy() for a in s.x)
    assert np.isfinite(C1).all() and np.isfinite(C2).all()
    np.testing.assert_allclose(C1g, 0.5, atol=1e-10)
    np.testing.assert_allclose(C2g, 0.5, atol=1e-10)
    assert C1[1:24].min() > -1e-8 and C1[1:24].max() < 0.5 + 1e-8
    assert C2[25:47].max() < 1.0 + 1e-8 and C2[25:47].min() > 0.5 - 1e-8


def test_port_binary_static_interface():
    """tests/test_concentration_binary.py's binary gate: the liquidus,
    continuity and partition closures hold on the cut cells."""
    mesh = tpt.Mesh((40,), (8.0,), (0.0,))
    cap = tpt.compute_capacity(tpt.geometry.halfspace(0, 4.0), mesh,
                               device="cpu")
    mk = lambda: tpt.Phase(None, None, lambda x, y, z, t: 0.0, 1.0)  # noqa
    bc_T = tpt.BorderConditions({"bottom": tpt.Dirichlet(-0.5),
                                 "top": tpt.Dirichlet(0.5)})
    bc_C = tpt.BorderConditions({"bottom": tpt.Dirichlet(0.2),
                                 "top": tpt.Dirichlet(0.8)})
    z = torch.zeros(mesh.np_shape, dtype=torch.float64)
    s = tb.DiffusionUnsteadyBinary(mk(), mk(), mk(), mk(), bc_T, bc_C, DT,
                                   (z,) * 8, mesh, "BE", Tm=TM, m_liq=M_LIQ,
                                   k_part=K_PART)
    s.solve(lambda x, t: x - 4.0, lambda x, t: -(x - 4.0), 0.0, 0.02,
            method="direct")
    T1w, T1g, T2w, T2g, C1w, C1g, C2w, C2g = (a.numpy() for a in s.x)
    for a in (T1w, T2w, C1w, C2w):
        assert np.isfinite(a).all()
    sel = cap.cell_types.numpy() == -1
    assert sel.any()
    np.testing.assert_allclose(T1g[sel], TM + M_LIQ * C1g[sel], atol=1e-8)
    np.testing.assert_allclose(T2g[sel], T1g[sel], atol=1e-8)
    np.testing.assert_allclose(C2g[sel], K_PART * C1g[sel], atol=1e-8)

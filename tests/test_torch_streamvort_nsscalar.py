"""The port's StreamVorticity and NavierStokesScalarCoupler against the
JAX package on the CPU in f64 (the port on the JAX capacities), then the
JAX package's gates (tests/test_streamvort_nsscalar.py) on the port.

Parity: three CN stream-vorticity steps on a disk at 16², two coupled
steps of the Boussinesq cavity at 8² with each coupling (passive, Picard
and the monolithic Newton step with its ``jacfwd`` through the scalar
assembly), and two ``run_fast`` steps with ``pgmres``: 1e-9 of scale,
with equal Krylov counts."""

import numpy as np
import pytest
import torch

import penguin_tpu as jpt
import penguin_tpu_torch as tpt
from penguin_tpu.solvers import ns_scalar as jsc
from penguin_tpu.solvers import streamvort as jsv
from penguin_tpu_torch.solvers import ns_scalar as tsc
from penguin_tpu_torch.solvers import streamvort as tsv
from penguin_tpu_torch.solvers.navierstokes import NavierStokesMono
from penguin_tpu_torch.solvers.ns_scalar import (
    MonolithicCoupling,
    NavierStokesScalarCoupler,
    PassiveCoupling,
    PicardCoupling,
)
from penguin_tpu_torch.solvers.stokes import PinPressureGauge
from penguin_tpu_torch.solvers.streamvort import StreamVorticity

import torch_ns_cases as NS
import torch_stokes_cases as C
from torch_stefan_cases import one_thread  # noqa: F401  (autouse fixture)


def _arr(pkg, a):
    if C.is_torch(pkg):
        return torch.as_tensor(a)
    import jax.numpy as jnp
    return jnp.asarray(a)


def _stream_vorticity(pkg, carry=None):
    mesh = pkg.Mesh((16, 16), (1.0, 1.0), (0.0, 0.0))
    cap = pkg.compute_capacity(pkg.geometry.circle((0.5, 0.5), 0.4), mesh,
                               p=4, s=1, **C.kw(pkg))
    if carry is not None:
        cap = C.carry_capacity(carry, mesh)
    Cc = C._np(cap.C_om)
    w0 = np.exp(-((Cc[..., 0] - 0.45) ** 2 + (Cc[..., 1] - 0.5) ** 2)
                / 0.02) * (C._np(cap.V) > 0)
    w0 = _arr(pkg, w0)
    bords = C.walls(pkg, keys=("left", "right", "top", "bottom"))
    mod = tsv if C.is_torch(pkg) else jsv
    return mod.StreamVorticity(cap, 0.05, 1e-2, pkg.make_diffusion_ops(cap),
                               bc_stream_border=bords,
                               bc_vorticity_border=bords,
                               omega0=(w0, 0 * w0))


def test_streamvorticity_matches_jax():
    a = _stream_vorticity(jpt)
    b = _stream_vorticity(tpt, carry=a.capacity)
    a.run(3, scheme="CN")
    b.run(3, scheme="CN")
    C.close(b.omega + b.psi + b.velocity, a.omega + a.psi + a.velocity,
            1e-9)
    assert b.time == a.time and len(b.states) == len(a.states) == 4


def _coupler(pkg, strategy, n=10, carry=None, T_ref=0.5):
    """The Boussinesq cavity of tests/test_streamvort_nsscalar.py:389 (hot
    floor, cold lid, adiabatic sides)."""
    fl = C.fluid(pkg, None, n, L=1.0, mu=1e-2)
    if carry is not None:
        fl = C.carry_fluid(carry, fl)
    bc_wall = C.walls(pkg)
    bc_T = pkg.BorderConditions({
        "bottom": pkg.Dirichlet(1.0), "top": pkg.Dirichlet(0.0),
        "left": pkg.Neumann(0.0), "right": pkg.Neumann(0.0)})
    Cc = C._np(fl.capacity_p.C_om)
    T0 = _arr(pkg, np.clip(1.0 - Cc[..., 0], 0.0, 1.0)
              * (C._np(fl.capacity_p.V) > 0))
    mom = NS.ns_class(pkg)(fl, (bc_wall, bc_wall), None, pkg.Dirichlet(0.0))
    mod = tsc if C.is_torch(pkg) else jsc
    return mod.NavierStokesScalarCoupler(
        mom, fl.capacity_p, fl.operator_p, kappa=1e-2,
        scalar_source=lambda x, y, z, t: 0.0, bc_scalar=bc_T,
        bc_scalar_cut=pkg.Dirichlet(0.0), strategy=strategy, beta=10.0,
        gravity=(0.0, -1.0), T_ref=T_ref, T0=(T0, T0))


@pytest.mark.parametrize("kind", ["passive", "picard", "monolithic"])
def test_coupler_steps_match_jax(kind):
    """Two Picard-coupled steps (the second with the AB2 convection), one
    passive step and one monolithic Newton step: velocity, pressure and
    temperature to 1e-9 of scale."""
    def strategy(mod):
        return {"passive": lambda: mod.PassiveCoupling(),
                "picard": lambda: mod.PicardCoupling(tol_T=0.0, tol_U=0.0,
                                                     maxiter=2),
                "monolithic": lambda: mod.MonolithicCoupling(
                    tol=1e-11, maxiter=4)}[kind]()

    cj = _coupler(jpt, strategy(jsc), n=8)
    ct = _coupler(tpt, strategy(tsc), n=8, carry=cj.momentum.fluid)
    steps = 2 if kind == "picard" else 1
    for c in (cj, ct):
        for _ in range(steps):
            c.step(0.01)
    C.close(ct.x + ct.T, cj.x + cj.T, 1e-9)
    assert ct.time == cj.time and len(ct.states) == steps
    if kind != "monolithic":
        C.close(ct.conv_prev, cj.conv_prev, 1e-9)


def test_run_fast_matches_jax():
    """Two ``run_fast`` steps with two Picard sweeps of ``pgmres`` (the
    block-Schur M on momentum, Jacobi on the scalar): 1e-9 of scale with
    the same per-step Krylov counts."""
    cj = _coupler(jpt, jsc.PicardCoupling(maxiter=2), n=8)
    ct = _coupler(tpt, tsc.PicardCoupling(maxiter=2), n=8,
                  carry=cj.momentum.fluid)
    for c in (cj, ct):
        c.run_fast(0.01, 0.02, picard_iters=2, tol=1e-12, method="pgmres")
    C.close(ct.x + ct.T, cj.x + cj.T, 1e-9)
    for name in ("krylov_iters_u", "krylov_iters_T"):
        np.testing.assert_array_equal(getattr(ct, name), getattr(cj, name))
    for name in ("krylov_relres_u", "krylov_relres_T"):
        assert (getattr(ct, name) <= 1e-12).all()
        assert (getattr(cj, name) <= 1e-12).all()
    assert ct.time == cj.time


# ---------------------------------------------------------------------------
# the JAX package's gates on the port
# ---------------------------------------------------------------------------

def test_streamvorticity_gaussian_decay():
    n = 24
    mesh = tpt.Mesh((n, n), (1.0, 1.0), (0.0, 0.0))
    cap = tpt.compute_capacity(tpt.geometry.full_domain(2), mesh, p=4, s=1,
                               device="cpu")
    ops = tpt.make_diffusion_ops(cap)
    z = torch.zeros(mesh.np_shape, dtype=torch.float64)
    Cc = cap.C_om.numpy()
    w0 = np.exp(-((Cc[..., 0] - 0.5) ** 2 + (Cc[..., 1] - 0.5) ** 2) / 0.01)
    w0[cap.V.numpy() == 0] = 0.0
    w0 = torch.as_tensor(w0)
    bords = C.walls(tpt, keys=("left", "right", "top", "bottom"))
    sv = StreamVorticity(cap, 0.05, 1e-3, ops, bc_stream_border=bords,
                         bc_vorticity_border=bords, omega0=(w0, z))
    e0 = float((w0 ** 2 * cap.V).sum())
    sv.run(4)
    assert torch.isfinite(sv.omega[0]).all()
    e1 = float((sv.omega[0] ** 2 * cap.V).sum())
    assert 0 < e1 < e0
    assert sv.velocity[0].abs().max().item() > 0


def _heated_cavity(n, strategy):
    fl = C.fluid(tpt, None, n, L=1.0, mu=1e-2)
    bc_wall = C.walls(tpt)
    mom = NavierStokesMono(fl, (bc_wall, bc_wall), PinPressureGauge(),
                           tpt.Dirichlet(0.0))
    bc_T = tpt.BorderConditions({"left": tpt.Dirichlet(1.0),
                                 "right": tpt.Dirichlet(0.0)})
    Cc = fl.capacity_p.C_om.numpy()
    T0w = torch.as_tensor(np.clip(1.0 - Cc[..., 0], 0.0, 1.0)
                          * (fl.capacity_p.V.numpy() > 0))
    return NavierStokesScalarCoupler(
        mom, fl.capacity_p, fl.operator_p, kappa=1e-2,
        scalar_source=lambda x, y, z, t: 0.0,
        bc_scalar=bc_T, bc_scalar_cut=tpt.Dirichlet(0.0),
        strategy=strategy, beta=10.0, gravity=(0.0, -1.0),
        T_ref=0.0, T0=(T0w, T0w))


@pytest.mark.slow
def test_buoyant_cavity_coupling():
    n = 16
    coupler = _heated_cavity(n, PassiveCoupling())
    coupler.run(dt=0.01, t_end=0.05)
    uy = coupler.x[2].numpy()
    T = coupler.T[0].numpy()
    assert np.isfinite(uy).all() and np.isfinite(T).all()
    left_col = uy[1:4, 1:n - 1].mean()
    right_col = uy[n - 4:n - 1, 1:n - 1].mean()
    assert left_col > 0 and right_col < 0, (left_col, right_col)
    assert np.abs(uy).max() > 1e-4


@pytest.mark.slow
def test_monolithic_coupling_matches_picard():
    n = 10
    c1 = _heated_cavity(n, PicardCoupling(tol_T=1e-12, tol_U=1e-12,
                                          maxiter=30))
    c1.step(0.01)
    c2 = _heated_cavity(n, MonolithicCoupling(tol=1e-11, maxiter=10))
    c2.step(0.01)
    for a, b in zip(c1.x, c2.x):
        assert (a - b).abs().max().item() < 5e-3
    assert (c1.T[0] - c2.T[0]).abs().max().item() < 5e-3


def test_run_fast_matches_step():
    """The Krylov fast path (block-Schur BiCGStab on momentum) reproduces
    the Picard stepper's dense solves to solver precision."""
    def make():
        return _coupler(tpt, PicardCoupling(tol_T=0.0, tol_U=0.0, maxiter=2))

    dt = 0.01
    a = make()
    a.step(dt, scheme="BE")
    a.step(dt, scheme="BE")
    b = make()
    b.run_fast(dt, 2 * dt, scheme="BE", picard_iters=2, tol=1e-13)
    for xa, xb in zip(a.x, b.x):
        assert (xa - xb).abs().max().item() < 1e-8
    for Ta, Tb in zip(a.T, b.T):
        assert (Ta - Tb).abs().max().item() < 1e-8
    assert b.time == a.time


@pytest.mark.slow
def test_heated_cavity_run_fast_matches_jax():
    """benchmarks/differential_cavity.py at its 64² (Ra = 1e3, Pr = 0.71),
    two ``run_fast`` steps of two Picard sweeps by pgmres: the momentum
    pgmres stops at its cap (240 iterations for maxiter 200, restart 60)
    with relres ~5e-4 in both packages, with equal counts and states to
    1e-9 of scale."""
    Ra, Pr, n = 1.0e3, 0.71, 64
    nu = float(np.sqrt(Pr / Ra))

    def make(pkg, carry=None):
        fl = C.fluid(pkg, None, n, L=1.0, mu=nu)
        if carry is not None:
            fl = C.carry_fluid(carry, fl)
        mom = NS.ns_class(pkg)(fl, (C.walls(pkg), C.walls(pkg)), None,
                               pkg.Dirichlet(0.0))
        bc_T = pkg.BorderConditions({
            "bottom": pkg.Dirichlet(0.5), "top": pkg.Dirichlet(-0.5),
            "left": pkg.Neumann(0.0), "right": pkg.Neumann(0.0)})
        Cc = C._np(fl.capacity_p.C_om)
        T0 = _arr(pkg, (0.5 - np.clip(Cc[..., 0], 0, 1))
                  * (C._np(fl.capacity_p.V) > 0))
        mod = tsc if C.is_torch(pkg) else jsc
        return mod.NavierStokesScalarCoupler(
            mom, fl.capacity_p, pkg.make_diffusion_ops(fl.capacity_p),
            kappa=nu / Pr, scalar_source=lambda x, y, z, t: 0.0,
            bc_scalar=bc_T, bc_scalar_cut=pkg.Dirichlet(0.0),
            strategy=mod.PicardCoupling(tol_T=1e-6, tol_U=1e-6, maxiter=8),
            beta=1.0, gravity=(0.0, -1.0), T_ref=0.0, T0=(T0, T0))

    cj = make(jpt)
    ct = make(tpt, carry=cj.momentum.fluid)
    for c in (cj, ct):
        c.run_fast(0.05, 0.1, scheme="BE", picard_iters=2, tol=1e-6,
                   method="pgmres")
    np.testing.assert_array_equal(ct.krylov_iters_u, cj.krylov_iters_u)
    np.testing.assert_array_equal(ct.krylov_iters_T, cj.krylov_iters_T)
    assert (ct.krylov_iters_u == 240).all()
    assert (ct.krylov_relres_u > 1e-6).all()
    C.close(ct.x + ct.T, cj.x + cj.T, 1e-9)

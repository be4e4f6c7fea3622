"""The port's Krylov and dense solvers against the JAX package's
(``penguin_tpu.linsolve``), on seeded dense systems (f64, CPU unless
stated), plus the regressions of tests/test_linsolve.py mirrored in the
port and the chunked loops held against step-by-step loops."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from penguin_tpu import linsolve as jl
from penguin_tpu_torch import linsolve as tl
from torch_stefan_cases import one_thread  # noqa: F401  (autouse fixture)

RTOL = 1e-10


def _spd(n, seed):
    A = np.random.default_rng(seed).standard_normal((n, n))
    return A @ A.T + n * np.eye(n)


def _nonsym(n, seed, diag=3.0, scale=0.5):
    rng = np.random.default_rng(seed)
    return diag * np.eye(n) + scale * rng.standard_normal((n, n)) / np.sqrt(n)


def _rhs(A, seed):
    xt = np.random.default_rng(seed).standard_normal(A.shape[0])
    return xt, A @ xt


def _ops(A):
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    return (lambda v: Aj @ v), (lambda v: At @ v)


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _both(name, A, b, x0=None, jkw=None, tkw=None, **kw):
    """Run ``name`` in both packages on the same system."""
    ja, ta = _ops(A)
    x0 = np.zeros_like(b) if x0 is None else x0
    xj, kj, rj = getattr(jl, name)(ja, jnp.asarray(b), jnp.asarray(x0),
                                   **kw, **(jkw or {}))
    xt, kt, rt = getattr(tl, name)(ta, torch.as_tensor(b),
                                   torch.as_tensor(x0), **kw, **(tkw or {}))
    return (xj, int(kj), float(rj)), (xt, int(kt), float(rt))


@pytest.mark.parametrize("name,A,kw", [
    ("pcg", _spd(120, 0), dict(tol=1e-12, maxiter=500)),
    ("pbicgstab", _nonsym(120, 2), dict(tol=1e-12, maxiter=500)),
    ("fgmres", _nonsym(90, 5, scale=0.4), dict(tol=1e-12, maxiter=400,
                                               restart=30)),
], ids=["pcg", "pbicgstab", "fgmres"])
def test_krylov_matches_jax(name, A, kw):
    """Iterate to 1e-10 relative and iteration counts equal; pcg and fgmres
    with the Jacobi preconditioner (an array for pcg, a callable for
    fgmres)."""
    _, b = _rhs(A, 1)
    d = np.diagonal(A).copy()
    prec = {"pcg": (dict(Minv=jnp.asarray(1.0 / d)),
                    dict(Minv=torch.as_tensor(1.0 / d))),
            "pbicgstab": ({}, {}),
            "fgmres": (dict(Minv=lambda r: r / jnp.asarray(d)),
                       dict(Minv=lambda r: r / torch.as_tensor(d)))}[name]
    (xj, kj, rj), (xt, kt, rt) = _both(name, A, b, jkw=prec[0], tkw=prec[1],
                                       **kw)
    assert _rel(xt, xj) <= RTOL
    assert kt == kj > 0
    assert rt < 1e-11


def test_pgmres_tree_and_restart_matches_jax():
    """pgmres on a tuple/dict tree with restart 25, with the JAX row
    equilibrator's Minv carried across, so both solve the same
    preconditioned system (the port's own probes draw other bits)."""
    n = 160
    A = _nonsym(n, 6)
    xt, b = _rhs(A, 7)
    Aj, At = jnp.asarray(A), torch.as_tensor(A)

    def tree_apply(cat, split):
        def ap(x):
            y = split(cat(x))
            return (y[: n // 2], {"z": y[n // 2:]})
        return ap

    japply = tree_apply(lambda x: Aj @ jnp.concatenate([x[0], x[1]["z"]]),
                        lambda y: y)
    tapply = tree_apply(lambda x: At @ torch.cat([x[0], x[1]["z"]]),
                        lambda y: y)
    jb = (jnp.asarray(b[: n // 2]), {"z": jnp.asarray(b[n // 2:])})
    tb = (torch.as_tensor(b[: n // 2]), {"z": torch.as_tensor(b[n // 2:])})
    jMinv = jl.row_norm_equilibrator(japply, jb)
    tMinv = (torch.as_tensor(np.array(jMinv[0])),
             {"z": torch.as_tensor(np.array(jMinv[1]["z"]))})
    zeros = np.zeros(n // 2)
    xj, kj, rj = jl.pgmres(japply, jb, (jnp.asarray(zeros),
                                        {"z": jnp.asarray(zeros)}),
                           Minv=jMinv, tol=1e-12, maxiter=600, restart=25)
    xp, kp, rp = tl.pgmres(tapply, tb, (torch.as_tensor(zeros),
                                        {"z": torch.as_tensor(zeros)}),
                           Minv=tMinv, tol=1e-12, maxiter=600, restart=25)
    got = torch.cat([xp[0], xp[1]["z"]])
    want = np.concatenate([np.asarray(xj[0]), np.asarray(xj[1]["z"])])
    assert _rel(got, want) <= RTOL
    assert int(kp) == int(kj) and 0 < int(kp) <= 25
    assert np.abs(got.numpy() - xt).max() < 1e-7


def test_pbicgstab_rho_breakdown_restart():
    """Mirror of tests/test_linsolve.py:44 (skew-dominated system whose
    shadow residual decorrelates fast): finite, converged, equal to JAX.
    Rounding steers this system's iteration: the counts differ by a few
    (110 against 107)."""
    n = 60
    S = np.random.default_rng(4).standard_normal((n, n)) / np.sqrt(n)
    A = np.eye(n) + 2.0 * (S - S.T)
    xt, b = _rhs(A, 5)
    (xj, kj, _), (xp, kp, rp) = _both("pbicgstab", A, b, tol=1e-10,
                                      maxiter=2000)
    assert bool(torch.isfinite(xp).all())
    assert rp < 1e-8
    assert np.abs(xp.numpy() - xt).max() < 1e-7
    assert _rel(xp, xj) <= 1e-8 and abs(kp - kj) <= 5


def test_pgmres_early_exit_true_residual_large_norm():
    """Mirror of tests/test_linsolve.py:106: when a cycle exits early, the
    masked Givens entry keeps the spurious g[j_f]·V[j_f] term out of x.
    The residual is computed directly from (A, x, b) on a ||A|| ~ 2e3
    system at a loose tol, so the early exit fires."""
    n = 100
    A = _spd(n, 11) * 20.0
    _, b = _rhs(A, 12)
    tol = 1e-4
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    d = torch.as_tensor(np.diagonal(A).copy())
    for name, Minv in (("pgmres", 1.0 / d), ("fgmres", lambda r: r / d)):
        x, it, _ = getattr(tl, name)(lambda v: At @ v, bt,
                                     torch.zeros(n, dtype=torch.float64),
                                     Minv=Minv, tol=tol, maxiter=200,
                                     restart=40)
        assert 0 < it < 40, (name, it)
        true_res = float(torch.linalg.norm(bt - At @ x) / torch.linalg.norm(bt))
        assert true_res <= 10.0 * tol, (name, true_res, it)


def test_fgmres_flexible_preconditioner():
    """Mirror of tests/test_linsolve.py:137: fgmres converges with a
    NONLINEAR preconditioner (5 inner CG iterations) and reports the true
    residual norm."""
    n = 120
    A = torch.as_tensor(_nonsym(n, 3, diag=4.0, scale=0.6))
    xt = torch.as_tensor(np.random.default_rng(4).standard_normal(n))
    b = A @ xt

    def inner_cg(r, iters=5):
        x = torch.zeros_like(r)
        p, rc, rr = r.clone(), r, torch.dot(r, r)
        for _ in range(iters):
            Ap = A @ p
            alpha = rr / torch.clamp_min(torch.dot(p, Ap), 1e-30)
            x = x + alpha * p
            rc = rc - alpha * Ap
            rr_new = torch.dot(rc, rc)
            p = rc + (rr_new / torch.clamp_min(rr, 1e-30)) * p
            rr = rr_new
        return x

    x, it, res = tl.fgmres(lambda v: A @ v, b,
                           torch.zeros(n, dtype=torch.float64), Minv=inner_cg,
                           tol=1e-10, maxiter=300, restart=30)
    assert (x - xt).abs().max() < 1e-7
    true_res = float(torch.linalg.norm(A @ x - b) / torch.linalg.norm(b))
    assert abs(float(res) - true_res) < 1e-8 + 0.5 * true_res


def _pcg_steps(apply_fn, b, x, Minv, tol, maxiter):
    """The JAX pcg loop (linsolve.py:96-128) as a plain early-exit loop."""
    tiny, tol = tl._guards(b, tol)
    bb = torch.clamp_min(torch.dot(b, b), tiny)
    bound = (tol * tol) * bb
    r = b - apply_fn(x)
    z = Minv * r
    p, rz, rr, k = z, torch.dot(r, z), torch.dot(r, r), 0
    while bool(rr > bound) and k < maxiter:
        Ap = apply_fn(p)
        pAp = torch.dot(p, Ap)
        alpha = rz / torch.where(pAp != 0, pAp, 1.0)
        x = alpha * p + x
        r = -alpha * Ap + r
        z = Minv * r
        rz_new = torch.dot(r, z)
        beta = rz_new / torch.where(rz != 0, rz, 1.0)
        p = beta * p + z
        rz, rr, k = rz_new, torch.dot(r, r), k + 1
    return x, k


def _bicgstab_steps(apply_fn, b, x, tol, maxiter):
    """The JAX pbicgstab loop (linsolve.py:147-193) as a plain early-exit
    loop (no preconditioner)."""
    tiny, tol = tl._guards(b, tol)
    bb = torch.clamp_min(torch.dot(b, b), tiny)
    bound = (tol * tol) * bb
    r = b - apply_fn(x)
    rhat, p, v = r, torch.zeros_like(b), torch.zeros_like(b)
    rho = alpha = omega = torch.ones((), dtype=b.dtype)
    rr, k = torch.dot(r, r), 0
    safe = lambda d: torch.where(d.abs() > tiny, d, tiny)
    while bool(rr > bound) and k < maxiter:
        rho_new = torch.dot(rhat, r)
        brk = rho_new.abs() < 1e-12 * torch.sqrt(
            torch.clamp_min(torch.dot(rhat, rhat), tiny)
            * torch.clamp_min(rr, tiny))
        rhat = torch.where(brk, r, rhat)
        rho_new = torch.where(brk, rr, rho_new)
        beta = torch.where(brk, 0.0, (rho_new / safe(rho)) * (alpha / safe(omega)))
        p = r + beta * (p - omega * v)
        v = apply_fn(p)
        alpha = rho_new / safe(torch.dot(rhat, v))
        s = -alpha * v + r
        t = apply_fn(s)
        omega = torch.dot(t, s) / safe(torch.dot(t, t))
        x = x + alpha * p + omega * s
        r = -omega * t + s
        rho, rr, k = rho_new, torch.dot(r, r), k + 1
    return x, k


@pytest.mark.parametrize("tol,maxiter", [(1e-12, 500), (1e-12, 13),
                                         (1e-12, 16), (1e-30, 3), (1.0, 5)],
                         ids=["converges", "cap13", "cap16", "cap3",
                              "converged0"])
def test_chunked_loops_equal_step_by_step(tol, maxiter):
    """pcg and pbicgstab with their device-side flag return the early-exit
    loop's iterate bit for bit and its count, whether they stop mid-chunk,
    at the cap, or before the first iteration; one host read per chunk."""
    A = torch.as_tensor(_spd(80, 21))
    b = torch.as_tensor(np.random.default_rng(22).standard_normal(80))
    Minv = 1.0 / torch.diagonal(A)
    x0 = torch.zeros(80, dtype=torch.float64)
    apply_fn = lambda v: A @ v

    reads = tl.host_read.count
    x, k, _ = tl.pcg(apply_fn, b, x0, Minv=Minv, tol=tol, maxiter=maxiter)
    assert tl.host_read.count - reads == max(1, -(-k // tl.CHUNK))
    xr, kr = _pcg_steps(apply_fn, b, x0, Minv, tol, maxiter)
    assert k == kr and torch.equal(x, xr)

    An = torch.as_tensor(_nonsym(80, 23))
    apply_n = lambda v: An @ v
    x, k, _ = tl.pbicgstab(apply_n, b, x0, tol=tol, maxiter=maxiter)
    xr, kr = _bicgstab_steps(apply_n, b, x0, tol, maxiter)
    assert k == kr and torch.equal(x, xr)


def _masked_operator(n, seed):
    """A dense operator whose last rows/columns are structurally zero, so
    the dense paths must put identity equations there."""
    A = _nonsym(n, seed)
    A[-3:, :] = 0.0
    A[:, -3:] = 0.0
    return A


def test_dense_paths_match_jax():
    """DenseFactorSolver, solve_linear(direct) and solve_linear(lstsq) on an
    operator with structurally zero rows/columns (identity-fixed) and on a
    rank-deficient one (lstsq's min-norm solution)."""
    n = 70
    A = _masked_operator(n, 30)
    _, b = _rhs(A, 31)
    b[-3:] = 5.0                      # rhs of inactive rows is dropped
    ja, ta = _ops(A)
    jb, tb = jnp.asarray(b), torch.as_tensor(b)
    Aj, _ = jl.materialize_dense(ja, jb)
    At, _ = tl.materialize_dense(ta, tb)
    np.testing.assert_array_equal(At.numpy(), np.asarray(Aj))
    want = np.asarray(jl.DenseFactorSolver(ja, jb).solve(jb))
    got = tl.DenseFactorSolver(ta, tb).solve(tb)
    assert _rel(got, want) <= RTOL and (got[-3:] == 0).all()
    for method in ("direct", "lstsq"):
        want = jl.solve_linear(ja, jb, method=method)
        assert _rel(tl.solve_linear(ta, tb, method=method), want) <= RTOL
    # rank 40 of 70: the min-norm least-squares solution
    rng = np.random.default_rng(32)
    R = rng.standard_normal((n, 40)) @ rng.standard_normal((40, n))
    ja, ta = _ops(R)
    want = jl.solve_linear(ja, jb, method="lstsq")
    assert _rel(tl.solve_linear(ta, tb, method="lstsq"), want) <= 1e-8


def test_materialize_dense_vmap_equals_column_loop():
    """The vmapped basis application equals applying the operator column by
    column, bit for bit, with a block size that splits the columns."""
    n = 50
    A = torch.as_tensor(_nonsym(n, 33))
    apply_fn = lambda x: (A[:25] @ torch.cat(x), A[25:] @ torch.cat(x))
    tmpl = (torch.zeros(25, dtype=torch.float64),
            torch.zeros(25, dtype=torch.float64))
    old = tl._DENSE_BLOCK
    try:
        tl._DENSE_BLOCK = 7 * n
        M, _ = tl.materialize_dense(apply_fn, tmpl)
    finally:
        tl._DENSE_BLOCK = old
    eye = torch.eye(n, dtype=torch.float64)
    cols = [torch.cat(apply_fn((eye[j, :25], eye[j, 25:]))) for j in range(n)]
    assert torch.equal(M, torch.stack(cols, dim=1))


@pytest.mark.parametrize("precondition", [False, True], ids=["plain", "M"])
def test_krylov_solver_gmres_matches_jax(precondition):
    """KrylovSolver(method="gmres") ports jax.scipy's batched GMRES: left
    preconditioned, restart 20, cycles to max(tol·||b||, atol) in the
    preconditioned norm.  Held to JAX at the solver tolerance."""
    n = 110
    A = _nonsym(n, 40, scale=1.5)
    xt, b = _rhs(A, 41)
    ja, ta = _ops(A)
    d = np.diagonal(A).copy()
    jM = (lambda r: r / jnp.asarray(d)) if precondition else None
    tM = (lambda r: r / torch.as_tensor(d)) if precondition else None
    tol = 1e-9
    want = jl.KrylovSolver(ja, method="gmres", tol=tol, M=jM).solve(
        jnp.asarray(b))
    solver = tl.KrylovSolver(ta, method="gmres", tol=tol, M=tM)
    got = solver.solve(torch.as_tensor(b))
    assert _rel(got, want) <= 10 * tol
    assert np.abs(got.numpy() - xt).max() < 1e-6
    assert solver.history == [solver.iters] and solver.iters > 0


def test_krylov_solver_methods_match_jax():
    """KrylovSolver's cg, bicgstab and pgmres (with its own equilibrator
    probes, so the counts may differ by a few) and an atol bump, against
    JAX at the solver level."""
    n = 100
    A = _spd(n, 50)
    _, b = _rhs(A, 51)
    ja, ta = _ops(A)
    d = np.diagonal(A).copy()
    for method, tol, atol in (("cg", 1e-11, 0.0), ("bicgstab", 1e-11, 0.0),
                              ("cg", 1e-14, 1e-6), ("pgmres", 1e-11, 0.0)):
        want = jl.KrylovSolver(ja, method=method, tol=tol, atol=atol,
                               M=lambda r: r / jnp.asarray(d),
                               template=jnp.asarray(b)).solve(jnp.asarray(b))
        got = tl.KrylovSolver(ta, method=method, tol=tol, atol=atol,
                              M=lambda r: r / torch.as_tensor(d),
                              template=torch.as_tensor(b)).solve(
                                  torch.as_tensor(b))
        assert _rel(got, want) <= 100 * max(tol, atol / np.linalg.norm(b)), \
            method


def test_row_norm_equilibrator_estimates_row_norms():
    """The Rademacher estimate approaches the exact row 2-norms with many
    probes, and is within 3x with the default 8 (tests/test_linsolve.py:83);
    it draws the same probes on every call."""
    n = 40
    rng = np.random.default_rng(60)
    D = 10.0 ** (-6 * rng.uniform(size=n))
    A = torch.as_tensor(D[:, None] * _nonsym(n, 61))
    exact = torch.linalg.norm(A, dim=1)
    apply_fn = lambda v: A @ v
    tmpl = torch.zeros(n, dtype=torch.float64)
    ratio = tl.row_norm_equilibrator(apply_fn, tmpl, probes=4000) * exact
    assert (ratio - 1.0).abs().max() < 0.1
    Minv = tl.row_norm_equilibrator(apply_fn, tmpl)
    ratio = Minv * exact
    assert ratio.min() > 0.3 and ratio.max() < 3.0
    assert torch.equal(Minv, tl.row_norm_equilibrator(apply_fn, tmpl))
    x, _, _ = tl.pgmres(apply_fn, A @ torch.ones(n, dtype=torch.float64),
                        tmpl, Minv=Minv, tol=1e-12, maxiter=600, restart=30)
    assert (x - 1.0).abs().max() < 1e-6


@pytest.mark.parametrize("name", ["pcg", "pbicgstab", "pgmres", "fgmres",
                                  "gmres"])
def test_krylov_f32_unreachable_tol_no_nan(name):
    """Mirror of tests/test_f32_robustness.py:61: an f32 Krylov asked for
    1e-14 returns a clean solution (tol floored at 8·eps, guards at the f32
    tiny) instead of iterating into breakdown NaNs."""
    rng = np.random.default_rng(0)
    n = 64
    A = np.asarray(rng.normal(size=(n, n)), np.float32)
    A = A @ A.T + n * np.eye(n, dtype=np.float32)
    x_true = np.asarray(rng.normal(size=n), np.float32)
    At, b = torch.as_tensor(A), torch.as_tensor(A @ x_true)
    x0 = torch.zeros(n, dtype=torch.float32)
    if name == "gmres":
        x, it, relres = tl.gmres(lambda v: At @ v, b, x0, tol=1e-14,
                                 maxiter=300)
    else:
        x, it, relres = getattr(tl, name)(lambda v: At @ v, b, x0, tol=1e-14,
                                          maxiter=300)
    assert x.dtype == torch.float32
    assert bool(torch.isfinite(x).all())
    err = float(torch.linalg.norm(x - torch.as_tensor(x_true))
                / np.linalg.norm(x_true))
    assert err < 1e-4, (err, it, float(relres))

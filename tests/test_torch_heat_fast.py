"""The port's FastHeatBE against the JAX package's, on the CPU (f64 unless
stated), and the whole benchmark slice end to end in both packages."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import penguin_tpu as jpt
from penguin_tpu.solvers.heat_fast import FastHeatBE as JaxFastHeatBE
import penguin_tpu_torch as tpt
from penguin_tpu_torch.convert import CAPACITY_FIELDS, capacity_from_numpy
from penguin_tpu_torch.solvers import FastHeatBE
from penguin_tpu_torch.solvers import heat_fast as thf
from torch_stefan_cases import one_thread  # noqa: F401  (autouse fixture)

BORDERS_2D = ("left", "right", "top", "bottom")


def _borders(pkg, keys):
    return pkg.BorderConditions({k: pkg.Dirichlet(0.0) for k in keys})


def _jax_numpy_fields(jcap):
    out = {}
    for name in CAPACITY_FIELDS:
        v = getattr(jcap, name)
        out[name] = None if v is None else (
            tuple(np.asarray(a) for a in v) if isinstance(v, tuple)
            else np.asarray(v))
    return out


def _pair(n, L, jbody, tbody, dt, cg_tol, cg_maxiter, borders=BORDERS_2D,
          p=8, s=2, source=lambda x, y, z, t: 0.0, carry_capacity=False):
    """The same heat problem built in both packages; with
    ``carry_capacity`` the port runs on the JAX capacity."""
    jmesh = jpt.Mesh(n, (L,) * len(n), (0.0,) * len(n))
    tmesh = tpt.Mesh(n, (L,) * len(n), (0.0,) * len(n))
    jcap = jpt.compute_capacity(jbody, jmesh, p=p, s=s)
    if carry_capacity:
        tcap = capacity_from_numpy(_jax_numpy_fields(jcap), tmesh,
                                   device="cpu", dtype=torch.float64)
    else:
        tcap = tpt.compute_capacity(tbody, tmesh, p=p, s=s, device="cpu")
    jfast = JaxFastHeatBE(jcap, jpt.make_diffusion_ops(jcap), 1.0, source,
                          jpt.Dirichlet(1.0), _borders(jpt, borders), dt,
                          cg_tol=cg_tol, cg_maxiter=cg_maxiter)
    tfast = FastHeatBE(tcap, tpt.make_diffusion_ops(tcap), 1.0, source,
                       tpt.Dirichlet(1.0), _borders(tpt, borders), dt,
                       cg_tol=cg_tol, cg_maxiter=cg_maxiter)
    return jmesh, jfast, tfast


def _step_counts(fast, T0, n_steps):
    """CG iterations of each step of ``run``'s loop (same warm start)."""
    T = T1 = T2 = T0
    its = []
    for _ in range(n_steps):
        Tn, k = fast.step(T, 3.0 * T - 3.0 * T1 + T2)
        T, T1, T2 = Tn, T, T1
        its.append(int(k))
    return T, its


def _run_both(jmesh, jfast, tfast, n_steps):
    """Run both steppers; returns the max deviation on active cells and the
    per-step CG counts of each.  The JAX side uses ``run`` and a step loop:
    its ``run_telemetry`` fails under x64 (an int32 counter meets an int64
    one in the loop carry)."""
    shape = jmesh.np_shape
    jT = jfast.run(jnp.zeros(shape), n_steps)
    _, jits = _step_counts(jfast, jnp.zeros(shape), n_steps)
    t0 = torch.zeros(shape, dtype=torch.float64)
    tT, last, mx = tfast.run_telemetry(t0, n_steps)
    tS, tits = _step_counts(tfast, t0, n_steps)
    assert torch.equal(tT, tS)
    assert (int(last), int(mx)) == (tits[-1], max(tits))
    active = np.asarray(jfast.active)
    np.testing.assert_array_equal(tfast.active.numpy(), active)
    err = np.abs(tT.numpy()[active] - np.asarray(jT)[active]).max()
    return err, jits, tits


def _circle(c, R):
    return jpt.geometry.circle(c, R), tpt.geometry.circle(c, R)


@pytest.mark.parametrize("carry", [False, True], ids=["own", "jax_capacity"])
def test_fast_heat_32_matches_jax(carry):
    """The 32² case of tests/test_heat_fast.py:13, 8 BE steps at tol 1e-13:
    both CGs run the same iterations, so the fields agree to 1e-9 (the JAX
    test's own bound against the direct solver) with equal CG counts.
    ``jax_capacity`` feeds the port the JAX capacity through convert."""
    n, L = (32, 32), 4.0
    dt = 0.25 * (L / n[0]) ** 2
    jmesh, jfast, tfast = _pair(n, L, *_circle((2.01, 2.01), 1.0), dt,
                                1e-13, 500, carry_capacity=carry)
    err, jits, tits = _run_both(jmesh, jfast, tfast, 8)
    assert err <= 1e-9, err
    assert tits == jits
    # one matvec and one step on a seeded field
    x = np.random.default_rng(5).standard_normal(jmesh.np_shape)
    mv_t = tfast.matvec(torch.as_tensor(x)).numpy()
    mv_j = np.asarray(jfast.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(mv_t, mv_j, rtol=0,
                               atol=1e-13 * np.abs(mv_j).max())
    (sj, kj), (st, kt) = jfast.step(jnp.asarray(x)), \
        tfast.step(torch.as_tensor(x))
    assert int(kj) == int(kt)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-9)


def test_fast_heat_3d_matches_jax():
    """The 3D case of tests/test_heat_fast.py:71 (7-point stencil), 5 steps;
    1e-8 as the JAX test holds it."""
    n, L = (12, 10, 14), 2.0
    jmesh, jfast, tfast = _pair(
        n, L, jpt.geometry.sphere((1.0, 1.0, 1.0), 0.7),
        tpt.geometry.sphere((1.0, 1.0, 1.0), 0.7), 1e-3, 1e-13, 800,
        borders=BORDERS_2D + ("front", "back"))
    err, jits, tits = _run_both(jmesh, jfast, tfast, 5)
    assert err <= 1e-8, err
    assert tits == jits


def test_f32_matches_f64_port():
    """The port's f32 path against its f64 path on the bench configuration
    at 64², as tests/test_heat_fast.py:44 holds the JAX package (5e-4)."""
    n, L = 64, 4.0
    mesh = tpt.Mesh((n, n), (L, L), (0.0, 0.0))
    body = tpt.geometry.circle((2.0, 2.0), 1.0)
    out = {}
    for dtype in (torch.float64, torch.float32):
        cap = tpt.compute_capacity(body, mesh, p=4, s=1, dtype=dtype,
                                   device="cpu")
        fast = FastHeatBE(cap, tpt.make_diffusion_ops(cap), 1.0,
                          lambda x, y, z, t: 0.0, tpt.Dirichlet(1.0),
                          _borders(tpt, BORDERS_2D), 0.25 * (L / n) ** 2,
                          cg_tol=1e-6, cg_maxiter=64)
        T = fast.run(torch.zeros(mesh.np_shape, dtype=dtype), 20)
        assert T.dtype == dtype
        out[dtype] = T.double().numpy()
    err = np.abs(out[torch.float64] - out[torch.float32]).max()
    assert err < 5e-4, err


@pytest.mark.parametrize("dt_h2,maxiter", [(0.25, 24), (100.0, 600)],
                         ids=["easy", "stiff"])
def test_bench_slice_64_end_to_end(dt_h2, maxiter):
    """The benchmark chain (Mesh -> compute_capacity(p=4, s=1) ->
    make_diffusion_ops -> FastHeatBE.run_telemetry) in both packages at 64²,
    f64, at the bench's two time steps and iteration caps, tol 1e-10,
    12 steps: fields to 1e-9 on active cells, equal CG counts."""
    n, L = (64, 64), 4.0
    jmesh, jfast, tfast = _pair(n, L, *_circle((2.0, 2.0), 1.0),
                                dt_h2 * (L / n[0]) ** 2, 1e-10, maxiter,
                                p=4, s=1)
    err, jits, tits = _run_both(jmesh, jfast, tfast, 12)
    assert err <= 1e-9, err
    assert tits == jits


def _cg_early_exit(coeffs, dinv, tol2, maxiter, b, x):
    """The JAX loop (heat_fast.py:73-98) as a plain early-exit loop."""
    mv = lambda v: thf._apply_stencil(coeffs, v)
    r = b - mv(x)
    z = dinv * r
    p = z
    rz = thf._dot(r, z)
    bound = tol2 * torch.clamp_min(thf._dot(b, b), 1e-30)
    k = 0
    while bool(thf._dot(r, r) > bound) and k < maxiter:
        Ap = mv(p)
        alpha = rz / thf._dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = dinv * r
        rz_new = thf._dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
    return x, k


@pytest.mark.parametrize("tol,maxiter", [(1e-6, 64), (1e-12, 13),
                                         (1e-12, 16), (1e-30, 3), (1.0, 5)],
                         ids=["converges", "cap13", "cap16", "cap3",
                              "converged0"])
def test_chunked_cg_equals_early_exit(tol, maxiter):
    """The chunked CG with its device-side flag returns the early-exit
    loop's iterate bit for bit and its iteration count, whether it stops
    mid-chunk, at the cap, or before the first iteration."""
    n, L = 24, 4.0
    mesh = tpt.Mesh((n, n), (L, L))
    cap = tpt.compute_capacity(tpt.geometry.circle((2.0, 2.0), 1.0), mesh,
                               p=4, s=1, device="cpu")
    fast = FastHeatBE(cap, tpt.make_diffusion_ops(cap), 1.0, 0.0,
                      tpt.Dirichlet(1.0), _borders(tpt, BORDERS_2D),
                      100.0 * (L / n) ** 2)
    rng = np.random.default_rng(6)
    b = torch.as_tensor(rng.standard_normal(mesh.np_shape))
    x0 = torch.zeros_like(b)
    tol2 = torch.tensor(tol * tol, dtype=torch.float64)
    x, k = thf._cg(fast._coeffs, fast._dinv, tol2, maxiter, b, x0)
    xr, kr = _cg_early_exit(fast._coeffs, fast._dinv, tol2, maxiter, b, x0)
    assert int(k) == kr
    assert torch.equal(x, xr)
    assert bool(torch.isfinite(x).all())

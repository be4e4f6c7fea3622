"""Parity of the PyTorch port's shift stencils and diffusion operators with
the JAX package (f64, CPU), and adjointness against dense matrices as in
tests/test_operators.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import penguin_tpu as jpt
from penguin_tpu import operators as jop
import penguin_tpu_torch as tpt
from penguin_tpu_torch import operators as top
from torch_stefan_cases import one_thread  # noqa: F401  (autouse fixture)


def dense_dm(n, periodic=False):
    D = np.diag(np.ones(n)) - np.diag(np.ones(n - 1), -1)
    D[n - 1, n - 1] = 0.0
    if periodic:
        D[0, n - 2] = -1.0
        D[n - 1, 0] = 1.0
    return D


def dense_dp(n, periodic=False):
    D = -np.diag(np.ones(n)) + np.diag(np.ones(n - 1), 1)
    D[n - 1, n - 1] = 0.0
    if periodic:
        D[0, n - 2] = -1.0
        D[n - 1, 0] = 1.0
    return D


def dense_sm(n, periodic=False):
    D = 0.5 * (np.diag(np.ones(n)) + np.diag(np.ones(n - 1), -1))
    D[n - 1, n - 1] = 0.0
    if periodic:
        D[0, n - 2] = 0.5
        D[n - 1, 0] = 0.5
    return D


def dense_sp(n, periodic=False):
    D = 0.5 * (np.diag(np.ones(n)) + np.diag(np.ones(n - 1), 1))
    D[n - 1, n - 1] = 0.0
    if periodic:
        D[0, n - 2] = 0.5
        D[n - 1, 0] = 0.5
    return D


NAMES = ["dm", "dp", "sm", "sp"]
DENSE = {"dm": dense_dm, "dp": dense_dp, "sm": dense_sm, "sp": dense_sp}


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_stencils_match_jax_and_dense(name, periodic):
    """Each stencil and its adjoint, on every axis of a 3D array, against
    JAX and the dense 1D matrix applied along the axis.  Both are exact
    sums of at most two terms, so 1e-14 is round-off only."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 7, 6))
    for axis in range(3):
        D = DENSE[name](x.shape[axis], periodic)
        for fn, mat in ((name, D), (name + "_t", D.T)):
            got = getattr(top, fn)(torch.as_tensor(x), axis, periodic).numpy()
            want = np.asarray(getattr(jop, fn)(jnp.asarray(x), axis, periodic))
            dense = np.apply_along_axis(lambda v: mat @ v, axis, x)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)
            np.testing.assert_allclose(got, dense, rtol=0, atol=1e-14)


def test_stencils_do_not_write_inputs():
    x = torch.arange(12.0, dtype=torch.float64).reshape(3, 4)
    before = x.clone()
    for name in NAMES:
        for fn in (name, name + "_t"):
            getattr(top, fn)(x, 1, True)
    assert torch.equal(x, before)


@pytest.fixture(scope="module")
def both_ops():
    n = (11, 13)
    jm = jpt.Mesh(n, (2.0, 2.0), (0.0, 0.0))
    tm = tpt.Mesh(n, (2.0, 2.0), (0.0, 0.0))
    jcap = jpt.compute_capacity(jpt.geometry.circle((1.0, 1.0), 0.7), jm)
    tcap = tpt.compute_capacity(tpt.geometry.circle((1.0, 1.0), 0.7), tm,
                                device="cpu")
    return jpt.make_diffusion_ops(jcap), tpt.make_diffusion_ops(tcap), n


def test_make_diffusion_ops_fields(both_ops):
    jops, tops, _ = both_ops
    for f in ("A", "B", "Wdag"):
        for a, b in zip(getattr(jops, f), getattr(tops, f)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12,
                                       atol=1e-14)
    np.testing.assert_allclose(tops.V.numpy(), np.asarray(jops.V), rtol=1e-12,
                               atol=1e-14)


def test_diffusion_ops_apply_match_jax(both_ops):
    """G, H, GT, HT, Wq, flux, grad and div on random fields, against JAX
    (1e-12 relative: capacities agree to round-off, see the capacity
    parity test, and each operator adds a few terms)."""
    jops, tops, n = both_ops
    rng = np.random.default_rng(4)
    shape = (n[0] + 1, n[1] + 1)
    x, xg = rng.standard_normal((2,) + shape)
    q = tuple(rng.standard_normal((2,) + shape))
    qg = tuple(rng.standard_normal((2,) + shape))
    tx, txg = torch.as_tensor(x), torch.as_tensor(xg)
    tq_, tqg = tuple(map(torch.as_tensor, q)), tuple(map(torch.as_tensor, qg))
    jx, jxg = jnp.asarray(x), jnp.asarray(xg)
    jq_, jqg = tuple(map(jnp.asarray, q)), tuple(map(jnp.asarray, qg))

    def close(got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=1e-12 * max(np.abs(w).max(), 1.0))

    close(tops.G(tx), jops.G(jx))
    close(tops.H(tx), jops.H(jx))
    close(tops.GT(tq_), jops.GT(jq_))
    close(tops.HT(tq_), jops.HT(jq_))
    close(tops.Wq(tq_), jops.Wq(jq_))
    close(tops.flux(tx, txg), jops.flux(jx, jxg))
    close(tops.grad(tx, txg), jops.grad(jx, jxg))
    close(tops.div(tq_, tqg), jops.div(jq_, jqg))


def test_divergence_adjointness(both_ops):
    """GT/HT are exact adjoints of G/H in the port (as in
    tests/test_operators.py)."""
    _, tops, n = both_ops
    rng = np.random.default_rng(2)
    shape = (n[0] + 1, n[1] + 1)
    x = torch.as_tensor(rng.standard_normal(shape))
    q = tuple(torch.as_tensor(rng.standard_normal(shape)) for _ in range(2))
    lhsG = sum(float(torch.sum(g * qq)) for g, qq in zip(tops.G(x), q))
    rhsG = float(torch.sum(x * tops.GT(q)))
    assert abs(lhsG - rhsG) < 1e-10
    lhsH = sum(float(torch.sum(h * qq)) for h, qq in zip(tops.H(x), q))
    rhsH = float(torch.sum(x * tops.HT(q)))
    assert abs(lhsH - rhsH) < 1e-10


def _cross_pair(cut_moments=True):
    n = (16, 16)
    jb = lambda x, y: jnp.sqrt((x - 0.51) ** 2 + (y - 0.52) ** 2) - 0.31
    tb = lambda x, y: torch.sqrt((x - 0.51) ** 2 + (y - 0.52) ** 2) - 0.31
    jcap = jpt.compute_capacity(jb, jpt.Mesh(n, (1.0, 1.0)),
                                cut_moments=cut_moments)
    tcap = tpt.compute_capacity(tb, tpt.Mesh(n, (1.0, 1.0)), device="cpu",
                                cut_moments=cut_moments)
    return jcap, tcap, (n[0] + 1, n[1] + 1)


def test_cross_moment_not_ported():
    """``make_diffusion_ops(cross_moment=True)`` used to raise as not
    ported; now it builds the ``Xw`` weights.  They and the operators that
    use them (G, GT, flux, div; sw_apply and its adjoint) agree with JAX on
    random fields to 1e-11 of scale (a per-cell 2x2 inverse sits between
    the capacities and the weights), and a capacity without cut moments
    is refused."""
    jcap, tcap, shape = _cross_pair()
    jops = jpt.make_diffusion_ops(jcap, cross_moment=True)
    tops = tpt.make_diffusion_ops(tcap, cross_moment=True)
    assert tops.Xw is not None and len(tops.Xw) == 2

    def close(got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert np.abs(g.numpy() - w).max() <= 1e-11 * max(
                np.abs(w).max(), 1.0)

    for d in range(2):
        jk0, jslots = jops.Xw[d]
        tk0, tslots = tops.Xw[d]
        close(tk0, jk0)
        for (twp, twm), (jwp, jwm) in zip(tslots, jslots):
            close((twp, twm), (jwp, jwm))
    # the correction is not empty on this disk
    assert max(float(tops.Xw[d][0].abs().max()) for d in range(2)) > 1e-3

    rng = np.random.default_rng(6)
    x, xg = rng.standard_normal((2,) + shape)
    q = tuple(rng.standard_normal((2,) + shape))
    qg = tuple(rng.standard_normal((2,) + shape))
    tx, txg = torch.as_tensor(x), torch.as_tensor(xg)
    tq_, tqg = tuple(map(torch.as_tensor, q)), tuple(map(torch.as_tensor, qg))
    jx, jxg = jnp.asarray(x), jnp.asarray(xg)
    jq_, jqg = tuple(map(jnp.asarray, q)), tuple(map(jnp.asarray, qg))
    close(tops.G(tx), jops.G(jx))
    close(tops.GT(tq_), jops.GT(jq_))
    close(tops.flux(tx, txg), jops.flux(jx, jxg))
    close(tops.div(tq_, tqg), jops.div(jq_, jqg))
    close(top.sw_apply(tops.Xw[0], tx), jop.sw_apply(jops.Xw[0], jx))
    close(top.sw_applyT(tops.Xw[1], tx), jop.sw_applyT(jops.Xw[1], jx))

    _, plain, _ = _cross_pair(cut_moments=False)
    with pytest.raises(ValueError, match="cut_moments=True"):
        tpt.make_diffusion_ops(plain, cross_moment=True)


def test_xw_adjoint_exact():
    """With ``Xw`` set, GT stays the exact adjoint of G
    (tests/test_cut_moments.py)."""
    _, tcap, shape = _cross_pair()
    ops = tpt.make_diffusion_ops(tcap, cross_moment=True)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal(shape))
    qs = tuple(torch.as_tensor(rng.standard_normal(shape)) for _ in range(2))
    lhs = sum(float(torch.sum(g * q)) for g, q in zip(ops.G(x), qs))
    rhs = float(torch.sum(x * ops.GT(qs)))
    assert abs(lhs - rhs) < 1e-10 * max(abs(lhs), 1.0)


def test_linear_flux_flat_interface():
    """tests/test_cut_moments.py's tilted half-plane with a linear field:
    with the cross-moment weights and the half-strip interface moments
    the flux sits at round-off on faces with a staggered volume worth the
    name, and the cut-row residual drops by more than 20x against the
    centroid scheme."""
    from penguin_tpu_torch.capacity import gamma_half_moments

    n = 24
    mesh = tpt.Mesh((n, n), (1.0, 1.0))
    nx, ny = np.cos(0.37), np.sin(0.37)
    cap = tpt.compute_capacity(
        lambda x, y: -(nx * (x - 0.52) + ny * (y - 0.47)), mesh,
        cut_moments=True, device="cpu")
    h = 1.0 / n
    u = lambda x, y: 0.3 + 0.7 * x - 0.45 * y
    Cg = torch.where((cap.cell_types == -1)[..., None], cap.C_ga, cap.C_om)
    uw = u(cap.C_om[..., 0], cap.C_om[..., 1])
    ug = u(Cg[..., 0], Cg[..., 1])

    def flux(cross):
        o = tpt.make_diffusion_ops(cap, cross_moment=cross)
        q = list(o.flux(uw, ug))
        if cross:
            for a, (S_lo, X_lo, S_hi, X_hi) in enumerate(
                    gamma_half_moments(cap)):
                D_lo = S_lo * (u(X_lo[..., 0], X_lo[..., 1]) - ug)
                D_hi = S_hi * (u(X_hi[..., 0], X_hi[..., 1]) - ug)
                q[a] = q[a] + o.Wdag[a] * (top._shift_m(D_hi, a) + D_lo)
        return o, q

    o, q = flux(True)
    for a, exact in enumerate((0.7, -0.45)):
        W = cap.W[a].numpy()
        err = np.abs(q[a].numpy() - exact)[W > 0.05 * h * h]
        assert np.median(err) < 1e-8, (a, np.median(err))
        assert err.max() < 0.05, (a, err.max())

    def rows(cross):
        o, q = flux(cross)
        r = o.GT(tuple(q)).numpy()
        cut = (cap.cell_types == -1).numpy()
        cut[0, :] = cut[-2:, :] = False
        cut[:, 0] = False
        cut[:, -2:] = False
        return np.abs(r[cut]).max()

    assert rows(True) < 0.05 * rows(False)

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


def test_cross_moment_not_ported():
    n = (6, 6)
    cap = tpt.compute_capacity(tpt.geometry.circle((1.0, 1.0), 0.7),
                               tpt.Mesh(n, (2.0, 2.0)), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpt.make_diffusion_ops(cap, cross_moment=True)

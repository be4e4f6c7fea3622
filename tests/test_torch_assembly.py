"""Parity of the port's border classification, border-condition surgery and
coefficient builders with the JAX package (f64, CPU)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import penguin_tpu as jpt
from penguin_tpu import assembly as ja
import penguin_tpu_torch as tpt
from penguin_tpu_torch import assembly as ta
from torch_stefan_cases import one_thread  # noqa: F401  (autouse fixture)


@pytest.fixture(scope="module")
def caps():
    n = (9, 12)
    jcap = jpt.compute_capacity(jpt.geometry.circle((1.0, 0.9), 0.8),
                                jpt.Mesh(n, (2.0, 2.0)), p=4, s=1)
    tcap = tpt.compute_capacity(tpt.geometry.circle((1.0, 0.9), 0.8),
                                tpt.Mesh(n, (2.0, 2.0)), p=4, s=1,
                                device="cpu")
    return jcap, tcap


@pytest.mark.parametrize("n", [(7,), (5, 6), (4, 5, 3)], ids=["1d", "2d", "3d"])
def test_border_cells_and_positions(n):
    jm, tm = jpt.Mesh(n, (1.0,) * len(n)), tpt.Mesh(n, (1.0,) * len(n))
    jmasks, tmasks = ja.classify_border_cells(jm), ta.classify_border_cells(tm)
    assert sorted(jmasks) == sorted(tmasks)
    for key in jmasks:
        np.testing.assert_array_equal(tmasks[key], jmasks[key])
    for a, b in zip(ja.border_positions(jm), ta.border_positions(tm, device="cpu")):
        assert b.dtype == torch.float64
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _conditions(pkg):
    return pkg.BorderConditions({
        "left": pkg.Dirichlet(lambda x, y: x + 2.0 * y),
        "right": pkg.Neumann(0.5),
        "bottom": pkg.Periodic(),
        "top": pkg.Robin(1.0, 0.5, lambda x, y, z, t: x * t),
    })


@pytest.mark.parametrize("with_capacity", [False, True],
                         ids=["centers", "centroids"])
def test_border_bc_matvec_and_rhs(caps, with_capacity):
    """Every branch of BorderBC.matvec and .rhs on seeded fields; the same
    selections of the same values, so exact up to one division (Neumann)."""
    jcap, tcap = caps
    jb = ja.border_info(jcap.mesh, _conditions(jpt),
                        capacity=jcap if with_capacity else None)
    tb = ta.border_info(tcap.mesh, _conditions(tpt),
                        capacity=tcap if with_capacity else None,
                        device="cpu")
    rng = np.random.default_rng(8)
    y, x, b = rng.standard_normal((3,) + jcap.mesh.np_shape)
    got = tb.matvec(torch.as_tensor(y), torch.as_tensor(x)).numpy()
    want = np.asarray(jb.matvec(jnp.asarray(y), jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)
    got = tb.rhs(torch.as_tensor(b), 0.7).numpy()
    want = np.asarray(jb.rhs(jnp.asarray(b), 0.7))
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=1e-15)


def test_coefficient_builders(caps):
    jcap, tcap = caps
    pairs = [
        (ja.coefficient_diag(2.5, jcap), ta.coefficient_diag(2.5, tcap)),
        (ja.coefficient_diag(lambda x, y: 1.0 + x * y, jcap),
         ta.coefficient_diag(lambda x, y: 1.0 + x * y, tcap)),
        (ja.source_vector(lambda x, y, z, t: x - t, jcap, 0.3),
         ta.source_vector(lambda x, y, z, t: x - t, tcap, 0.3)),
        (ja.gamma_value_vector(jpt.Dirichlet(lambda x, y: y), jcap),
         ta.gamma_value_vector(tpt.Dirichlet(lambda x, y: y), tcap)),
        (ja.gamma_value_vector(jpt.GibbsThomson(1.5, 0.1, 0.2), jcap),
         ta.gamma_value_vector(tpt.GibbsThomson(1.5, 0.1, 0.2), tcap)),
        (ja._col_G_nz(jpt.make_diffusion_ops(jcap)),
         ta._col_G_nz(tpt.make_diffusion_ops(tcap))),
    ]
    for want, got in pairs:
        assert got.shape == jcap.mesh.np_shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14,
                                   atol=1e-14)
    for cond in (jpt.Dirichlet(1.0), jpt.Neumann(), jpt.Robin(2.0, 3.0, 0.0)):
        tcond = getattr(tpt, type(cond).__name__)(
            *[getattr(cond, f) for f in cond.__dataclass_fields__])
        assert ta.build_I_bc(tcond) == ja.build_I_bc(cond)

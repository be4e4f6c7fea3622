"""The port's StokesMono operators and block preconditioner against the JAX
package on the CPU in f64: steady and unsteady apply/rhs (moment and
centroid cut flux, ghost cut rows, Traction rows) and ``M(r)`` for every
``schur`` × ``mom`` pair to 1e-12 of scale, with equal spectrum bounds
(1e-10) and Chebyshev depths.  Inputs are seeded numpy states on the
Taylor-Couette annulus of benchmarks/couette_cylinder.py at 16², the port
on the JAX package's capacities (``torch_stokes_cases.carry_fluid``)."""

import math

import numpy as np
import pytest
import torch

import penguin_tpu as jpt
import penguin_tpu_torch as tpt
from penguin_tpu.solvers.stokes import StokesMono as JStokes
from penguin_tpu_torch.solvers.stokes import StokesMono as TStokes

import torch_stokes_cases as C
from torch_stefan_cases import one_thread  # noqa: F401  (autouse fixture)

N = 16
SCHURS = ("cheb", "cg", "dct_cg", "mass")
MOMS = ("jacobi", "cg", "cg_dst")


@pytest.fixture(scope="module")
def couette():
    """The annulus in both packages with each cut flux, and seeded
    states."""
    out = {}
    for flux in ("moment", "centroid"):
        sj = C.couette_solver(jpt, JStokes, N, cut_flux=flux)
        st = C.couette_solver(tpt, TStokes, N, cut_flux=flux,
                              carry=sj.fluid)
        out[flux] = (sj, st) + C.seeded_pair(sj, 7)
    return out


def _bounds_equal(sj, st):
    """Equal spectrum bounds (1e-10) and Chebyshev depth."""
    (lj, uj, kj), (lt, ut, kt) = sj._schur_bounds, st._schur_bounds
    assert kj == kt
    for a, b in ((lj, lt), (uj, ut)):
        assert abs(float(a) - float(b)) <= 1e-10 * abs(float(a))


@pytest.mark.parametrize("flux", ["moment", "centroid"])
def test_steady_apply_and_rhs_match_jax(couette, flux):
    sj, st, xj, xt = couette[flux]
    assert st.cut_flux == sj.cut_flux == flux
    np.testing.assert_array_equal(st.p_active.numpy(),
                                  np.asarray(sj.p_active))
    for d in range(2):
        np.testing.assert_array_equal(st.u_active[d].numpy(),
                                      np.asarray(sj.u_active[d]))
    assert st.pin_idx == sj.pin_idx
    C.close(st.apply_steady(xt), sj.apply_steady(xj), 1e-12)
    C.close(st.rhs_steady(), sj.rhs_steady(), 1e-12)


@pytest.mark.parametrize("theta", [1.0, 0.5])
def test_unsteady_apply_and_rhs_match_jax(couette, theta):
    """The θ-scheme operator and rhs (with ``extra_mom``) at dt = 0.05."""
    sj, st, xj, xt = couette["moment"]
    dt = 0.05
    C.close(st.make_unsteady_apply(dt, theta)(xt),
            sj.make_unsteady_apply(dt, theta)(xj), 1e-12)
    extra_j = (xj[0], xj[2])
    extra_t = (xt[0], xt[2])
    C.close(st.make_unsteady_rhs(dt, theta)(xt, 0.1, 0.15, extra_t),
            sj.make_unsteady_rhs(dt, theta)(xj, 0.1, 0.15, extra_j), 1e-12)


@pytest.mark.parametrize("schur", SCHURS)
@pytest.mark.parametrize("mom", MOMS)
def test_block_preconditioner_matches_jax(couette, schur, mom):
    """``M(r)`` for one of the twelve branches, steady, on the moment
    annulus: the same output to 1e-12, bounds and depth equal."""
    sj, st, xj, xt = couette["moment"]
    Mj = sj.make_block_preconditioner(schur=schur, mom=mom)
    Mt = st.make_block_preconditioner(schur=schur, mom=mom)
    _bounds_equal(sj, st)
    C.close(Mt(xt), Mj(xj), 1e-12)
    if mom != "jacobi":
        C.close((Mt.mom_solve(0, xt[0]), Mt.mom_solve(1, xt[2])),
                (Mj.mom_solve(0, xj[0]), Mj.mom_solve(1, xj[2])), 1e-12)


@pytest.mark.parametrize("schur,mom", [("cheb", "jacobi"), ("dct_cg", "cg"),
                                       ("cg", "cg_dst")])
def test_unsteady_preconditioner_matches_jax(couette, schur, mom):
    """With ``dt``, θ = 1/2 and a convection diagonal (``conv_diag``)."""
    sj, st, xj, xt = couette["centroid"]
    kw = dict(dt=0.05, theta=0.5, schur=schur, mom=mom)
    conv = 0.3 * np.abs(np.asarray(xj[0]))
    Mj = sj.make_block_preconditioner(
        conv_diag=(conv, conv), **kw)
    ct = torch.as_tensor(conv)
    Mt = st.make_block_preconditioner(conv_diag=(ct, ct), **kw)
    _bounds_equal(sj, st)
    C.close(Mt(xt), Mj(xj), 1e-12)


@pytest.mark.parametrize("lmin,depth", [(0.01, 22), (1e-3, 48)])
def test_given_bounds_deepen_the_chebyshev(couette, lmin, depth):
    """Bounds passed in: no power iteration and no host read; the depth
    follows 1.6·sqrt(lmax/lmin), capped at 48, as in JAX."""
    from penguin_tpu_torch.linsolve import host_read
    sj, st, xj, xt = couette["moment"]
    Mj = sj.make_block_preconditioner(lmin=lmin, lmax=2.0)
    reads = host_read.count
    Mt = st.make_block_preconditioner(lmin=lmin, lmax=2.0)
    assert host_read.count == reads
    assert st._schur_bounds[2] == sj._schur_bounds[2] == depth
    assert depth == int(min(max(1.6 * math.sqrt(2.0 / lmin), 20), 48))
    C.close(Mt(xt), Mj(xj), 1e-12)


def test_estimated_bounds_cost_one_read(couette):
    """The power iteration stays on the device; the Chebyshev depth is one
    read of both bounds per build, and applying M reads nothing."""
    from penguin_tpu_torch.linsolve import host_read
    sj, st, xj, xt = couette["moment"]
    reads = host_read.count
    M = st.make_block_preconditioner()
    assert host_read.count == reads + 1
    M(xt)
    assert host_read.count == reads + 1


@pytest.fixture(scope="module")
def ghost():
    """The annulus at 24² with ghost cut rows in both packages."""
    sj = C.couette_solver(jpt, JStokes, 24, cut_row="ghost")
    st = C.couette_solver(tpt, TStokes, 24, cut_row="ghost",
                          carry=sj.fluid)
    return (sj, st) + C.seeded_pair(sj, 8)


def test_ghost_cut_rows_match_jax(ghost):
    """The host-built ghost rows (positions, stencils, weights, wall
    points), the apply, the rhs and M with them."""
    sj, st, xj, xt = ghost
    assert sum(g is not None for g in st._ghost) == 2
    for gj, gt in zip(sj._ghost, st._ghost):
        for key in ("gpos", "idx"):
            np.testing.assert_array_equal(gt[key].numpy(),
                                          np.asarray(gj[key]))
        C.close((gt["wts"], gt["cwall"]) + gt["xw"],
                (gj["wts"], gj["cwall"]) + gj["xw"], 1e-14)
    np.testing.assert_array_equal(st.p_active.numpy(),
                                  np.asarray(sj.p_active))
    C.close(st.apply_steady(xt), sj.apply_steady(xj), 1e-12)
    C.close(st.rhs_steady(), sj.rhs_steady(), 1e-12)
    for mom in ("jacobi", "cg"):
        Mj = sj.make_block_preconditioner(mom=mom)
        Mt = st.make_block_preconditioner(mom=mom)
        _bounds_equal(sj, st)
        C.close(Mt(xt), Mj(xj), 1e-12)


def test_traction_rows_match_jax():
    """Traction cut rows on a circle: apply (traction-balance rows),
    rhs and M."""
    def make(pkg, S, carry=None):
        circle = pkg.geometry.circle((2.0, 2.0), 1.2)
        fl = C.fluid(pkg, circle, 16, L=4.0, p=6, s=1,
                     f_u=lambda x, y, z: 1.0)
        if carry is not None:
            fl = C.carry_fluid(carry, fl)
        bc = C.walls(pkg)
        return S(fl, (bc, bc), None, pkg.boundary.Traction(0.75))

    sj = make(jpt, JStokes)
    st = make(tpt, TStokes, sj.fluid)
    xj, xt = C.seeded_pair(sj, 9)
    for d in range(2):
        np.testing.assert_array_equal(st.trac_active[d].numpy(),
                                      np.asarray(sj.trac_active[d]))
    C.close(st.apply_steady(xt), sj.apply_steady(xj), 1e-12)
    C.close(st.rhs_steady(), sj.rhs_steady(), 1e-12)
    C.close(st.make_block_preconditioner()(xt),
            sj.make_block_preconditioner()(xj), 1e-12)

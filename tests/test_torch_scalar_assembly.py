"""Parity of the port's masked mono/diph scalar assembly and ConvectionOps
with the JAX package (f64, CPU), on a 24² cut circle whose capacity is
carried across from JAX, so both sides see the same geometry bit for bit.

Masks must be equal; apply, rhs and diag must match to 1e-12 of each
output's scale on seeded inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import penguin_tpu as jpt
from penguin_tpu import assembly as ja
import penguin_tpu_torch as tpt
from penguin_tpu_torch import assembly as ta
from penguin_tpu_torch.convert import CAPACITY_FIELDS, capacity_from_numpy
from torch_stefan_cases import one_thread  # noqa: F401  (autouse fixture)

N, L = 24, 4.0
TOL = 1e-12
KEYS = ("left", "right", "top", "bottom")


def _fields(jcap):
    out = {}
    for name in CAPACITY_FIELDS:
        v = getattr(jcap, name)
        out[name] = None if v is None else (
            tuple(np.asarray(a) for a in v) if isinstance(v, tuple)
            else np.asarray(v))
    return out


def _caps(body):
    jcap = jpt.compute_capacity(body, jpt.Mesh((N, N), (L, L)))
    tcap = capacity_from_numpy(_fields(jcap), tpt.Mesh((N, N), (L, L)),
                               device="cpu")
    return jcap, tcap


@pytest.fixture(scope="module")
def circle():
    return _caps(jpt.geometry.circle((2.03, 1.97), 1.1))


@pytest.fixture(scope="module")
def outside():
    inside = jpt.geometry.circle((2.03, 1.97), 1.1)
    return _caps(lambda x, y: -inside(x, y))


def _close(got, want, what):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                               err_msg=what)


def _close_tree(got, want, what):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"{what}[{i}]")


def _border(pkg, kind):
    cond = {"dirichlet": pkg.Dirichlet(lambda x, y: 0.5 + 0.1 * x),
            "neumann": pkg.Neumann(0.25),
            "robin": pkg.Robin(1.0, 0.5, lambda x, y: 0.3 * x)}[kind]
    # one Dirichlet side keeps every case well posed
    return pkg.BorderConditions({**{k: cond for k in KEYS},
                                 "bottom": pkg.Dirichlet(0.0)})


def _iface(pkg, kind):
    return {"dirichlet": pkg.Dirichlet(lambda x, y: 1.0 + 0.2 * y),
            "neumann": pkg.Neumann(0.3),
            "robin": pkg.Robin(2.0, 0.5, 0.7)}[kind]


def _src(dt):
    """A source for the scheme: steady rhs evaluate it without a time."""
    if dt is None:
        return lambda x, y, z: 1.0 + x * y
    return lambda x, y, z, t: 1.0 + x * y + t


def _seeded(shape, k, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape) for _ in range(k)]


SCHEMES = [(None, "BE"), (0.01, "BE"), (0.01, "CN")]
SCHEME_IDS = ["steady", "BE", "CN"]


@pytest.mark.parametrize("dt,scheme", SCHEMES, ids=SCHEME_IDS)
@pytest.mark.parametrize("kind", ["dirichlet", "neumann", "robin"])
def test_mono_system_matches_jax(circle, kind, dt, scheme):
    jcap, tcap = circle
    out = {}
    for pkg, asm, cap in ((jpt, ja, jcap), (tpt, ta, tcap)):
        ops = pkg.make_diffusion_ops(cap)
        bc_i = _iface(pkg, kind)
        ia, ib = asm.build_I_bc(bc_i)
        Id = asm.coefficient_diag(lambda x, y: 1.0 + 0.1 * x * y, cap)
        masks = asm.scalar_masks(ops, cap.Gamma, ia, ib, steady=dt is None)
        border = asm.border_info(cap.mesh, _border(pkg, kind), capacity=cap)
        kw = dict(dt=dt, scheme=scheme, border=border, masks=masks)
        out[pkg] = (masks,
                    asm.mono_apply_fn(ops, Id, cap.Gamma, ia, ib, **kw),
                    asm.mono_rhs_fn(ops, Id, cap.Gamma, ia, ib, cap, _src(dt),
                                    bc_i, **kw),
                    asm.mono_diag_fn(ops, Id, cap.Gamma, ia, ib, **kw))
    (jm, japply, jrhs, jdiag), (tm, tapply, trhs, tdiag) = out[jpt], out[tpt]
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    x = _seeded(jcap.V.shape, 2, 3)
    _close_tree(tapply(tuple(map(torch.as_tensor, x))),
                japply(tuple(map(jnp.asarray, x))), "apply")
    args = {} if dt is None else dict(t=0.3)
    jb = jrhs(tuple(map(jnp.asarray, x)), **args) if dt else jrhs()
    tb = trhs(tuple(map(torch.as_tensor, x)), **args) if dt else trhs()
    _close_tree(tb, jb, "rhs")
    _close_tree(tdiag, jdiag, "diag")


@pytest.mark.parametrize("dt,scheme", SCHEMES, ids=SCHEME_IDS)
@pytest.mark.parametrize("kind", ["dirichlet", "neumann", "robin"])
def test_diph_system_matches_jax(circle, outside, kind, dt, scheme):
    """Two phases with a Henry jump (α₂ = 0.5) and a flux jump with a
    callable value."""
    (jc1, tc1), (jc2, tc2) = circle, outside
    out = {}
    for pkg, asm, c1, c2 in ((jpt, ja, jc1, jc2), (tpt, ta, tc1, tc2)):
        o1, o2 = pkg.make_diffusion_ops(c1), pkg.make_diffusion_ops(c2)
        ic = pkg.InterfaceConditions(pkg.ScalarJump(1.0, 0.5, 0.1),
                                     pkg.FluxJump(1.0, 2.0,
                                                  lambda x, y: 0.2 * x))
        masks = asm.diph_masks(o1, o2, c1.Gamma, c2.Gamma, 1.0, 0.5, 1.0,
                               2.0, steady=dt is None)
        bc_b = _border(pkg, kind)
        b1 = asm.border_info(c1.mesh, bc_b, phase_mask=c1.cell_types != 0,
                             capacity=c1)
        b2 = asm.border_info(c2.mesh, bc_b, phase_mask=c2.cell_types != 0,
                             capacity=c2)
        Id1 = asm.coefficient_diag(1.0, c1)
        Id2 = asm.coefficient_diag(2.0, c2)
        kw = dict(dt=dt, scheme=scheme, border1=b1, border2=b2, masks=masks)
        out[pkg] = (masks, asm.diph_apply_fn(o1, o2, Id1, Id2, ic, **kw),
                    asm.diph_rhs_fn(o1, o2, Id1, Id2, c1, c2, _src(dt),
                                    _src(dt), ic, **kw))
    (jm, japply, jrhs), (tm, tapply, trhs) = out[jpt], out[tpt]
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    x = _seeded(jc1.V.shape, 4, 4)
    _close_tree(tapply(tuple(map(torch.as_tensor, x))),
                japply(tuple(map(jnp.asarray, x))), "apply")
    if dt is None:
        _close_tree(trhs(), jrhs(), "rhs")
    else:
        _close_tree(trhs(tuple(map(torch.as_tensor, x)), 0.3),
                    jrhs(tuple(map(jnp.asarray, x)), 0.3), "rhs")


def _conv_pair(cap_pair, seed):
    jcap, tcap = cap_pair
    u = _seeded(jcap.V.shape, 3, seed)
    jconv = jpt.make_convection_ops(jcap, (jnp.asarray(u[0]),
                                           jnp.asarray(u[1])),
                                    jnp.asarray(u[2]))
    tconv = tpt.make_convection_ops(tcap, (torch.as_tensor(u[0]),
                                           torch.as_tensor(u[1])),
                                    torch.as_tensor(u[2]))
    return jconv, tconv


def test_convection_ops_match_jax(circle):
    jconv, tconv = _conv_pair(circle, 5)
    _close_tree(tconv.k_diag, jconv.k_diag, "k_diag")
    x = _seeded(circle[0].V.shape, 1, 6)[0]
    _close(tconv.conv(torch.as_tensor(x)), jconv.conv(jnp.asarray(x)), "conv")
    _close(tconv.kconv(torch.as_tensor(x)), jconv.kconv(jnp.asarray(x)),
           "kconv")
    np.testing.assert_array_equal(ta._conv_nz(tconv).numpy(),
                                  np.asarray(ja._conv_nz(jconv)))
    np.testing.assert_array_equal(
        ta._col_H_nz(tconv).numpy(), np.asarray(ja._col_H_nz(jconv)))


@pytest.mark.parametrize("dt,scheme", SCHEMES, ids=SCHEME_IDS)
def test_advdiff_systems_match_jax(circle, outside, dt, scheme):
    """The convective mono system and the diph system with the advdiff CN
    rhs (``advdiff_cn``)."""
    (jc1, tc1), (jc2, tc2) = circle, outside
    jv1, tv1 = _conv_pair(circle, 7)
    jv2, tv2 = _conv_pair(outside, 8)
    x = _seeded(jc1.V.shape, 4, 9)
    out = {}
    for pkg, asm, c1, c2, v1, v2 in ((jpt, ja, jc1, jc2, jv1, jv2),
                                     (tpt, ta, tc1, tc2, tv1, tv2)):
        bc_i = pkg.Dirichlet(1.0)
        bc_b = _border(pkg, "dirichlet")
        masks = asm.scalar_masks(v1, c1.Gamma, 1.0, 0.0, steady=dt is None,
                                 conv=v1)
        border = asm.border_info(c1.mesh, bc_b, capacity=c1)
        Id = asm.coefficient_diag(0.1, c1)
        kw = dict(dt=dt, scheme=scheme, border=border, masks=masks, conv=v1)
        mono = (asm.mono_apply_fn(v1, Id, c1.Gamma, 1.0, 0.0, **kw),
                asm.mono_rhs_fn(v1, Id, c1.Gamma, 1.0, 0.0, c1, _src(dt),
                                bc_i, **kw))
        ic = pkg.InterfaceConditions(pkg.ScalarJump(1.0, 0.5, 0.0),
                                     pkg.FluxJump(1.0, 1.0, 0.0))
        dmasks = asm.diph_masks(v1, v2, c1.Gamma, c2.Gamma, 1.0, 0.5, 1.0,
                                1.0, steady=dt is None, conv1=v1, conv2=v2)
        b1 = asm.border_info(c1.mesh, bc_b, phase_mask=c1.cell_types != 0,
                             capacity=c1)
        b2 = asm.border_info(c2.mesh, bc_b, phase_mask=c2.cell_types != 0,
                             capacity=c2)
        dkw = dict(dt=dt, scheme=scheme, border1=b1, border2=b2,
                   masks=dmasks, conv1=v1, conv2=v2)
        Id2 = asm.coefficient_diag(0.2, c2)
        diph = (asm.diph_apply_fn(v1, v2, Id, Id2, ic, **dkw),
                asm.diph_rhs_fn(v1, v2, Id, Id2, c1, c2, _src(dt), _src(dt), ic,
                                advdiff_cn=True, **dkw))
        conv = jnp.asarray if pkg is jpt else torch.as_tensor
        xs = tuple(map(conv, x))
        rhs_args = () if dt is None else (0.3,)
        out[pkg] = (masks, dmasks, mono[0](xs[:2]),
                    mono[1](*((xs[:2],) + rhs_args if dt else ())),
                    diph[0](xs), diph[1](*((xs,) + rhs_args if dt else ())))
    jo, to = out[jpt], out[tpt]
    for a, b in zip(to[0] + to[1], jo[0] + jo[1]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for i, what in enumerate(("mono apply", "mono rhs", "diph apply",
                              "diph rhs")):
        _close_tree(to[2 + i], jo[2 + i], what)

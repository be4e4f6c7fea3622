"""Parity of the PyTorch port's quadrature and capacity build with the JAX
package, on the CPU.  Inputs come from numpy seeds; f64 unless stated."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import penguin_tpu as jpt
from penguin_tpu import quadrature as jq
import penguin_tpu_torch as tpt
from penguin_tpu_torch import quadrature as tq
from penguin_tpu_torch.convert import CAPACITY_FIELDS, capacity_to_numpy


def _np(a):
    return np.asarray(a, dtype=np.float64)


def test_gl_rule_matches():
    for p, s in ((4, 1), (8, 2), (3, 3)):
        jn, jw = jq.gl_rule(p, s)
        tn, tw = tq.gl_rule(p, s)
        np.testing.assert_array_equal(jn, tn)
        np.testing.assert_array_equal(jw, tw)


def test_segment_fraction_random_triples():
    rng = np.random.default_rng(0)
    # random triples, plus exact zeros and sign patterns that hit the
    # linear / no-root / double-root branches
    tri = rng.standard_normal((3, 4000))
    tri[:, :200] = np.round(tri[:, :200])
    tri[1, 200:300] = 0.5 * (tri[0, 200:300] + tri[2, 200:300])  # linear
    jf, jm = jq.segment_fraction(*[jnp.asarray(t) for t in tri])
    tf, tm = tq.segment_fraction(*[torch.as_tensor(t) for t in tri])
    # same f64 formulas in the same order: agreement to a few ulps
    np.testing.assert_allclose(tf.numpy(), _np(jf), rtol=0, atol=1e-14)
    np.testing.assert_allclose(tm.numpy(), _np(jm), rtol=0, atol=1e-14)


def test_box_integrals_2d_and_3d():
    rng = np.random.default_rng(1)
    for M in (2, 3):
        lo = rng.uniform(0.0, 1.0, (M, 5, 7))
        hi = lo + rng.uniform(0.05, 0.4, (M, 5, 7))
        c = rng.uniform(0.3, 1.0, M)

        def jphi(*xs):
            return jnp.sqrt(sum((x - ci) ** 2 for x, ci in zip(xs, c))) - 0.5

        def tphi(*xs):
            return torch.sqrt(sum((x - ci) ** 2 for x, ci in zip(xs, c))) - 0.5

        jv, jm = jq.box_integrals(jphi, list(jnp.asarray(lo)),
                                  list(jnp.asarray(hi)), p=4, s=2)
        tv, tm = tq.box_integrals(tphi, list(torch.as_tensor(lo)),
                                  list(torch.as_tensor(hi)), p=4, s=2)
        # same nodes, same accumulation order: f64 round-off only
        np.testing.assert_allclose(tv.numpy(), _np(jv), rtol=0, atol=1e-14)
        for a, b in zip(tm, jm):
            np.testing.assert_allclose(a.numpy(), _np(b), rtol=0, atol=1e-14)


def _disk(c, R):
    return (lambda x, y: jnp.sqrt((x - c[0]) ** 2 + (y - c[1]) ** 2) - R,
            lambda x, y: torch.sqrt((x - c[0]) ** 2 + (y - c[1]) ** 2) - R)


def _jax_fields(cap):
    out = {}
    for name in CAPACITY_FIELDS:
        v = getattr(cap, name)
        out[name] = None if v is None else (
            tuple(_np(a) for a in v) if isinstance(v, tuple) else _np(v))
    return out


def compare_capacity(jcap, tcap, rtol_scale):
    """Field-by-field comparison; each float field to ``rtol_scale`` times
    its largest magnitude, ``cell_types`` exactly."""
    jf = _jax_fields(jcap)
    tf = capacity_to_numpy(tcap)
    for name in CAPACITY_FIELDS:
        assert (jf[name] is None) == (tf[name] is None), name
        if jf[name] is None:
            continue
        js = jf[name] if isinstance(jf[name], tuple) else (jf[name],)
        ts = tf[name] if isinstance(tf[name], tuple) else (tf[name],)
        assert len(js) == len(ts), name
        for a, b in zip(js, ts):
            assert a.shape == b.shape, (name, a.shape, b.shape)
            if name == "cell_types":
                np.testing.assert_array_equal(b.astype(np.int8),
                                              a.astype(np.int8))
                continue
            scale = max(np.abs(a).max(), 1e-300)
            err = np.abs(a - b.astype(np.float64)).max()
            assert err <= rtol_scale * scale, (name, err, scale)


# f64 tolerance: both builds evaluate the same formulas in f64; the closest-
# point C_ga differences a finite-difference gradient (delta = 1e-4 h), the
# worst amplifier of round-off, so 1e-11 of each field's scale bounds all.
F64_TOL = 1e-11


@pytest.mark.parametrize("c,R,n", [((2.0, 2.0), 1.0, 32),
                                   ((2.01, 2.01), 1.0, 32),
                                   ((2.0, 2.0), 1.0, 64),
                                   ((2.008, 2.008), 1.0, 64)],
                         ids=["circle32", "offset32", "grazing64",
                              "grazing64_offset"])
def test_capacity_2d_matches_jax(c, R, n):
    """The 32² circle and the grazing cases of test_capacity_consistency
    (n <= 64), at the bench's p=4, s=1 and at the default p=8, s=2."""
    jb, tb = _disk(c, R)
    jm = jpt.Mesh((n, n), (4.0, 4.0), (0.0, 0.0))
    tm = tpt.Mesh((n, n), (4.0, 4.0), (0.0, 0.0))
    for p, s in ((4, 1), (8, 2)):
        jcap = jpt.compute_capacity(jb, jm, p=p, s=s)
        tcap = tpt.compute_capacity(tb, tm, p=p, s=s)
        compare_capacity(jcap, tcap, F64_TOL)


def test_capacity_3d_sphere_matches_jax():
    n = (12, 10, 14)
    jm = jpt.Mesh(n, (2.0, 2.0, 2.0), (0.0, 0.0, 0.0))
    tm = tpt.Mesh(n, (2.0, 2.0, 2.0), (0.0, 0.0, 0.0))
    jcap = jpt.compute_capacity(jpt.geometry.sphere((1.0, 1.0, 1.0), 0.7), jm)
    tcap = tpt.compute_capacity(tpt.geometry.sphere((1.0, 1.0, 1.0), 0.7), tm)
    compare_capacity(jcap, tcap, F64_TOL)


def test_capacity_f32_build_64():
    """f32 build at 64² (the bench geometry), against the JAX f32 build.

    Under the suite's x64 mode the JAX build comes back mixed: its
    quadrature sums are f64 (quadrature.py:167,190), so V, B, W, C_om, Vh
    are f64 values, while A and Gamma are f32.  The port computes every
    field in f32.  Measured here: A and Gamma agree bitwise; the f64-summed
    fields differ by f32 round-off amplified at grazing cells, up to
    2.4e-5 of the field's scale (B, Vh); C_ga, a closest-point step through
    an f32 finite difference over 1e-4 h, differs by 2.4e-5 of its scale,
    while JAX's own f32 C_ga is 1.5e-4 off its f64 one.  So: 5e-5 of the
    scale for every field, 5e-4 for C_ga, away from any cell whose class
    flipped, and at most 4 of the 4096 cells may flip (none do here)."""
    jb, tb = _disk((2.0, 2.0), 1.0)
    n = 64
    jcap = jpt.compute_capacity(jb, jpt.Mesh((n, n), (4.0, 4.0)), p=4, s=1,
                                dtype=jnp.float32)
    tcap = tpt.compute_capacity(tb, tpt.Mesh((n, n), (4.0, 4.0)), p=4, s=1,
                                dtype=torch.float32)
    jf = _jax_fields(jcap)
    tf = capacity_to_numpy(tcap)
    flip = jf["cell_types"] != tf["cell_types"]
    assert int(flip.sum()) <= 4, int(flip.sum())
    near = np.zeros_like(flip)
    for s0 in (-1, 0, 1):
        for s1 in (-1, 0, 1):
            near |= np.roll(flip, (s0, s1), (0, 1))
    for name in CAPACITY_FIELDS:
        if name == "cell_types":
            assert tf[name].dtype == np.int8
            continue
        js = jf[name] if isinstance(jf[name], tuple) else (jf[name],)
        ts = tf[name] if isinstance(tf[name], tuple) else (tf[name],)
        tol = 5e-4 if name == "C_ga" else 5e-5
        for a, b in zip(js, ts):
            assert b.dtype == np.float32, name
            keep = ~near if a.ndim == 2 else ~near[..., None]
            scale = np.abs(a).max()
            err = np.abs(np.where(keep, a - b, 0.0)).max()
            assert err <= tol * scale, (name, err, scale)


def test_capacity_1d_interval_matches_jax():
    jm = jpt.Mesh((16,), (2.0,), (0.0,))
    tm = tpt.Mesh((16,), (2.0,), (0.0,))
    jcap = jpt.compute_capacity(jpt.geometry.interval(1.03, 0.61), jm)
    tcap = tpt.compute_capacity(tpt.geometry.interval(1.03, 0.61), tm)
    compare_capacity(jcap, tcap, F64_TOL)


def _shapes(pkg):
    g = pkg.geometry
    disk = g.circle((0.4, 0.5), 0.3)
    return {
        "circle": (2, disk),
        "sphere": (3, g.sphere((0.4, 0.5, 0.6), 0.3)),
        "interval": (1, g.interval(0.4, 0.2)),
        "halfspace": (2, g.halfspace(1, 0.3, -1.0)),
        "rectangle": (2, g.rectangle((0.2, 0.1), (0.7, 0.8))),
        "box": (3, g.box((0.2, 0.1, 0.3), (0.7, 0.8, 0.9))),
        "ellipse": (2, g.ellipse((0.5, 0.4), (0.3, 0.2))),
        "union": (2, g.union(disk, g.ellipse((0.5, 0.4), (0.3, 0.2)))),
        "intersection": (2, g.intersection(disk, g.halfspace(0, 0.5))),
        "complement": (2, g.complement(disk)),
        "full_domain": (2, g.full_domain(2)),
        "translate_in_time": (3, g.translate_in_time(disk, (0.5, -0.25))),
    }


@pytest.mark.parametrize("name", list(_shapes(tpt)))
def test_geometry_matches_jax(name):
    """Every shape and combinator on seeded broadcast coordinates (f64,
    the same formulas: round-off only)."""
    ndim, tbody = _shapes(tpt)[name]
    _, jbody = _shapes(jpt)[name]
    rng = np.random.default_rng(7)
    coords = [rng.uniform(0.0, 1.0, (5,) + (1,) * d) for d in range(ndim)]
    # the JAX box needs equal shapes; the port broadcasts
    want = np.asarray(jbody(*[jnp.asarray(c)
                              for c in np.broadcast_arrays(*coords)]))
    got = tbody(*[torch.as_tensor(c) for c in coords])
    assert got.dtype == torch.float64
    np.testing.assert_allclose(np.broadcast_to(got.numpy(), want.shape),
                               want, rtol=0, atol=1e-15)

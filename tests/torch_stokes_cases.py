"""Shared set-up of the Stokes parity tests: one staggered fluid built in
either package (``penguin_tpu`` or ``penguin_tpu_torch``, the port on the
CPU in f64), the Taylor-Couette annulus of benchmarks/couette_cylinder.py
with its profile error, and the comparison helpers."""

import dataclasses

import numpy as np
import torch

import penguin_tpu as jpt
import penguin_tpu_torch as tpt

RI, RO, OM = 0.5, 1.5, 1.0
CA = -OM * RI**2 / (RO**2 - RI**2)
CB = OM * RI**2 * RO**2 / (RO**2 - RI**2)
CENTER = (2.0 + 0.008, 2.0 + 0.008)


def is_torch(pkg):
    return pkg is tpt


def xp(pkg):
    """The array module of ``pkg``: torch or jax.numpy."""
    if is_torch(pkg):
        return torch
    import jax.numpy as jnp
    return jnp


def kw(pkg):
    return dict(device="cpu") if is_torch(pkg) else {}


def staggered_meshes(pkg, n, L, ndim=2):
    """The pressure mesh and the velocity meshes offset -h/2 along their
    own axis."""
    ns = n if isinstance(n, tuple) else (n,) * ndim
    Ls = L if isinstance(L, tuple) else (L,) * ndim
    mesh_p = pkg.Mesh(ns, Ls, (0.0,) * ndim)
    meshes_u = tuple(
        pkg.Mesh(ns, Ls, tuple(-0.5 * Ls[a] / ns[a] if i == a else 0.0
                               for i in range(ndim)))
        for a in range(ndim))
    return mesh_p, meshes_u


def fluid(pkg, body, n, L=1.0, ndim=2, mu=1.0, rho=1.0, f_u=None,
          periodic=None, p=4, s=1, cut_moments="auto"):
    """A Fluid on the staggered meshes of ``body`` (None: the full
    domain)."""
    mesh_p, meshes_u = staggered_meshes(pkg, n, L, ndim)
    body = body or pkg.geometry.full_domain(ndim)
    caps = [pkg.compute_capacity(body, m, p=p, s=s, cut_moments=cut_moments,
                                 **kw(pkg))
            for m in meshes_u + (mesh_p,)]
    ops = [pkg.make_diffusion_ops(c, periodic=periodic) for c in caps]
    return pkg.Fluid(
        mesh_u=meshes_u, mesh_p=mesh_p, capacity_u=tuple(caps[:ndim]),
        operator_u=tuple(ops[:ndim]), capacity_p=caps[ndim],
        operator_p=ops[ndim], mu=mu, rho=rho,
        f_u=f_u if f_u is not None else (lambda x, y, z: 0.0),
        f_p=lambda x, y, z: 0.0)


def carry_capacity(jcap, mesh):
    """A JAX capacity carried into the port (CPU, f64) on the port's
    ``mesh``, as numpy arrays."""
    from penguin_tpu_torch.convert import CAPACITY_FIELDS, capacity_from_numpy
    fields = {}
    for k in CAPACITY_FIELDS:
        v = getattr(jcap, k)
        fields[k] = (None if v is None else tuple(np.asarray(a) for a in v)
                     if isinstance(v, tuple) else np.asarray(v))
    return capacity_from_numpy(fields, mesh, device="cpu")


def carry_fluid(jfl, tfl):
    """The port fluid ``tfl`` on the JAX fluid's capacities, carried across
    as numpy arrays (the two packages' capacity builds agree to 1e-11 of
    scale only, which sliver weights Wꜝ ~ 1e6 would carry into every
    operator comparison)."""
    caps_u = tuple(carry_capacity(c, m)
                   for c, m in zip(jfl.capacity_u, tfl.mesh_u))
    cap_p = carry_capacity(jfl.capacity_p, tfl.mesh_p)
    ops_u = tuple(tpt.make_diffusion_ops(c, periodic=op.periodic)
                  for c, op in zip(caps_u, tfl.operator_u))
    return dataclasses.replace(
        tfl, capacity_u=caps_u, operator_u=ops_u, capacity_p=cap_p,
        operator_p=tpt.make_diffusion_ops(
            cap_p, periodic=tfl.operator_p.periodic))


def walls(pkg, value=0.0, keys=("left", "right", "bottom", "top")):
    return pkg.BorderConditions({k: pkg.Dirichlet(value) for k in keys})


def annulus(pkg):
    m = xp(pkg)

    def body(x, y):
        r = m.sqrt((x - CENTER[0]) ** 2 + (y - CENTER[1]) ** 2)
        return m.maximum(RI - r, r - RO)

    return body


def rotating_inner_wall(pkg):
    """(uγ_x, uγ_y): rigid rotation on the inner wall, rest on the outer,
    selected by the radius (a where over r)."""
    m = xp(pkg)

    def ug_x(x, y, z, t=None):
        r = m.sqrt((x - CENTER[0]) ** 2 + (y - CENTER[1]) ** 2)
        return m.where(r < 0.5 * (RI + RO), -OM * (y - CENTER[1]), 0.0)

    def ug_y(x, y, z, t=None):
        r = m.sqrt((x - CENTER[0]) ** 2 + (y - CENTER[1]) ** 2)
        return m.where(r < 0.5 * (RI + RO), OM * (x - CENTER[0]), 0.0)

    return pkg.Dirichlet(ug_x), pkg.Dirichlet(ug_y)


def couette_solver(pkg, S, n, cut_flux="auto", cut_row="center",
                   cut_moments="auto", carry=None):
    """The Taylor-Couette annulus of benchmarks/couette_cylinder.py; the
    port's on the capacities of the JAX fluid ``carry`` when given."""
    fl = fluid(pkg, annulus(pkg), n, L=4.0, cut_moments=cut_moments)
    if carry is not None:
        fl = carry_fluid(carry, fl)
    bc = walls(pkg)
    return S(fl, (bc, bc), None, rotating_inner_wall(pkg), cut_row=cut_row,
             cut_flux=cut_flux)


def couette_error(s, n):
    """Max |u_θ - exact| along the vertical line through the centre, 2
    cells away from both walls (the benchmark's measure)."""
    d = 4.0 / n
    ux = np.asarray(_np(s.velocity(0)))
    Cy = np.asarray(_np(s.fluid.capacity_u[0].C_om))
    j = np.argmin(np.abs(np.asarray(s.fluid.mesh_u[0].nodes[0]) + 0.5 * d
                         - CENTER[0]))
    ys = Cy[j, :, 1]
    r = np.abs(ys - CENTER[1])
    sel = (r > RI + 2 * d) & (r < RO - 2 * d)
    u_th = np.where(ys > CENTER[1], -ux[j, :], ux[j, :])
    exact = CA * r + CB / np.maximum(r, 1e-12)
    return float(np.abs(u_th - exact)[sel].max())


def lid_bcs(pkg):
    noslip = pkg.Dirichlet(0.0)
    lid = pkg.Dirichlet(lambda x, y, z: 1.0)
    bc_ux = pkg.BorderConditions({"left": noslip, "right": noslip,
                                  "bottom": noslip, "top": lid})
    return bc_ux, walls(pkg)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def state_np(x):
    return tuple(_np(a) for a in x)


def close(got, want, tol):
    """Every field of ``got`` within ``tol`` of ``want`` relative to the
    scale max(max|want|, 1); returns the largest relative deviation."""
    got, want = state_np(got), state_np(want)
    assert len(got) == len(want)
    scale = max(max(float(np.abs(w).max()) for w in want), 1.0)
    err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    assert err <= tol * scale, (err, scale)
    return err / scale


def random_state(pkg, shapes, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(sh) for sh in shapes]
    if is_torch(pkg):
        return tuple(torch.as_tensor(a) for a in arrs)
    import jax.numpy as jnp
    return tuple(jnp.asarray(a) for a in arrs)


def seeded_pair(solver_j, seed):
    """The same seeded random state in both packages, shaped like the JAX
    solver's state."""
    shapes = [tuple(a.shape) for a in solver_j.zero_state()]
    return random_state(jpt, shapes, seed), random_state(tpt, shapes, seed)

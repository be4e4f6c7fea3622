"""Shared set-up of the Navier-Stokes parity tests: the flows of the JAX
package's Navier-Stokes tests built in either package (``penguin_tpu`` or
``penguin_tpu_torch``, the port on the CPU in f64), the port's on the JAX
capacities when ``carry`` (the JAX fluid) is given."""

import numpy as np
import torch

import penguin_tpu as jpt
import penguin_tpu_torch as tpt

import torch_stokes_cases as C


def ns_class(pkg):
    if C.is_torch(pkg):
        from penguin_tpu_torch.solvers.navierstokes import NavierStokesMono
    else:
        from penguin_tpu.solvers.navierstokes import NavierStokesMono
    return NavierStokesMono


def _fluid(pkg, body, n, L, mu, carry, cut_moments="auto"):
    fl = C.fluid(pkg, body, n, L=L, mu=mu, cut_moments=cut_moments)
    return C.carry_fluid(carry, fl) if carry is not None else fl


def obstacle(pkg):
    """A disk of radius 0.17 off the centre of the unit box, fluid
    outside."""
    return pkg.geometry.complement(pkg.geometry.circle((0.45, 0.52), 0.17))


def cut_cavity(pkg, n=10, mu=0.01, carry=None):
    """The lid-driven cavity of tests/test_navierstokes.py:93 around the
    obstacle (cut cells in every operator)."""
    fl = _fluid(pkg, obstacle(pkg), n, 1.0, mu, carry)
    return ns_class(pkg)(fl, C.lid_bcs(pkg), None, pkg.Dirichlet(0.0))


def channel(pkg, outlet="right", n=16, carry=None):
    """Flow past the obstacle with a parabolic inlet and an Outflow border
    on the ``outlet`` side (left or right)."""
    inlet = "left" if outlet == "right" else "right"
    sign = 1.0 if outlet == "right" else -1.0
    fl = _fluid(pkg, obstacle(pkg), n, 1.0, 0.05, carry)

    def prof(x, y, z=0.0, t=None):
        return sign * 4.0 * y * (1.0 - y)

    d0 = pkg.Dirichlet(0.0)
    bc_ux = pkg.BorderConditions({outlet: pkg.Outflow(),
                                  inlet: pkg.Dirichlet(prof),
                                  "bottom": d0, "top": d0})
    bc_uy = pkg.BorderConditions({outlet: pkg.Outflow(), inlet: d0,
                                  "bottom": d0, "top": d0})
    return ns_class(pkg)(fl, (bc_ux, bc_uy), None, d0)


def cylinder(pkg, n=24, mu=0.05, carry=None):
    """tests/test_cv_force.py's cylinder of radius 0.5 at (2.01, 2.01) in
    a 4 × 4 box with a uniform stream on every border."""
    cyl = pkg.geometry.circle((2.01, 2.01), 0.5)
    fl = _fluid(pkg, pkg.geometry.complement(cyl), n, 4.0, mu, carry)
    bc_ux = C.walls(pkg, 1.0)
    bc_uy = C.walls(pkg, 0.0)
    return ns_class(pkg)(fl, (bc_ux, bc_uy), None, pkg.Dirichlet(0.0))


def pair(make, **kw):
    """(JAX solver, port solver on the JAX capacities)."""
    sj = make(jpt, **kw)
    return sj, make(tpt, carry=sj.fluid, **kw)


def to_torch(x):
    return tuple(torch.as_tensor(np.array(a)) for a in x)


def smooth_state(s, seed):
    """A smooth state of ``s`` (either package): a stream of magnitude ~1
    with seeded low modes in both velocity components (uω and uγ alike)
    and the pressure, sampled at the DOF centroids."""
    rng = np.random.default_rng(seed)
    out = []
    for d in range(s.N):
        Cd = C._np(s.fluid.capacity_u[d].C_om)
        a, b, c = rng.uniform(0.2, 0.4, 3)
        u = ((1.0 if d == 0 else 0.0)
             + a * np.sin(1.3 * Cd[..., 0] + b) * np.cos(0.9 * Cd[..., 1] - c))
        out += [u, u]
    Cp = C._np(s.fluid.capacity_p.C_om)
    k = rng.uniform(0.5, 1.5, 2)
    out.append(0.3 * np.cos(k[0] * Cp[..., 0]) * np.sin(k[1] * Cp[..., 1]))
    if isinstance(s.fluid.capacity_p.V, torch.Tensor):
        return tuple(torch.as_tensor(a) for a in out)
    import jax.numpy as jnp
    return tuple(jnp.asarray(a) for a in out)


def residual_relres(apply_fn, b, x):
    """||b - A x|| / ||b|| over the whole state (port tensors)."""
    from penguin_tpu_torch.linsolve import _ravel
    r = _ravel(tuple(bb - aa for bb, aa in zip(b, apply_fn(x))))[0]
    return float(torch.linalg.vector_norm(r)
                 / torch.linalg.vector_norm(_ravel(b)[0]))


def dfg(pkg, n, dtype, umax, ramp=None):
    """The DFG channel of benchmarks/dfg_cylinder_steady.py:55-115 (and
    dfg_cylinder_shedding.py): walls exactly at y = 0 and 0.41, ghost wall
    rows, the moment cut flux, a parabolic inlet of peak ``umax`` (times a
    cosine ramp over ``ramp`` time units), an Outflow outlet, ν = 1e-3."""
    m = C.xp(pkg)
    nx, ny = n
    Lx, Ly = 2.2, 0.41
    dx, dy = Lx / nx, Ly / ny
    meshes = (pkg.Mesh(n, (Lx, Ly), (-dx, -0.5 * dy)),
              pkg.Mesh(n, (Lx, Ly), (-0.5 * dx, -dy)),
              pkg.Mesh(n, (Lx, Ly), (-0.5 * dx, -0.5 * dy)))
    body = pkg.geometry.complement(pkg.geometry.circle((0.2, 0.2), 0.05))
    kw = dict(device="cpu") if C.is_torch(pkg) else {}
    caps = [pkg.compute_capacity(body, mm, p=4, s=1, dtype=dtype,
                                 cut_moments=True, **kw) for mm in meshes]
    ops = [pkg.make_diffusion_ops(c) for c in caps]
    fl = pkg.Fluid(mesh_u=meshes[:2], mesh_p=meshes[2],
                   capacity_u=tuple(caps[:2]), operator_u=tuple(ops[:2]),
                   capacity_p=caps[2], operator_p=ops[2], mu=1e-3, rho=1.0,
                   f_u=lambda x, y, z: 0.0, f_p=lambda x, y, z: 0.0)

    def inflow(x, y, z=0.0, t=None):
        prof = umax * 4.0 * (y / Ly) * (1.0 - y / Ly)
        if ramp is None or t is None:
            return prof
        if C.is_torch(pkg):  # the port passes t as a Python float
            return prof * (1.0 if t >= ramp
                           else 0.5 * (1.0 - np.cos(np.pi * t / ramp)))
        return prof * m.where(t >= ramp, 1.0,
                              0.5 * (1.0 - m.cos(np.pi * t / ramp)))

    d0 = pkg.Dirichlet(0.0)
    bc_ux = pkg.BorderConditions({"left": pkg.Dirichlet(inflow),
                                  "right": pkg.Outflow(), "bottom": d0,
                                  "top": d0})
    return ns_class(pkg)(fl, (bc_ux, C.walls(pkg)), None, d0,
                         wall_row="ghost", cut_flux="moment")

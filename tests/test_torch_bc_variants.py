"""Interface-condition variants of the port's scalar solvers, mirroring
tests/test_bc_variants.py inside the port (f64, CPU) and holding each
solution against the JAX package's on the same capacity."""

import numpy as np
import jax.numpy as jnp
import torch

import penguin_tpu as jpt
from penguin_tpu.solvers import diffusion as jd
import penguin_tpu_torch as tpt
from penguin_tpu_torch.convert import CAPACITY_FIELDS, capacity_from_numpy
from penguin_tpu_torch.solvers import diffusion as td
from torch_stefan_cases import one_thread  # noqa: F401  (autouse fixture)

KEYS = ("left", "right", "top", "bottom")


def _pair(body, n, size):
    jcap = jpt.compute_capacity(body, jpt.Mesh(n, size))
    fields = {}
    for name in CAPACITY_FIELDS:
        v = getattr(jcap, name)
        fields[name] = None if v is None else (
            tuple(np.asarray(a) for a in v) if isinstance(v, tuple)
            else np.asarray(v))
    return jcap, capacity_from_numpy(fields, tpt.Mesh(n, size), device="cpu")


def _close(got, want, tol=1e-9):
    for a, b in zip(want, got):
        a = np.asarray(a)
        assert np.abs(b.numpy() - a).max() <= tol * max(np.abs(a).max(), 1.0)


def test_robin_interface_steady():
    """A strong Robin interface approaches Dirichlet, a weak one lets the
    field float higher; each solve matches JAX."""
    jcap, tcap = _pair(jpt.geometry.circle((2.0, 2.0), 1.0), (32, 32),
                       (4.0, 4.0))
    out = {}
    for pkg, mod, cap in ((jpt, jd, jcap), (tpt, td, tcap)):
        phase = pkg.Phase(cap, pkg.make_diffusion_ops(cap),
                          lambda x, y, z: 4.0, 1.0)
        bc_b = pkg.BorderConditions({k: pkg.Dirichlet(0.0) for k in KEYS})
        out[pkg] = []
        for bc_i in (pkg.Dirichlet(0.0), pkg.Robin(1000.0, 1.0, 0.0),
                     pkg.Robin(1.0, 1.0, 0.0)):
            s = mod.DiffusionSteadyMono(phase, bc_b, bc_i)
            out[pkg].append(s.solve(method="direct"))
    for j, t in zip(out[jpt], out[tpt]):
        _close(t, j)
    sel = tcap.cell_types == 1
    ud, ur, uw = (x[0][sel] for x in out[tpt])
    assert (ur - ud).abs().max() < 5e-2 * max(ud.abs().max().item(), 1)
    assert uw.max() > ud.max()


def test_neumann_interface_steady_lstsq():
    """A pure Neumann interface, compatible with the source: the min-norm
    least-squares solve leaves a residual below 1e-10 and matches JAX."""
    jcap, tcap = _pair(jpt.geometry.interval(2.0, 1.0), (24,), (4.0,))
    out = []
    for pkg, mod, cap in ((jpt, jd, jcap), (tpt, td, tcap)):
        phase = pkg.Phase(cap, pkg.make_diffusion_ops(cap),
                          lambda x, y, z: 1.0, 1.0)
        bc_b = pkg.BorderConditions({"bottom": pkg.Dirichlet(0.0),
                                     "top": pkg.Dirichlet(0.0)})
        s = mod.DiffusionSteadyMono(phase, bc_b, pkg.Neumann(-1.0))
        s.solve(method="lstsq")
        out.append(s)
    resid = max((a - b).abs().max().item()
                for a, b in zip(out[1].apply(out[1].x), out[1]._rhs()))
    assert resid < 1e-10
    _close(out[1].x, out[0].x)


def test_gibbs_thomson_interface():
    """GibbsThomson with no curvature or velocity term is Dirichlet(Tm)."""
    jcap, tcap = _pair(jpt.geometry.circle((2.0, 2.0), 1.0), (24, 24),
                       (4.0, 4.0))
    out = {}
    for pkg, mod, cap, zeros in (
            (jpt, jd, jcap, jnp.zeros),
            (tpt, td, tcap, lambda s: torch.zeros(s, dtype=torch.float64))):
        phase = pkg.Phase(cap, pkg.make_diffusion_ops(cap),
                          lambda x, y, z, t: 0.0, 1.0)
        bc_b = pkg.BorderConditions({k: pkg.Dirichlet(0.0) for k in KEYS})
        z = zeros((25, 25))
        out[pkg] = []
        for bc_i in (pkg.GibbsThomson(Tm=0.7, eps_k=0.0, eps_v=0.0),
                     pkg.Dirichlet(0.7)):
            s = mod.DiffusionUnsteadyMono(phase, bc_b, bc_i, 1e-3, (z, z),
                                          "BE")
            out[pkg].append(s.solve(1e-2, method="direct",
                                    keep_states=False))
    g, d = out[tpt]
    assert (g[0] - d[0]).abs().max().item() < 1e-12
    _close(g, out[jpt][0])

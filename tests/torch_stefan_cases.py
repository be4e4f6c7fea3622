"""Shared set-up of the port's phase-change tests: the Frank-disk cases of
the 2D Stefan tests (``test_torch_stefan2d*.py``), a solid disk of radius S
at t0 = 1 growing into liquid undercooled to T_INF on an 8 × 8 box, in
either package, and the one-thread fixture of every phase-change test
module."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import exp1

import penguin_tpu as jpt
from penguin_tpu.front_tracking import FrontTracker as JFront
from penguin_tpu_torch.front_tracking import FrontTracker as TFront

N, L, DT = 16, 8.0, 0.02
CENTER = (4.0, 4.0)
S = 1.0
T_INF = -(S**2 / 4) * np.exp(S**2 / 4) * exp1(S**2 / 4)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _close(got, want, tol):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want, dtype=np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    assert np.array_equal(np.isnan(g), np.isnan(w))
    g, w = np.nan_to_num(g), np.nan_to_num(w)
    assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1.0), \
        np.abs(g - w).max()


def frank_state(n=N, mesh=None):
    """The Frank-disk temperature at t0 = 1 on the centroids of the liquid
    (exterior) capacity, as the JAX tests build it, and the markers."""
    mesh = mesh or jpt.Mesh((n, n), (L, L), (0.0, 0.0))
    front = JFront().create_circle(CENTER, S, n=n)
    C = np.asarray(jpt.compute_capacity(lambda x, y: -front.sdf(x, y), mesh,
                                        p=4, s=1).C_om)
    r = np.sqrt((C[..., 0] - CENTER[0]) ** 2 + (C[..., 1] - CENTER[1]) ** 2)
    Tw = np.where(r >= S, T_INF * (1 - exp1(np.maximum(r**2 / 4, 1e-12))
                                   / exp1(S**2 / 4)), 0.0)
    return np.asarray(front.markers), Tw


def mono_solver(pkg, mod, bc_i, n=N, dtype=torch.float64):
    """(solver, front, ic) of the Frank disk in one package."""
    mk, Tw = frank_state(n)
    mesh = pkg.Mesh((n, n), (L, L), (0.0, 0.0))
    if pkg is jpt:
        u0, front = (jnp.asarray(Tw), jnp.zeros_like(jnp.asarray(Tw))), \
            JFront(mk)
    else:
        u0 = (_t(Tw, dtype), torch.zeros(Tw.shape, dtype=dtype))
        front = TFront(_t(mk, dtype))
    bc_b = pkg.BorderConditions({k: pkg.Dirichlet(float(T_INF))
                                 for k in ("left", "right", "top", "bottom")})
    phase = pkg.Phase(None, None, lambda x, y, z, t: 0.0, 1.0)
    ic = pkg.InterfaceConditions(pkg.ScalarJump(1.0, 1.0, 0.0),
                                 pkg.FluxJump(1.0, 1.0, 1.0))
    return mod.StefanMono2D(phase, bc_b, bc_i, DT, u0, mesh, "BE"), front, ic



def diph_solver(pkg, mod, n=N, dtype=torch.float64):
    """(solver, front) of the two-phase Frank disk: phase 1 the solid disk
    at Tm = 0, phase 2 the undercooled liquid (tests/test_stefan2d_diph.py)."""
    mk, Tw = frank_state(n)
    z = np.zeros_like(Tw)
    mesh = pkg.Mesh((n, n), (L, L), (0.0, 0.0))
    if pkg is jpt:
        u0, front = tuple(jnp.asarray(a) for a in (z, z, Tw, z)), JFront(mk)
    else:
        u0 = tuple(_t(a, dtype) for a in (z, z, Tw, z))
        front = TFront(_t(mk, dtype))
    bc_b = pkg.BorderConditions({k: pkg.Dirichlet(float(T_INF))
                                 for k in ("left", "right", "top", "bottom")})
    ph = pkg.Phase(None, None, lambda x, y, z, t: 0.0, 1.0)
    ic = pkg.InterfaceConditions(pkg.ScalarJump(1.0, 1.0, 0.0),
                                 pkg.FluxJump(1.0, 1.0, 1.0))
    return mod.StefanDiph2D(ph, ph, bc_b, ic, DT, u0, mesh, "BE"), front


def _mean_radius(markers):
    mk = markers.detach().numpy().astype(np.float64)
    return float(np.sqrt(((mk - np.asarray(CENTER)) ** 2).sum(1)).mean())


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The phase-change tests' tensors are small: one intra-op thread does
    their work as fast, and keeps parallel test workers from oversubscribing
    the cores.  Imported into each test module, where pytest uses it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

"""FastHeatBE set-ups the port's heat tests share, with no JAX: the CPU
tests against the early-exit loop and the ``cuda`` tests of the CG's
CUDA graphs."""

import torch

import penguin_tpu_torch as tpt
from penguin_tpu_torch.solvers import FastHeatBE

BORDERS = ("left", "right", "top", "bottom", "backward", "forward")

# (CG tolerance, iteration cap) by case: the CG converges mid-chunk, stops
# at a cap inside a chunk or at a chunk's end, or has converged before its
# first iteration (tolerance 1 from a zero start)
CG_CASES = {"converges": (1e-6, 64), "cap13": (1e-12, 13),
            "cap16": (1e-12, 16), "cap3": (1e-30, 3),
            "converged0": (1.0, 5)}


def heat_solver(ndim, n, dt_h2, device="cpu", cg_tol=1e-6, cg_maxiter=32,
                L=4.0):
    """FastHeatBE on n^ndim cells of [0, L]^ndim around a circle or sphere:
    Dirichlet 1 on the body, 0 on the borders, dt = dt_h2 h², f64."""
    mesh = tpt.Mesh((n,) * ndim, (L,) * ndim)
    body = (tpt.geometry.circle((2.0, 2.0), 1.0) if ndim == 2
            else tpt.geometry.sphere((2.0, 2.0, 2.0), 1.2))
    cap = tpt.compute_capacity(body, mesh, p=4, s=1, dtype=torch.float64,
                               device=device)
    borders = tpt.BorderConditions(
        {k: tpt.Dirichlet(0.0) for k in BORDERS[:2 * ndim]})
    return FastHeatBE(cap, tpt.make_diffusion_ops(cap), 1.0, 0.0,
                      tpt.Dirichlet(1.0), borders, dt_h2 * (L / n) ** 2,
                      cg_tol=cg_tol, cg_maxiter=cg_maxiter)

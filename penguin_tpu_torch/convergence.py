"""Volume-weighted error norms split by cell type, the project's primary
verification metric (torch counterpart of ``penguin_tpu.convergence``,
reference ``src/convergence.jl``).  The norms are computed on the host in
numpy: tensors are copied there, and the analytic solution is called with
numpy coordinates."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["lp_norm", "check_convergence", "check_convergence_diph"]


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def lp_norm(errors, mask, p, capacity):
    """Volume-weighted Lp (or L-inf) norm over cells selected by ``mask``.

    Matches the reference definition (src/convergence.jl:4-15):
    ``(Σ_i |e_i|^p V_i / Σ_all V)^(1/p)``.
    """
    errors = _np(errors)
    V = _np(capacity.V)
    mask = _np(mask).astype(bool)
    if np.isinf(p):
        if not mask.any():
            return 0.0
        return float(np.abs(errors[mask]).max())
    num = float((np.abs(errors[mask]) ** p * V[mask]).sum())
    den = float(V.sum())
    return (num / den) ** (1.0 / p)


def _eval_analytic(u_analytical, capacity):
    C = _np(capacity.C_om)
    return np.asarray(u_analytical(*[C[..., d] for d in range(C.shape[-1])]))


def check_convergence(u_analytical, solver, capacity, p=2, relative=False,
                      verbose=True):
    """Compare the solver's bulk field against an analytic solution at cell
    centroids; returns (u_ana, u_num, global, full, cut, empty) errors."""
    u_ana = _eval_analytic(u_analytical, capacity)
    u_num = _np(solver.x_omega)
    err = u_ana - u_num
    if relative:
        err = err / np.where(np.abs(u_ana) > 0, u_ana, 1.0)

    ct = _np(capacity.cell_types)
    masks = {
        "all": (ct == 1) | (ct == -1),
        "full": ct == 1,
        "cut": ct == -1,
        "empty": ct == 0,
    }
    out = {k: lp_norm(err, m, p, capacity) for k, m in masks.items()}
    if verbose:
        for k, v in out.items():
            print(f"{k:>5s} cells L{p} norm = {v:.6e}")
    return (u_ana, u_num, out["all"], out["full"], out["cut"], out["empty"])


def check_convergence_diph(u1_analytical, u2_analytical, solver, capacity1,
                           capacity2, p=2, relative=False, verbose=True):
    res1 = check_convergence(u1_analytical, solver.phase_view(0), capacity1, p,
                             relative, verbose=False)
    res2 = check_convergence(u2_analytical, solver.phase_view(1), capacity2, p,
                             relative, verbose=False)
    u_ana = (res1[0], res2[0])
    u_num = (res1[1], res2[1])
    glob = (res1[2], res2[2], max(res1[2], res2[2]))
    full = (res1[3], res2[3], max(res1[3], res2[3]))
    cut = (res1[4], res2[4], max(res1[4], res2[4]))
    empty = (res1[5], res2[5], max(res1[5], res2[5]))
    if verbose:
        print(f"phase1 global L{p}={glob[0]:.4e}  phase2 global L{p}={glob[1]:.4e}")
    return (u_ana, u_num, glob, full, cut, empty)

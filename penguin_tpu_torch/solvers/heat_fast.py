"""Backward-Euler heat stepper with a Dirichlet interface and Dirichlet
borders (torch counterpart of ``penguin_tpu.solvers.heat_fast``).

The interface closure row ``Γ T_γ = Γ g_γ`` is eliminated analytically
(T_γ := g_γ on cut cells), leaving one SPD system on the bulk field::

    (V + dt · Id · Gᵀ Wꜝ G) T_ω = V T_ωⁿ + dt V f − dt Id Gᵀ Wꜝ H g_γ

Every factor is diagonal-or-shift, so the operator collapses to a
(2N+1)-point variable-coefficient stencil whose coefficients (with the
inactive-cell identity rows and the Dirichlet border rows folded in) are
computed once.  The system is solved by Jacobi-preconditioned CG, warm
started by quadratic extrapolation, on the DOF grid as it is: the stencil
kernels take any shape, so the JAX version's tile padding and ghost-plane
trimming have no counterpart here.  In 2D and 3D the CG matvec is
``kernels.stencil.stencil5_matvec`` / ``stencil7_matvec``: the CUDA kernel
for CUDA tensors, the plain composite for CPU tensors.

CG termination stays on the device.  The JAX version tests
``vdot(r, r) > tol² · vdot(b, b)`` inside ``lax.while_loop``; a Python
``while`` on that tensor would wait for the device on every iteration.
Here the CG runs in chunks of ``CG_CHUNK`` iterations.  Each iteration
computes a device-side ``active`` flag, the same test the JAX loop makes,
and an inactive iteration is a no-op: its step lengths are zeroed, with
the divisions guarded first, so no NaN can appear.  The host reads the flag
once per chunk.  The iterate and the iteration count therefore equal the
early-exit loop's.  ``CG_CHUNK = 8`` covers the easy benchmark step (1-7
iterations) with one read, and costs at most 7 wasted iterations per solve.
"""

from __future__ import annotations

import torch

from ..assembly import (
    border_info,
    coefficient_diag,
    gamma_value_vector,
    source_vector,
    _col_G_nz,
)
from ..boundary import Dirichlet, eval_condition_value
from ..diagnostics import span
from ..kernels.stencil import _stencil_ref, stencil5_matvec, stencil7_matvec
from ..operators import _shift_m, _shift_p, _zlast, dm, dm_t

__all__ = ["FastHeatBE", "CG_CHUNK"]

CG_CHUNK = 8


def _apply_stencil(coeffs, x):
    """(2N+1)-point variable-coefficient matvec."""
    if x.dim() == 2:
        return stencil5_matvec(*coeffs, x)
    if x.dim() == 3:
        return stencil7_matvec(*coeffs, x)
    return _stencil_ref(coeffs, x)


def _dot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _cg(coeffs, dinv, tol2, maxiter, b, x, matvec=_apply_stencil, dot=_dot):
    """Jacobi-preconditioned CG from ``x``; returns (x, iterations) with the
    iteration count as a 0-d device tensor.  ``matvec(coeffs, x)`` and
    ``dot`` are the solver's ``_cg_matvec`` and ``_cg_dot``."""
    r = b - matvec(coeffs, x)
    z = dinv * r
    p = z
    rz = dot(r, z)
    bound = tol2 * torch.clamp_min(dot(b, b), 1e-30)
    rr = dot(r, r)
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    for _ in range(0, maxiter, CG_CHUNK):
        # one profiler span for launching the chunk and one for its host
        # read; none per iteration, where even ≈ 1 µs adds up
        with span("heat_fast.cg_chunk"):
            for _ in range(CG_CHUNK):
                active = (rr > bound) & (k < maxiter)
                Ap = matvec(coeffs, p)
                pAp = dot(p, Ap)
                alpha = torch.where(active,
                                    rz / torch.where(active, pAp, 1.0), 0.0)
                x = x + alpha * p
                r = r - alpha * Ap
                z = dinv * r
                rz_new = dot(r, z)
                beta = torch.where(active,
                                   rz_new / torch.where(active, rz, 1.0), 0.0)
                p = z + beta * p
                rz = torch.where(active, rz_new, rz)
                rr = dot(r, r)
                k = k + active.to(k.dtype)
        with span("heat_fast.cg_flag"):
            more = bool((rr > bound) & (k < maxiter))
        if not more:
            break
    return x, k


class FastHeatBE:
    """Backward-Euler heat stepper with Dirichlet interface + Dirichlet
    borders, eliminated interface unknowns, and stencil-collapsed CG.

    The tensors live on the capacity's device; ``dtype`` defaults to the
    capacity's dtype."""

    def __init__(self, capacity, ops, diffusion, source, bc_i, bc_b, dt,
                 cg_tol=1e-6, cg_maxiter=32, dtype=None):
        with span("heat_fast.build"):
            if dtype is None:
                dtype = capacity.V.dtype
            cast = lambda a: a.to(dtype)
            self.dt = dt = float(dt)
            V = cast(ops.V)
            A = tuple(cast(a) for a in ops.A)
            B = tuple(cast(b) for b in ops.B)
            Wdag = tuple(cast(w) for w in ops.Wdag)
            Id = cast(coefficient_diag(diffusion, capacity))
            g_gamma = cast(gamma_value_vector(bc_i, capacity))
            f_cells = cast(source_vector(source, capacity, 0.0))
            Gamma = cast(capacity.Gamma)
            ndim = len(A)

            # eliminated interface field: g on cut cells, 0 elsewhere
            Tg = torch.where(Gamma > 0, g_gamma, 0.0)

            border = border_info(capacity.mesh, bc_b, capacity=capacity)
            bmask = torch.zeros(V.shape, dtype=torch.bool, device=V.device)
            bvals = torch.zeros_like(V)
            for key, cond, axis, side, mask in border.items:
                if not isinstance(cond, Dirichlet):
                    raise ValueError(
                        "FastHeatBE supports Dirichlet borders only")
                bmask = bmask | mask
                bvals = torch.where(
                    mask, cast(eval_condition_value(cond.value, border.pos)),
                    bvals)

            active = ((V != 0.0) | _col_G_nz(ops)) & (~bmask)

            # collapse V + dt·Id·GᵀWꜝG to a (2N+1)-point stencil
            #   y_j = c_c x_j + Σ_d (c_m[d] x_{j-1_d} + c_p[d] x_{j+1_d})
            # row m (padding) vanishes automatically because B[m] = 0.
            c_c = V
            c_m, c_p = [], []
            for d in range(ndim):
                diag_d = _zlast(
                    B[d] ** 2 * (Wdag[d] + _shift_p(Wdag[d], d)), d)
                c_c = c_c + dt * Id * diag_d
                c_m.append(-dt * Id * B[d] * Wdag[d] * _shift_m(B[d], d))
                c_p.append(-dt * Id * B[d] * _shift_p(Wdag[d] * B[d], d))
            # masking folded into the coefficients: inactive/border ->
            # identity row
            c_c = torch.where(active, c_c, 1.0)
            coeffs = [c_c]
            for d in range(ndim):
                coeffs += [torch.where(active, c_m[d], 0.0),
                           torch.where(active, c_p[d], 0.0)]

            # constant rhs pieces: dt·V·f − dt·Id·GᵀWꜝH g_γ  (+ border values)
            h_apply = 0.0
            for d in range(ndim):
                q = Wdag[d] * (A[d] * dm(Tg, d) - dm(B[d] * Tg, d))
                h_apply = h_apply + Id * (B[d] * dm_t(q, d))
            rhs_const = dt * V * f_cells - dt * h_apply
            rhs_const = torch.where(active, rhs_const, 0.0)
            rhs_const = torch.where(bmask, bvals, rhs_const)

            diag = torch.where(c_c == 0, 1.0, c_c)
            self._coeffs = tuple(c.contiguous() for c in coeffs)
            self._dinv = 1.0 / diag
            self._Va = torch.where(active, V, 0.0)
            self._rhs = rhs_const
            self._tol2 = torch.tensor(cg_tol * cg_tol, dtype=dtype,
                                      device=V.device)
            self._cg_maxiter = int(cg_maxiter)

            self.Tg = Tg
            self.active = active
            self.dtype = dtype

    # the CG's matvec and dot: ``parallel.sharding`` replaces them on one
    # rank's copy (a halo exchange before the stencil, a sum over the ranks
    # after the dot)
    _cg_matvec = staticmethod(_apply_stencil)
    _cg_dot = staticmethod(_dot)

    # ------------------------------------------------------------------
    def step(self, Tw, x0=None):
        """One BE step: returns (T_{n+1}, cg_iters) with ``cg_iters`` a 0-d
        tensor on the device."""
        b = self._Va * Tw + self._rhs
        x0 = Tw if x0 is None else x0
        return _cg(self._coeffs, self._dinv, self._tol2, self._cg_maxiter,
                   b, x0.contiguous(), matvec=self._cg_matvec,
                   dot=self._cg_dot)

    def matvec(self, x):
        return self._cg_matvec(self._coeffs, x.contiguous())

    def _steps(self, T0, n_steps):
        # quadratically extrapolated warm start (x0 = 3Tn - 3Tn-1 + Tn-2)
        T = T1 = T2 = T0
        for _ in range(n_steps):
            # closed before the yield: the caller's work stays outside
            with span("heat_fast.step"):
                Tn, iters = self.step(T, 3.0 * T - 3.0 * T1 + T2)
            T, T1, T2 = Tn, T, T1
            yield T, iters

    def run(self, T0, n_steps):
        """n_steps of BE from T0; returns T_n."""
        T = T0
        for T, _ in self._steps(T0, n_steps):
            pass
        return T

    def run_telemetry(self, T0, n_steps):
        """Like :meth:`run`, also returning (cg_iters_last, cg_iters_max)
        over the span as 0-d device tensors."""
        T = T0
        last = mx = torch.zeros((), dtype=torch.int64, device=T0.device)
        for T, last in self._steps(T0, n_steps):
            mx = torch.maximum(mx, last)
        return T, last, mx

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
Here the CG runs in chunks of ``CG_CHUNK`` iterations on a state that each
iteration updates in place.  Each iteration ends by computing the next
one's device-side ``active`` flag, the same test the JAX loop makes, and an
inactive iteration is a no-op: its step lengths are zeroed, with the
divisions guarded first, so no NaN can appear.  The host reads the flag
once per chunk.  The iterate and the iteration count therefore equal the
early-exit loop's.  ``CG_CHUNK = 8`` covers the easy benchmark step (1-7
iterations) with one read, and costs at most 7 wasted iterations per solve.

On a card the chunks are CUDA graphs.  A chunk is ≈ 240 small kernels;
issued one by one from Python, each costs more host time than device time,
so the device mostly waits.  The first solve of a solver captures two
graphs through ``_graph.capture``, in one private memory pool, after an
eager warm-up on a side stream: ``first`` (the prologue, from the
right-hand side and the starting iterate in two static buffers, and one
chunk) and ``more`` (one further chunk).  A solve fills the buffers,
replays ``first``, then ``more`` while the flag says so, and returns a copy
of the iterate.  The kernels, their order and the results are those of the
eager chunks.  The graphs engage where ``_graph.may_replay`` lets them
(CUDA fields on the current device, of the solver's shape and dtype,
outside another capture) and the matvec and dot are the module's own.  A
CPU solver, or a copy whose matvec or dot is replaced on the instance (the
decomposed CG of ``parallel.sharding``), runs the same chunks eagerly.
"""

from __future__ import annotations

import torch

from .. import _graph
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


class _Chunks:
    """One CG solve, issued a chunk at a time on a state that each iteration
    updates in place: the iterate ``x`` (the tensor given), ``r``, ``p``,
    ``rz``, the iteration count ``k`` and the next iteration's flag
    ``active``.  ``first`` runs the prologue and one chunk, ``more`` one
    further chunk.  ``matvec(coeffs, x)`` and ``dot`` are the solver's
    ``_cg_matvec`` and ``_cg_dot``."""

    def __init__(self, coeffs, dinv, tol2, maxiter, b, x, matvec, dot):
        self.coeffs, self.dinv, self.tol2 = coeffs, dinv, tol2
        self.maxiter, self.b, self.x = maxiter, b, x
        self.matvec, self.dot = matvec, dot

    def first(self):
        b, dot = self.b, self.dot
        self.r = r = b - self.matvec(self.coeffs, self.x)
        self.p = z = self.dinv * r
        self.rz = dot(r, z)
        self.bound = self.tol2 * torch.clamp_min(dot(b, b), 1e-30)
        self.k = torch.zeros((), dtype=torch.int64, device=b.device)
        self.active = (dot(r, r) > self.bound) & (self.k < self.maxiter)
        self.more()

    def more(self):
        coeffs, dinv, matvec, dot = self.coeffs, self.dinv, self.matvec, \
            self.dot
        x, r, p, rz, k, active = (self.x, self.r, self.p, self.rz, self.k,
                                  self.active)
        for _ in range(CG_CHUNK):
            Ap = matvec(coeffs, p)
            pAp = dot(p, Ap)
            alpha = torch.where(active,
                                rz / torch.where(active, pAp, 1.0), 0.0)
            x.add_(alpha * p)
            r.sub_(alpha * Ap)
            z = dinv * r
            rz_new = dot(r, z)
            beta = torch.where(active,
                               rz_new / torch.where(active, rz, 1.0), 0.0)
            torch.add(z, beta * p, out=p)
            torch.where(active, rz_new, rz, out=rz)
            rr = dot(r, r)
            k.add_(active.to(k.dtype))
            torch.bitwise_and(rr > self.bound, k < self.maxiter, out=active)


def _issue(first, more, cg):
    """Issues ``first``, then ``more`` while the flag ``cg.active`` is up,
    reading it once a chunk: at least one chunk, at most
    ``ceil(maxiter / CG_CHUNK)``."""
    chunk = first
    for _ in range(0, max(cg.maxiter, 1), CG_CHUNK):
        # one profiler span for issuing the chunk and one for its host
        # read; none per iteration, where even ≈ 1 µs adds up
        with span("heat_fast.cg_chunk"):
            chunk()
        with span("heat_fast.cg_flag"):
            go = bool(cg.active)
        if not go:
            break
        chunk = more


def _cg(coeffs, dinv, tol2, maxiter, b, x, matvec=_apply_stencil, dot=_dot):
    """Jacobi-preconditioned CG from ``x``, issued eagerly; returns (x,
    iterations) with the iteration count as a 0-d device tensor.  ``x`` is
    left as it was."""
    cg = _Chunks(coeffs, dinv, tol2, maxiter, b,
                 x.clone(memory_format=torch.contiguous_format), matvec, dot)
    _issue(cg.first, cg.more, cg)
    return cg.x, cg.k


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
            self._cg_graphs = None

    # the CG's matvec and dot: ``parallel.sharding`` replaces them on one
    # rank's copy (a halo exchange before the stencil, a sum over the ranks
    # after the dot)
    _cg_matvec = staticmethod(_apply_stencil)
    _cg_dot = staticmethod(_dot)

    def __copy__(self):
        # a copy captures graphs of its own: this solver's read its buffers
        new = object.__new__(type(self))
        vars(new).update(vars(self))
        new._cg_graphs = None
        return new

    def _graphs(self, *fields):
        """``(chunks, first, more)``: the CG's state over its static buffers
        and its graphs (see the module docstring), captured on first use,
        where they may replay on ``fields``; None where the CG is eager."""
        Va = self._Va
        if not (self._cg_matvec is _apply_stencil and self._cg_dot is _dot
                and _graph.may_replay(fields, (Va,) * len(fields))):
            return None
        if self._cg_graphs is None:
            arrays = (self._coeffs, self._dinv, self._tol2, self._cg_maxiter,
                      torch.zeros_like(Va), torch.zeros_like(Va))
            cg = _Chunks(*arrays, _apply_stencil, _dot)
            # the plain stencil warms up: the kernel needs none, and the
            # device then runs only the solves' stencil launches
            warm = _Chunks(*arrays, _stencil_ref, _dot)
            graphs, _ = _graph.capture((cg.first, cg.more), Va.device,
                                       "heat_fast.cg_graph",
                                       warm_up=(warm.first, warm.more))
            self._cg_graphs = (cg, *graphs)
        return self._cg_graphs

    # ------------------------------------------------------------------
    def step(self, Tw, x0=None):
        """One BE step: returns (T_{n+1}, cg_iters) with ``cg_iters`` a 0-d
        tensor on the device."""
        x0 = Tw if x0 is None else x0
        graphs = self._graphs(Tw, x0)
        if graphs is None:
            return _cg(self._coeffs, self._dinv, self._tol2,
                       self._cg_maxiter, self._Va * Tw + self._rhs, x0,
                       matvec=self._cg_matvec, dot=self._cg_dot)
        cg, first, more = graphs
        torch.add(self._Va * Tw, self._rhs, out=cg.b)
        if x0 is not cg.x:
            cg.x.copy_(x0)
        _issue(first, more, cg)
        # new tensors, which later solves leave alone
        return cg.x.clone(), cg.k.clone()

    def matvec(self, x):
        return self._cg_matvec(self._coeffs, x.contiguous())

    def _steps(self, T0, n_steps):
        # quadratically extrapolated warm start (x0 = 3Tn - 3Tn-1 + Tn-2)
        T = T1 = T2 = T0
        for _ in range(n_steps):
            # closed before the yield: the caller's work stays outside
            with span("heat_fast.step"):
                # on the graph path straight into the buffer the CG reads
                graphs = self._graphs(T)
                x0 = torch.add(3.0 * T - 3.0 * T1, T2,
                               out=None if graphs is None else graphs[0].x)
                Tn, iters = self.step(T, x0)
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

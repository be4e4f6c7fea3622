"""1D Stefan (free-boundary phase change) solvers (torch).

Counterpart of ``penguin_tpu.solvers.stefan1d`` (reference
liquidmotionsolver/diffusion.jl): per time step, a fixed-point/Newton
iteration over the interface position xf:

1. solve the space-time slab temperature system with the interface
   interpolated linearly in time between the step-start anchor ``xf_a`` and
   the current iterate ``xf_b`` (body ``x - (xf_a (t1-t) + xf_b (t-t0))/dt``,
   diffusion.jl:280-288);
2. interface flux ``Σ Id Hᵀ Wꜝ (G Tω + H Tγ)`` (diffusion.jl:247-255);
3. residual ``res = ΣV(t0) - ΣV(t1) - flux/ρL``;
4. ``xf ← xf + step(res)`` with a pluggable learning-rate strategy
   (fixed / adagrad / rmsprop / nadam / Barzilai-Borwein / secant,
   diffusion.jl:43-122).

The JAX version runs the time loop as one jitted ``lax.scan`` with a
``lax.while_loop`` Newton inside.  Here both are Python loops: the front
position, the residual and the learning-rate state stay on the device, and
the convergence test is read on the host once per Newton iteration (each
iteration is a whole slab build, so that read is cheap); the per-step logs
are copied to numpy once after the loop.  The slab time ``t_start + k·dt``
is a Python float, as in the moving classes.

Same documented deviation from the reference as the JAX version: the slab
rhs uses the converged previous-step state throughout the Newton
iterations.

``MovingLiquidDiffusionUnsteadyMonoCoupled`` solves its Newton system with
an SVD minimum-norm least-squares solve whose cut-off is JAX's
``jnp.linalg.lstsq`` default (``eps·max(M, N)`` of the largest singular
value), on every device: its Jacobian can be singular (the 3-cell fusion of
the Stefan rows is a tridiagonal [1 1 1], singular whenever 3 divides the
row count, and inactive cells give identity rows), and
``torch.linalg.lstsq`` on CUDA only offers ``gels``, which assumes full
rank.

The analytic similarity constants (``find_lambda_stefan`` etc.) are the
port's own numpy/scipy copies.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..assembly import _col_G_nz, _col_H_nz, border_info
from ..capacity import compute_capacity_spacetime
from ..linsolve import _lstsq_min_norm, host_read
from .diffusion import _ScalarSolverBase
from .moving_diffusion import (
    _direct_solve,
    _eval_D,
    _eval_f,
    _eval_g,
    _like,
    _num_slabs,
    build_moving_diph_stef_system,
    build_moving_mono_system,
    psi_weights,
    slice_spacetime,
)

__all__ = ["MovingLiquidDiffusionUnsteadyMono",
           "MovingLiquidDiffusionUnsteadyMonoCoupled",
           "MovingLiquidDiffusionUnsteadyDiph", "solve_stefan_1d_adaptive",
           "interface_flux_1d", "find_lambda_stefan",
           "find_lambda_stefan_two_phase", "stefan_interface_position"]


def _interp_body_1d(x, t, params):
    """Fluid x < xf(t), xf linear in slab time (slab times are [0, dt])."""
    xf_a, xf_b, dt = params
    return x - (xf_a * (dt - t) + xf_b * t) / dt


def interface_flux_1d(cap_st, D, Tw, Tg):
    """Σ Id Hᵀ Wꜝ (G Tω + H Tγ) on the slab's spatial block."""
    ops, Va, Vb, Gamma0, C_sp, _ = slice_spacetime(cap_st)
    Id = _eval_D(D, C_sp)
    q = ops.flux(Tw, Tg)
    return torch.sum(Id * ops.HT(q)), Va, Vb


def lr_state_init(like):
    """(grad_accum, mean_grad_sq, m, v) accumulators (LearningRateState,
    diffusion.jl:3-41), zeros of ``like``'s dtype on its device."""
    z = torch.zeros((), dtype=like.dtype, device=like.device)
    return (z, z, z, z)


def _lr_step(strategy, alpha, res, xf_b, prev_xf, prev_grad, it,
             lr_state=None, eps=1e-8, beta1=0.9, beta2=0.999):
    """Learning-rate strategies (apply_learning_rate_step!,
    diffusion.jl:43-122) on 0-d tensors; ``it`` is the host iteration
    count.  Returns (step, new_lr_state)."""
    if lr_state is None:
        lr_state = lr_state_init(res)
    accum, msq, m, v = lr_state
    if strategy == "fixed":
        return alpha * res, lr_state
    if strategy == "adagrad":
        accum = accum + res * res
        lr = alpha / (torch.sqrt(accum) + eps)
        return lr * res, (accum, msq, m, v)
    if strategy == "rmsprop":
        msq = beta2 * msq + (1 - beta2) * res * res
        lr = alpha / (torch.sqrt(msq) + eps)
        return lr * res, (accum, msq, m, v)
    if strategy == "nadam":
        tt = it + 1.0
        m = beta1 * m + (1 - beta1) * res
        v = beta2 * v + (1 - beta2) * res * res
        bc1 = max(1 - beta1**tt, eps)
        bc2 = max(1 - beta2**tt, eps)
        m_hat = m / bc1
        v_hat = v / bc2
        lr = alpha / (torch.sqrt(v_hat) + eps)
        direction = beta1 * m_hat + (1 - beta1) * res / bc1
        return lr * direction, (accum, msq, m, v)
    dx = xf_b - prev_xf
    dg = res - prev_grad
    if strategy in ("bb", "barzilai_borwein"):
        if it == 0:
            return alpha * res, lr_state
        denom = torch.where(dg.abs() > eps, dg * dg, 0.0)
        # 1e-300 rounds to 0 in f32, as the JAX literal does: the where
        # keeps the 0/0 out of lr
        lr = torch.where(denom > 0,
                         (dx * dg).abs() / torch.clamp_min(denom, 1e-300),
                         alpha)
        return lr * res, lr_state
    if strategy == "secant":
        if it == 0:
            return alpha * res, lr_state
        big = dg.abs() > eps
        prop = -res * dx / torch.where(big, dg, 1.0)
        return torch.where(big, prop, alpha * res), lr_state
    raise ValueError(f"unknown learning-rate strategy {strategy}")


def _still_iterating(it, max_iter, tol, err, extra=None):
    """The Newton loops' ``while`` test.  ``err`` starts at inf, so the first
    test needs no read; later ones read one device flag (``err > tol`` and
    ``extra``, a device condition, when given)."""
    if it >= max_iter:
        return False
    if it == 0:
        return math.inf > tol
    go = err > tol
    if extra is not None:
        go = go & extra
    return bool(host_read(go))


def _xf_newton(slab_solve, Told, xf_start, newton_params, lr_strategy,
               relative=True):
    """Fixed-point/Newton iteration over the front position of one step:
    ``slab_solve(Told, xf_a, xf_b) -> (state, res)``.  Returns
    (state, xf, err, iterations)."""
    max_iter, tol, reltol, alpha = newton_params
    max_iter = int(max_iter)
    T, xf_b, pxf = Told, xf_start, xf_start
    pg = torch.zeros_like(xf_start)
    lrs = lr_state_init(xf_start)
    err = torch.full_like(xf_start, math.inf)
    it = 0
    while _still_iterating(it, max_iter, tol, err,
                           err > reltol * xf_b.abs() if relative else None):
        Tn, res = slab_solve(Told, xf_start, xf_b)
        step, lrs = _lr_step(lr_strategy, alpha, res, xf_b, pxf, pg, it, lrs)
        T, xf_b, pxf, pg, err = Tn, xf_b + step, xf_b, res, res.abs()
        it += 1
    return T, xf_b, err, it


def _march_front(newton_step, u0, xf0, t_start, dt, K):
    """The K+1 steps of a 1D front solver: ``newton_step(state, xf, t)``
    returns (state, xf, err, iterations).  Returns (state, xf_log, errs,
    iterations); the logs stay on the device until one read."""
    T = u0
    xf = torch.as_tensor(xf0, **_like(u0))
    xfs, errs, iters = [], [], []
    for k in range(K + 1):
        T, xf, err, it = newton_step(T, xf, t_start + k * dt)
        xfs.append(xf)
        errs.append(err)
        iters.append(it)
    logs = host_read(torch.stack([torch.stack(xfs), torch.stack(errs)]))
    return T, logs[0], logs[1], np.asarray(iters)


class _Front1DBase(_ScalarSolverBase):
    def _record(self, T, xf_log, errs, iters):
        self.x = T
        self.xf = float(xf_log[-1])
        self.xf_log = xf_log
        self.newton_errs = errs
        self.newton_iters = iters
        self.states = [T]
        return self.x


class _Mono1D(_Front1DBase):
    def __init__(self, phase, bc_b, bc_i, dt, u0, mesh, scheme="BE"):
        self.phase = phase
        self.bc_b = bc_b
        self.bc_i = bc_i
        self.dt = float(dt)
        self.u0 = u0
        self.mesh = mesh
        self.scheme = scheme
        self.border = border_info(mesh, bc_b, **_like(u0))

    def _slab(self, xf_a, xf_b, dt, p, s):
        return compute_capacity_spacetime(
            _interp_body_1d, self.mesh, 0.0, dt, p=p, s=s,
            params=(xf_a, xf_b, dt), **_like(self.u0))

    def _mono_slab_solve(self, t, dt, rhoL, p, s):
        """``(Told, xf_a, xf_b) -> (T, res)`` of the one-phase slab."""
        D, f = self.phase.diffusion, self.phase.source

        def slab_solve(Told, xf_a, xf_b):
            cap = self._slab(xf_a, xf_b, dt, p, s)
            apply_fn, rhs_fn = build_moving_mono_system(
                cap, D, f, self.bc_i, self.border, t, dt, self.scheme)
            T = _direct_solve(apply_fn, rhs_fn(Told))
            flux, Va, Vb = interface_flux_1d(cap, D, T[0], T[1])
            return T, torch.sum(Va) - torch.sum(Vb) - flux / rhoL

        return slab_solve


class MovingLiquidDiffusionUnsteadyMono(_Mono1D):
    """1D one-phase Stefan solver."""

    def solve(self, xf0, t_start, t_end, ic,
              newton_params=(1000, 1e-10, 1e-10, 1.0),
              method="direct", lr_strategy="fixed", p=6, s=1):
        """Returns the final state; ``xf_log``, ``newton_errs`` and
        ``newton_iters`` per step.  ``ic.flux.value`` is ρL."""
        dt = self.dt
        K = _num_slabs(dt, t_start, t_end)
        rhoL = ic.flux.value

        def newton_step(Told, xf, t):
            return _xf_newton(self._mono_slab_solve(t, dt, rhoL, p, s), Told,
                              xf, newton_params, lr_strategy)

        return self._record(*_march_front(newton_step, self.u0, xf0, t_start,
                                          dt, K))


class MovingLiquidDiffusionUnsteadyMonoCoupled(_Mono1D):
    """Coupled-Newton 1D Stefan: Newton on the extended unknown
    z = (Tω, Tγ, V_future), temperature and the future cut-cell volumes
    solved simultaneously (reference coupled_newton_step!,
    liquidmotionsolver/diffusion_coupled.jl:14-209).

    Extended residual per cell (geometry refreshed each iteration):

    - bulk row ``F = Va Tω + Id GᵀWꜝG ψ⁺(Tω,Tγ) - (Va - Vf) Tγ
      - (Vf Tω_old + V f)``, the moving-scheme row with the end-of-slab
      volume Vf as an unknown;
    - Stefan row ``R = ρL (Va - Vf) - Id Hᵀ Wꜝ (G Tω + H Tγ)``, fused over
      each cell's 3-cell neighbourhood;
    - value row ``Tγ - g`` on interface cells.

    The 3m×3m Jacobian is exact (``torch.func.jacfwd`` of the residual over
    the flattened unknown) and the Newton step is the SVD minimum-norm
    least-squares solution (see the module docstring); the front moves by
    the geometric identity δxf = Σ δVf."""

    def solve(self, xf0, t_start, t_end, ic,
              newton_params=(40, 1e-10, 1e-10, 1.0), p=6, s=1):
        dt = self.dt
        K = _num_slabs(dt, t_start, t_end)
        max_iter, tol, reltol, damp = newton_params
        max_iter = int(max_iter)
        rhoL = ic.flux.value
        D, f = self.phase.diffusion, self.phase.source
        bc_i, border, scheme = self.bc_i, self.border, self.scheme

        def newton_iter(Tprev, Titer, xf_a, xf_b, t):
            # Tprev: converged previous-step field (the rhs mass term);
            # Titer: the current Newton iterate (linearization point)
            cap = self._slab(xf_a, xf_b, dt, p, s)
            ops, Va, Vb, Gamma0, C_sp, Cg_sp = slice_spacetime(cap)
            psip, psim = psi_weights(scheme, Vb, Va)
            Id = _eval_D(D, C_sp)
            bulk_act = (Va != 0) | (Vb != 0) | _col_G_nz(ops)
            ifc_act = (Gamma0 != 0) | _col_H_nz(ops)
            gg = _eval_g(bc_i, Cg_sp, Gamma0, t)
            Tw0, Tg0 = Tprev
            fn1 = _eval_f(f, C_sp, t + dt)
            if scheme == "CN":
                fn = _eval_f(f, C_sp, t)
                qm = ops.flux(psim * Tw0, torch.zeros_like(Tg0))
                hterm = ops.flux(torch.zeros_like(Tw0), Tg0)
                b_fixed = (-Id * ops.GT(qm) - 0.5 * Id * ops.GT(hterm)
                           + 0.5 * ops.V * (fn + fn1))
            else:
                b_fixed = ops.V * fn1

            def residual(Tw, Tg, Vf):
                q = ops.flux(psip * Tw, psip * Tg)
                Fw = Va * Tw + Id * ops.GT(q) - (Va - Vf) * Tg
                Fw = torch.where(bulk_act, Fw, Tw)
                if border is not None:
                    Fw = border.matvec(Fw, Tw)
                b1v = Vf * Tw0 + b_fixed
                if border is not None:
                    b1v = border.rhs(b1v, t)
                Fw = Fw - b1v
                R = rhoL * (Va - Vf) - Id * ops.HT(ops.flux(Tw, Tg))
                # 1D stencil fusion (the 2D solver's 3x3 box filter,
                # stefan.jl:588-785): each interface row becomes the
                # aggregate balance of its 3-cell neighbourhood
                zero = R.new_zeros(1)
                R = R + torch.cat([zero, R[:-1]]) + torch.cat([R[1:], zero])
                Gr = torch.where(ifc_act, Tg - gg, Tg)
                return Fw, R, Gr

            m = Va.numel()

            def flat_residual(v):
                parts = residual(*(c.reshape(Va.shape) for c in v.split(m)))
                return torch.cat([r.reshape(-1) for r in parts])

            flat = torch.cat([Titer[0].reshape(-1), Titer[1].reshape(-1),
                              Vb.reshape(-1)])
            rflat = flat_residual(flat)
            J = torch.func.jacfwd(flat_residual)(flat)
            rcond = torch.finfo(J.dtype).eps * max(J.shape)
            dTw, dTg, dVf = (c.reshape(Va.shape) for c in
                             _lstsq_min_norm(J, -rflat, rcond).split(m))
            Tn = (Titer[0] + damp * dTw, Titer[1] + damp * dTg)
            # 1D geometric identity: total fluid volume = fluid length
            return Tn, xf_b + damp * torch.sum(dVf), torch.linalg.norm(rflat)

        def newton_step(Told, xf_start, t):
            T, xf_b = Told, xf_start
            err = torch.full_like(xf_start, math.inf)
            it = 0
            while _still_iterating(
                    it, max_iter, tol, err,
                    err > reltol * torch.clamp_min(xf_b.abs(), 1.0)):
                T, xf_b, err = newton_iter(Told, T, xf_start, xf_b, t)
                it += 1
            return T, xf_b, err, it

        return self._record(*_march_front(newton_step, self.u0, xf0, t_start,
                                          dt, K))


def _adaptive_dt(v_max, h_min, cfl_target, dt_cur, dt_min, dt_max,
                 growth=1.1, shrink=0.8, safety=0.9):
    """The interface-CFL controller (utils.adapt_timestep): ``v_max`` a 0-d
    tensor, ``dt_cur`` a number; returns a 0-d tensor."""
    dt_opt = safety * cfl_target * h_min / torch.clamp_min(v_max, 1e-10)
    dt_new = torch.where(dt_opt > dt_cur,
                         torch.clamp_max(dt_opt, dt_cur * growth),
                         torch.clamp_min(dt_opt, dt_cur * shrink))
    dt_new = torch.where(v_max < 1e-10,
                         torch.full_like(dt_new, min(dt_cur * growth, dt_max)),
                         dt_new)
    return torch.clamp(dt_new, dt_min, dt_max)


class MovingLiquidDiffusionUnsteadyDiph(_Front1DBase):
    """1D two-phase Stefan (Neumann problem): Newton over the front with
    the diphasic slab system; the residual sums the interface fluxes of
    both phases (reference liquidmotionsolver/diffusion.jl:653-900:
    ``res = H_{n+1} - H_n - (flux1 + flux2)/ρL``)."""

    def __init__(self, phase1, phase2, bc_b, ic, dt, u0, mesh, scheme="BE"):
        self.phase1, self.phase2 = phase1, phase2
        self.bc_b = bc_b
        self.ic = ic
        self.dt = float(dt)
        self.u0 = u0
        self.mesh = mesh
        self.scheme = scheme

    def solve(self, xf0, t_start, t_end,
              newton_params=(1000, 1e-10, 1e-10, 1.0),
              lr_strategy="fixed", p=6, s=1):
        dt = self.dt
        K = _num_slabs(dt, t_start, t_end)
        rhoL = self.ic.flux.value
        D1, f1 = self.phase1.diffusion, self.phase1.source
        D2, f2 = self.phase2.diffusion, self.phase2.source
        mesh, scheme, ic, bc_b = self.mesh, self.scheme, self.ic, self.bc_b
        like = _like(self.u0)

        def body2(x, t, params):
            return -_interp_body_1d(x, t, params)

        def slab_solve(Told, xf_a, xf_b, t):
            caps = [compute_capacity_spacetime(
                body, mesh, 0.0, dt, p=p, s=s, params=(xf_a, xf_b, dt),
                **like) for body in (_interp_body_1d, body2)]
            b1m, b2m = (border_info(mesh, bc_b,
                                    phase_mask=c.cell_types[..., 0] != 0,
                                    **like) for c in caps)
            apply_fn, rhs_fn = build_moving_diph_stef_system(
                caps[0], caps[1], D1, D2, f1, f2, ic, b1m, b2m, t, dt, scheme)
            X = _direct_solve(apply_fn, rhs_fn(Told))
            flux1, Va, Vb = interface_flux_1d(caps[0], D1, X[0], X[1])
            flux2, _, _ = interface_flux_1d(caps[1], D2, X[2], X[3])
            return X, torch.sum(Va) - torch.sum(Vb) - (flux1 + flux2) / rhoL

        def newton_step(Xold, xf, t):
            return _xf_newton(lambda X, a, b: slab_solve(X, a, b, t), Xold,
                              xf, newton_params, lr_strategy)

        return self._record(*_march_front(newton_step, self.u0, xf0, t_start,
                                          dt, K))


def solve_stefan_1d_adaptive(solver, xf0, t_start, t_end, ic,
                             newton_params=(200, 1e-10, 1e-10, 1.0),
                             cfl_target=0.5, dt_min=1e-6, dt_max=0.1,
                             max_steps=500, lr_strategy="fixed", p=6, s=1):
    """Adaptive-Δt driver for MovingLiquidDiffusionUnsteadyMono (reference
    adaptive_timestep path, liquidmotionsolver/diffusion.jl:309-333): Δt
    adapts to the interface CFL.  The time and the slab width are host
    floats, read once per step (the JAX version carries them traced)."""
    rhoL = ic.flux.value
    h_min = min(solver.mesh.h)
    T = solver.u0
    xf = torch.as_tensor(xf0, **_like(solver.u0))
    t, dt, k = float(t_start), solver.dt, 0
    while t < t_end - 1e-12 and k < max_steps:
        dt_c = min(dt, t_end - t)
        T, xfn, _, _ = _xf_newton(
            solver._mono_slab_solve(t, dt_c, rhoL, p, s), T, xf,
            newton_params, lr_strategy, relative=False)
        v = (xfn - xf).abs() / dt_c
        dt = float(host_read(_adaptive_dt(v, h_min, cfl_target, dt_c, dt_min,
                                          dt_max)))
        xf, t, k = xfn, t + dt_c, k + 1
    solver.x = T
    solver.xf = float(host_read(xf))
    solver.t_final = float(t)
    solver.n_steps = int(k)
    return solver.x


def find_lambda_stefan(stefan_number, x0=0.1):
    """λ with λ e^{λ²} erf λ = St/√π (Stefan_1d_1ph.jl:17-21)."""
    from scipy.optimize import brentq
    from scipy.special import erf

    def fun(lam):
        return lam * np.exp(lam**2) * erf(lam) - stefan_number / np.sqrt(np.pi)

    return brentq(fun, 1e-6, 5.0)


def stefan_interface_position(t, k, lam):
    return 2.0 * lam * np.sqrt(k * t)


def find_lambda_stefan_two_phase(st_l, st_s, alpha_ratio=1.0):
    """λ for the two-phase Neumann problem (equal-property form):
    St_l/(e^{λ²} erf λ) - St_s √a/(e^{a λ²} erfc(λ√a)) = λ√π, a = α_l/α_s."""
    from scipy.optimize import brentq
    from scipy.special import erf, erfc

    a = alpha_ratio

    def fun(lam):
        return (
            st_l / (np.exp(lam**2) * erf(lam))
            - st_s * np.sqrt(a) / (np.exp(a * lam**2) * erfc(lam * np.sqrt(a)))
            - lam * np.sqrt(np.pi)
        )

    return brentq(fun, 1e-6, 3.0)

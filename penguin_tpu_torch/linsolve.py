"""Matrix-free linear solvers (torch).

Counterpart of ``penguin_tpu.linsolve``.  Systems stay matrix-free:
inactive DOFs are identity equations (``x_i = 0``), exactly equivalent to
the reference's ``remove_zero_rows_cols!``, and solves are:

- ``direct``: materialize the operator densely (``torch.func.vmap`` of the
  flat apply over the identity, in column blocks) + LU.  Small systems.
- ``pcg`` / ``pbicgstab``: Jacobi-preconditioned Krylov on trees of
  tensors.  The JAX loops test convergence on the device under
  ``lax.while_loop``; here the iterations run in chunks of ``CHUNK``.  Each
  iteration computes a device-side ``active`` flag (the JAX loop's test)
  and an inactive iteration selects its old state, so it is a no-op; the
  host reads the flag once per chunk.  Iterate and count equal the
  early-exit loop's.
- ``pgmres`` / ``fgmres``: restarted GMRES.  The Arnoldi vectors and the
  modified Gram-Schmidt stay on the device; the Hessenberg column comes to
  the host once per Arnoldi step, where the Givens rotations and the
  early-exit test run in numpy scalars of the working dtype.
- ``gmres``: the algorithm of ``jax.scipy.sparse.linalg.gmres`` with
  ``solve_method="batched"``, which ``KrylovSolver(method="gmres")`` calls.

A tree is a tensor or a tuple, list or dict of trees.  Every Krylov solver
returns ``(x, iters, relres)``: ``iters`` a Python int, ``relres`` a
scalar.  Every copy to the host goes through :func:`host_read`, which
counts them in ``host_read.count``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "materialize_dense",
    "solve_linear",
    "DenseFactorSolver",
    "KrylovSolver",
    "pcg",
    "pbicgstab",
    "pgmres",
    "fgmres",
    "gmres",
    "row_norm_equilibrator",
    "host_read",
    "CHUNK",
]

# pcg/pbicgstab iterations between two host reads of the convergence flag
CHUNK = 8


def host_read(t):
    """Copy ``t`` to a numpy array; counts the reads in ``host_read.count``
    (on a CUDA tensor each one waits for the device)."""
    host_read.count += 1
    return t.detach().cpu().numpy()


host_read.count = 0


# ---------------------------------------------------------------------------
# trees of tensors
# ---------------------------------------------------------------------------

def _tree_map(fn, *trees):
    t = trees[0]
    if isinstance(t, torch.Tensor):
        return fn(*trees)
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(u[k] for u in trees)) for k in t}
    return type(t)(_tree_map(fn, *parts) for parts in zip(*trees))


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [leaf for sub in tree for leaf in _leaves(sub)]


def _unflatten(template, leaves):
    """Rebuild ``template``'s structure from an iterator of leaves."""
    if isinstance(template, torch.Tensor):
        return next(leaves)
    if isinstance(template, dict):
        built = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: built[k] for k in template}
    return type(template)(_unflatten(sub, leaves) for sub in template)


def _ravel(tree):
    """(flat vector, unravel) of a tree, like ``jax.flatten_util``."""
    leaves = _leaves(tree)
    shapes = [leaf.shape for leaf in leaves]
    sizes = [leaf.numel() for leaf in leaves]
    flat = torch.cat([leaf.reshape(-1) for leaf in leaves])

    def unravel(v):
        parts = (p.reshape(s) for p, s in zip(v.split(sizes), shapes))
        return _unflatten(tree, parts)

    return flat, unravel


def _tdot(a, b):
    """Tree dot product."""
    return sum(torch.dot(x.reshape(-1), y.reshape(-1))
               for x, y in zip(_leaves(a), _leaves(b)))


def _dots(reduce):
    """``dots(*pairs)``: the tree dots of ``pairs``, a list.  ``reduce``
    (the Krylov solvers' private ``_reduce``) maps a stacked tensor of this
    process's partial sums to their sums over the ranks, so dots that are
    independent of each other travel in one reduction; ``None`` is the
    whole-grid path, each dot on its own."""
    if reduce is None:
        return lambda *pairs: [_tdot(a, b) for a, b in pairs]
    return lambda *pairs: list(reduce(torch.stack(
        [_tdot(a, b) for a, b in pairs])).unbind())


def _taxpy(alpha, x, y):
    return _tree_map(lambda a, b: alpha * a + b, x, y)


def _tsub(x, y):
    return _tree_map(lambda a, b: a - b, x, y)


def _select(flag, new, old):
    return _tree_map(lambda a, b: torch.where(flag, a, b), new, old)


def _make_prec(Minv):
    if Minv is None:
        return lambda r: r
    if callable(Minv):
        return Minv
    return lambda r: _tree_map(lambda a, b: a * b, Minv, r)


def _dtype_of(tree):
    return _leaves(tree)[0].dtype


def _guards(tree, tol):
    """(tiny, floored tol) for the working dtype: ``tiny`` is the smallest
    normal number (a literal 1e-300 flushes to 0 in f32 and turns every
    breakdown branch into a division by zero); the floor 8·eps keeps an
    f32 Krylov from iterating into rounding-noise breakdowns.  ``tol`` may
    be a tensor (``KrylovSolver``'s ``atol`` bump)."""
    fi = torch.finfo(_dtype_of(tree))
    floor = 8.0 * fi.eps
    if isinstance(tol, torch.Tensor):
        return fi.tiny, torch.clamp_min(tol, floor)
    return fi.tiny, max(float(tol), floor)


def _np_dtype(dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


# ---------------------------------------------------------------------------
# CG and BiCGStab, chunked with a device-side convergence flag
# ---------------------------------------------------------------------------

def _chunked(body, state, live, maxiter):
    """Run ``body`` while ``live(state)`` holds, reading the flag on the host
    once per ``CHUNK`` iterations.  ``body(state, active)`` must return the
    old state where ``active`` is false.  Returns (state, iterations)."""
    k = torch.zeros((), dtype=torch.int64, device=_leaves(state)[0].device)
    for _ in range(0, max(int(maxiter), 0), CHUNK):
        for _ in range(CHUNK):
            active = live(state) & (k < maxiter)
            state = body(state, active)
            k = k + active.to(k.dtype)
        go, k_host = host_read(torch.stack(
            [(live(state) & (k < maxiter)).to(k.dtype), k]))
        if not go:
            return state, int(k_host)
    return state, int(host_read(k))


def pcg(apply_fn, b, x0, Minv=None, tol=1e-8, maxiter=500, *,
        _reduce=None):
    """Jacobi(/diagonal)-preconditioned conjugate gradients on trees.

    ``Minv``: tree of inverse-diagonal entries, or a callable
    ``r -> M⁻¹r`` (None = identity).  Returns ``(x, iters, relres)`` with
    ``relres = ||r||/||b||``.  No best-iterate tracking and no stagnation
    patience, as in the JAX version: either makes x a discontinuous
    function of (A, b).  ``parallel.sharding`` passes a private
    ``_reduce`` that sums the ranks' partial dots (see :func:`_dots`), so
    every rank sees the same values."""
    prec = _make_prec(Minv)
    dots = _dots(_reduce)
    tiny, tol = _guards(b, tol)
    r0 = _tsub(b, apply_fn(x0))
    z0 = prec(r0)
    bb, rz0, rr0 = dots((b, b), (r0, z0), (r0, r0))
    bb = torch.clamp_min(bb, tiny)
    bound = (tol * tol) * bb

    def body(st, active):
        x, r, p, rz, rr = st
        Ap = apply_fn(p)
        pAp, = dots((p, Ap))
        alpha = rz / torch.where(pAp != 0, pAp, 1.0)
        x_n = _taxpy(alpha, p, x)
        r_n = _taxpy(-alpha, Ap, r)
        z = prec(r_n)
        rz_n, rr_n = dots((r_n, z), (r_n, r_n))
        beta = rz_n / torch.where(rz != 0, rz, 1.0)
        p_n = _taxpy(beta, p, z)
        return _select(active, (x_n, r_n, p_n, rz_n, rr_n), st)

    # no isfinite() bailout either: a transient f32 overflow (rr = Inf)
    # keeps iterating through `Inf > bound` and recovers
    st, k = _chunked(body, (x0, r0, z0, rz0, rr0),
                     lambda st: st[4] > bound, maxiter)
    return st[0], k, torch.sqrt(st[4] / bb)


def pbicgstab(apply_fn, b, x0, Minv=None, tol=1e-8, maxiter=500, *,
              _reduce=None):
    """Preconditioned BiCGStab on trees (right preconditioning).
    ``Minv``: inverse-diagonal tree or callable ``r -> M⁻¹r``.
    Returns ``(x, iters, relres)``; no best-iterate/patience adaptivity
    (see :func:`pcg`).  ``_reduce``: as in :func:`pcg`."""
    prec = _make_prec(Minv)
    dots = _dots(_reduce)
    tiny, tol = _guards(b, tol)
    r0 = _tsub(b, apply_fn(x0))
    bb, rr0 = dots((b, b), (r0, r0))
    bb = torch.clamp_min(bb, tiny)
    bound = (tol * tol) * bb

    zeros = _tree_map(torch.zeros_like, b)
    one = torch.ones((), dtype=_dtype_of(b), device=_leaves(b)[0].device)
    # ρ-breakdown threshold scales with the rounding noise of the dtype
    brk_tol = 1e-12 if torch.finfo(_dtype_of(b)).eps < 1e-10 else 1e-6

    def safe(d):
        return torch.where(d.abs() > tiny, d, tiny)

    def body(st, active):
        x, r, rhat, p, v, rho, alpha, omega, rr = st
        rho_n, rhat2 = dots((rhat, r), (rhat, rhat))
        # ρ-breakdown (serendipitous ⟂ of r and the shadow residual):
        # restart with rhat := r, the standard remedy; without it the 1/ρ
        # guard amplifies garbage until the iterate NaNs
        brk = rho_n.abs() < brk_tol * torch.sqrt(
            torch.clamp_min(rhat2, tiny) * torch.clamp_min(rr, tiny))
        rhat_n = _select(brk, r, rhat)
        rho_n = torch.where(brk, rr, rho_n)
        # β = 0 on restart makes the direction p := r below
        beta = torch.where(brk, 0.0,
                           (rho_n / safe(rho)) * (alpha / safe(omega)))
        p_n = _tree_map(lambda rr_, pp, vv: rr_ + beta * (pp - omega * vv),
                        r, p, v)
        phat = prec(p_n)
        v_n = apply_fn(phat)
        rv, = dots((rhat_n, v_n))
        alpha_n = rho_n / safe(rv)
        s = _taxpy(-alpha_n, v_n, r)
        shat = prec(s)
        t = apply_fn(shat)
        ts, tt = dots((t, s), (t, t))
        omega_n = ts / safe(tt)
        x_n = _tree_map(lambda xx, ph, sh: xx + alpha_n * ph + omega_n * sh,
                        x, phat, shat)
        r_n = _taxpy(-omega_n, t, s)
        rr_n, = dots((r_n, r_n))
        return _select(active, (x_n, r_n, rhat_n, p_n, v_n, rho_n, alpha_n,
                                omega_n, rr_n), st)

    init = (x0, r0, r0, zeros, zeros, one, one, one, rr0)
    st, k = _chunked(body, init, lambda st: st[8] > bound, maxiter)
    return st[0], k, torch.sqrt(st[8] / bb)


def row_norm_equilibrator(apply_fn, template, probes=8):
    """Matrix-free row-norm estimate for left equilibration.

    For Rademacher probes z, ``E[(Az)_i²] = Σ_j A_ij²``, so ``probes``
    applications of the operator estimate every row 2-norm at once.
    Returns a tree of inverse row norms to pass as ``Minv`` (left) to
    :func:`pgmres`.  The probes come from a CPU ``torch.Generator`` seeded
    0 and then move to the template's device, so the card and the CPU get
    the same estimate.  (The JAX version draws them with ``jax.random``:
    other bits, the same distribution.)"""
    gen = torch.Generator().manual_seed(0)
    leaves = _leaves(template)
    acc = _tree_map(torch.zeros_like, template)
    for _ in range(probes):
        z = _unflatten(template, iter([
            (2 * torch.randint(0, 2, leaf.shape, generator=gen) - 1)
            .to(dtype=leaf.dtype, device=leaf.device) for leaf in leaves]))
        y = apply_fn(z)
        acc = _tree_map(lambda a, v: a + v * v, acc, y)
    return _tree_map(
        lambda a: 1.0 / torch.clamp_min(torch.sqrt(a / probes), 1e-30), acc)


# ---------------------------------------------------------------------------
# restarted GMRES (host-side Hessenberg)
# ---------------------------------------------------------------------------

def _norm(reduce):
    """The 2-norm of a flat vector: ``torch.linalg.norm`` on the whole
    grid, the root of the summed dot under a private ``_reduce``."""
    if reduce is None:
        return torch.linalg.norm
    return lambda v: torch.sqrt(reduce(torch.dot(v, v)))


def _arnoldi_cycle(Af, Mz, x, rhs, m, thresh, np_dt, reduce=None):
    """One restart cycle of GMRES(m) from ``x``, with the early exit on the
    running Givens residual ``|g[j]|``.  ``Af`` maps a flat vector to the
    flat image the basis is built from; ``Mz`` (flexible GMRES) maps a basis
    vector to the direction stored in Z, or is None.  ``reduce``: the
    solvers' ``_reduce``; each Gram-Schmidt dot is then one reduction.
    Returns (x_new, |g[j_f]|, j_f)."""
    dot = torch.dot if reduce is None else (
        lambda a, b: reduce(torch.dot(a, b)))
    norm = _norm(reduce)
    r = rhs - Af(x)
    beta = norm(r)
    n = r.numel()
    V = torch.empty((m + 1, n), dtype=r.dtype, device=r.device)
    V[0] = r / torch.where(beta == 0, 1.0, beta)
    Z = None if Mz is None else torch.empty_like(V[:m])
    R = np.zeros((m + 1, m), np_dt)
    cs = np.zeros(m, np_dt)
    sn = np.zeros(m, np_dt)
    g = np.zeros(m + 1, np_dt)
    g[0] = host_read(beta)
    j = 0
    # the fixed-depth cycle oversolved by up to a full restart
    while j < m and g[j] ** 2 > thresh:
        if Z is None:
            w = Af(V[j])
        else:
            Z[j] = Mz(V[j])
            w = Af(Z[j])
        # modified Gram-Schmidt over the vectors built so far
        hs = []
        for i in range(j + 1):
            hij = dot(V[i], w)
            w = w - hij * V[i]
            hs.append(hij)
        hnext_d = norm(w)
        V[j + 1] = w / torch.where(hnext_d == 0, 1.0, hnext_d)
        col = host_read(torch.stack(hs + [hnext_d]))
        h = np.zeros(m + 1, np_dt)
        h[:j + 1] = col[:j + 1]
        hnext = col[j + 1]
        for i in range(j):
            hi = cs[i] * h[i] + sn[i] * h[i + 1]
            hi1 = -sn[i] * h[i] + cs[i] * h[i + 1]
            h[i], h[i + 1] = hi, hi1
        # new rotation eliminating (h[j], hnext)
        denom = np.sqrt(h[j] ** 2 + hnext ** 2)
        safe = np_dt.type(1.0) if denom == 0 else denom
        c_j = np_dt.type(1.0) if denom == 0 else h[j] / safe
        s_j = hnext / safe
        cs[j], sn[j] = c_j, s_j
        h[j] = c_j * h[j] + s_j * hnext
        g[j + 1] = -s_j * g[j]
        g[j] = c_j * g[j]
        R[:, j] = h
        j += 1
    # back substitution on the rotated (upper-triangular) R.  Columns >= j
    # were never set and get unit diagonals, but g[j] holds the NONZERO
    # Givens residual estimate: left in, it makes y[j] = g[j] and x picks up
    # a spurious g[j]·V[j] term (true residual ~||A||x the reported
    # relres).  Mask g above the completed depth so unrun columns
    # contribute exactly zero.
    Rm = R[:m, :m].copy()
    dg = np.diagonal(Rm).copy()
    Rm[np.diag_indices(m)] = np.where(np.abs(dg) < 1e-30, 1.0, dg)
    gm = np.where(np.arange(m) < j, g[:m], 0.0).astype(np_dt)
    y = torch.linalg.solve_triangular(torch.from_numpy(Rm),
                                      torch.from_numpy(gm)[:, None],
                                      upper=True)[:, 0].to(x.device)
    if Z is None:
        rows = min(j + 1, m)           # V[j] is set; y[j] is masked to 0
        x_new = x + V[:rows].T @ y[:rows]
    else:
        x_new = x + Z[:j].T @ y[:j]    # Z[j] was never set
    return x_new, np.abs(g[j]), j


def _gmres(Af, Mz, rhs, x0, b_tree, tol, maxiter, restart, reduce=None):
    np_dt = _np_dtype(rhs.dtype)
    # the restart depth is the global size's bound (the same on every rank)
    m = int(restart if reduce is not None else min(restart, rhs.numel()))
    tiny, tol = _guards(b_tree, tol)
    r0 = rhs - Af(x0)
    if reduce is None:
        pair = [torch.clamp_min(torch.dot(rhs, rhs), tiny),
                torch.linalg.norm(r0)]
    else:
        bb_d, rr_d = reduce(torch.stack([torch.dot(rhs, rhs),
                                         torch.dot(r0, r0)]))
        pair = [torch.clamp_min(bb_d, tiny), torch.sqrt(rr_d)]
    bb, rnorm = host_read(torch.stack(pair))
    thresh = np_dt.type(float(tol) * float(tol)) * bb
    x, k = x0, 0
    while rnorm * rnorm > thresh and k < maxiter:
        x, rnorm, j_f = _arnoldi_cycle(Af, Mz, x, rhs, m, thresh, np_dt,
                                       reduce)
        k += j_f
    return x, k, rnorm / np.sqrt(bb)


def pgmres(apply_fn, b, x0, Minv=None, tol=1e-8, maxiter=500, restart=40, *,
           _reduce=None):
    """Left-preconditioned restarted GMRES(m) on trees with telemetry.

    ``Minv`` (inverse-diagonal tree or callable) is applied on the LEFT:
    row equilibration, which the badly row-scaled cut-cell saddle/jump
    systems need.  Returns ``(x, iters, relres)``; ``relres`` is in the
    preconditioned residual norm.  ``_reduce``: as in :func:`pcg`;
    Gram-Schmidt stays modified, one summed dot per Hessenberg entry."""
    prec = _make_prec(Minv)
    pb, unravel = _ravel(prec(b))
    x0_flat = _ravel(x0)[0]

    def Af(v):
        return _ravel(prec(apply_fn(unravel(v))))[0]

    x, k, relres = _gmres(Af, None, pb, x0_flat, b, tol, maxiter, restart,
                          _reduce)
    return unravel(x), k, relres


def fgmres(apply_fn, b, x0, Minv=None, tol=1e-8, maxiter=500, restart=40, *,
           _reduce=None):
    """Flexible restarted GMRES (right preconditioning, Saad 1993).

    The preconditioner may be a NONLINEAR operator (an inner Krylov solve):
    each Arnoldi vector's preconditioned image ``z_j = M(v_j)`` is stored
    and the update is ``x += Z y``.  ``relres`` is in the TRUE
    (unpreconditioned) residual norm.  Returns ``(x, iters, relres)``.
    ``_reduce``: as in :func:`pgmres`."""
    prec = _make_prec(Minv)
    b_flat, unravel = _ravel(b)
    x0_flat = _ravel(x0)[0]

    def Af(v):
        return _ravel(apply_fn(unravel(v)))[0]

    def Mz(v):
        return _ravel(prec(unravel(v)))[0]

    x, k, relres = _gmres(Af, Mz, b_flat, x0_flat, b, tol, maxiter, restart,
                          _reduce)
    return unravel(x), k, relres


# ---------------------------------------------------------------------------
# jax.scipy.sparse.linalg.gmres, solve_method="batched"
# ---------------------------------------------------------------------------

def _safe_normalize(x, thresh=None):
    norm = torch.linalg.norm(x)
    if thresh is None:
        thresh = torch.finfo(x.dtype).eps
    use = norm > thresh
    return (torch.where(use, x / norm, 0.0), torch.where(use, norm, 0.0))


def gmres(apply_fn, b, x0=None, tol=1e-5, atol=0.0, restart=20, maxiter=None,
          M=None):
    """Restarted GMRES as ``jax.scipy.sparse.linalg.gmres`` computes it with
    ``solve_method="batched"``: LEFT-preconditioned (the basis spans
    ``M(A(v))``), every cycle builds the whole ``restart``-deep basis unless
    the Arnoldi step breaks down (classical Gram-Schmidt, one pass), and
    solves the small least-squares problem by its normal equations.  Cycles
    repeat while the preconditioned residual norm exceeds
    ``max(tol·‖b‖, atol)``, at most ``maxiter`` cycles (default 10·n).
    ``M`` is a callable or None.  Returns ``(x, iters, relres)`` with
    ``iters`` the Arnoldi steps taken and ``relres`` the preconditioned
    residual norm over ‖b‖."""
    b_flat, unravel = _ravel(b)
    x = torch.zeros_like(b_flat) if x0 is None else _ravel(x0)[0]
    n = b_flat.numel()
    dtype = b_flat.dtype
    eps = torch.finfo(dtype).eps

    def A(v):
        return _ravel(apply_fn(unravel(v)))[0]

    def Mf(v):
        return v if M is None else _ravel(M(unravel(v)))[0]

    maxiter = 10 * n if maxiter is None else maxiter
    restart = min(restart, n)
    b_norm = torch.linalg.norm(b_flat)
    atol_t = torch.clamp_min(tol * b_norm, atol)
    unit, rnorm = _safe_normalize(Mf(b_flat - A(x)))
    k = steps = 0
    while k < maxiter and host_read(rnorm > atol_t):
        V = torch.zeros((restart + 1, n), dtype=dtype, device=x.device)
        V[0] = unit
        H = torch.eye(restart, restart + 1, dtype=dtype, device=x.device)
        for j in range(restart):
            v = Mf(A(V[j]))
            _, v_norm_0 = _safe_normalize(v)
            h = V @ v
            v = v - V.T @ h
            unit_v, v_norm_1 = _safe_normalize(v, thresh=eps * v_norm_0)
            V[j + 1] = unit_v
            h[j + 1] = v_norm_1
            H[j] = h
            steps += 1
            if host_read(v_norm_1 == 0):
                break
        beta = torch.zeros(restart + 1, dtype=dtype, device=x.device)
        beta[0] = rnorm
        a = H.T
        chol = torch.linalg.cholesky(a.T @ a)
        y = torch.cholesky_solve((a.T @ beta)[:, None], chol)[:, 0]
        x = x + V[:-1].T @ y
        unit, rnorm = _safe_normalize(Mf(b_flat - A(x)))
        k += 1
    return unravel(x), steps, rnorm / b_norm


# ---------------------------------------------------------------------------
# dense paths
# ---------------------------------------------------------------------------

# entries per vmapped block of identity columns (bounds the batched
# intermediates of materialize_dense)
_DENSE_BLOCK = 1 << 22


def materialize_dense(apply_fn, template):
    """Build the dense matrix of a linear tree operator.

    ``apply_fn(x) -> y`` with x, y trees shaped like ``template``.  Returns
    (A, unravel) where ``A[i, j]`` acts on the raveled vector.  The apply
    is vmapped over blocks of identity columns."""
    flat, unravel = _ravel(template)
    n = flat.numel()

    def flat_apply(v):
        return _ravel(apply_fn(unravel(v)))[0]

    eye = torch.eye(n, dtype=flat.dtype, device=flat.device)
    block = max(1, _DENSE_BLOCK // max(n, 1))
    rows = [torch.func.vmap(flat_apply)(eye[i:i + block])
            for i in range(0, n, block)]
    return torch.cat(rows).T, unravel


def _keep_mask(A):
    """Reference drop semantics: index i is inactive when row i or column i
    is all-zero."""
    return (A.abs().sum(dim=1) > 0.0) & (A.abs().sum(dim=0) > 0.0)


def _identity_fixed(A, keep):
    d = keep.to(A.dtype)
    return A * d[:, None] * d[None, :] + torch.diag(1.0 - d)


def _fix_inactive_dense(A, b):
    """Inactive rows/cols are replaced by identity and their rhs by 0."""
    keep = _keep_mask(A)
    return _identity_fixed(A, keep), torch.where(keep, b, 0.0)


class DenseFactorSolver:
    """LU-factorized dense solve for repeated right-hand sides (the unsteady
    time loops reuse the factorization every step, mirroring the
    reference's single matrix build per scheme)."""

    def __init__(self, apply_fn, template):
        A_raw, self.unravel = materialize_dense(apply_fn, template)
        self.keep = _keep_mask(A_raw)
        self.lu, self.piv = torch.linalg.lu_factor(
            _identity_fixed(A_raw, self.keep))

    def solve(self, b, x0=None):
        flat_b = torch.where(self.keep, _ravel(b)[0], 0.0)
        x = torch.linalg.lu_solve(self.lu, self.piv, flat_b[:, None])[:, 0]
        return self.unravel(x)


def _lstsq_min_norm(A, b, rcond):
    """Min-norm SVD least squares, as ``jnp.linalg.lstsq`` computes it."""
    u, s, vt = torch.linalg.svd(A, full_matrices=False)
    mask = (s > 0) & (s >= rcond * s[0])
    s_inv = torch.where(mask, 1.0 / torch.where(mask, s, 1.0), 0.0)
    return vt.T @ (s_inv * (u.T @ b))


class KrylovSolver:
    """Matrix-free Krylov wrapper: the in-house ``pcg``/``pbicgstab``, the
    row-equilibrated restarted ``pgmres`` (the robust choice for
    nonsymmetric/convective cut-cell systems) and the JAX-batched
    ``gmres``.  For pgmres pass ``template`` (any tree shaped like b) so
    the row-norm equilibrator is estimated once at construction, not per
    step.  Telemetry: ``iters`` and ``relres`` of the last solve, and
    ``history``, the iterations of every solve."""

    def __init__(self, apply_fn, method="bicgstab", tol=1e-10, atol=0.0,
                 maxiter=None, M=None, template=None, restart=150):
        self.apply_fn = apply_fn
        self.method = method
        self.tol = tol
        self.atol = atol
        self.maxiter = maxiter
        self.M = M
        self.restart = restart
        self.Minv = (row_norm_equilibrator(apply_fn, template)
                     if method == "pgmres" and template is not None else None)
        self.iters = None
        self.relres = None
        self.history = []

    def solve(self, b, x0=None):
        x = self._solve(b, x0)
        self.history.append(self.iters)
        return x

    def _solve(self, b, x0):
        if x0 is None:
            x0 = _tree_map(torch.zeros_like, b)
        if self.method == "pgmres":
            Minv = self.Minv
            if Minv is None:
                Minv = row_norm_equilibrator(self.apply_fn, b)
            x, self.iters, self.relres = pgmres(
                self.apply_fn, b, x0, Minv=Minv, tol=self.tol,
                maxiter=self.maxiter or 2000, restart=self.restart)
            return x
        # the in-house solvers converge on relres <= tol (floored at 8·eps
        # of the working dtype, so tol=0 means "to rounding noise"); the
        # absolute criterion max(tol·||b||, atol) maps onto that as a tol
        # bump
        tol_eff = self.tol
        if self.atol:
            flat_b = _ravel(b)[0]
            bnorm = torch.clamp_min(torch.linalg.norm(flat_b),
                                    torch.finfo(flat_b.dtype).tiny)
            tol_eff = torch.clamp_min(self.atol / bnorm, self.tol)
        if self.method in ("cg", "pcg"):
            x, self.iters, self.relres = pcg(
                self.apply_fn, b, x0, Minv=self.M, tol=tol_eff,
                maxiter=self.maxiter or 2000)
        elif self.method in ("bicgstab", "pbicgstab"):
            x, self.iters, self.relres = pbicgstab(
                self.apply_fn, b, x0, Minv=self.M, tol=tol_eff,
                maxiter=self.maxiter or 2000)
        elif self.method == "gmres":
            x, self.iters, self.relres = gmres(
                self.apply_fn, b, x0=x0, tol=self.tol, atol=self.atol,
                maxiter=self.maxiter, M=self.M)
        else:
            raise ValueError(f"unknown Krylov method {self.method}")
        return x


def solve_linear(apply_fn, b, method="auto", x0=None, tol=1e-10, maxiter=None,
                 M=None):
    """One-shot linear solve.  ``method``: auto | direct | lstsq | pgmres |
    cg | bicgstab | gmres.  ``auto`` chooses direct for n <= 8000 and
    pgmres otherwise."""
    flat_b, _ = _ravel(b)
    n = flat_b.numel()
    if method == "auto":
        method = "direct" if n <= 8000 else "pgmres"
    if method == "pgmres":
        # row-equilibrated restarted GMRES, the restart length sized to a
        # ~1.2 GB f64 Krylov-basis budget
        Minv = row_norm_equilibrator(apply_fn, b)
        restart = int(min(150, max(20, 1.5e8 // max(n, 1))))
        x, _, _ = pgmres(apply_fn, b, x0 if x0 is not None else
                         _tree_map(torch.zeros_like, b),
                         Minv=Minv, tol=tol, maxiter=maxiter or 2000,
                         restart=restart)
        return x
    if method == "direct":
        A, unravel = materialize_dense(apply_fn, b)
        A, bb = _fix_inactive_dense(A, flat_b)
        return unravel(torch.linalg.solve(A, bb))
    if method == "lstsq":
        # min-norm SVD solve: handles structurally singular saddle points
        # (orphan pressure modes)
        A, unravel = materialize_dense(apply_fn, b)
        A, bb = _fix_inactive_dense(A, flat_b)
        return unravel(_lstsq_min_norm(A, bb, 1e-12))
    solver = KrylovSolver(apply_fn, method=method, tol=tol, maxiter=maxiter,
                          M=M)
    return solver.solve(b, x0=x0)

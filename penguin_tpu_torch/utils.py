"""Field initializers, velocity generators, small-cell remedies, and the
adaptive time-step controller (torch counterpart of ``penguin_tpu.utils``:
the reference's ``src/utils.jl``, the capacity-cleaning utilities of
``src/capacity.jl:693-851``, and ``adapt_timestep`` of
``src/solver.jl:611-662``).

The initializers put their tensors on ``device``, by default the CUDA
device, in ``dtype`` (float64); the capacity transforms follow the
capacity's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ._device import resolve_device

__all__ = [
    "initialize_temperature_uniform",
    "initialize_temperature_square",
    "initialize_temperature_circle",
    "initialize_temperature_function",
    "initialize_rotating_velocity_field",
    "initialize_poiseuille_velocity_field",
    "initialize_radial_velocity_field",
    "remove_small_volumes",
    "clamp_merge_small_cells",
    "adapt_timestep",
    "volume_redefinition",
    "moment_consistent_W",
]


def _to(a, dtype, device):
    return torch.as_tensor(np.asarray(a), device=resolve_device(device)).to(
        dtype)


# -- temperature initializers (utils.jl:5-56) -------------------------------

def initialize_temperature_uniform(mesh, value, dtype=torch.float64,
                                   device=None):
    T = torch.full(mesh.np_shape, value, dtype=dtype,
                   device=resolve_device(device))
    return T, T


def _dof_coords(mesh):
    """Node coordinates broadcast over the DOF grid (numpy)."""
    N = mesh.ndim
    out = []
    for d in range(N):
        c = np.asarray(mesh.nodes[d], dtype=np.float64)
        shp = [1] * N
        shp[d] = mesh.np_shape[d]
        out.append(np.broadcast_to(c.reshape(shp), mesh.np_shape))
    return out


def initialize_temperature_square(mesh, center, half_width, value, base=0.0,
                                  dtype=torch.float64, device=None):
    X, Y = _dof_coords(mesh)[:2]
    m = (np.abs(X - center[0]) <= half_width) & (
        np.abs(Y - center[1]) <= half_width)
    T = _to(np.where(m, value, base), dtype, device)
    return T, T


def initialize_temperature_circle(mesh, center, radius, value, base=0.0,
                                  dtype=torch.float64, device=None):
    X, Y = _dof_coords(mesh)[:2]
    m = (X - center[0]) ** 2 + (Y - center[1]) ** 2 <= radius**2
    T = _to(np.where(m, value, base), dtype, device)
    return T, T


def initialize_temperature_function(mesh, func, dtype=torch.float64,
                                    device=None):
    """``func`` is called with numpy DOF-grid coordinates."""
    T = _to(func(*_dof_coords(mesh)), dtype, device)
    return T, T


# -- velocity field generators (utils.jl:62-130) ----------------------------

def initialize_rotating_velocity_field(mesh, magnitude=1.0, center=None,
                                       dtype=torch.float64, device=None):
    X, Y = _dof_coords(mesh)[:2]
    if center is None:
        center = (
            mesh.x0[0] + mesh.domain_size[0] / 2,
            mesh.x0[1] + mesh.domain_size[1] / 2,
        )
    return (_to(-(Y - center[1]) * magnitude, dtype, device),
            _to((X - center[0]) * magnitude, dtype, device))


def initialize_poiseuille_velocity_field(mesh, dtype=torch.float64,
                                         device=None):
    X, Y = _dof_coords(mesh)[:2]
    return (_to(X * (1 - X), dtype, device),
            torch.zeros(mesh.np_shape, dtype=dtype,
                        device=resolve_device(device)))


def initialize_radial_velocity_field(mesh, center, magnitude=1.0,
                                     dtype=torch.float64, device=None):
    X, Y = _dof_coords(mesh)[:2]
    r = np.sqrt((X - center[0]) ** 2 + (Y - center[1]) ** 2)
    r = np.where(r > 0, r, 1.0)
    return (_to((X - center[0]) / r * magnitude, dtype, device),
            _to((Y - center[1]) / r * magnitude, dtype, device))


# -- small-cell remedies (capacity.jl:693-851) ------------------------------

def remove_small_volumes(capacity, tol):
    """Zero out every capacity entry of cells with V < tol (functional
    version of remove_small_volumes!); returns a new Capacity."""
    small = capacity.V < tol
    kf = (~small).to(capacity.V.dtype)
    return dataclasses.replace(
        capacity,
        V=capacity.V * kf,
        Gamma=capacity.Gamma * kf,
        cell_types=torch.where(small, 0, capacity.cell_types).to(
            capacity.cell_types.dtype),
        A=tuple(a * kf for a in capacity.A),
        B=tuple(b * kf for b in capacity.B),
        W=tuple(w * kf for w in capacity.W),
        C_om=capacity.C_om * kf[..., None],
    )


def clamp_merge_small_cells(capacity, tol=1e-12):
    """Merge sliver cut cells (0 < V < tol) into their nearest face
    neighbor with V >= tol, the conditioning remedy of
    ``clamp_merge_small_cells!`` (reference src/capacity.jl:746-851),
    as a functional fixed-shape transform:

    - V, Γ and the per-axis A/B/W diagonals of the source are summed into
      the target; target centroid becomes the volume-weighted average;
      source entries are zeroed (cell_type -> 0);
    - targets are restricted to the 2N face neighbors (for a resolved
      interface the nearest good cell is always face-adjacent);
    - already-empty cells are skipped (their merge is a no-op).

    Ties between equally near neighbours go to the first direction in the
    order (axis 0 +, axis 0 −, axis 1 +, ...), as ``argmin`` picks.
    Returns ``(new_capacity, n_merged)`` with ``n_merged`` a 0-d tensor."""
    V = capacity.V
    N = capacity.ndim
    small = (V > 0) & (V < tol)
    good = V >= tol
    C = capacity.C_om

    # candidate directions: (axis, ±1); rolling by -s brings the value of
    # neighbour (idx + s) onto the small cell's slot
    dirs = [(d, s) for d in range(N) for s in (+1, -1)]
    d2s = []
    for d, s in dirs:
        # roll wraps across the domain; the wrapped slots land on the inert
        # padding plane, but mask them so no merge crosses the domain
        idx = torch.arange(V.shape[d], device=V.device).reshape(
            tuple(-1 if i == d else 1 for i in range(V.ndim)))
        in_range = (idx + s >= 0) & (idx + s < V.shape[d])
        nb_good = torch.roll(good, -s, dims=d) & in_range
        d2 = torch.sum((C - torch.roll(C, -s, dims=d)) ** 2, dim=-1)
        d2s.append(torch.where(nb_good, d2, torch.inf))
    d2_stack = torch.stack(d2s)            # (2N, *shape)
    choice = torch.argmin(d2_stack, dim=0)
    merging = small & torch.isfinite(torch.amin(d2_stack, dim=0))

    dt_ = V.dtype
    addV = torch.zeros_like(V)
    addG = torch.zeros_like(V)
    addVC = torch.zeros_like(C)
    addA = [torch.zeros_like(a) for a in capacity.A]
    addB = [torch.zeros_like(b) for b in capacity.B]
    addW = [torch.zeros_like(w) for w in capacity.W]
    for k, (d, s) in enumerate(dirs):
        m = (merging & (choice == k)).to(dt_)

        # scatter source -> target = shift the masked source values by +s
        def to_tgt(x, m=m, d=d, s=s):
            return torch.roll(x * m, s, dims=d)

        addV = addV + to_tgt(V)
        addG = addG + to_tgt(capacity.Gamma)
        addVC = addVC + torch.roll((V * m)[..., None] * C, s, dims=d)
        for i in range(N):
            addA[i] = addA[i] + to_tgt(capacity.A[i])
            addB[i] = addB[i] + to_tgt(capacity.B[i])
            addW[i] = addW[i] + to_tgt(capacity.W[i])

    keep = (~merging).to(dt_)
    newV = V * keep + addV
    newC = torch.where(
        (newV > 0)[..., None],
        (V[..., None] * C * keep[..., None] + addVC)
        / torch.clamp_min(newV, tol * 1e-6)[..., None],
        C * keep[..., None],
    )
    new_cap = dataclasses.replace(
        capacity,
        V=newV,
        Gamma=capacity.Gamma * keep + addG,
        cell_types=torch.where(merging, 0, capacity.cell_types).to(
            capacity.cell_types.dtype),
        C_om=newC,
        A=tuple(a * keep + da for a, da in zip(capacity.A, addA)),
        B=tuple(b * keep + db for b, db in zip(capacity.B, addB)),
        W=tuple(w * keep + dw for w, dw in zip(capacity.W, addW)),
    )
    return new_cap, merging.sum()


# -- adaptive time step (solver.jl:611-662) ---------------------------------

def adapt_timestep(velocity_field, mesh, cfl_target, dt_current, dt_min,
                   dt_max, growth_factor=1.1, shrink_factor=0.8,
                   safety_factor=0.9):
    """Interface-velocity CFL controller.  NOTE: the reference swaps the
    growth/shrink factors in its min/max clamps (solver.jl:646-652); this
    uses the intended semantics (grow at most by growth_factor, shrink at
    most to shrink_factor).  Returns (dt_new, cfl) as Python floats."""
    v = velocity_field
    if isinstance(v, torch.Tensor):
        v_max = float(v.abs().max())
    else:
        v_max = float(np.max(np.abs(np.asarray(v))))
    if v_max < 1e-10:
        return min(dt_current * growth_factor, dt_max), 0.0
    h_min = min(mesh.h[: mesh.ndim])
    dt_opt = safety_factor * cfl_target * h_min / v_max
    if dt_opt > dt_current:
        dt_new = min(dt_opt, dt_current * growth_factor)
    else:
        dt_new = max(dt_opt, dt_current * shrink_factor)
    dt_new = float(np.clip(dt_new, dt_min, dt_max))
    return dt_new, v_max * dt_new / h_min


def volume_redefinition(capacity, ops):
    """1D second-order consistency correction: rebuild W and V from discrete
    gradients of the centroid polynomials (utils.jl:134-158)."""
    p_o = capacity.C_om[..., 0]
    p_g = capacity.C_ga[..., 0]
    grad = ops.grad(p_o, p_g)[0]
    W_new = (grad * capacity.W[0],)
    q_o = 0.5 * p_o**2
    q_g = 0.5 * p_g**2
    g2 = ops.grad(q_o, q_g)
    V_new = ops.div(g2, g2)
    return dataclasses.replace(capacity, W=W_new, V=V_new)


def moment_consistent_W(capacity, ops=None):
    """N-D generalization of the reference's 1D ``volume_redefinition!``
    (utils.jl:134-158): rebuild each staggered volume ``W[d]`` so the
    discrete cut-cell gradient is EXACT on fields linear along axis ``d``.

    Feeding the coordinate field ``u = x_d`` through the flux numerator
    yields the effective gradient arm ``N_d = G_d(C_ω·e_d) + H_d(C_γ·e_d)``,
    which replaces the quadrature ``W[d]`` at interior slots where it is
    positive.  (The JAX version's docstring records the measured verdict:
    use it in 1D, as the reference does; N-D capacities keep the
    quadrature W.)  Slot 0 (the border half-stencil) and the padding slot
    keep the quadrature value.  Returns a new Capacity."""
    if ops is None:
        from .operators import make_diffusion_ops

        ops = make_diffusion_ops(capacity)
    N = capacity.ndim
    W_new = []
    for d in range(N):
        p_o = capacity.C_om[..., d]
        p_g = capacity.C_ga[..., d]
        arm = ops.grad(p_o, p_g)[d] * capacity.W[d]
        w_q = capacity.W[d]
        idx = torch.arange(w_q.shape[d], device=w_q.device).reshape(
            tuple(-1 if i == d else 1 for i in range(w_q.ndim)))
        interior = (idx > 0) & (idx < w_q.shape[d] - 1)
        W_new.append(torch.where(interior & (arm > 0) & (w_q > 0), arm, w_q))
    return dataclasses.replace(capacity, W=tuple(W_new))

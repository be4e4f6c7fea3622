"""Plotting and animation (torch): counterpart of ``penguin_tpu.viz``
(the reference's ``vizualize.jl`` / ``vizualize_mov.jl``), matplotlib with
the Agg backend, imported only when a plot is made.  Tensors on any device
are copied to the host first; a geometry body is called on f64 CPU tensors.

- ``plot_solution``: bulk/interface fields by dimension and phase count
- ``animate_solution``: time-series animation from solver states
- ``plot_interface_evolution``, ``plot_residuals``, ``plot_timestep_history``
- ``interface_spectrum``: FFT of the marker radius profile
  (vizualize_mov.jl:409+)
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "plot_solution",
    "animate_solution",
    "plot_interface_evolution",
    "plot_residuals",
    "plot_timestep_history",
    "plot_newton_rates",
    "plot_residual_fields",
    "plot_isotherms",
    "interface_spectrum",
]


def _np(a):
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _body_on_host(body, X, Y):
    """``body`` (torch ops) evaluated on the numpy grids X, Y as f64 CPU
    tensors, read back as numpy."""
    return _np(body(torch.as_tensor(X, dtype=torch.float64),
                    torch.as_tensor(Y, dtype=torch.float64)))


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_solution(solver, mesh, body=None, capacity=None, state_i=None,
                  filename=None):
    """Plot the bulk field (1D line / 2D pcolormesh) with the interface
    contour overlaid (vizualize.jl:1-480)."""
    plt = _mpl()
    x = solver.states[state_i] if (state_i is not None and solver.states) else solver.x
    Tw = _np(x[0] if isinstance(x, (tuple, list)) else x)
    N = mesh.ndim
    fig, ax = plt.subplots(figsize=(6, 5))
    if N == 1:
        xs = np.asarray(mesh.nodes[0])
        ax.plot(xs, Tw, "o-", ms=2)
        ax.set_xlabel("x")
        ax.set_ylabel("T")
    else:
        n1, n2 = mesh.n[:2]
        if capacity is not None:
            mask = _np(capacity.cell_types) == 0
            Tw = np.where(mask, np.nan, Tw)
        im = ax.pcolormesh(Tw[: n1, : n2].T, shading="auto")
        fig.colorbar(im, ax=ax)
        if body is not None:
            xs = np.linspace(mesh.x0[0], mesh.x0[0] + mesh.domain_size[0], 200)
            ys = np.linspace(mesh.x0[1], mesh.x0[1] + mesh.domain_size[1], 200)
            X, Y = np.meshgrid(xs, ys, indexing="ij")
            phi = _body_on_host(body, X, Y)
            ax.contour(
                (X - mesh.x0[0]) / mesh.h[0] - 0.5,
                (Y - mesh.x0[1]) / mesh.h[1] - 0.5,
                phi, levels=[0.0], colors="r",
            )
    if filename:
        fig.savefig(filename, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return filename
    return fig


def animate_solution(solver, mesh, body=None, filename="animation.gif",
                     fps=10):
    """Animate the stored states (vizualize.jl:481-660)."""
    plt = _mpl()
    from matplotlib.animation import FuncAnimation, PillowWriter

    states = solver.states
    N = mesh.ndim
    fig, ax = plt.subplots(figsize=(6, 5))

    def frame(k):
        ax.clear()
        x = states[k]
        Tw = _np(x[0] if isinstance(x, (tuple, list)) else x)
        if N == 1:
            ax.plot(np.asarray(mesh.nodes[0]), Tw)
        else:
            n1, n2 = mesh.n[:2]
            ax.pcolormesh(Tw[: n1, : n2].T, shading="auto")
        ax.set_title(f"state {k}")

    anim = FuncAnimation(fig, frame, frames=len(states))
    anim.save(filename, writer=PillowWriter(fps=fps))
    plt.close(fig)
    return filename


def plot_interface_evolution(marker_log, filename=None):
    """Overlay marker fronts over time (vizualize_mov.jl)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(6, 6))
    M = _np(marker_log)
    for k in range(M.shape[0]):
        mk = np.vstack([M[k], M[k][:1]])
        ax.plot(mk[:, 0], mk[:, 1], alpha=0.3 + 0.7 * k / max(M.shape[0] - 1, 1))
    ax.set_aspect("equal")
    if filename:
        fig.savefig(filename, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return filename
    return fig


def plot_residuals(residuals, filename=None):
    plt = _mpl()
    fig, ax = plt.subplots()
    ax.semilogy(_np(residuals), "o-")
    ax.set_xlabel("iteration / step")
    ax.set_ylabel("residual")
    if filename:
        fig.savefig(filename, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return filename
    return fig


def plot_timestep_history(history, filename=None):
    plt = _mpl()
    h = _np(history)
    fig, ax = plt.subplots()
    ax.plot(h[:, 0], h[:, 1], "o-")
    ax.set_xlabel("t")
    ax.set_ylabel("dt")
    if filename:
        fig.savefig(filename, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return filename
    return fig


def plot_newton_rates(residual_hist, filename=None, max_steps=12):
    """Per-timestep Newton/GN convergence curves with fitted rates — the
    moving-solver debugging view of vizualize_mov.jl:1-633 (per-iteration
    residual plots).  ``residual_hist``: (n_steps, max_iter), NaN past
    convergence (``StefanMono2D.solve`` records it as
    ``self.residual_hist``)."""
    from .diagnostics import convergence_rates

    plt = _mpl()
    H = _np(residual_hist)
    rates = convergence_rates(H)
    fig, (ax, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    sel = np.linspace(0, H.shape[0] - 1, min(max_steps, H.shape[0]),
                      dtype=int)
    for k in sel:
        row = H[k][np.isfinite(H[k])]
        if row.size:
            ax.semilogy(np.arange(1, row.size + 1), row, "o-", alpha=0.7,
                        label=f"step {k}")
    ax.set_xlabel("inner iteration")
    ax.set_ylabel("GN residual")
    ax.legend(fontsize=7)
    ax2.plot(rates, "s-")
    ax2.set_xlabel("time step")
    ax2.set_ylabel("fitted log-reduction rate / iter")
    if filename:
        fig.savefig(filename, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return filename
    return fig


def plot_residual_fields(fields, filename=None, n_show=4):
    """Heatmaps of the per-cell energy residual grid at selected steps
    (``StefanMono2D.solve(capture_residual_field=True)`` →
    ``self.residual_fields``) — the reference's per-iteration residual
    PNG dumps (stefan.jl:845-859)."""
    plt = _mpl()
    F = _np(fields)
    sel = np.linspace(0, F.shape[0] - 1, min(n_show, F.shape[0]), dtype=int)
    fig, axes = plt.subplots(1, len(sel), figsize=(4 * len(sel), 3.6))
    axes = np.atleast_1d(axes)
    for ax, k in zip(axes, sel):
        m = ax.imshow(np.abs(F[k]).T, origin="lower", cmap="magma")
        ax.set_title(f"|residual| step {k}")
        fig.colorbar(m, ax=ax, shrink=0.8)
    if filename:
        fig.savefig(filename, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return filename
    return fig


def plot_isotherms(solver, mesh, body=None, levels=None, state_i=None,
                   filename=None):
    """Contour lines of equal temperature (plot_isotherms,
    vizualize.jl:637-720)."""
    plt = _mpl()
    x = solver.x if state_i is None else solver.states[state_i]
    T = _np(x[0])
    nx, ny = mesh.n[:2]
    X = np.asarray(mesh.centers[0])[:nx]
    Y = np.asarray(mesh.centers[1])[:ny]
    fig, ax = plt.subplots(figsize=(6, 5))
    cs = ax.contour(X, Y, T[:nx, :ny].T,
                    levels=levels if levels is not None else 10,
                    cmap="coolwarm")
    ax.clabel(cs, inline=True, fontsize=7)
    if body is not None:
        xx, yy = np.meshgrid(X, Y, indexing="ij")
        phi = _body_on_host(body, xx, yy)
        ax.contour(X, Y, phi.T, levels=[0.0], colors="k", linewidths=1.5)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_title("isotherms")
    if filename:
        fig.savefig(filename, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def interface_spectrum(markers, center):
    """FFT amplitude spectrum of the marker radius profile — the interface
    roughness diagnostic (vizualize_mov.jl:409+)."""
    mk = _np(markers)
    r = np.sqrt((mk[:, 0] - center[0]) ** 2 + (mk[:, 1] - center[1]) ** 2)
    amp = np.abs(np.fft.rfft(r - r.mean())) / len(r)
    return amp

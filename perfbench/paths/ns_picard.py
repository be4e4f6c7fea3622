"""Entry path ``ns_picard``: the port's implicit-Picard Navier-Stokes
stepper on the DFG 2D-2 channel.

Builds, through the port's public path as ``benchmarks/dfg_cylinder_shedding.py``
does, the three staggered meshes (origins shifted by -h/2 so the walls lie
on the domain's edges), the cylinder as the complement of a circle, the
capacities (``compute_capacity``), the ``Fluid`` and ``NavierStokesMono``
with ghost wall rows, parabolic inflow, outflow on the right and no slip
elsewhere.  Every episode starts from the steady Stokes flow at full
inflow, the run's initial state: set-up takes it from the plain reference's
exact solve (``reference.ns_picard.stokes_start``), since none of
``StokesMono.solve``'s Krylov paths reaches this channel's steady solution
(the DCT-CG and Chebyshev block preconditioners stall above a relative
residual of 1e-4).  One interval is one
``solve_unsteady_picard(..., method="fgmres")`` call of the traffic's
``steps_per_interval`` steps.  Its telemetry, read once an interval, is
(largest fgmres count of a sweep, 1 if a sweep stopped at its cap above its
tolerance, 1 if the state is finite).
"""

from __future__ import annotations

import time

import torch

import penguin_tpu_torch as pt
from penguin_tpu_torch.kernels import stencil
from penguin_tpu_torch.solvers.navierstokes import NavierStokesMono
from penguin_tpu_torch.solvers.stokes import PinPressureGauge
from perfbench.reference.ns_picard import (capacity_answer, probe_blocks,
                                          stokes_start)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def inflow_profile(config):
    """The parabolic inflow at full strength, as a border value."""
    height, u_max = float(config["domain"][1]), float(config["u_max"])

    def inflow(x, y, z=0.0, t=None):
        xi = y / height
        return u_max * 4.0 * xi * (1.0 - xi)

    return inflow


def build_solver(config, device):
    """The meshes' capacities and the solver; returns ``(solver, caps,
    capacity_s)``."""
    nx, ny = (int(n) for n in config["grid"])
    lx, ly = (float(v) for v in config["domain"])
    dx, dy = lx / nx, ly / ny
    dtype = getattr(torch, config["dtype"])
    mesh_p = pt.Mesh((nx, ny), (lx, ly), (-0.5 * dx, -0.5 * dy))
    mesh_ux = pt.Mesh((nx, ny), (lx, ly), (-dx, -0.5 * dy))
    mesh_uy = pt.Mesh((nx, ny), (lx, ly), (-0.5 * dx, -dy))
    body = pt.geometry.complement(pt.geometry.circle(
        tuple(float(c) for c in config["cylinder"]), float(config["radius"])))
    quad = config["quadrature"]
    t = time.perf_counter()
    caps = [pt.compute_capacity(body, m, p=int(quad["p"]), s=int(quad["s"]),
                                dtype=dtype, device=device)
            for m in (mesh_ux, mesh_uy, mesh_p)]
    _sync(device)
    capacity_s = time.perf_counter() - t
    rho = float(config["rho"])
    fluid = pt.Fluid(
        mesh_u=(mesh_ux, mesh_uy), mesh_p=mesh_p,
        capacity_u=(caps[0], caps[1]),
        operator_u=(pt.make_diffusion_ops(caps[0]),
                    pt.make_diffusion_ops(caps[1])),
        capacity_p=caps[2], operator_p=pt.make_diffusion_ops(caps[2]),
        mu=rho * float(config["nu"]), rho=rho,
        f_u=lambda x, y, z: 0.0, f_p=lambda x, y, z: 0.0)
    wall = pt.Dirichlet(0.0)
    bc_ux = pt.BorderConditions({
        "left": pt.Dirichlet(inflow_profile(config)), "right": pt.Outflow(),
        "bottom": wall, "top": wall})
    bc_uy = pt.BorderConditions({"left": wall, "right": wall,
                                 "bottom": wall, "top": wall})
    solver = NavierStokesMono(fluid, (bc_ux, bc_uy), PinPressureGauge(),
                              pt.Dirichlet(float(config["cut_value"])),
                              wall_row=config["wall_row"])
    return solver, caps, capacity_s


class Entry:
    """The system under test for one run of a DFG channel cell."""

    def __init__(self, config, traffic, inputs, device):
        self.solver, caps, self.capacity_s = build_solver(config, device)
        self.capacity = capacity_answer(caps)
        self.dt = float(traffic["dt"])
        self.theta = 0.5 if traffic["scheme"] == "CN" else 1.0
        self.kw = dict(scheme=traffic["scheme"],
                       picard_iters=int(traffic["picard_iters"]),
                       method="fgmres", tol=float(config["cg_tol"]),
                       maxiter=int(config["fgmres_maxiter"]))
        self.tol, self.maxiter = self.kw["tol"], self.kw["maxiter"]
        self.steps = int(traffic["steps_per_interval"])
        self.t0 = float(traffic["t_ramp"])
        dtype = getattr(torch, config["dtype"])
        self.x0 = tuple(torch.as_tensor(a, dtype=dtype, device=device)
                        for a in stokes_start(config, device))
        shape = tuple(self.x0[0].shape)
        self.probe = probe_blocks(inputs["probe"].to(device), shape)
        self.numel = sum(f.numel() for f in self.x0)
        self.itemsize = self.x0[0].element_size()
        self._lo = self._hi = None

    def start(self):
        return (self.x0, 0)

    def interval(self, T):
        x, k = T
        t = self.t0 + k * self.dt
        x = self.solver.solve_unsteady_picard(
            self.dt, t + self.steps * self.dt, x0=x, t_start=t, **self.kw)
        # every sweep's counts; a program that logs only each step's last
        # sweep is read from that
        its = getattr(self.solver, "krylov_sweep_iters",
                      self.solver.krylov_iters)
        rel = getattr(self.solver, "krylov_sweep_relres",
                      self.solver.krylov_relres)
        stalled = bool(((its >= self.maxiter) & (rel > self.tol)).any())
        finite = bool(torch.stack([torch.isfinite(f).all() for f in x]).all())
        telemetry = torch.tensor([float(its.max()), float(stalled),
                                  float(finite)], dtype=torch.float64)
        return (x, k + self.steps), telemetry

    def interval_failed(self, telemetry):
        most, stalled, finite = telemetry
        return bool(stalled) or not finite

    def end_episode(self, T):
        """Folds the episode's end state into the elementwise least and
        greatest end states so far: every episode starts from the Stokes
        state, and the check judges each one's end."""
        x, _ = T
        if self._lo is None:
            self._lo = self._hi = x
        else:
            self._lo = tuple(torch.minimum(a, b) for a, b in zip(self._lo, x))
            self._hi = tuple(torch.maximum(a, b) for a, b in zip(self._hi, x))

    def counters(self):
        return {"stencil_launches": stencil.stencil5_matvec.launches
                + stencil.stencil7_matvec.launches}

    def answers(self):
        """What the run produced, for the check: the three meshes'
        capacities, the Picard operator at the Stokes state on the probe
        blocks, and the least and greatest end states of the episodes."""
        rows = self.solver._picard_rows(self.x0, self.dt, self.theta)
        return dict(capacity=self.capacity, operator=rows(self.probe),
                    fields=(self._lo, self._hi))

"""Entry path ``stefan_ft``: the port's marker front-tracking Stefan solver
on the Frank disk.

Builds, through the port's public path as ``benchmarks/stefan2d_tpu.py``
does, the mesh, the front (``FrontTracker.create_circle``: the
configuration's markers on the circle of radius ``S·sqrt(t0)``), the
liquid's static capacity (``compute_capacity`` of the polygon's exterior,
whose build time is ``capacity_s``), the similarity temperature at ``t0``
on its centroids and ``StefanMono2D`` with the interface at 0 and the
borders at ``T_inf``.  Every episode starts from that state at ``t0``.

One interval is one ``StefanMono2D.solve`` call of the traffic's
``steps_per_interval`` steps, carrying the markers and the temperature:
GN/LM over the markers' normal displacements with the intercept Jacobian,
each iteration a space-time band capacity rebuild and a reduced slab CG.
Its telemetry, read once an interval from the logs ``solve`` keeps, is
(largest GN count of a step, the interval's end radius against the
similarity solution, 1 if the markers and residuals are finite).  An
interval fails when its markers or GN residuals go non-finite (the gate of
``benchmarks/stefan2d_tpu.py``) or its mean marker radius misses
``S·sqrt(t)`` by more than the configuration's ``radius_gate`` (the 1% of
``chip_smoke.py`` phase 11).  The GN's tolerance is not a failure rule
here: at this size ‖F‖ has a floor above it, so every step runs its
``max_iter`` iterations (the configuration's ``gn_floor``); the check's
``front_residual`` holds every step's front to the Stefan condition
instead.  No step is taken outside ``solve``.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

import penguin_tpu_torch as pt
from penguin_tpu_torch.front_tracking import FrontTracker
from penguin_tpu_torch.kernels import stencil
from penguin_tpu_torch.solvers import stefan2d
from penguin_tpu_torch.solvers.moving_diffusion import _reduced_slab
from perfbench.reference.stefan_ft import similarity, undercooling

BORDERS = ("left", "right", "top", "bottom")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Entry:
    """The system under test for one run of a Frank-disk cell."""

    def __init__(self, config, traffic, inputs, device):
        if not hasattr(stefan2d.StefanMono2D, "last_slab"):
            # the check reads the last slab's inputs, which a program
            # without this record cannot hand over: fail before set-up
            raise RuntimeError("StefanMono2D keeps no last_slab; this cell "
                               "cannot be checked")
        self.dtype = getattr(torch, config["dtype"])
        like = dict(dtype=self.dtype, device=device)
        n, length = int(config["cells"]), float(config["length"])
        self.mesh = pt.Mesh((n, n), (length, length),
                            tuple(float(v) for v in config["origin"]))
        self.centre = tuple(float(v) for v in config["centre"])
        self.S, self.t0 = float(config["S"]), float(config["t0"])
        self.dt = float(traffic["dt"])
        quad = config["quadrature"]
        self.p, self.s = int(quad["p"]), int(quad["s"])
        front = FrontTracker(**like).create_circle(
            self.centre, self.S * math.sqrt(self.t0), n=int(config["markers"]))
        t = time.perf_counter()
        cap0 = pt.compute_capacity(lambda x, y: -front.sdf(x, y), self.mesh,
                                   p=self.p, s=self.s, **like)
        _sync(device)
        self.capacity_s = time.perf_counter() - t
        C = cap0.C_om.double().cpu().numpy()
        r = np.hypot(C[..., 0] - self.centre[0], C[..., 1] - self.centre[1])
        T0 = torch.as_tensor(similarity(r, self.t0, self.S), **like)
        self.mk0, self.u0 = front.markers, (T0, torch.zeros_like(T0))
        T_inf = undercooling(self.S)
        bc_b = pt.BorderConditions({k: pt.Dirichlet(T_inf) for k in BORDERS})
        phase = pt.Phase(None, None, lambda x, y, z, t: 0.0,
                         float(config["diffusivity"]))
        self.ic = pt.InterfaceConditions(
            pt.ScalarJump(1.0, 1.0, 0.0),
            pt.FluxJump(1.0, 1.0, float(config["rhoL"])))
        self.solver = stefan2d.StefanMono2D(
            phase, bc_b, pt.Dirichlet(float(config["interface_value"])),
            self.dt, self.u0, self.mesh, traffic["scheme"])
        max_iter, _, reltol, alpha = traffic["newton_params"]
        self.gate = float(config["radius_gate"])
        self.kw = dict(
            newton_params=(int(max_iter), float(config["cg_tol"]), reltol,
                           alpha),
            interior_fluid=bool(config["interior_fluid"]), method="auto",
            lin_tol=float(traffic["lin_tol"]),
            lin_maxiter=int(traffic["lin_maxiter"]),
            lm_init_lambda=traffic["lm"][0], lm_lambda_factor=traffic["lm"][1],
            lm_min_lambda=traffic["lm"][2], lm_max_lambda=traffic["lm"][3],
            enable_stencil_fusion=bool(traffic["stencil_fusion"]),
            smooth_window=int(traffic["smooth_window"]),
            smooth_passes=int(traffic["smooth_passes"]),
            extrapolation_factor=float(traffic["extrapolation_factor"]),
            max_disp_cells=float(traffic["max_disp_cells"]),
            jac=config["jacobian"], p=self.p, s=self.s,
            band_budget=config["band_budget"])
        self.steps = int(traffic["steps_per_interval"])
        self.probe = inputs["probe"].to(**like)
        self.numel = T0.numel()
        self.itemsize = T0.element_size()
        self._last = None
        self._radii = []

    def start(self):
        return (self.mk0, self.u0, 0)

    def interval(self, state):
        mk, u, k = state
        t = self.t0 + k * self.dt
        s = self.solver
        s.u0 = u
        # ``solve`` takes the K + 1 slabs from t to t + K dt
        x = s.solve(FrontTracker(mk), t, t + (self.steps - 1.5) * self.dt,
                    self.ic, **self.kw)
        its, rns = s.iters_log, s.residual_log
        r = np.linalg.norm(s.marker_log[-1] - np.asarray(self.centre), axis=-1)
        exact = self.S * math.sqrt(self.t0 + (k + self.steps) * self.dt)
        miss = abs(r.mean() / exact - 1)
        finite = bool(np.isfinite(s.marker_log).all()
                      and np.isfinite(rns).all())
        self._last = dict(start=(mk, u[0]), marker_log=s.marker_log,
                          slab=s.last_slab, field=x[0], iters_log=its,
                          krylov_iters=s.krylov_iters, residual_log=rns)
        telemetry = torch.tensor([float(its.max()), float(miss),
                                  float(finite)], dtype=torch.float64)
        return (s.markers, x, k + self.steps), telemetry

    def interval_failed(self, telemetry):
        most, miss, finite = telemetry
        return not finite or not miss <= self.gate

    def end_episode(self, state):
        """Keeps the episode's mean marker radius, on the device, with its
        step count: the check holds every episode's end to the similarity
        solution."""
        mk, _, k = state
        centre = torch.as_tensor(self.centre, dtype=mk.dtype, device=mk.device)
        self._radii.append((k, torch.linalg.norm(mk - centre, dim=-1).mean()))

    def counters(self):
        return {"stencil_launches": stencil.stencil5_matvec.launches
                + stencil.stencil7_matvec.launches}

    def answers(self):
        """What the run produced, for the check: the last interval's last
        slab (its start temperature and fronts), the space-time
        capacities the program solved it on and its reduced slab operator
        on the probe, the final temperature; the interval's start,
        per-step markers and logs; every episode's end radius."""
        last, s = self._last, self.solver
        Told, mk_a, mk_b, t, cap = last["slab"]
        apply, *_ = _reduced_slab(cap, s.phase.diffusion, s.phase.source,
                                  s.bc_i, s.border, Told, t, self.dt)
        capacity = dict(V=cap.V[..., 0],
                        A=[cap.A[0][..., 0], cap.A[1][..., 0],
                           cap.A[2][..., 0], cap.A[2][..., 1]],
                        B=[cap.B[d][..., 0] for d in range(2)],
                        W=[cap.W[d][..., 0] for d in range(2)])
        radii = [(k, float(r)) for k, r in self._radii]
        return dict(capacity=capacity, operator=apply(self.probe),
                    field=last["field"], slab=(Told[0], mk_a, mk_b),
                    start=last["start"],
                    marker_log=torch.as_tensor(last["marker_log"]),
                    end_radii=radii, iters_log=last["iters_log"],
                    krylov_iters=last["krylov_iters"],
                    residual_log=last["residual_log"])

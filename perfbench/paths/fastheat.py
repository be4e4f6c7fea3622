"""Entry path ``fastheat``: the port's backward-Euler heat stepper.

Builds, through the port's public path, the mesh, the body
(``geometry.circle`` or ``geometry.sphere``), the capacities
(``compute_capacity``), the diffusion operators and
``solvers.heat_fast.FastHeatBE``; one interval is one call of
``FastHeatBE.run_telemetry``, the public stepper with its extrapolated warm
start.  Its telemetry, read once an interval, is (last CG count, largest CG
count, 1 if the field is finite).
"""

from __future__ import annotations

import time

import torch

import penguin_tpu_torch as pt
from penguin_tpu_torch.kernels import stencil
from penguin_tpu_torch.solvers.heat_fast import FastHeatBE

_BORDERS = ("left", "right", "top", "bottom", "backward", "forward")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Entry:
    """The system under test for one run of a heat cell."""

    def __init__(self, config, traffic, inputs, device):
        N = int(config["ndim"])
        n = int(config["cells"])
        length = float(config["length"])
        dtype = getattr(torch, config["dtype"])
        mesh = pt.Mesh((n,) * N, (length,) * N, (0.0,) * N)
        shape = pt.geometry.circle if N == 2 else pt.geometry.sphere
        body = shape(tuple(inputs["centre"]), float(config["radius"]))
        quad = config["quadrature"]
        t = time.perf_counter()
        cap = pt.compute_capacity(body, mesh, p=int(quad["p"]),
                                  s=int(quad["s"]), dtype=dtype,
                                  device=device)
        _sync(device)
        self.capacity_s = time.perf_counter() - t
        borders = pt.BorderConditions(
            {k: pt.Dirichlet(float(config["border_value"]))
             for k in _BORDERS[:2 * N]})
        self.maxiter = int(traffic["cg_maxiter"])
        self.solver = FastHeatBE(
            cap, pt.make_diffusion_ops(cap), float(config["diffusivity"]),
            float(config["heat_source"]),
            pt.Dirichlet(float(config["interface_value"])), borders,
            float(traffic["dt_h2"]) * (length / n) ** 2,
            cg_tol=float(config["cg_tol"]), cg_maxiter=self.maxiter,
            dtype=dtype)
        self.capacity = dict(V=cap.V, A=list(cap.A), B=list(cap.B),
                             W=list(cap.W))
        self.steps = int(traffic["steps_per_interval"])
        self.T0 = inputs["T0"].to(device)
        self.probe = inputs["probe"].to(device)
        self.numel = self.T0.numel()
        self.itemsize = self.T0.element_size()
        self._lo = self._hi = None

    def start(self):
        return self.T0

    def interval(self, T):
        T, last, most = self.solver.run_telemetry(T, self.steps)
        finite = torch.isfinite(T).all().to(last.dtype)
        return T, torch.stack([last, most, finite])

    def interval_failed(self, telemetry):
        last, most, finite = telemetry
        return most >= self.maxiter or not finite

    def end_episode(self, T):
        """Folds the episode's end field into the elementwise least and
        greatest end fields so far: every episode starts from T0, and the
        check judges each one's end field."""
        if self._lo is None:
            self._lo = self._hi = T
        else:
            self._lo = torch.minimum(self._lo, T)
            self._hi = torch.maximum(self._hi, T)

    def counters(self):
        return {"stencil_launches": stencil.stencil5_matvec.launches
                + stencil.stencil7_matvec.launches}

    def answers(self):
        """What the run produced, for the check: the capacities, the folded
        operator on the probe, and the least and greatest end fields of the
        episodes."""
        return dict(capacity=self.capacity,
                    operator=self.solver.matvec(self.probe),
                    fields=(self._lo, self._hi))

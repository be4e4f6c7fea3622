"""The one generator of the benchmark's inputs.

A traffic mix is a JSON file under ``perfbench/workloads/``; a configuration
is a JSON file under ``perfbench/configs/``.  From both and a seed this
module makes, in the configuration's dtype, everything a run hands to the
program and to the reference alike.

The mix fixes one base problem, drawn from its ``problem_seed``:

- the body centre: the configuration's, moved by up to ±h/2 on every axis;
- ``T0``: a smooth initial field, a sum of the lowest ``t0_modes`` sine
  modes per axis with amplitudes ±1/|k|², scaled to the root mean square
  ``t0_rms`` and zero on the border cells.

The run's ``--seed`` picks a reflection or none on each axis, about the
centre of the cell grid (which maps the grid onto itself), and applies it
to the centre and to ``T0``: every seed cuts its own set of cells and starts from its own field,
and every seed's problem is a mirror image of the base one, so the solver's
work does not depend on the seed.  (Swapping axes is no symmetry of the
capacity build, whose quadrature treats the last axis in closed form.)  The seed also makes ``probe``, uniform
values in [-1, 1] on every slot (on the device), the operator's input for
the check.

The interval schedule is read from the traffic mix: ``steps_per_interval``
steps a call, ``episode_steps`` steps an episode, each episode from ``T0``.
"""

from __future__ import annotations

import math

import torch

__all__ = ["make_inputs", "schedule"]


def schedule(traffic):
    """(steps per interval, intervals per episode)."""
    k = int(traffic["steps_per_interval"])
    e = int(traffic["episode_steps"])
    if k < 1 or e % k:
        raise ValueError(f"episode_steps {e} is not a multiple of "
                         f"steps_per_interval {k}")
    return k, e // k


def make_inputs(config, traffic, seed, device):
    N = int(config["ndim"])
    n = int(config["cells"])
    length = float(config["length"])
    h = length / n
    dtype = getattr(torch, config["dtype"])
    f64 = dict(dtype=torch.float64, device=device)
    base = torch.Generator()
    base.manual_seed(int(traffic["problem_seed"]))
    run = torch.Generator()
    run.manual_seed(int(seed) % 2 ** 64)

    shift = (torch.rand(N, generator=base, dtype=torch.float64) - 0.5) * h
    centre = [float(c) + float(s) for c, s in zip(config["centre"],
                                                   shift.tolist())]
    M = int(traffic["t0_modes"])
    k = torch.arange(1, M + 1, **f64)
    k2 = sum(k.reshape([M if i == d else 1 for i in range(N)]) ** 2
             for d in range(N))
    signs = torch.randint(0, 2, (M,) * N, generator=base) * 2 - 1
    amp = signs.to(**f64) / k2
    # cell i's centre is (i + 1) h
    x = (torch.arange(n, **f64) + 1.0) * h
    modes = torch.sin(math.pi * k[:, None] * x[None, :] / length)   # (M, n)
    T0 = amp
    for _ in range(N):
        # contract the leading mode axis, append a grid axis
        T0 = torch.tensordot(T0, modes, dims=([0], [0]))
    idx = torch.arange(n, device=device)
    inner = (idx >= 1) & (idx <= n - 2)
    for d in range(N):
        T0 = T0 * inner.reshape([n if i == d else 1 for i in range(N)])
    T0 = T0 * (float(traffic["t0_rms"]) / torch.sqrt(T0.pow(2).mean()))

    # the seed's reflections of the cell grid: cell i spans (i + 1/2) h to
    # (i + 3/2) h, so x -> (n + 1) h - x maps cell i onto cell n - 1 - i
    flips = [d for d in range(N)
             if torch.randint(0, 2, (1,), generator=run).item()]
    centre = [(n + 1) * h - c if d in flips else c
              for d, c in enumerate(centre)]
    if flips:
        T0 = T0.flip(flips)
    T0 = torch.nn.functional.pad(T0, [0, 1] * N)    # the padding slot

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2 ** 64)
    probe = torch.rand((n + 1,) * N, generator=gen, **f64) * 2.0 - 1.0
    return dict(centre=centre, T0=T0.to(dtype), probe=probe.to(dtype))

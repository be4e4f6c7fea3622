"""The marker Stefan solvers' profiler spans, on the CPU at 16² with 16
markers in f64 (the Frank disk of ``torch_stefan_cases``): under a running
profiler each step leaves one ``stefan.step``, each GN iteration one
``stefan.gn_iter`` holding one each of ``stefan.slab_build``,
``stefan.slab_solve``, ``stefan.update`` and ``stefan.gn_host``, and no
number changes with the profiler on; the last slab's record reproduces the
final temperature."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import penguin_tpu_torch as tpt
from penguin_tpu_torch.capacity import compute_capacity_spacetime
from penguin_tpu_torch.solvers import stefan2d as ts
from penguin_tpu_torch.solvers.moving_diffusion import solve_moving_mono_step

from torch_stefan_cases import DT, diph_solver, mono_solver
from torch_stefan_cases import one_thread  # noqa: F401  (autouse fixture)

GN = dict(newton_params=(4, 1e-4, 1e-6, 1.0), interior_fluid=False,
          method="auto", p=4, s=1)
INNER = ("stefan.slab_build", "stefan.slab_solve", "stefan.update",
         "stefan.gn_host")


def _spans(prof):
    """name -> sorted (start, end) in ns of the host events named so."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("stefan."):
            out.setdefault(e.name(), []).append(
                (int(e.start_ns()), int(e.start_ns() + e.duration_ns())))
    return {k: sorted(v) for k, v in out.items()}


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _run(how, profiled):
    if how == "diph":
        s, front = diph_solver(tpt, ts)
    else:
        s, front, ic = mono_solver(tpt, ts, tpt.Dirichlet(0.0))
    if how == "solve":
        call = lambda: s.solve(front, 0.0, 0.5 * DT, ic, jac="intercept",
                               **GN)
    elif how == "geom":
        call = lambda: s.solve_geom(front, 0.0, 0.5 * DT, ic,
                                    newton_params=(3, 1e-6, 1e-6, 0.8),
                                    interior_fluid=False, p=4, s=1)
    else:
        call = lambda: s.solve(front, 0.0, 0.5 * DT,
                               newton_params=(3, 1e-4, 1e-6, 1.0),
                               interior_phase1=True, latent_sign=-1.0,
                               jac="intercept", p=4, s=1)
    if not profiled:
        call()
        return s, None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    return s, prof


@pytest.mark.parametrize("how", ["solve", "geom", "diph"])
def test_each_iteration_holds_its_parts(how):
    s, prof = _run(how, True)
    spans = _spans(prof)
    steps, iters = spans["stefan.step"], spans["stefan.gn_iter"]
    assert len(steps) == len(s.iters_log) == 2
    assert len(iters) == int(s.iters_log.sum()) > len(steps)
    for k, step in enumerate(steps):
        assert sum(_inside(it, step) for it in iters) == s.iters_log[k]
    for name in INNER:
        found = spans[name]
        assert len(found) == len(iters), name
        assert all(sum(_inside(f, it) for f in found) == 1 for it in iters)
    # the parts of an iteration follow one another
    for it in iters:
        parts = [next(f for f in spans[name] if _inside(f, it))
                 for name in INNER]
        assert all(a[1] <= b[0] for a, b in zip(parts, parts[1:]))


@pytest.mark.parametrize("how", ["solve", "geom", "diph"])
def test_the_spans_change_no_number(how):
    off, _ = _run(how, False)
    on, _ = _run(how, True)
    np.testing.assert_array_equal(on.marker_log, off.marker_log)
    np.testing.assert_array_equal(on.iters_log, off.iters_log)
    np.testing.assert_array_equal(on.residual_log, off.residual_log)
    for a, b in zip(on.x, off.x):
        assert torch.equal(a, b)


def test_the_last_slab_gives_the_final_temperature():
    """``last_slab`` holds the inputs of the final field: solving that slab
    again gives it bit for bit, its fronts are the last step's start and
    the front of its last GN evaluation, and its capacities are the ones
    that slab builds."""
    s, front, ic = mono_solver(tpt, ts, tpt.Dirichlet(0.0))
    mk_start = front.markers
    s.solve(front, 0.0, 0.5 * DT, ic, jac="intercept", **GN)
    Told, mk_a, mk_b, t, kept = s.last_slab
    assert t == DT
    np.testing.assert_array_equal(mk_a.numpy(), s.marker_log[0])
    assert not torch.equal(mk_a, mk_start)
    cap = compute_capacity_spacetime(
        ts._st_marker_body, s.mesh, 0.0, DT, p=4, s=1,
        params=(mk_a, mk_b, DT, -1.0), band_budget=s._band_budget,
        dtype=torch.float64, device="cpu")
    for a, b in [(cap.V, kept.V), *zip(cap.A, kept.A), *zip(cap.B, kept.B),
                 *zip(cap.W, kept.W)]:
        assert torch.equal(a, b)
    T, _, _ = solve_moving_mono_step(cap, 1.0, s.phase.source, s.bc_i,
                                     s.border, Told, DT, DT, "BE", tol=1e-9,
                                     maxiter=400)
    for a, b in zip(T, s.x):
        assert torch.equal(a, b)

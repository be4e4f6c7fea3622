"""The port's DFG 2D-2 channel against the benchmark's plain reference
(``perfbench/reference/ns_picard.py``: assembled sparse matrices, exact
sparse LU), on a 44 × 16 channel of the same geometry: capacities, the
Stokes and Picard rows, a CN step's right-hand side, two CN Picard steps;
the benchmark's entry path doing the same work on every seed; the fgmres
block preconditioner kept across calls; and the stepper's profiler spans.
No JAX here."""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import traffic as generator
from perfbench.paths import ns_picard as entry_path
from perfbench.reference import ns_picard as ref

from torch_stefan_cases import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
DT, THETA = 0.002, 0.5
SEEDS = (2 ** 31 + 11, 7_300_000_019)


def _config():
    config = json.loads((ROOT / "perfbench" / "configs"
                         / "dfg2d2_cylinder_f64.json").read_text())
    config.update(grid=[44, 16], cells=44)
    return config


def _traffic(steps):
    traffic = json.loads((ROOT / "perfbench" / "workloads"
                          / "picard-cn-dt0.002-stokes.json").read_text())
    traffic.update(episode_steps=steps, steps_per_interval=steps)
    return traffic


@pytest.fixture(scope="module")
def case():
    config = _config()
    solver, caps, _ = entry_path.build_solver(config, CPU)
    rcaps = ref.all_capacities(config, torch.float64, CPU)
    system = ref.System({m: ref._np(c, np.float64) for m, c in rcaps.items()},
                        config)
    start = ref.unflat(ref.solve(system.matrix(), ref.flat(system.rhs())),
                       system.g.shape)
    return dict(config=config, solver=solver, caps=caps, rcaps=rcaps,
                system=system, start=start)


def _state(rng, shape, scale=1.0):
    return tuple(torch.as_tensor(scale * rng.standard_normal(shape))
                 for _ in range(5))


def _np_state(x):
    return ref.flat([f.detach().cpu().numpy() for f in x])


def test_capacities_match_reference(case):
    """The same quadrature, written twice: the three meshes' V, A, B, W,
    centroids and cut moments agree to rounding (1e-12 of a full cell,
    face or cell width)."""
    n, L = case["config"]["grid"], case["config"]["domain"]
    h = [L[d] / n[d] for d in range(2)]
    for cap, m in zip(case["caps"], ("ux", "uy", "p")):
        rc = case["rcaps"][m]
        assert torch.equal(cap.cell_types == -1, rc["cut"])
        assert (cap.V - rc["V"]).abs().max() <= 1e-12 * h[0] * h[1]
        for d in range(2):
            face = h[1 - d]
            assert (cap.A[d] - rc["A"][d]).abs().max() <= 1e-12 * face
            assert (cap.B[d] - rc["B"][d]).abs().max() <= 1e-12 * face
            assert (cap.W[d] - rc["W"][d]).abs().max() <= 1e-12 * h[0] * h[1]
            assert (cap.Bm[d] - rc["Bm"][d]).abs().max() <= 1e-12 * h[0]
        assert (cap.C_om - rc["C"]).abs().max() <= 1e-12 * h[0]
    assert (case["caps"][2].Am[0] - case["rcaps"]["p"]["Am"][0]).abs().max() \
        <= 1e-12 * h[0]


@pytest.mark.parametrize("rows", ["stokes", "picard", "cn_rhs"])
def test_rows_match_reference(case, rows):
    """The port's matrix-free rows against the reference's assembled
    matrices, on every row of all five blocks, at a seeded state and probe:
    each row's gap within 1e-12 of its own sum of |terms| (the two sum the
    same terms in another order)."""
    solver, system = case["solver"], case["system"]
    shape = system.g.shape
    rng = np.random.default_rng(17)
    probe = _state(rng, shape)
    state = _state(rng, shape)
    if rows == "stokes":
        A = system.matrix()
        got = _np_state(solver.apply_steady(probe))
    elif rows == "picard":
        A = system.matrix(DT, THETA, [s.numpy() for s in state])
        got = _np_state(solver._picard_rows(state, DT, THETA)(probe))
    else:
        want = ref.flat(system.rhs(DT, THETA, [s.numpy() for s in state]))
        extra = tuple(-(1.0 - THETA) * solver.fluid.rho * c
                      for c in solver.conv_vectors(state))
        got = _np_state(solver.make_unsteady_rhs(DT, THETA)(
            state, 1.0, 1.0 + DT, extra_mom=extra))
        scale = np.maximum(np.abs(want), 1.0)
        assert np.max(np.abs(got - want) / scale) <= 1e-12
        return
    want = A @ ref.flat([p.numpy() for p in probe])
    scale = abs(A) @ np.abs(ref.flat([p.numpy() for p in probe]))
    gap = np.abs(got - want) / np.maximum(scale, np.finfo(float).tiny)
    assert gap.max() <= 1e-12, gap.max()


def test_two_cn_steps_match_reference(case):
    """Two CN steps of two Picard sweeps from the Stokes start: the port's
    fgmres run to 1e-11 against the reference's exact LU.  What is left is
    the fgmres tolerance carried through the saddle point: the velocities
    within 1e-8 of their largest value, the pressure (fixed by continuity
    rows of width h) within 1e-5 of its own (read 3.7e-10 and 5.2e-7)."""
    solver, system = case["solver"], case["system"]
    x0 = tuple(torch.as_tensor(a) for a in case["start"])
    got = solver.solve_unsteady_picard(DT, 1.0 + 2 * DT, scheme="CN",
                                       picard_iters=2, method="fgmres",
                                       tol=1e-11, maxiter=400, x0=x0,
                                       t_start=1.0)
    x = case["start"]
    for _ in range(2):
        b = ref.flat(system.rhs(DT, THETA, x))
        x_it = x
        for _ in range(2):
            x_it = ref.unflat(ref.solve(system.matrix(DT, THETA, x_it), b),
                              system.g.shape)
        x = x_it
    u_scale = max(np.abs(x[0]).max(), np.abs(x[2]).max())
    for k in range(4):
        assert np.abs(got[k].numpy() - x[k]).max() <= 1e-8 * u_scale, k
    assert np.abs(got[4].numpy() - x[4]).max() <= 1e-5 * np.abs(x[4]).max()


def _episode(config, traffic, seed):
    inputs = generator.make_inputs(config, traffic, seed, CPU)
    entry = entry_path.Entry(config, traffic, inputs, CPU)
    T, telemetry = entry.interval(entry.start())
    return entry, T[0], telemetry


def test_every_seed_does_the_same_work():
    """The seed draws only the check's probe: two seeds' episodes take the
    same fgmres counts in every sweep and end in the same state, bit for
    bit."""
    config, traffic = _config(), _traffic(2)
    a, xa, ta = _episode(config, traffic, SEEDS[0])
    its_a = a.solver.krylov_sweep_iters.copy()
    b, xb, tb = _episode(config, traffic, SEEDS[1])
    assert np.array_equal(its_a, b.solver.krylov_sweep_iters)
    assert ta.tolist() == tb.tolist() and ta[1] == 0 and ta[2] == 1
    assert all(torch.equal(p, q) for p, q in zip(xa, xb))
    assert not all(torch.equal(p, q) for p, q in zip(a.probe, b.probe))


def test_preconditioner_is_kept_across_calls(case, monkeypatch):
    """Two calls of two steps give one call of four, bit for bit, with M
    built once; a new dt, a new ρ or a new fluid builds it again."""
    solver = copy.copy(case["solver"])
    builds = []
    make = type(solver).make_block_preconditioner

    def counted(self, *args, **kwargs):
        builds.append(kwargs.get("dt"))
        return make(self, *args, **kwargs)

    monkeypatch.setattr(type(solver), "make_block_preconditioner", counted)
    kw = dict(scheme="CN", picard_iters=2, method="fgmres", tol=1e-8,
              maxiter=200)
    x0 = tuple(torch.as_tensor(a) for a in case["start"])
    whole = solver.solve_unsteady_picard(DT, 1.0 + 4 * DT, x0=x0,
                                         t_start=1.0, **kw)
    its_whole = solver.krylov_sweep_iters.copy()
    assert builds == [DT]
    solver._picard_M = None
    half = solver.solve_unsteady_picard(DT, 1.0 + 2 * DT, x0=x0,
                                        t_start=1.0, **kw)
    its = [solver.krylov_sweep_iters.copy()]
    half = solver.solve_unsteady_picard(DT, 1.0 + 4 * DT, x0=half,
                                        t_start=1.0 + 2 * DT, **kw)
    its.append(solver.krylov_sweep_iters.copy())
    assert builds == [DT, DT]
    assert np.array_equal(np.concatenate(its), its_whole)
    assert all(torch.equal(p, q) for p, q in zip(half, whole))

    solver.solve_unsteady_picard(DT / 2, 1.0 + DT / 2, x0=x0, t_start=1.0,
                                 **kw)
    assert builds == [DT, DT, DT / 2]
    solver.rho_diag = tuple(r.clone() for r in solver.rho_diag)
    solver.solve_unsteady_picard(DT / 2, 1.0 + DT / 2, x0=x0, t_start=1.0,
                                 **kw)
    solver.fluid = copy.copy(solver.fluid)
    solver.solve_unsteady_picard(DT / 2, 1.0 + DT / 2, x0=x0, t_start=1.0,
                                 **kw)
    assert builds == [DT, DT, DT / 2, DT / 2, DT / 2]
    solver.solve_unsteady_picard(DT / 2, 1.0 + DT / 2, x0=x0, t_start=1.0,
                                 **kw)
    assert len(builds) == 5


def test_spans_of_the_stepper(case):
    """A traced call leaves one ``navierstokes.step`` a step, one
    ``navierstokes.picard_sweep`` a sweep, one ``linsolve.fgmres_iter``
    and one ``linsolve.fgmres_host`` an Arnoldi iteration, one
    ``stokes.precond`` an iteration (each applies M once), and one
    ``stokes.precond_build`` in all."""
    from torch.profiler import ProfilerActivity, profile

    solver = copy.copy(case["solver"])
    solver._picard_M = None
    x0 = tuple(torch.as_tensor(a) for a in case["start"])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        solver.solve_unsteady_picard(DT, 1.0 + 2 * DT, scheme="CN",
                                     picard_iters=2, method="fgmres",
                                     tol=1e-6, maxiter=120, x0=x0,
                                     t_start=1.0)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    count = {n: names.count(n) for n in set(names)}
    iters = int(solver.krylov_sweep_iters.sum())
    assert count.get("navierstokes.step") == 2
    assert count.get("navierstokes.picard_sweep") == 4
    assert count.get("linsolve.fgmres_iter") == iters
    assert count.get("linsolve.fgmres_host") == iters
    assert count.get("stokes.precond") == iters
    assert count.get("stokes.precond_build") == 1

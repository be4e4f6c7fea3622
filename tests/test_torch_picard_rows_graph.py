"""The fgmres Picard stepper's rows apply replayed as one CUDA graph (a
``_graph.StaticCall`` of ``NavierStokesMono._picard_apply``, kept beside
the block-Schur M) against the eager apply, on the DFG 2D-2 channel of
``perfbench.paths.ns_picard`` at 44 × 16 and 128 × 64, on a card (marked
``cuda``; each test skips without one); and the stepper on the CPU, which
never captures.  No JAX here, so the file runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_picard_rows_graph.py
"""

import contextlib
import copy
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from penguin_tpu_torch import _graph
from penguin_tpu_torch.parallel import sharding
from penguin_tpu_torch.solvers import navierstokes
from penguin_tpu_torch.solvers.navierstokes import NavierStokesMono
from perfbench.paths import ns_picard as entry_path
from perfbench.reference import ns_picard as ref

ROOT = Path(__file__).resolve().parents[1]
DT, THETA = 0.002, 0.5
GRIDS = [(44, 16), (128, 64)]
SEEDS = (2 ** 31 + 5, 7_300_000_041, 12)
ROWS = "navierstokes.picard_rows_graph"
STEP = dict(scheme="CN", picard_iters=2, method="fgmres", tol=1e-6,
            maxiter=120, t_start=1.0)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(grid):
    config = json.loads((ROOT / "perfbench" / "configs"
                         / "dfg2d2_cylinder_f64.json").read_text())
    config.update(grid=list(grid), cells=grid[0])
    return config


def _case(grid, device):
    config = _config(grid)
    solver, _, _ = entry_path.build_solver(config, device)
    start = tuple(torch.as_tensor(a, device=device)
                  for a in ref.stokes_start(config, device))
    return dict(solver=solver, start=start)


_CASES = {}


@pytest.fixture(params=GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def case(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    grid = request.param
    if grid not in _CASES:
        _CASES[grid] = _case(grid, torch.device("cuda", 0))
    return _CASES[grid]


@pytest.fixture
def captures(monkeypatch):
    """The names of the graphs captured during the test, in order."""
    names = []
    capture = _graph.capture

    def recording(fns, device, name, warm_up=None):
        names.append(name)
        return capture(fns, device, name, warm_up)

    monkeypatch.setattr(_graph, "capture", recording)
    return names


def _fresh(case):
    """A copy of the case's solver with nothing kept: its own graphs."""
    solver = copy.copy(case["solver"])
    solver._picard_M = None
    return solver


def _leaves(like, seed, dtype=None, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return tuple((scale * torch.randn(tuple(f.shape), generator=g,
                                      dtype=torch.float64))
                 .to(device=f.device, dtype=dtype or f.dtype) for f in like)


def _perturbed(x, seed):
    return tuple(a + b for a, b in zip(x, _leaves(x, seed, scale=1e-2)))


def _eager(solver, x_k, x):
    """The rows at ``x_k`` applied to ``x`` as every other caller runs
    them: ``_picard_rows``, with no graph."""
    return solver._picard_rows(x_k, DT, THETA)(x)


def _equal(a, b):
    return len(a) == len(b) and all(torch.equal(p, q) for p, q in zip(a, b))


@pytest.mark.cuda
def test_replay_equals_eager_for_two_linearisations(case, captures):
    """Bit for bit, the first apply (which captures) and later ones (which
    only replay), at the start and at a second ``x_k`` whose linearisation
    leaves refill the graph's static inputs."""
    solver = _fresh(case)
    _, rows = solver._picard_kept(DT, THETA)
    assert rows is not None and rows.replay is None
    for x_k in (case["start"], _perturbed(case["start"], 1)):
        apply = solver._picard_sweep_rows(x_k, DT, THETA, rows)
        for seed in SEEDS:
            x = _leaves(x_k, seed)
            assert _equal(apply(x), _eager(solver, x_k, x))
        assert rows.replay is not None
    assert captures == [ROWS]


@pytest.mark.cuda
def test_two_picard_steps_equal_the_eager_stepper(case, captures,
                                                  monkeypatch):
    """Two CN Picard steps through ``solve_unsteady_picard(method="fgmres")``
    give the same state and the same fgmres counts of every sweep with the
    rows and M replayed as with both eager."""
    graphed = _fresh(case)
    xg = graphed.solve_unsteady_picard(DT, 1.0 + 2 * DT, x0=case["start"],
                                       **STEP)
    assert graphed._picard_M[3].replay is not None
    assert sorted(captures) == sorted([ROWS, "stokes.precond_graph"])

    monkeypatch.setattr(_graph, "may_replay", lambda fields, like: False)
    eager = _fresh(case)
    xe = eager.solve_unsteady_picard(DT, 1.0 + 2 * DT, x0=case["start"],
                                     **STEP)
    assert eager._picard_M[3].replay is None and len(captures) == 2
    assert np.array_equal(graphed.krylov_sweep_iters,
                          eager.krylov_sweep_iters)
    assert np.array_equal(graphed.krylov_sweep_relres,
                          eager.krylov_sweep_relres)
    assert _equal(xg, xe)


@pytest.mark.cuda
def test_one_capture_serves_every_sweep_and_call(case, captures):
    """Two calls of two sweeps each replay one graph; a new dt keeps a new
    one, captured on its first apply."""
    solver = _fresh(case)
    x = solver.solve_unsteady_picard(DT, 1.0 + DT, x0=case["start"], **STEP)
    rows = solver._picard_M[3]
    solver.solve_unsteady_picard(DT, 1.0 + 2 * DT, x0=x,
                                 **dict(STEP, t_start=1.0 + DT))
    assert solver._picard_M[3] is rows and captures.count(ROWS) == 1
    solver.solve_unsteady_picard(DT / 2, 1.0 + DT / 2, x0=x, **STEP)
    assert solver._picard_M[3] is not rows and captures.count(ROWS) == 2
    assert solver._picard_M[3].replay is not None


@pytest.mark.cuda
def test_foreign_leaves_run_eagerly(case, captures):
    """``x`` of another dtype, shape, device or number runs the eager apply
    (float32 leaves give its result bit for bit) and leaves the graph and
    its buffers as they were; linearisation leaves handed in unfilled are
    copied in and replayed."""
    solver = _fresh(case)
    _, rows = solver._picard_kept(DT, THETA)
    x_k = case["start"]
    apply = solver._picard_sweep_rows(x_k, DT, THETA, rows)
    apply(_leaves(x_k, 3))
    replay, inputs = rows.replay, tuple(t.clone() for t in rows.inputs)
    x32 = _leaves(x_k, 4, dtype=torch.float32)
    assert _equal(apply(x32), _eager(solver, x_k, x32))
    assert rows.replay is replay and _equal(rows.inputs, inputs)
    lin = rows.inputs[5:]
    assert not _graph.may_replay(tuple(t[:-1] for t in x_k) + lin,
                                 rows.inputs)
    assert not _graph.may_replay(tuple(t.cpu() for t in x_k) + lin,
                                 rows.inputs)
    assert not _graph.may_replay(x_k[:-1] + lin, rows.inputs)
    assert _graph.may_replay(x_k + lin, rows.inputs)
    x_k2 = _perturbed(x_k, 5)
    unfilled = solver._picard_linearisation(x_k2)
    assert not any(a is b for a, b in zip(unfilled, rows.inputs))
    x = _leaves(x_k, 6)
    assert _equal(rows(tuple(x) + unfilled), _eager(solver, x_k2, x))
    assert rows.replay is replay and captures == [ROWS]


@pytest.mark.cuda
def test_a_call_inside_another_capture_runs_eagerly(case, captures):
    """The rows applied while a caller captures its own graph issue the
    eager apply into that graph, whose replay gives the eager result."""
    solver = _fresh(case)
    _, rows = solver._picard_kept(DT, THETA)
    x_k = case["start"]
    solver._picard_sweep_rows(x_k, DT, THETA, rows)(_leaves(x_k, 7))
    replay = rows.replay
    static = tuple(t.clone() for t in _leaves(x_k, 8))
    outer = torch.cuda.CUDAGraph()
    with torch.cuda.graph(outer):
        out = solver._picard_sweep_rows(x_k, DT, THETA, rows)(static)
    assert rows.replay is replay and captures == [ROWS]
    for a, b in zip(static, _leaves(x_k, 9)):
        a.copy_(b)
    outer.replay()
    torch.cuda.synchronize()
    assert _equal(out, _eager(solver, x_k, static))


@pytest.mark.cuda
def test_wrapped_and_rank_rows_run_eagerly(case, captures):
    """A ``_picard_rows`` wrapped on the instance (``parallel.sharding``'s
    timing) or overridden by a rank's solver (``_RankFlow``) is what the
    stepper applies: no graph is captured, or kept for a wrapped one."""
    x_k, x = case["start"], _leaves(case["start"], 10)
    solver = _fresh(case)
    _, rows = solver._picard_kept(DT, THETA)
    calls = []

    def wrapped(*a):
        calls.append(1)
        return NavierStokesMono._picard_rows(solver, *a)

    solver._picard_rows = wrapped
    assert _equal(solver._picard_sweep_rows(x_k, DT, THETA, rows)(x),
                  _eager(case["solver"], x_k, x))
    assert calls == [1] and rows.replay is None
    wrapped_too = _fresh(case)
    wrapped_too._picard_rows = wrapped
    assert wrapped_too._picard_kept(DT, THETA)[1] is None

    rank = object.__new__(sharding._RankFlow)
    vars(rank).update(vars(_fresh(case)))
    whole = SimpleNamespace(grow=lambda t: t, crop=lambda t: t)
    rank._view, rank._grid = case["solver"], whole
    assert not rank._own_picard_rows()
    assert _equal(rank._picard_sweep_rows(x_k, DT, THETA, rows)(x),
                  _eager(case["solver"], x_k, x))
    assert rows.replay is None and captures == []


@pytest.mark.cuda
def test_a_copied_solver_captures_its_own_graph(case, captures):
    solver = _fresh(case)
    _, rows = solver._picard_kept(DT, THETA)
    x_k, x = case["start"], _leaves(case["start"], 11)
    y = solver._picard_sweep_rows(x_k, DT, THETA, rows)(x)
    twin = copy.copy(solver)
    _, rows_t = twin._picard_kept(DT, THETA)
    assert rows_t is not rows and rows_t.replay is None
    assert _equal(twin._picard_sweep_rows(x_k, DT, THETA, rows_t)(x), y)
    assert rows_t.replay is not None and rows_t.replay is not rows.replay
    assert solver._picard_kept(DT, THETA)[1] is rows
    assert captures == [ROWS, ROWS]


def test_the_cpu_stepper_never_captures_and_spans_each_apply(monkeypatch):
    """On the CPU the stepper applies its rows eagerly, each apply inside
    one ``navierstokes.picard_rows`` span, and captures nothing."""
    monkeypatch.setattr(_graph, "capture", None)      # never reached
    solver, _, _ = entry_path.build_solver(_config(GRIDS[0]),
                                           torch.device("cpu"))
    opened, applies = [], []
    span = navierstokes.span

    @contextlib.contextmanager
    def recording(name):
        opened.append(name)
        with span(name):
            yield
        opened.append(None)

    apply = NavierStokesMono._picard_apply

    def counting(self, *args):
        applies.append(opened[-1] if opened else None)
        return apply(self, *args)

    monkeypatch.setattr(navierstokes, "span", recording)
    monkeypatch.setattr(NavierStokesMono, "_picard_apply", counting)
    solver.solve_unsteady_picard(DT, DT, scheme="CN", picard_iters=2,
                                 method="fgmres", tol=1e-6, maxiter=3)
    assert solver._picard_M[3].replay is None
    assert len(applies) >= 2 * 4
    assert applies == ["navierstokes.picard_rows"] * len(applies)
    assert opened.count("navierstokes.picard_rows") == len(applies)

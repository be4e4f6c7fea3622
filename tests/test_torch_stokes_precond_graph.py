"""The Picard stepper's kept block-Schur M replayed as one CUDA graph
(a ``_graph.StaticCall`` of its apply) against its eager apply, on the DFG 2D-2 channel
of ``perfbench.paths.ns_picard`` at 44 × 16 and 128 × 64, on a card (marked
``cuda``; each test skips without one); and the kept M on the CPU, which
never captures.  No JAX here, so the file runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_stokes_precond_graph.py
"""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from penguin_tpu_torch import _graph
from perfbench.paths import ns_picard as entry_path
from perfbench.reference import ns_picard as ref

ROOT = Path(__file__).resolve().parents[1]
DT, THETA = 0.002, 0.5
GRIDS = [(44, 16), (128, 64)]
SEEDS = (2 ** 31 + 5, 7_300_000_041, 12)


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
def graphs(monkeypatch):
    """The ``StaticCall`` objects made during the test, in order: one for
    each kept M wrapped for a graph (the Picard rows' graphs, kept beside
    it, are not M's)."""
    made = []
    init = _graph.StaticCall.__init__

    def recording(self, *args):
        init(self, *args)
        if self.name == "stokes.precond_graph":
            made.append(self)

    monkeypatch.setattr(_graph.StaticCall, "__init__", recording)
    return made


def _eager(M, r):
    """M's eager apply on ``r``: the same call with the graph gate shut."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_graph, "may_replay", lambda fields, like: False)
        return M(r)


def _fresh(case):
    """A copy of the case's solver with no kept M: its own M and graph."""
    solver = copy.copy(case["solver"])
    solver._picard_M = None
    return solver


def _leaves(like, seed, dtype=None):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(tuple(f.shape), generator=g, dtype=torch.float64)
                 .to(device=f.device, dtype=dtype or f.dtype) for f in like)


def _equal(a, b):
    return len(a) == len(b) and all(torch.equal(p, q) for p, q in zip(a, b))


@pytest.mark.cuda
def test_replay_equals_eager_on_random_leaves(case, graphs):
    """Bit for bit, the first call (which captures) and later ones (which
    only replay)."""
    M = _fresh(case)._picard_preconditioner(DT, THETA)
    assert len(graphs) == 1 and graphs[0].replay is None
    for seed in SEEDS:
        r = _leaves(case["start"], seed)
        z = M(r)
        assert graphs[0].replay is not None
        assert _equal(z, _eager(M, r))


@pytest.mark.cuda
def test_replay_equals_eager_in_float32(graphs):
    """A float32 channel (``chip_smoke``'s DFG 2D-2 runs one) captures its
    own float32 graph, bit for bit the eager apply."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    config = _config(GRIDS[0])
    config.update(dtype="float32")
    solver, _, _ = entry_path.build_solver(config, torch.device("cuda", 0))
    M = solver._picard_preconditioner(DT, THETA)
    like = solver.zero_state()
    assert all(t.dtype == torch.float32 for t in like)
    for seed in SEEDS:
        r = _leaves(like, seed)
        assert _graph.may_replay(r, like) and _equal(M(r), _eager(M, r))
    assert graphs[0].replay is not None


@pytest.mark.cuda
def test_replay_equals_eager_on_fgmres_basis_vectors(case, graphs,
                                                     monkeypatch):
    """The vectors a real Picard sweep hands M: every one recorded during a
    CN step, replayed again afterwards, equals the eager image."""
    solver = _fresh(case)
    seen = []
    call = _graph.StaticCall.__call__

    def recording(self, r):
        if self.name == "stokes.precond_graph":
            seen.append(tuple(t.clone() for t in r))
        return call(self, r)

    monkeypatch.setattr(_graph.StaticCall, "__call__", recording)
    solver.solve_unsteady_picard(DT, 1.0 + DT, scheme="CN", picard_iters=2,
                                 method="fgmres", tol=1e-6, maxiter=120,
                                 x0=case["start"], t_start=1.0)
    monkeypatch.setattr(_graph.StaticCall, "__call__", call)
    M = solver._picard_M[2]
    assert len(seen) >= 4 and graphs[0].replay is not None
    for r in seen[:: max(1, len(seen) // 4)]:
        assert _equal(M(r), _eager(M, r))


@pytest.mark.cuda
def test_a_held_result_is_left_alone(case, graphs):
    """A result kept across a second call is not the graph's static output,
    and the second call leaves it unchanged; a leaf M passes through is
    the caller's own, as it is eagerly."""
    M = _fresh(case)._picard_preconditioner(DT, THETA)
    r1, r2 = _leaves(case["start"], 1), _leaves(case["start"], 2)
    z1 = M(r1)
    held = tuple(t.clone() for t in z1)
    z2 = M(r2)
    assert _equal(z1, held) and not _equal(z1, z2)
    outs = {t.data_ptr() for t in graphs[0].outputs}
    eager = _eager(M, r1)
    for i, (z, e) in enumerate(zip(z1, eager)):
        if e is r1[i]:
            assert z is r1[i]
        else:
            assert z.data_ptr() not in outs


@pytest.mark.cuda
def test_two_picard_steps_equal_the_eager_stepper(case, graphs, monkeypatch):
    """Two CN Picard steps through ``solve_unsteady_picard(method="fgmres")``
    give the same state and the same fgmres counts of every sweep with the
    graph as with the eager apply."""
    kw = dict(scheme="CN", picard_iters=2, method="fgmres", tol=1e-6,
              maxiter=120, x0=case["start"], t_start=1.0)
    graphed = _fresh(case)
    xg = graphed.solve_unsteady_picard(DT, 1.0 + 2 * DT, **kw)
    its_g = graphed.krylov_sweep_iters.copy()
    assert graphs[0].replay is not None

    monkeypatch.setattr(_graph, "may_replay", lambda fields, like: False)
    eager = _fresh(case)
    xe = eager.solve_unsteady_picard(DT, 1.0 + 2 * DT, **kw)
    assert len(graphs) == 2 and graphs[1].replay is None
    assert np.array_equal(its_g, eager.krylov_sweep_iters)
    assert _equal(xg, xe)


@pytest.mark.cuda
def test_foreign_leaves_run_eagerly(case, graphs):
    """Leaves of another dtype, shape, device or number run the eager apply
    (float32 leaves give its result bit for bit) and leave the graph and
    its buffers as they were."""
    solver = _fresh(case)
    M = solver._picard_preconditioner(DT, THETA)
    like = solver.zero_state()
    r = _leaves(case["start"], 3)
    M(r)
    graph = graphs[0]
    replay, inputs = graph.replay, tuple(t.clone() for t in graph.inputs)
    r32 = _leaves(case["start"], 4, dtype=torch.float32)
    assert not _graph.may_replay(r32, like)
    assert _equal(M(r32), graph.fn(r32))
    assert graph.replay is replay and _equal(graph.inputs, inputs)
    assert not _graph.may_replay(tuple(t[:-1] for t in r), like)
    assert not _graph.may_replay(tuple(t.cpu() for t in r), like)
    assert not _graph.may_replay(r[:-1], like)
    assert _graph.may_replay(r, like)


@pytest.mark.cuda
def test_a_call_inside_another_capture_runs_eagerly(case, graphs):
    """M called while a caller captures its own graph issues the eager
    apply into that graph, whose replay gives the eager result."""
    M = _fresh(case)._picard_preconditioner(DT, THETA)
    r = _leaves(case["start"], 5)
    M(r)
    replay = graphs[0].replay
    static = tuple(t.clone() for t in r)
    outer = torch.cuda.CUDAGraph()
    with torch.cuda.graph(outer):
        out = M(static)
    assert graphs[0].replay is replay
    for a, b in zip(static, _leaves(case["start"], 6)):
        a.copy_(b)
    outer.replay()
    torch.cuda.synchronize()
    assert _equal(out, _eager(M, static))


@pytest.mark.cuda
def test_a_copied_solver_captures_its_own_graph(case, graphs):
    solver = _fresh(case)
    M = solver._picard_preconditioner(DT, THETA)
    r = _leaves(case["start"], 7)
    z = M(r)
    twin = copy.copy(solver)
    Mt = twin._picard_preconditioner(DT, THETA)
    assert Mt is not M and len(graphs) == 2 and graphs[1].replay is None
    assert _equal(Mt(r), z)
    assert graphs[1].replay is not None
    assert graphs[1].replay is not graphs[0].replay
    assert solver._picard_preconditioner(DT, THETA) is M


def test_the_kept_m_on_the_cpu_never_captures(graphs):
    """On the CPU the kept M runs its eager apply: equal to the unwrapped M
    bit for bit, and no graph."""
    cpu = torch.device("cpu")
    config = _config(GRIDS[0])
    solver, _, _ = entry_path.build_solver(config, cpu)
    M = solver._picard_preconditioner(DT, THETA)
    assert len(graphs) == 1
    like = solver.zero_state()
    for seed in SEEDS:
        r = _leaves(like, seed)
        assert not _graph.may_replay(r, like)
        assert _equal(M(r), graphs[0].fn(r))
    assert graphs[0].replay is None

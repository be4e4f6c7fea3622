"""FastHeatBE's CG replayed as CUDA graphs against the same chunks issued
eagerly, on a card (marked ``cuda``; each test skips without one).  No JAX
here, so the file runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_heat_fast_graph.py
"""

import copy

import numpy as np
import pytest
import torch

from penguin_tpu_torch import _graph
from penguin_tpu_torch.kernels import stencil as ks
from penguin_tpu_torch.solvers import heat_fast as thf
from torch_heat_cases import CG_CASES, heat_solver

SIZES = {2: 256, 3: 48}
# at tolerance 1e-6 the CG converges mid-chunk at these sizes: 28 and
# 36-38 iterations from a zero start on the tests' fields (the CPU, f64)
DT_H2 = 4.0


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def captures(monkeypatch):
    """What ``_graph.capture`` returned during the test, one entry a
    capture."""
    seen = []
    capture = _graph.capture

    def recording(*args, **kw):
        seen.append(capture(*args, **kw))
        return seen[-1]

    monkeypatch.setattr(_graph, "capture", recording)
    return seen


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _field(fast, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(tuple(fast._Va.shape)),
                           device=fast._Va.device)


def _eager(fast):
    """A copy of ``fast`` whose matvec is replaced on the instance, as
    ``parallel.sharding`` replaces it: its CG runs eagerly."""
    ref = copy.copy(fast)
    ref._cg_matvec = lambda coeffs, x: thf._apply_stencil(coeffs, x)
    return ref


def _launches():
    return ks.stencil5_matvec.launches + ks.stencil7_matvec.launches


def _matvecs(k):
    """Matvecs of a solve of ``k`` iterations: the initial residual's and
    one per iteration of each chunk issued, one chunk at least."""
    return 1 + thf.CG_CHUNK * max(1, -(-k // thf.CG_CHUNK))


@pytest.mark.cuda
@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("case", list(CG_CASES))
def test_replay_equals_eager(device, captures, ndim, case):
    """Bit for bit in the iterate and the count, the first solve (which
    captures) and later ones (which only replay)."""
    tol, maxiter = CG_CASES[case]
    fast = heat_solver(ndim, SIZES[ndim], DT_H2, device, cg_tol=tol,
                       cg_maxiter=maxiter)
    zero = torch.zeros_like(fast._Va)
    for seed in (1, 2, 3):
        Tw = _field(fast, seed)
        b = fast._Va * Tw + fast._rhs
        xe, ke = thf._cg(fast._coeffs, fast._dinv, fast._tol2, maxiter, b,
                         zero)
        xg, kg = fast.step(Tw, zero)
        assert len(captures) == 1
        assert int(kg) == int(ke) <= maxiter
        assert torch.equal(xg, xe)
    if case == "converges":
        assert 0 < int(kg) < maxiter
    if case == "converged0":
        assert int(kg) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("ndim", [2, 3])
def test_run_telemetry_replayed_equals_eager(device, captures, ndim):
    """The stepper with its warm start written into the graphs' buffer,
    against the same stepper run eagerly."""
    fast = heat_solver(ndim, SIZES[ndim], 100.0, device, cg_tol=1e-10,
                       cg_maxiter=600)
    ref = _eager(fast)
    T0 = _field(fast, 4)
    for _ in range(2):
        T, last, mx = fast.run_telemetry(T0, 5)
        Te, laste, mxe = ref.run_telemetry(T0, 5)
        assert torch.equal(T, Te)
        assert (int(last), int(mx)) == (int(laste), int(mxe))
        assert int(mx) > thf.CG_CHUNK
    assert len(captures) == 1       # the graph solver's; the eager one none


@pytest.mark.cuda
def test_results_are_never_overwritten(device):
    fast = heat_solver(2, SIZES[2], 100.0, device, cg_tol=1e-10,
                       cg_maxiter=600)
    T = _field(fast, 5)
    kept = []
    for _ in range(3):
        T, last, mx = fast.run_telemetry(T, 3)
        kept.append(((T, last, mx), (T.clone(), last.clone(), mx.clone())))
    x, k = fast.step(T)
    kept.append(((x, k), (x.clone(), k.clone())))
    fast.step(_field(fast, 6))
    fast.run_telemetry(_field(fast, 7), 2)
    for now, then in kept:
        assert all(torch.equal(a, b) for a, b in zip(now, then))


@pytest.mark.cuda
@pytest.mark.parametrize("ndim", [2, 3])
def test_replays_count_the_launches_that_ran(device, ndim):
    """The wrappers' counters grow under replay as they do eagerly, and by
    the stencil kernels a profiler sees on the device."""
    from torch.profiler import ProfilerActivity, profile
    fast = heat_solver(ndim, SIZES[ndim], 100.0, device, cg_tol=1e-10,
                       cg_maxiter=600)
    Tw = _field(fast, 8)
    fast.step(Tw)                                   # captures
    before = _launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, k = fast.step(Tw)
        torch.cuda.synchronize()
    replayed = _launches() - before
    before = _launches()
    _, ke = _eager(fast).step(Tw)
    eager = _launches() - before
    assert int(k) == int(ke) > thf.CG_CHUNK
    assert replayed == eager == _matvecs(int(k))
    kernel = f"stencil{2 * ndim + 1}_kernel"
    seen = sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and kernel in e.name())
    assert seen == replayed


@pytest.mark.cuda
def test_an_instance_override_captures_nothing(device, captures):
    """A copy holds no graph of the solver it came from: it captures its
    own.  With its matvec replaced on the instance, as a rank's block has
    it, a copy runs eagerly and captures nothing.  Both agree with the
    graphs bit for bit."""
    fast = heat_solver(2, SIZES[2], DT_H2, device)
    Tw = _field(fast, 9)
    x, k = fast.step(Tw)
    assert len(captures) == 1
    xt, kt = copy.copy(fast).step(Tw)
    assert len(captures) == 2 and captures[1][0] != captures[0][0]
    assert int(kt) == int(k) and torch.equal(xt, x)
    blk = copy.copy(fast)
    calls = []

    def matvec(coeffs, v):
        calls.append(1)
        return thf._apply_stencil(coeffs, v)

    blk._cg_matvec = matvec
    xb, kb = blk.step(Tw)
    assert len(captures) == 2
    assert len(calls) == _matvecs(int(kb))
    assert int(kb) == int(k) and torch.equal(xb, x)


def test_a_cpu_solver_captures_nothing(captures):
    """On the CPU the same chunks run eagerly, and nothing is captured."""
    fast = heat_solver(2, 16, 100.0, cg_tol=1e-10, cg_maxiter=200)
    T0 = torch.zeros_like(fast._Va)
    T, last, mx = fast.run_telemetry(T0, 3)
    assert not _graph.may_replay((T0,), (fast._Va,)) and captures == []
    assert int(mx) > thf.CG_CHUNK and bool(torch.isfinite(T).all())

"""The port's CUDA-graph module (``penguin_tpu_torch._graph``).

On the CPU: the gate ``may_replay``, on stand-ins that carry a device, a
dtype and a shape, with the CUDA queries it makes answered by the test; and
a ``StaticCall`` on CPU tensors, which runs its chain eagerly and captures
nothing.  Marked ``cuda``: a small chain of kernels with stencil launches in
it, replayed against its eager run, its launch counters, two captures
sharing a pool, a call inside another capture, and a capture while a dead
graph waits for the collector.  No JAX here, so the file runs on a machine
that has none:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_graph.py
"""

import gc
from types import SimpleNamespace

import pytest
import torch

from penguin_tpu_torch import _graph
from penguin_tpu_torch.kernels import stencil as ks

F64, CUDA0 = torch.float64, torch.device("cuda", 0)


def _stand_in(device=CUDA0, dtype=F64, shape=(4, 6)):
    return SimpleNamespace(device=torch.device(device), dtype=dtype,
                           shape=torch.Size(shape))


# (fields, whether a graph over two (4, 6) float64 tensors on cuda:0 may run
# on them) by case
GATE_CASES = {
    "match": ([_stand_in(), _stand_in()], True),
    "cpu": ([_stand_in("cpu"), _stand_in("cpu")], False),
    "other-device": ([_stand_in("cuda:1"), _stand_in()], False),
    "shape": ([_stand_in(), _stand_in(shape=(4, 5))], False),
    "dtype": ([_stand_in(), _stand_in(dtype=torch.float32)], False),
    "count": ([_stand_in()], False),
}


@pytest.mark.parametrize("case", list(GATE_CASES))
@pytest.mark.parametrize("capturing", [False, True])
def test_the_gate(case, capturing, monkeypatch):
    """CUDA fields of the current device, of the captured shapes and dtype,
    outside another capture: only these may replay."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    fields, want = GATE_CASES[case]
    assert _graph.may_replay(fields, [_stand_in(), _stand_in()]) is (
        want and not capturing)


def test_the_gate_refuses_cpu_tensors():
    like = (torch.zeros(4, 6, dtype=F64), torch.zeros(3, dtype=F64))
    assert not _graph.may_replay(like, like)


def test_a_cpu_static_call_captures_nothing(monkeypatch):
    """On CPU tensors a ``StaticCall`` is its chain, run eagerly."""
    monkeypatch.setattr(_graph, "capture", None)      # never reached
    like = (torch.zeros(3, 4, dtype=F64), torch.zeros(3, 4, dtype=F64))
    call = _graph.StaticCall(_chain, like, "test.graph")
    leaves = _leaves(like, 1)
    out = call(leaves)
    want = _chain(leaves)
    assert call.replay is None and out[2] is leaves[1]
    assert all(torch.equal(a, b) for a, b in zip(out, want))


def test_a_cpu_fill_hands_back_the_leaves():
    """On CPU tensors ``fill`` leaves the static inputs alone and hands the
    leaves back, so the eager chain reads them."""
    like = (torch.zeros(3, 4, dtype=F64), torch.zeros(3, 4, dtype=F64))
    call = _graph.StaticCall(_chain, like, "test.graph")
    leaves = _leaves(like, 2)
    held = call.fill(leaves[1:], 1)
    assert held == leaves[1:] and not call.inputs[1].any()
    out = call(leaves[:1] + held)
    assert all(torch.equal(a, b) for a, b in zip(out, _chain(leaves)))


def _chain(leaves):
    """A fixed chain from (a, b) to (y, z, b): two stencil matvecs among
    elementwise kernels and a reduction, and a leaf passed through."""
    a, b = leaves
    y = ks.stencil5_matvec(a, b, a * 0.5, b - a, torch.sin(a), b)
    z = ks.stencil5_matvec(b, a, a, b, a * b, y) * torch.sum(y * y)
    return y + 1.0, z, b


def _leaves(like, seed):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(tuple(t.shape), generator=g, dtype=t.dtype)
                 .to(t.device) for t in like)


@pytest.fixture
def like():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return tuple(torch.zeros(37, 53, dtype=F64, device=CUDA0)
                 for _ in range(2))


def _launches():
    return ks.stencil5_matvec.launches


@pytest.mark.cuda
def test_replay_equals_eager(like):
    """Bit for bit, the first call (which captures) and later ones (which
    only replay); the passed-through leaf is the caller's own, and a held
    result is left alone by the next call."""
    call = _graph.StaticCall(_chain, like, "test.graph")
    held = []
    for seed in (1, 2, 3):
        leaves = _leaves(like, seed)
        out = call(leaves)
        assert call.replay is not None and out[2] is leaves[1]
        assert all(torch.equal(a, b) for a, b in zip(out, _chain(leaves)))
        held.append((out, tuple(t.clone() for t in out)))
    for now, then in held:
        assert all(torch.equal(a, b) for a, b in zip(now, then))


@pytest.mark.cuda
def test_filled_inputs_are_read_as_filled(like):
    """Leaves filled once into the static inputs serve every later call,
    the first (which captures) and later replays, bit for bit the eager
    chain on the values filled, whatever the source leaf holds later."""
    call = _graph.StaticCall(_chain, like, "test.graph")
    source = _leaves(like, 9)[1]
    held = call.fill((source,), 1)
    assert held[0] is call.inputs[1]
    want_b = source.clone()
    source.zero_()
    for seed in (1, 2):
        a = _leaves(like, seed)[0]
        out = call((a,) + held)
        assert call.replay is not None and out[2] is held[0]
        assert all(torch.equal(p, q) for p, q in zip(out, _chain((a, want_b))))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 5])
def test_launch_counters_count_what_ran(like, n):
    """A capture and ``n`` replays move the counters as ``n`` eager runs
    do."""
    call = _graph.StaticCall(_chain, like, "test.graph")
    before = _launches()
    for seed in range(n):
        call(_leaves(like, seed))
    replayed = _launches() - before
    before = _launches()
    for seed in range(n):
        _chain(_leaves(like, seed))
    assert replayed == _launches() - before == 2 * n


@pytest.mark.cuda
def test_two_captures_share_a_pool_and_state(like):
    """Two calls captured together, the second working in place on what the
    first made (FastHeatBE's ``first`` and ``more``), replay as they run
    eagerly."""
    src = torch.zeros_like(like[0])
    state = {}

    def first():
        state["x"] = torch.cos(src) * 2.0

    def more():
        state["x"].mul_(0.5).add_(torch.sin(state["x"]))

    (first_r, more_r), _ = _graph.capture((first, more), CUDA0, "test.graph")
    for seed in (4, 5):
        src.copy_(_leaves(like, seed)[0])
        first_r()
        more_r()
        more_r()
        want = torch.cos(src) * 2.0
        for _ in range(2):
            want = want * 0.5 + torch.sin(want * 0.5)
        assert torch.equal(state["x"], want)


@pytest.mark.cuda
def test_a_call_inside_another_capture_runs_eagerly(like):
    """A ``StaticCall`` called while a caller captures its own graph issues
    the eager chain into that graph, whose replay gives the eager result."""
    call = _graph.StaticCall(_chain, like, "test.graph")
    call(_leaves(like, 6))
    replay = call.replay
    static = _leaves(like, 7)
    outer = torch.cuda.CUDAGraph()
    with torch.cuda.graph(outer):
        out = call(static)
    assert call.replay is replay
    for a, b in zip(static, _leaves(like, 8)):
        a.copy_(b)
    outer.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, _chain(static)))


@pytest.mark.cuda
def test_the_collector_frees_no_graph_mid_capture(like):
    """A graph left in a dead reference cycle while another is captured
    (a dropped solver's) is freed after the capture, not during it, where
    its destruction would end the capture."""
    dead = [_graph.StaticCall(_chain, like, "test.graph")]
    dead[0](_leaves(like, 11))
    calls = []

    def chain(leaves):
        calls.append(1)
        if len(calls) == 2:                     # the captured call
            cycle = [dead.pop()]
            cycle.append(cycle)
            del cycle
        return _chain(leaves)

    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        call = _graph.StaticCall(chain, like, "test.graph")
        leaves = _leaves(like, 12)
        out = call(leaves)
    finally:
        gc.set_threshold(*threshold)
    assert len(calls) == 2 and not dead and call.replay is not None
    assert all(torch.equal(a, b) for a, b in zip(out, _chain(leaves)))

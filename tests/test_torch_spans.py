"""The port's profiler spans (``diagnostics.span``) and where the program
places them, on the CPU at tiny sizes: each span is one ``cpu_op`` host
event in a ``torch.profiler`` trace and nothing without a profiler."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import penguin_tpu_torch as tpt
from penguin_tpu_torch import diagnostics as tdg
from penguin_tpu_torch.solvers import FastHeatBE

CAPACITY_PHASES = ("capacity.volumes", "capacity.faces", "capacity.lines",
                   "capacity.half_volumes", "capacity.staggered",
                   "capacity.interface")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _profiled(fn):
    """Run ``fn`` under a CPU profiler; returns the profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof


def _spans(prof, name):
    """(start, end) in ns of the host events named ``name``, in order."""
    return sorted((int(e.start_ns()), int(e.start_ns() + e.duration_ns()))
                  for e in prof.profiler.kineto_results.events()
                  if e.name() == name)


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_span_is_one_cpu_op(tmp_path):
    def block():
        with tdg.span("test.span"):
            torch.ones(8).sum()

    prof = _profiled(block)
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    cats = [e.get("cat") for e in events if e.get("name") == "test.span"]
    assert cats == ["cpu_op"]
    assert not any(e.get("cat") == "user_annotation" for e in events)


def test_span_without_a_profiler_records_nothing():
    before = {k: dict(v) for k, v in tdg._REGISTRY.items()}
    with tdg.span("test.no_profiler"):
        torch.ones(4).sum()
    assert tdg._REGISTRY == before


def test_timed_leaves_its_name_in_a_trace():
    def block():
        with tdg.timed("test.timed"):
            torch.ones(8).sum()

    prof = _profiled(block)
    assert len(_spans(prof, "test.timed")) == 1
    assert tdg.report(print_fn=lambda *_: None)["test.timed"]["n"] >= 1


def test_capacity_build_holds_its_phases():
    mesh = tpt.Mesh((32, 32), (4.0, 4.0), (0.0, 0.0))
    body = tpt.geometry.circle((2.0, 2.0), 1.0)
    prof = _profiled(lambda: tpt.compute_capacity(body, mesh, p=4, s=1,
                                                  device="cpu"))
    build = _spans(prof, "capacity.build")
    assert len(build) == 1
    for phase in CAPACITY_PHASES:
        found = _spans(prof, phase)
        assert len(found) == 1, phase
        assert _inside(found[0], build[0]), phase


def test_heat_steps_chunks_and_flag_reads():
    n = 16
    mesh = tpt.Mesh((n, n), (4.0, 4.0), (0.0, 0.0))
    cap = tpt.compute_capacity(tpt.geometry.circle((2.0, 2.0), 1.0), mesh,
                               p=4, s=1, device="cpu")
    borders = tpt.BorderConditions(
        {k: tpt.Dirichlet(0.0) for k in ("left", "right", "top", "bottom")})
    T0 = torch.zeros(cap.V.shape, dtype=torch.float64)
    out = {}

    def run():
        ops = tpt.make_diffusion_ops(cap)
        fast = FastHeatBE(cap, ops, 1.0, 0.0, tpt.Dirichlet(1.0), borders,
                          50.0 * (4.0 / n) ** 2, cg_tol=1e-10,
                          cg_maxiter=200)
        out["iters"] = fast.run_telemetry(T0, 3)[2]

    prof = _profiled(run)
    assert len(_spans(prof, "operators.build")) == 1
    assert len(_spans(prof, "heat_fast.build")) == 1
    steps = _spans(prof, "heat_fast.step")
    chunks = _spans(prof, "heat_fast.cg_chunk")
    flags = _spans(prof, "heat_fast.cg_flag")
    assert len(steps) == 3
    # a stiff step: more than one chunk, each with its one flag read
    assert int(out["iters"]) > 8 and len(chunks) > len(steps)
    assert len(chunks) == len(flags)
    for chunk, flag in zip(chunks, flags):
        assert chunk[1] <= flag[0]
        assert any(_inside(chunk, s) and _inside(flag, s) for s in steps)

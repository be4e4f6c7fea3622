"""The readers of the program's spans (``perfbench/spans.py``) on a
synthetic trace with overlaps computed by hand, and, on a card (marked
``cuda``), the spans of a tiny traced cell against its device events."""

import time

import pytest
import torch

from perfbench import spans, trace
from perfbench import traffic as generator
from perfbench.harness import Bench, run_cell
from conftest import ROOT

BENCH = Bench(ROOT)
MS = 1_000_000  # ns
SEED = 2 ** 31 + 977
SPAN_PREFIXES = ("heat_fast.", "capacity.", "operators.", "kernels.build")


def read(name, rec):
    return BENCH.reader(name).read(rec)


def _rec():
    """A 20 ms window; the device is busy over [1, 3], [5, 6], [7, 9] and
    [12, 13] ms (idle 14 ms, 70%)."""
    device = [("void stencil5_kernel", 1 * MS, 3 * MS, 7),
              ("void elementwise", 5 * MS, 6 * MS, 7),
              ("Memcpy DtoH (Device -> Pageable)", 7 * MS, 9 * MS, 7),
              ("void dot_kernel", 12 * MS, 13 * MS, 7)]
    host = [
        ("heat_fast.step", 0.5 * MS, 15 * MS, 1),
        # chunk 1, 3.5 ms: busy [2, 3] and [5, 5.5], so 2 ms idle; the
        # busy intervals straddle both its edges
        ("heat_fast.cg_chunk", 2 * MS, 5.5 * MS, 1),
        # flag 1, 2 ms: busy [5.5, 6] and [7, 7.5], 1 ms idle
        ("heat_fast.cg_flag", 5.5 * MS, 7.5 * MS, 1),
        # chunk 2, 3 ms: busy [8, 9]; the gap [9, 12] straddles its end,
        # 2 ms of it inside
        ("heat_fast.cg_chunk", 8 * MS, 11 * MS, 1),
        # flag 2, 1.5 ms: busy [12, 12.5], 1 ms idle
        ("heat_fast.cg_flag", 11 * MS, 12.5 * MS, 1),
        ("aten::dot", 8.5 * MS, 9.5 * MS, 1),
        # names that only resemble a span's are not read
        ("heat_fast.cg_chunks", 13 * MS, 20 * MS, 1),
        ("aten::heat_fast.cg_flag", 13 * MS, 20 * MS, 1),
    ]
    return dict(trace=dict(span=(0, 20 * MS), host=host, device=device,
                           steps=1))


def test_readers_on_hand_computed_overlaps():
    rec = _rec()
    assert read("device_idle_pct", rec) == pytest.approx(70.0)
    assert read("cg_chunk_ms", rec) == pytest.approx((3.5 + 3.0) / 2)
    assert read("idle_cg_pct", rec) == pytest.approx(100 * 4 / 20)
    assert read("idle_sync_pct", rec) == pytest.approx(100 * 2 / 20)


def test_the_parts_add_within_the_idle_share():
    rec = _rec()
    assert (read("idle_cg_pct", rec) + read("idle_sync_pct", rec)
            <= read("device_idle_pct", rec))


def test_a_span_is_clipped_to_the_window():
    rec = _rec()
    # a chunk from 19 to 21 ms keeps its 1 ms inside the window, all idle
    rec["trace"]["host"].append(("heat_fast.cg_chunk", 19 * MS, 21 * MS, 1))
    assert spans.intervals(rec["trace"], "heat_fast.cg_chunk")[-1] == (
        19 * MS, 20 * MS)
    assert read("idle_cg_pct", rec) == pytest.approx(100 * 5 / 20)
    assert read("cg_chunk_ms", rec) == pytest.approx((3.5 + 3.0 + 1.0) / 3)


def test_the_3d_variant_is_read_by_its_base():
    rec = _rec()
    assert BENCH.reader("idle_sync_pct.3d") is BENCH.reader("idle_sync_pct")
    assert read("idle_sync_pct.3d", rec) == read("idle_sync_pct", rec)


@pytest.mark.parametrize("name", ["cg_chunk_ms", "idle_cg_pct",
                                  "idle_sync_pct", "idle_sync_pct.3d"])
def test_nothing_to_read(name):
    assert read(name, dict(trace=None)) is None
    no_spans = _rec()
    no_spans["trace"]["host"] = [ev for ev in no_spans["trace"]["host"]
                                 if not ev[0].startswith("heat_fast.")]
    assert read(name, no_spans) is None
    if name != "cg_chunk_ms":
        # no device events: no idle share, as device_idle_pct
        idle = _rec()
        idle["trace"]["device"] = []
        assert read(name, idle) is None


def _tiny_cell(root, device):
    bench = Bench(root)
    w = bench.cell("heat2d-stiff-f64")
    config = bench.config(w["config"])
    traffic = bench.data("workloads", w["traffic"])
    path = bench.module("paths", config["path"])
    inputs = generator.make_inputs(config, traffic, SEED, device)
    return config, traffic, path, inputs


@pytest.mark.cuda
def test_spans_share_the_device_clock(tiny_root):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    device = torch.device("cuda", 0)
    config, traffic, path, inputs = _tiny_cell(tiny_root, device)
    _, per_episode = generator.schedule(traffic)

    def build_and_run():
        entry = path.Entry(config, traffic, inputs, device)
        T = entry.start()
        for _ in range(per_episode):
            T, telemetry = entry.interval(T)
            entry.interval_failed(telemetry.tolist())

    tr = trace.profile(build_and_run)
    assert not [ev[0] for ev in tr["device"]
                if any(p in ev[0] for p in SPAN_PREFIXES)]
    steps = spans.intervals(tr, "heat_fast.step")
    chunks = spans.intervals(tr, "heat_fast.cg_chunk")
    assert len(steps) == per_episode * int(traffic["steps_per_interval"])
    # one stencil5 launch for the initial residual, one per iteration of
    # each chunk: the stream runs them in order, step by step
    per_step = [1 + 8 * sum(1 for c in chunks if s <= c[0] and c[1] <= e)
                for s, e in steps]
    kernels = sorted(ev[1] for ev in tr["device"]
                     if "stencil5_kernel" in ev[0])
    assert len(kernels) == sum(per_step)
    first = 0
    for (start, _), n in zip(steps, per_step):
        assert all(t >= start for t in kernels[first:first + n])
        first += n


@pytest.mark.cuda
def test_a_traced_cell_reports_the_span_metrics(tiny_root):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, check = run_cell(Bench(tiny_root), "heat2d-stiff-f64", SEED,
                             0.01, True, torch.device("cuda", 0),
                             time.perf_counter())
    assert result["correct"], check
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert {"cg_chunk_ms", "idle_cg_pct", "idle_sync_pct"} <= set(m)
    assert m["idle_cg_pct"] + m["idle_sync_pct"] <= m["device_idle_pct"]
    ops = [name for name, _ in result["breakdown"]["device_ops"]]
    assert not [n for n in ops if any(p in n for p in SPAN_PREFIXES)]

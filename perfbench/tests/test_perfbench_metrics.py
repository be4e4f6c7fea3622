"""The metric readers and the trace reduction on small synthetic inputs."""

import pytest

from perfbench import roofline, trace
from perfbench.harness import Bench
from conftest import ROOT

BENCH = Bench(ROOT)
MS = 1_000_000  # ns


def read(name, rec):
    return BENCH.reader(name).read(rec)


def _rec():
    k5 = "void stencil5_kernel<double>(double const*, ...)"
    k7 = "void stencil7_kernel<double>(double const*, ...)"
    device = [
        (k5, 1 * MS, 2 * MS, 7),            # 1 ms
        ("void elementwise", 1.5 * MS, 3 * MS, 7),  # overlaps: union 1-3
        ("Memcpy DtoH (Device -> Pageable)", 5 * MS, 6 * MS, 7),
        (k7, 7 * MS, 9 * MS, 7),            # 2 ms
    ]
    host = [
        ("aten::dot", 3 * MS, 4.5 * MS, 1),
        ("cudaLaunchKernel", 3.5 * MS, 4 * MS, 1),
        ("aten::item", 6 * MS, 7 * MS, 1),
    ]
    return dict(setup_s=12.5, window_s=2.0, steps=400, steps_per_interval=10,
                interval_ms=[float(i) for i in range(1, 41)],
                capacity_s=1.25, numel=257 ** 3, itemsize=8,
                device_kind="NVIDIA H100 80GB HBM3",
                trace=dict(span=(0, 10 * MS), host=host, device=device,
                           steps=4),
                syncs=(12, 10), launches=(90, 10))


def test_end_to_end_readers():
    rec = _rec()
    assert read("setup_s", rec) == 12.5
    assert read("step_ms", rec) == pytest.approx(5.0)
    # intervals of 1..40 ms over 10 steps: the 95th percentile of
    # 0.1..4.0 ms, inclusive method
    assert read("step_ms_p95", rec) == pytest.approx(3.805)
    assert read("step_ms_p95", dict(rec, interval_ms=[1.0] * 5)) is None


def test_per_layer_readers():
    rec = _rec()
    assert read("capacity_s", rec) == 1.25
    assert read("kernels_per_step", rec) == pytest.approx(3 / 4)
    assert read("host_syncs_per_step", rec) == pytest.approx(1.2)
    assert read("stencil_launches_per_step", rec) == pytest.approx(9.0)
    assert read("stencil5_us", rec) == pytest.approx(1000.0)
    # busy: [1, 3] + [5, 6] + [7, 9] = 5 ms of a 10 ms span
    assert read("device_idle_pct", rec) == pytest.approx(50.0)
    least = 9 * 8 * 257 ** 3 / 3.35e12
    assert read("stencil7_roofline", rec) == pytest.approx(
        100 * least / 2e-3)


def test_a_variant_is_read_by_its_base():
    rec = _rec()
    assert BENCH.reader("step_ms.3d") is BENCH.reader("step_ms")
    assert read("device_idle_pct.3d", rec) == read("device_idle_pct", rec)


def test_readers_find_nothing_to_read():
    rec = dict(_rec(), trace=None, syncs=None, launches=None)
    for name in ("kernels_per_step", "host_syncs_per_step",
                 "stencil_launches_per_step", "stencil5_us",
                 "stencil7_roofline", "device_idle_pct"):
        assert read(name, rec) is None
    no_kernels = dict(_rec())
    no_kernels["trace"] = dict(no_kernels["trace"], device=[])
    assert read("stencil5_us", no_kernels) is None
    assert read("stencil7_roofline", dict(_rec(), device_kind="cpu")) is None


def test_breakdown():
    out = trace.breakdown(_rec()["trace"])
    ops = dict(out["device_ops"])
    assert ops["void elementwise"] == pytest.approx(1.5e-3)
    gaps = dict(out["idle_gaps"])
    # idle: 0-1 (no host op), 3-5 (mid 4 ms: cudaLaunchKernel, innermost),
    # 6-7 (mid 6.5 ms: aten::item), 9-10 (none)
    assert gaps["python"] == pytest.approx(2e-3)
    assert gaps["cudaLaunchKernel"] == pytest.approx(2e-3)
    assert gaps["aten::item"] == pytest.approx(1e-3)


def test_stencil_work():
    assert roofline.stencil_work(2, 1025 ** 2, 4) == (9 * 1025 ** 2,
                                                      7 * 4 * 1025 ** 2)
    assert roofline.least_seconds("cpu", 3, 10, 8) is None
